"""The frontend's entry points and the resident train transform as programs
(``train/graphs.ProgramGraphs``), on the CPU: the counterparts of
``MicroFrontendJax``'s jitted ``_features_jit``, ``_features_i16_jit`` and
``_stream_jit`` and of the JAX dataset's jitted ``resident`` transform
(``_jitted_device_fns``).

On the CPU a program has no graph: each call is its function, and its keys
are kept as on a card. So:

(a) each entry point, exact and fast, ``==`` its eager twin, and against
the JAX package's jitted entry point on the same seeded input: exact mode
``==``; fast mode within tests/test_torch_fast_frontend.py's bound (at most
one grid step, on at most 5e-4 of the features: the FFT libraries' last
bits);
(b) the keys: one a shape, one program a ``num_windows``; the program runs
on the frontend's device; inside another program the entry points run
their eager twins, and a program called there raises;
(c) the resident program: the bank and the background bank are read in
place, keyed by their storage (an in-place edit keeps the key, new storage
is a new key), never copied (the function gets the bank itself; a bank on
another device raises); its batches and the generator's state ``==`` the
eager ``_train_device`` loop's; the eager transform ``==`` the JAX
package's resident transform with the JAX draws injected (no background
mix, whose float arithmetic differs by one int16 step at most:
tests/test_torch_augment.py);
(d) ``disable_graphs()`` keeps no key.

The graphs run only on a card: ``chip_smoke.py``'s phase o holds each
program graphed ``==`` eager there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus
from multilingual_kws_tpu.data.dataset import AudioDataset as JaxAudioDataset
from multilingual_kws_tpu.data.dataset import _jitted_device_fns
from multilingual_kws_tpu.ops.augment import SpecAugParams as JaxSpecAugParams
from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.ops.pallas_augment import draw_augment_params as jax_draw_augment_params
from multilingual_kws_tpu.settings import standard_microspeech_model_settings as jax_settings
from multilingual_kws_tpu_torch.data import dataset as port_dataset
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
from multilingual_kws_tpu_torch.ops.cuda_augment import AugmentDraws
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train import graphs
from test_torch_augment import _jax_spec_draws
from test_torch_fast_frontend import _assert_close_features

MODES = ["exact", "fast"]
ENTRIES = ["features", "features_from_int16", "stream_features"]
STREAM_SAMPLES = 24000  # 26 windows of one second at the 20 ms hop
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frontends():
    """mode -> (the port's frontend on the CPU, the JAX package's)."""
    return {mode: (MicroFrontendTorch(FrontendConfig(), device="cpu", mode=mode),
                   MicroFrontendJax(JaxFrontendConfig(), mode=mode, use_pallas=False)) for mode in MODES}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=8)


def _int16(seed: int, shape) -> np.ndarray:
    """Speech-level noise with loud and quiet stretches, one silent row."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, shape) * rng.uniform(1, 20000, (*shape[:-1], 1))
    a *= np.repeat(rng.uniform(0.001, 1, (*shape[:-1], shape[-1] // 1000)), 1000, axis=-1)
    if a.ndim == 2:
        a[0] = 0
    return np.clip(np.round(a), -32768, 32767).astype(np.int16)


def _inputs(entry: str):
    """(the port's arguments, the JAX package's) of an entry point."""
    if entry == "features":
        x = (_int16(1, (3, 16000)) / 32768.0).astype(np.float32)
        return (x,), (jnp.asarray(x),)
    if entry == "features_from_int16":
        x = _int16(2, (3, 16000))
        return (x,), (jnp.asarray(x),)
    x = _int16(3, (STREAM_SAMPLES,))
    n = -(-(STREAM_SAMPLES - 16000) // 320)
    return (x, n), (jnp.asarray(x), n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_program_equals_eager_and_the_jax_entry_point(frontends, entry, mode):
    ft, fj = frontends[mode]
    args, jargs = _inputs(entry)
    got = [getattr(ft, entry)(*args) for _ in range(3)]  # the key's eager call, then what replays on a card
    eager = getattr(ft, f"{entry}_eager")(*args)
    assert all(g.device == ft.device and g.dtype == torch.float32 and torch.equal(g, eager) for g in got)
    want = np.asarray(getattr(fj, entry)(*jargs))
    assert eager.shape == want.shape
    if mode == "exact":
        np.testing.assert_array_equal(eager.numpy(), want)
    else:
        _assert_close_features(eager, want, entry)
    prog = ft.program(entry, *args[1:])
    assert len(prog.keys()) == 1 and prog.eager_calls == 3 and prog.captures == 0


def test_long_clips_take_the_prefix_and_suffix_through_the_program(frontends):
    """Clips of more than 204 frames (the fused kernel's limit) go through
    the prefix on the clip batch and the suffix: still ``==`` the JAX
    package's ``features_from_int16``."""
    ft, fj = MicroFrontendTorch(FrontendConfig(), device="cpu"), frontends["exact"][1]
    x = _int16(4, (2, 70000))  # 218 frames
    got = ft.features_from_int16(x)
    assert tuple(got.shape) == (2, 218, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fj.features_from_int16(jnp.asarray(x))))


def test_one_key_a_shape_and_one_program_a_window_count():
    fe = MicroFrontendTorch(device="cpu")
    clips = _int16(5, (3, 16000))
    for x in (clips[:2], clips[:2], clips, clips[:2].astype(np.int32)):
        fe.features_from_int16(x)
    prog = fe.program("features_from_int16")
    # int32 audio is checked and cast to int16 before the program: its key is int16's
    assert [k[0][0][:2] for k in prog.keys()] == [((3, 16000), torch.int16), ((2, 16000), torch.int16)]
    assert prog.eager_calls == 4 and fe.program("features_from_int16") is prog
    stream = _int16(6, (STREAM_SAMPLES,))
    for n in (5, 5, 7):
        fe.stream_features(stream, n)
    five, seven = fe.program("stream_features", 5), fe.program("stream_features", 7)
    assert five is not seven and len(five.keys()) == len(seven.keys()) == 1
    assert five.eager_calls == 2 and seven.eager_calls == 1
    assert tuple(fe.stream_features(stream, 7).shape) == (7, 49, 40)
    # the last MAX_SHAPES window counts keep their programs
    for n in range(1, graphs.MAX_SHAPES + 2):
        fe.stream_features(stream[: 16000 + 320 * n], n)
    kept = [k for k in fe._programs if isinstance(k, tuple)]
    assert kept == [("stream_features", n) for n in range(2, graphs.MAX_SHAPES + 2)]
    with pytest.raises(ValueError, match="no entry point"):
        fe.program("spectrogram")


def test_program_runs_on_the_frontends_device():
    """Whatever device the argument lies on, the program runs on the
    frontend's (a host array is uploaded into its static input on a card);
    the eager twins compute where a tensor lies."""
    fe = MicroFrontendTorch(device="cpu")
    prog = fe.program("features")
    assert prog.device(torch.empty(2, 16000, device="meta")) == torch.device("cpu")
    x = (_int16(7, (2, 16000)) / 32768.0).astype(np.float32)
    assert torch.equal(fe.features(x), fe.features(torch.from_numpy(x)))
    assert fe.features(x).device == torch.device("cpu")


def test_inside_another_program_the_entry_points_run_eagerly():
    """An entry point called inside another program (or an epoch step) runs
    its eager twin, which the enclosing graph records: the frontend's
    program sees no call. A program called there raises."""
    fe = MicroFrontendTorch(device="cpu")
    x = torch.from_numpy(_int16(8, (2, 16000)))
    outer = graphs.ProgramGraphs(lambda a: fe.features_from_int16(a) + 1.0)
    assert torch.equal(outer(x), fe.features_from_int16_eager(x) + 1.0)
    assert fe.program("features_from_int16").keys() == [] and not graphs.inside_program()
    inner = fe.program("features_from_int16")
    nested = graphs.ProgramGraphs(lambda a: inner(a))
    with pytest.raises(RuntimeError, match="inside another program"):
        nested(x)
    assert not graphs.inside_program()


def _dataset(corpus, seed=3, **kw):
    return AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown_files"],
                        unknown_percentage=50.0, spec_aug_params=SpecAugParams(percentage=80), seed=seed,
                        device="cpu", **kw)


def test_resident_program_reads_the_bank_in_place(corpus, monkeypatch):
    files = corpus["alpha"][:5]
    ds = _dataset(corpus)
    made = ds.build_resident_bank(files)
    bank = made["bank"]
    idx, _, sil = ds._put_batch(next(ds.host_train_indices(files, 4, 1, made)))
    prog = ds._resident_program
    assert prog.generators == [ds.gen] and prog.resident == {0, 3, 4} and prog.device(idx) == ds.device
    seen = []
    fn = prog.fn
    monkeypatch.setattr(prog, "fn", lambda *a: seen.append(a) or fn(*a))
    first = ds.resident_specs(bank, idx, sil)
    (key,) = prog.keys()
    assert seen[0][0] is bank and seen[0][3] is ds.bg_data and seen[0][4] is ds.bg_sizes  # not copies
    assert key[1] == (bank.data_ptr(), ds.bg_data.data_ptr(), ds.bg_sizes.data_ptr())
    # an in-place edit keeps the key, and the call reads it
    gen = ds.gen.get_state()
    bank.copy_(bank // 2)
    ds.gen.set_state(gen)
    halved = ds.resident_specs(bank, idx, sil)
    assert prog.keys() == [key] and not torch.equal(halved, first)
    ds.gen.set_state(gen)
    assert torch.equal(halved, ds._train_device(bank, idx, sil))
    # new storage: a new key, and the old storage's key goes
    other = bank.clone()
    ds.resident_specs(other, idx, sil)
    assert prog.keys() != [key] and len(prog.keys()) == 1 and prog.keys()[0][1][0] == other.data_ptr()
    # a bank elsewhere is not copied over: it raises
    with pytest.raises(ValueError, match="read in place"):
        ds.resident_specs(bank.to("meta"), idx, sil)
    with graphs.disable_graphs():
        ds.resident_specs(bank, idx, sil)
    assert len(prog.keys()) == 1 and prog.eager_calls == 3


def test_resident_batches_are_the_eager_transforms(corpus):
    """``train_batches_resident`` through the program against the eager
    ``_train_device`` on the same draws: every batch, label and the
    generator's state after them."""
    files = corpus["alpha"][:5]
    a, b = _dataset(corpus, seed=6), _dataset(corpus, seed=6)
    got = list(a.train_batches_resident(files, BATCH, 3))
    bank = b.build_resident_bank(files)
    want = []
    for idx, lbl, sil in b.host_train_indices(files, BATCH, 3, bank):
        idx, lbl, sil = b._put_batch((idx, lbl, sil))
        want.append((b._train_device(bank["bank"], idx, sil), lbl))
    assert len(got) == len(want) == 3 and a._resident_program.eager_calls == 3
    for (sg, lg), (sw, lw) in zip(got, want):
        assert torch.equal(sg, sw) and torch.equal(lg, lw)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def test_resident_transform_matches_jax_with_injected_draws(corpus, monkeypatch):
    """The port's resident transform on bank rows with the JAX package's
    draws (augmentation and SpecAugment from one key, split as the JAX
    transform splits it) ``==`` the JAX package's jitted resident
    transform. No background mix and no silence rows: their float mix is
    one int16 step apart at most (tests/test_torch_augment.py)."""
    kw = dict(commands=["alpha"], background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"],
              unknown_percentage=50.0, background_frequency=0.0, silence_percentage=0.0, seed=4)
    jds = JaxAudioDataset(model_settings=jax_settings(3), spec_aug_params=JaxSpecAugParams(percentage=80), **kw)
    tds = AudioDataset(standard_microspeech_model_settings(3), spec_aug_params=SpecAugParams(percentage=80),
                       device="cpu", **kw)
    files = corpus["alpha"][:5]
    jbank, tbank = jds.build_resident_bank(files), tds.build_resident_bank(files)
    assert jbank["index"] == tbank["index"]
    idx, _, sil = next(tds.host_train_indices(files, BATCH, 1, tbank))
    assert not sil.any()
    key = jax.random.PRNGKey(11)
    _, resident, _ = _jitted_device_fns(jds.frontend, jds.aug_params)
    want = np.asarray(resident(key, jbank["bank"], jnp.asarray(idx), jnp.asarray(sil), jds.bg_data, jds.bg_sizes))

    k_aug, k_spec = jax.random.split(key)
    draws = AugmentDraws(*(torch.from_numpy(np.array(a)) for a in jax_draw_augment_params(
        k_aug, BATCH, 16000, jds.bg_data.shape[0], jds.bg_sizes, jds.aug_params)))
    masks = _jax_spec_draws(k_spec, BATCH, 49, 40, tds.aug_params.spec_aug)
    assert bool(draws.shifts.ne(0).any()) and bool(masks.apply.any())
    monkeypatch.setattr(port_dataset, "draw_augment_params", lambda *a: draws)
    monkeypatch.setattr(port_dataset, "draw_spec_masks", lambda *a: masks)
    got = tds.resident_specs(tbank["bank"], torch.from_numpy(idx), torch.from_numpy(sil))
    assert got.shape == want.shape == (BATCH, 49, 40, 1)
    np.testing.assert_array_equal(got.numpy(), want)
