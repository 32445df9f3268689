"""The port's augmentation and training data pipeline against the JAX package.

- ``augment_quantize`` (on CPU tensors: its plain version) against the Pallas
  kernel ``augment_kernel_call`` in interpret mode, given the draws the JAX
  package takes for a fixed key (``pallas_augment.draw_augment_params``):
  torch cannot reproduce ``jax.random``, so the draws are injected. Rows
  that are not mixed (silence rows, volume 0) are ``==``. Mixed rows are
  held to the tolerance the JAX package already grants its own kernel
  against its XLA path (tests/test_pallas_augment.py): |diff| <= 1 int16
  step on fewer than 1e-4 of the samples, as the two RMS sums may round in
  another order. The kernel's own sum orders (one block per clip, or a
  cluster of blocks whose partial sums are added in rank order) are
  emulated in numpy and held to the same bound;
- ``apply_spec_masks`` given JAX's SpecAugment draws: ``==``;
- the host draws (``_host_train_draw``, ``host_train_indices``) are the
  JAX package's, line for line: identical for one seed;
- the streaming and resident pipelines give identical specs for one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus
from multilingual_kws_tpu.data.dataset import AudioDataset as JaxAudioDataset
from multilingual_kws_tpu.ops.augment import AugmentParams as JaxAugmentParams
from multilingual_kws_tpu.ops.augment import SpecAugParams as JaxSpecAugParams
from multilingual_kws_tpu.ops.augment import pad_background_bank as jax_pad_background_bank
from multilingual_kws_tpu.ops.augment import spec_augment as jax_spec_augment
from multilingual_kws_tpu.ops.pallas_augment import (
    augment_kernel_call,
    draw_augment_params,
    gather_bg_window,
    pack_scalar_rows,
)
from multilingual_kws_tpu.settings import standard_microspeech_model_settings as jax_settings
from multilingual_kws_tpu_torch.data.dataset import AudioDataset, load_background_bank
from multilingual_kws_tpu_torch.ops import cuda_augment
from multilingual_kws_tpu_torch.ops.augment import (
    AugmentParams,
    SpecAugParams,
    SpecMaskDraws,
    apply_spec_masks,
    draw_spec_masks,
    pad_background_bank,
    spec_augment,
)
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(b=24, t=16000, seed=0):
    """tests/test_pallas_augment.py's fixture: speech-level int16 clips, one
    silence row (zeroed), three background clips of which two barely longer
    than a clip."""
    rng = np.random.default_rng(seed)
    fg16 = ((rng.normal(0, 0.15, (b, t)) * 32768).clip(-32768, 32767)).astype(np.int16)
    is_sil = np.zeros(b, bool)
    is_sil[min(3, b - 1)] = True
    fg16[is_sil] = 0
    sizes = np.array([61234, 17000, 16001], np.int32)
    bank = np.zeros((3, int(sizes.max())), np.float32)
    for i, n in enumerate(sizes):
        bank[i, :n] = rng.normal(0, 0.1, n).astype(np.float32)
    return fg16, is_sil, jax_pad_background_bank(bank, t), sizes


@pytest.mark.parametrize("b,max_shift,seed,key", [(24, 1600, 0, 42), (24, 0, 1, 5), (11, 1600, 2, 9), (11, 0, 3, 7)])
def test_augment_matches_pallas_kernel(b, max_shift, seed, key):
    fg16, is_sil, bank, sizes = _fixture(b=b, seed=seed)
    t = fg16.shape[1]
    jparams = JaxAugmentParams(time_shift_samples=max_shift)
    shifts, idx, off, sil_vol, volume = draw_augment_params(
        jax.random.PRNGKey(key), b, t, bank.shape[0], jnp.asarray(sizes), jparams
    )
    bgw = gather_bg_window(jnp.asarray(bank), idx, off, t)
    si, sf = pack_scalar_rows(shifts, off, sil_vol, volume, jnp.asarray(is_sil), max_shift)
    want = np.asarray(
        augment_kernel_call(jnp.asarray(fg16, jnp.int32), bgw, si, sf, max_shift=max_shift, interpret=True)
    )

    draws = cuda_augment.AugmentDraws(
        *(torch.from_numpy(np.array(a)) for a in (shifts, idx, off, sil_vol, volume))
    )
    got = cuda_augment.augment_quantize(
        torch.from_numpy(fg16), torch.arange(b, dtype=torch.int32), torch.from_numpy(is_sil),
        torch.from_numpy(pad_background_bank(bank, t)), draws,
    ).numpy()
    assert got.dtype == np.int16 and got.shape == (b, t)
    got = got.astype(np.int32)
    unmixed = is_sil | (np.asarray(volume) == 0)
    assert unmixed.any() and (~unmixed).any()
    np.testing.assert_array_equal(got[unmixed], want[unmixed])
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-4, f"{(diff > 0).sum()} samples differ"


def _kernel_order_sum(sq, threads, blocks):
    """Row sums of float32 ``sq`` (B, t) in ``csrc/augment.cu``'s order: block
    r of ``blocks`` takes the r-th contiguous share of the row, thread i its
    samples i, i + threads, ... in turn, then a shuffle tree in each warp,
    the warps in order, and the blocks in rank order; one float32 rounding
    per addition."""
    b, t = sq.shape
    span = -(-t // blocks)
    total = np.zeros(b, np.float32)
    for r in range(blocks):
        seg = sq[:, r * span : min((r + 1) * span, t)]
        per = -(-seg.shape[1] // threads)
        lanes = np.zeros((b, per * threads), np.float32)
        lanes[:, : seg.shape[1]] = seg
        acc = np.zeros((b, threads), np.float32)
        for k in range(per):
            acc = acc + lanes[:, k * threads : (k + 1) * threads]
        warps = acc.reshape(b, threads // 32, 32)
        for off in (16, 8, 4, 2, 1):
            warps = warps + warps[..., np.arange(32) ^ off]
        block = np.zeros(b, np.float32)
        for w in range(threads // 32):
            block = block + warps[:, w, 0]
        total = total + block
    return total


def _kernel_order_augment(fg16, is_sil, bank, draws, threads, blocks):
    """The kernel's arithmetic in numpy float32: the shift and the crop, the
    two sums of squares in the kernel's order, the gain and the int16 mix."""
    shifts, idx, off, sil_vol, volume = (np.asarray(a) for a in draws)
    b, t = fg16.shape
    j = np.arange(t)
    k = j[None, :] - shifts[:, None]
    fg = np.where((k >= 0) & (k < t), fg16[np.arange(b)[:, None], np.clip(k, 0, t - 1)], 0)
    fg = fg.astype(np.float32) * np.float32(1 / 32768)
    col = off[:, None] + j[None, :]
    bg = np.where(col < bank.shape[1], bank[idx[:, None], np.clip(col, 0, bank.shape[1] - 1)], 0)
    bg = bg.astype(np.float32)
    inv_t = np.float32(1 / t)
    fg_rms = np.sqrt(_kernel_order_sum(fg * fg, threads, blocks) * inv_t)
    bg_rms = np.sqrt(_kernel_order_sum(bg * bg, threads, blocks) * inv_t)
    scaling = np.where(bg_rms > 0, fg_rms / np.maximum(bg_rms, np.float32(1e-30)), np.float32(0))
    gain = (scaling * volume.astype(np.float32))[:, None]
    mixed = np.clip(fg + bg * gain, np.float32(-1), np.float32(1))
    wav = np.where(is_sil[:, None], bg * sil_vol.astype(np.float32)[:, None], mixed)
    return np.clip(np.trunc(wav * np.float32(32768)), -32768, 32767).astype(np.int32)


@pytest.mark.parametrize("threads,blocks", [(512, 1), (1024, 2), (1024, 5), (1024, 8)])
def test_kernel_sum_order_within_bound(threads, blocks):
    """Each launch shape the kernel takes (one 512-thread block per clip;
    clusters of 1024-thread blocks) sums the RMS terms in an order whose
    result stays within the stated bound of the Pallas kernel."""
    fg16, is_sil, bank, sizes = _fixture(b=24, seed=8)
    t = fg16.shape[1]
    jparams = JaxAugmentParams(time_shift_samples=1600)
    draws = draw_augment_params(jax.random.PRNGKey(11), 24, t, bank.shape[0], jnp.asarray(sizes), jparams)
    bgw = gather_bg_window(jnp.asarray(bank), draws[1], draws[2], t)
    si, sf = pack_scalar_rows(*(draws[i] for i in (0, 2, 3, 4)), jnp.asarray(is_sil), 1600)
    want = np.asarray(augment_kernel_call(jnp.asarray(fg16, jnp.int32), bgw, si, sf, max_shift=1600, interpret=True))
    got = _kernel_order_augment(fg16, is_sil, np.asarray(bank), draws, threads, blocks)
    unmixed = is_sil | (np.asarray(draws[4]) == 0)
    assert unmixed.any() and (~unmixed).any()
    np.testing.assert_array_equal(got[unmixed], want[unmixed])
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-4, f"{(diff > 0).sum()} samples differ"


def test_augment_gathers_bank_rows():
    """Rows of a resident bank, in any order and repeated, give what the
    same clips uploaded as a batch give."""
    fg16, is_sil, bank, sizes = _fixture(b=8, seed=4)
    gen = torch.Generator().manual_seed(3)
    draws = cuda_augment.draw_augment_params(gen, 6, 16000, torch.from_numpy(sizes), AugmentParams())
    rows = torch.tensor([5, 0, 5, 7, 2, 1], dtype=torch.int32)
    sil = torch.from_numpy(is_sil)[rows.long()]
    bank_t = torch.from_numpy(bank)
    from_bank = cuda_augment.augment_quantize(torch.from_numpy(fg16), rows, sil, bank_t, draws)
    batch = torch.from_numpy(fg16)[rows.long()].contiguous()
    from_batch = cuda_augment.augment_quantize(batch, torch.arange(6, dtype=torch.int32), sil, bank_t, draws)
    assert torch.equal(from_bank, from_batch)


def test_draw_augment_params_ranges():
    sizes = torch.tensor([61234, 17000, 16001], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    d = cuda_augment.draw_augment_params(gen, 4096, 16000, sizes, AugmentParams())
    assert all(v.dtype == torch.int32 for v in (d.shifts, d.idx, d.off))
    assert int(d.shifts.min()) >= -1600 and int(d.shifts.max()) < 1600
    assert set(d.idx.tolist()) == {0, 1, 2}
    assert bool((d.off < torch.clamp(sizes[d.idx.long()] - 16000, min=1)).all())
    assert 0.75 < float((d.volume > 0).float().mean()) < 0.85  # background_frequency 0.8
    assert float(d.volume.max()) < 0.1 and float(d.sil_vol.max()) < 1.0
    none = cuda_augment.draw_augment_params(gen, 16, 16000, sizes, AugmentParams(time_shift_samples=0))
    assert not none.shifts.any()


def test_augment_wrapper_refuses_bad_inputs():
    fg16, is_sil, bank, sizes = _fixture(b=4, seed=6)
    gen = torch.Generator().manual_seed(1)
    d = cuda_augment.draw_augment_params(gen, 4, 16000, torch.from_numpy(sizes), AugmentParams())
    args = (torch.from_numpy(fg16), torch.arange(4, dtype=torch.int32), torch.from_numpy(is_sil), torch.from_numpy(bank))
    with pytest.raises(ValueError, match="shape"):
        cuda_augment.augment_quantize(*args[:2], torch.from_numpy(is_sil[:3]), args[3], d)
    with pytest.raises(ValueError, match="banks"):
        cuda_augment.augment_quantize(args[0][0], *args[1:], d)
    for rows in ([0, 1, 2, 4], [0, -1, 2, 3]):
        with pytest.raises(IndexError, match="rows"):
            cuda_augment.augment_quantize(args[0], torch.tensor(rows, dtype=torch.int32), *args[2:], d)
    far = d._replace(off=torch.full((4,), bank.shape[1] + 1, dtype=torch.int32))
    with pytest.raises(IndexError, match="off"):
        cuda_augment.augment_quantize(*args, far)


def _jax_spec_draws(key, b, t, f, p):
    """The draws of the JAX package's spec_augment, with its key splits."""
    keys = jax.random.split(key, 7)
    apply = jax.random.uniform(keys[0], (b,)) < (p.percentage / 100.0)

    def axis(kn, ks, kstart, axis_len, n_range, max_px):
        n = jax.random.randint(kn, (b,), 0, n_range + 1)
        sizes = jax.random.randint(ks, (b, n_range), 1, max_px + 1)
        starts = jax.random.randint(kstart, (b, n_range), 0, 2**30) % jnp.maximum(axis_len - sizes, 1)
        return n, sizes, starts

    f_draws = axis(keys[1], keys[2], keys[3], f, p.frequency_n_range, p.frequency_max_px)
    t_draws = axis(keys[4], keys[5], keys[6], t, p.time_n_range, p.time_max_px)
    return SpecMaskDraws(
        *(torch.from_numpy(np.array(a)) for a in (apply, *f_draws, *t_draws))
    )


@pytest.mark.parametrize("params", [dict(), dict(percentage=100.0, frequency_max_px=6, time_n_range=4)])
def test_spec_masks_match_jax(params):
    b, t, f = 32, 49, 40
    specs = np.random.default_rng(0).uniform(0.1, 26, (b, t, f)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(specs), JaxSpecAugParams(**params)))
    draws = _jax_spec_draws(key, b, t, f, SpecAugParams(**params))
    got = apply_spec_masks(torch.from_numpy(specs), draws).numpy()
    assert (want == 0).any() and (want != 0).any()
    np.testing.assert_array_equal(got, want)


def test_spec_augment_draws():
    """The port's own draws: masked positions are zero, the rest untouched,
    and about 80 % of the samples are masked."""
    specs = torch.ones((2000, 49, 40))
    gen = torch.Generator().manual_seed(0)
    d = draw_spec_masks(gen, 2000, 49, 40, SpecAugParams())
    out = apply_spec_masks(specs, d)
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    masked = (out == 0).flatten(1).any(1)
    assert not masked[~d.apply].any()
    assert 0.6 < float(masked.float().mean()) < 0.8  # 80 % apply, n = 0 on some
    assert int(d.freq_starts.max()) < 40 and int(d.time_starts.max()) < 49
    assert torch.equal(spec_augment(torch.Generator().manual_seed(0), specs, SpecAugParams()), out)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=8)


def _datasets(corpus, seed):
    kw = dict(
        commands=["alpha"], background_data_dir=corpus["bg_dir"],
        unknown_files=corpus["unknown_files"], unknown_percentage=50.0, seed=seed,
    )
    return JaxAudioDataset(model_settings=jax_settings(3), **kw), AudioDataset(
        model_settings=standard_microspeech_model_settings(3), device="cpu", **kw
    )


def test_host_draws_match_jax(corpus):
    jd, td = _datasets(corpus, seed=5)
    assert td.commands == jd.commands and td.label_to_id == jd.label_to_id
    files = corpus["alpha"][:5]
    for a, b in zip(jd._host_train_draw(files, 16, 7), td._host_train_draw(files, 16, 7)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    uniq = list(dict.fromkeys(files + corpus["unknown_files"]))
    bank = {"index": {f: i for i, f in enumerate(uniq)}}
    pairs = zip(jd.host_train_indices(files, 16, 9, bank), td.host_train_indices(files, 16, 9, bank))
    for n, (a, b) in enumerate(pairs, 1):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert n == 9


def test_background_bank_matches_jax(corpus):
    from multilingual_kws_tpu.data.dataset import load_background_bank as jax_load

    (jb, js), (tb, ts) = jax_load(corpus["bg_dir"]), load_background_bank(corpus["bg_dir"])
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)


def test_streaming_and_resident_pipelines_agree(corpus):
    files = corpus["alpha"][:5]
    _, a = _datasets(corpus, seed=2)
    _, b = _datasets(corpus, seed=2)
    streamed = list(a.train_batches(files, batch_size=8, num_steps=3, prefetch=2))
    resident = list(b.train_batches_resident(files, batch_size=8, num_steps=3))
    assert len(streamed) == len(resident) == 3
    for (sa, la), (sb, lb) in zip(streamed, resident):
        assert tuple(sa.shape) == (8, 49, 40, 1) and bool(torch.isfinite(sa).all())
        assert torch.equal(la, lb)
        assert torch.equal(sa, sb)


def test_eval_batches_match_jax(corpus):
    jd, td = _datasets(corpus, seed=1)
    files = corpus["alpha"] + corpus["bravo"][:3]
    want = list(jd.eval_batches(files, batch_size=4, with_silence_unknown=True))
    got = list(td.eval_batches(files, batch_size=4, with_silence_unknown=True))
    assert len(got) == len(want)
    for (gs, gl), (ws, wl) in zip(got, want):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
