"""The port's fast frontend mode against the JAX package's ``mode="fast"``.

On the CPU the port runs the plain version of its CUDA kernel
(``ops/cuda_fast.noise_scan_f32``); the JAX package runs its lax.scan path,
and its Pallas kernel in interpret mode.

Tolerances, and why:

- the recurrence and every pointwise stage, given the same inputs: ``==``.
  The port computes what XLA computes for the JAX expressions: one rounding
  for the recurrence's fused multiply-add, ``log2`` as log(x) * float32(1 /
  log 2) and ``exp2`` as exp(x * float32(log 2));
- the float prefix: each side is held to a float64 reference of the same
  prefix, in the energy before the ``sqrt``, relative to each frame's total
  energy (``test_prefix_matches_jax`` derives the bound);
- whole features (at most 5e-4 of the elements differ, each by one grid
  step): a last-bit difference of the prefix flips a floor of the suffix on
  3e-5 of the elements at most (measured on these inputs), by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_corpus, tiny_transfer_model
from multilingual_kws_tpu.ops.micro_exact import FILTERBANK_BITS, NOISE_REDUCTION_BITS, WINDOW_BITS
from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.ops.pallas_frontend import noise_estimate_scan
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.models.convert import flax_to_state_dict
from multilingual_kws_tpu_torch.models.efficientnet import BlockArgs, EfficientNet
from multilingual_kws_tpu_torch.models.kws_model import KWSTransferModel
from multilingual_kws_tpu_torch.ops import cuda_clip, cuda_fast, micro_fast
from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.train.evaluate import evaluate_files_single_target
from multilingual_kws_tpu_torch.train.finetune import transfer_learn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEP = 10.0 / 256.0
CONFIGS = {
    "default": {},
    "nopcan": dict(enable_pcan=False),
    "nolog": dict(enable_log=False),
    "raw": dict(enable_pcan=False, enable_log=False),
}


def _clips(seed: int, n: int = 8) -> np.ndarray:
    """Clips with loud and quiet stretches, and edge rows: silence,
    full-scale alternation, impulses, a constant full-scale row."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (n, 16000)) * rng.uniform(1, 30000, (n, 1))
    a *= np.repeat(rng.uniform(0.001, 1, (n, 16)), 1000, axis=1)
    a[0] = 0
    a[1] = np.where(np.arange(16000) % 2, 32767, -32768)
    a[2] = 0
    a[2, ::997] = 32767
    a[3] = 32767
    return np.clip(np.round(a), -32768, 32767).astype(np.int16)


def _stream(seed: int = 3, seconds: float = 2.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    x = rng.normal(0, 2500, n) * np.repeat(rng.uniform(0.01, 3, n // 1000 + 1), 1000)[:n]
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def fj():
    return MicroFrontendJax(JaxFrontendConfig(), mode="fast", use_pallas=False)


@pytest.fixture(scope="module")
def ft():
    return MicroFrontendTorch(FrontendConfig(), device="cpu", mode="fast")


def _assert_close_features(got, want, what=""):
    steps = np.abs(np.asarray(got) - np.asarray(want)) / STEP
    assert steps.max() <= 1.0 + 1e-6, (what, steps.max())
    assert (steps > 0).mean() <= 5e-4, (what, (steps > 0).mean())


def test_mode_is_checked():
    with pytest.raises(ValueError):
        MicroFrontendTorch(device="cpu", mode="fastest")


def test_audio_shorter_than_a_frame(fj, ft):
    a = np.zeros((2, 300), np.int16)
    got = ft.features_from_int16(a)
    assert tuple(got.shape) == (2, 0, 40) == np.asarray(fj.features_from_int16(jnp.asarray(a))).shape


# the float prefix's bound, in float32 rounding's own error model (see
# test_prefix_matches_jax): 2^-21, eight units of float32 rounding (2^-24)
PREFIX_ENERGY_BOUND = 2.0**-21


def _prefix_reference(audio, window, fb, win: int, step: int):
    """The fast prefix in float64: frames times the quantized Hann window, a
    zero-padded 512-point rFFT, energies / 512^2, the filterbank product.
    Returns the filterbank energies (F, C), before the sqrt, and each frame's
    total energy at the filterbank's unit weight (F, 1)."""
    n = 1 + (audio.shape[0] - win) // step
    frames = audio.astype(np.float64)[np.arange(n)[:, None] * step + np.arange(win)] * window
    spec = np.fft.rfft(frames, n=512, axis=-1)
    energy = (spec.real**2 + spec.imag**2) / 512.0**2
    unit = float(1 << FILTERBANK_BITS)
    return energy @ fb, unit * energy.sum(axis=1, keepdims=True)


def test_prefix_matches_jax(fj, ft):
    """Both float32 prefixes against a float64 reference of the same prefix.

    Error model: float32 rounding in the FFT and the filterbank sums scales
    with each frame's total energy, not with each channel's value. So the
    error is taken in the energy before the sqrt (the output squared),
    relative to the frame's total energy at the filterbank's unit weight
    (4096 = 2^FILTERBANK_BITS; a bin's weights in two adjacent channels add
    up to it). The sqrt cannot be the scale: where a loud frame leaves a
    channel near zero (the full-scale alternating row), an energy error of
    one float32 unit of the frame (2^-24) moves that channel by up to 4.8e-3
    of the channel's largest value on these inputs. A bound of 2e-6 of each
    channel's largest value holds only while both FFT libraries compute such
    leakage bins far better than float32 rounding promises (a difference of
    3.75e-5 has been seen on the same code).

    Measured on these inputs (float32 units are 2^-24 = 6.0e-8): torch 2.7e-8
    and JAX 2.4e-8 with MKL on its AVX-512 path, torch 3.0e-8 on its AVX2
    and 3.9e-8 on its SSE4.2 path (MKL_ENABLE_INSTRUCTIONS). The bound,
    2^-21 = 4.8e-7, leaves a margin of 12 over the largest. A fault of one
    quantization step is 8 to 15 times the bound: the centre window
    coefficient 1/4096 off gives 4.0e-6, the filterbank weight of bin 100 in
    channel 26 one off 7.3e-6. Each side is checked on its own, so a failure
    names the side that moved; the two against each other take twice the
    bound."""
    a = np.concatenate([_clips(1).reshape(-1), _stream()])
    want = np.asarray(jax.jit(fj.base_frames)(jnp.asarray(a)))
    got = ft.base_frames(a)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # the reference takes the JAX package's tables, which the port's equal
    tb = ft.fast_tables("cpu")
    window = np.asarray(fj.window_coeffs, np.float64) / float(1 << WINDOW_BITS)
    fb = np.asarray(fj.fb_matrix)
    np.testing.assert_array_equal(tb["window"].numpy(), window.astype(np.float32))
    np.testing.assert_array_equal(tb["fb"].numpy(), fb)
    ref, frame_energy = _prefix_reference(a, window, fb.astype(np.float64), ft.window_size, ft.window_step)
    frame_energy = np.maximum(frame_energy, 1e-300)  # silent frames: both sides give 0
    sq = {"torch": got.numpy().astype(np.float64) ** 2, "jax": want.astype(np.float64) ** 2}
    rel = {side: np.abs(v - ref) / frame_energy for side, v in sq.items()}
    err = {side: float(r.max()) for side, r in rel.items()}
    # on failure, each side's worst (frame, channel) too
    where = {side: tuple(int(i) for i in np.unravel_index(np.argmax(r), r.shape)) for side, r in rel.items()}
    assert max(err.values()) <= PREFIX_ENERGY_BOUND, (err, where)
    assert (np.abs(sq["torch"] - sq["jax"]) / frame_energy).max() <= 2 * PREFIX_ENERGY_BOUND


def test_prefix_ignores_a_reduced_matmul_precision(ft):
    """The float prefix's filterbank product stays float32 whatever the
    process allows: under ``torch.set_float32_matmul_precision("medium")``
    oneDNN runs float32 CPU products in bf16 on CPUs with bf16 units, an
    error far above test_prefix_matches_jax's bound (which that test once
    saw exceeded from a cause not found; ROADMAP.md §3). The prefix's bits
    must not move."""
    a = np.concatenate([_clips(1).reshape(-1), _stream()])
    want = ft.base_frames(a)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = ft.base_frames(a)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "shape,top,seed", [((49, 6, 40), 1e6, 0), ((10, 3, 40), 1e4, 1)], ids=["pallas_test", "odd_batch"]
)
def test_noise_scan_matches_lax_scan_and_pallas(fj, ft, shape, top, seed):
    """tests/test_pallas_frontend.py's inputs: (F, B, C) uniform in [0, top)."""
    x = np.random.default_rng(seed).uniform(0, top, shape).astype(np.float32)
    sm = fj.smoothing
    nrb = float(1 << NOISE_REDUCTION_BITS)
    sb = float(1 << fj.config.smoothing_bits)
    om = nrb - sm

    def step(est, sig):
        est = jnp.floor((sig * sb * sm + est * om) / nrb)
        return est, est

    _, scan = jax.jit(lambda v: jax.lax.scan(step, jnp.zeros(v.shape[1:], v.dtype), v))(jnp.asarray(x))
    pallas = noise_estimate_scan(jnp.asarray(x), sm, om, sb, nrb, interpret=True)
    f, b, c = shape
    rows = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)).reshape(b * f, c))
    got = cuda_fast.noise_scan_f32(rows, b, f, f, ft).numpy().transpose(1, 0, 2)
    np.testing.assert_array_equal(got, np.asarray(scan))
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_noise_scan_windows_at_stride_one(ft):
    """A stream's windows (stride 1) restart the estimate at each window
    start: each equals the scan of its own rows."""
    base = torch.from_numpy(np.random.default_rng(2).uniform(0, 5e4, (60, 40)).astype(np.float32))
    got = cuda_fast.noise_scan_f32(base, 12, 1, 49, ft)
    for w in (0, 5, 11):
        np.testing.assert_array_equal(got[w].numpy(), cuda_fast.noise_scan_f32(base[w : w + 49], 1, 49, 49, ft)[0].numpy())
    with pytest.raises(ValueError):
        cuda_fast.noise_scan_f32(base, 13, 1, 49, ft)


@pytest.mark.parametrize("cname", list(CONFIGS))
def test_suffix_stages_match_jax(cname):
    """The pointwise stages on JAX's own prefix, one stage more in each
    config: the noise subtraction alone, + PCAN, + log, all three."""
    cfg = CONFIGS[cname]
    fj = MicroFrontendJax(JaxFrontendConfig(**cfg), mode="fast", use_pallas=False)
    ft = MicroFrontendTorch(FrontendConfig(**cfg), device="cpu", mode="fast")
    base = np.array(jax.jit(fj.base_frames)(jnp.asarray(_clips(2, 16))))
    want = np.asarray(jax.jit(fj.nr_pcan_log)(jnp.asarray(base)))
    np.testing.assert_array_equal(ft.nr_pcan_log(torch.from_numpy(base)).numpy(), want)


def test_log2_and_exp2_as_xla_computes_them():
    """floor(log2) of integer-valued floats around every power of two, and
    exp2 of the integers the stages take, against jitted jnp."""
    v = np.unique(np.concatenate([np.arange(max(1, 2**k - 40), 2**k + 40) for k in range(36)])).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.floor(jnp.log2(x)))(jnp.asarray(v)))
    np.testing.assert_array_equal(torch.floor(micro_fast.log2_jax(torch.from_numpy(v))).numpy(), want)
    n = np.arange(-48, 49, dtype=np.float32)
    np.testing.assert_array_equal(
        micro_fast.exp2_jax(torch.from_numpy(n)).numpy(), np.asarray(jax.jit(jnp.exp2)(jnp.asarray(n)))
    )


def test_features_from_int16_matches_jax(fj, ft):
    a = _clips(4, 16)
    _assert_close_features(ft.features_from_int16(a), fj.features_from_int16(jnp.asarray(a)))


def test_features_matches_jax(fj, ft):
    wave = (_clips(5, 8).astype(np.float32) / 32768.0) * 1.01  # some samples saturate
    _assert_close_features(ft.features(wave), fj.features(jnp.asarray(wave)))


def test_stream_features_matches_jax(fj, ft):
    a = _stream()
    n_w = int(np.ceil((a.shape[0] - 16000) / 320))
    got = ft.stream_features(a, n_w)
    assert tuple(got.shape) == (n_w, 49, 40) and got.dtype == torch.float32
    _assert_close_features(got, fj.stream_features(jnp.asarray(a), n_w))


def test_unquantized_matches_jax():
    fj = MicroFrontendJax(JaxFrontendConfig(), mode="fast", quantize=False, use_pallas=False)
    ft = MicroFrontendTorch(FrontendConfig(), device="cpu", mode="fast", quantize=False)
    a = _clips(6, 8)
    base = np.array(jax.jit(fj.base_frames)(jnp.asarray(a)))
    np.testing.assert_array_equal(
        ft.nr_pcan_log(torch.from_numpy(base)).numpy(), np.asarray(jax.jit(fj.nr_pcan_log)(jnp.asarray(base)))
    )
    _assert_close_features(ft.features_from_int16(a), fj.features_from_int16(jnp.asarray(a)))


def test_fast_mode_never_takes_the_fused_exact_kernel(ft, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("fast mode reached clip_features")

    monkeypatch.setattr(cuda_clip, "clip_features", refuse)
    assert tuple(ft.features_from_int16(_clips(7, 4)).shape) == (4, 49, 40)


class _Recorder:
    def __init__(self, fe):
        self.fe, self.seen = fe, []

    def features_from_int16(self, audio):
        self.seen.append(audio.clone())
        return self.fe.features_from_int16(audio)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), clips_per_word=10)


def test_dataset_batch_is_fast_features_of_its_augmented_audio(fj, ft, corpus):
    """A training batch through a fast frontend (SpecAugment off) holds the
    fast features of the int16 batch the augmentation produced; those agree
    with the JAX package's fast features of the same int16."""
    rec = _Recorder(ft)
    ds = AudioDataset(
        standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown_files"],
        unknown_percentage=50.0, spec_aug_params=SpecAugParams(percentage=0.0), seed=3, frontend=rec,
        device="cpu",
    )
    specs, labels = next(ds.train_batches(corpus["alpha"][:5], 8, 1))
    (quant,) = rec.seen
    assert quant.dtype == torch.int16 and tuple(specs.shape) == (8, 49, 40, 1)
    np.testing.assert_array_equal(specs[..., 0].numpy(), ft.features_from_int16(quant).numpy())
    _assert_close_features(specs[..., 0], fj.features_from_int16(jnp.asarray(quant.numpy())))


def _tiny_trunk():
    return EfficientNet(
        width_coefficient=0.25, depth_coefficient=0.4,
        blocks=(BlockArgs(3, 1, 32, 16, 1, 1), BlockArgs(3, 1, 16, 24, 6, 2), BlockArgs(5, 1, 24, 40, 6, 2)),
    )


def test_fast_frontend_mode_accuracy_impact(corpus):
    """The port's twin of tests/test_finetune_e2e.py's bound on fast mode's
    accuracy cost: a model fine-tuned on exact features classifies the same
    clips alike when they are featurized in fast mode. The tiny trunk starts
    from the Flax model's init weights, converted by models/convert.py."""
    fm = tiny_transfer_model()
    x = np.zeros((2, 49, 40, 1), np.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = KWSTransferModel(_tiny_trunk(), 3)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    res = transfer_learn(
        target="alpha", train_files=corpus["alpha"][:5], val_files=corpus["alpha"][5:],
        unknown_files=corpus["unknown_files"], num_epochs=4, num_batches=2, batch_size=16,
        primary_lr=1e-2, bg_datadir=corpus["bg_dir"], seed=0, verbose=0, model=model, device="cpu",
    )
    predict = res.predict_fn()
    files = corpus["alpha"][5:] + corpus["bravo"][:5]
    exact = MicroFrontendTorch(FrontendConfig(), device="cpu")
    fast = MicroFrontendTorch(FrontendConfig(), device="cpu", mode="fast")
    conf_e, preds_e = evaluate_files_single_target(files, 2, predict, frontend=exact, device="cpu")
    conf_f, preds_f = evaluate_files_single_target(files, 2, predict, frontend=fast, device="cpu")
    np.testing.assert_array_equal(np.argmax(preds_e, -1), np.argmax(preds_f, -1))
    diff = np.abs(conf_e - conf_f)
    assert diff.max() < 0.15, diff
    assert diff.mean() < 0.04, diff
