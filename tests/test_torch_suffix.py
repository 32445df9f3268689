"""``cuda_frontend.stream_suffix`` on CPU tensors (its plain version) against
the JAX package, for every caller's shape: windows at stride 1 (the
stream), at a stride between, and at stride F (clip batches), with the
default frontend and with PCAN or the log off, raw and scaled.

The JAX side is the reference's own arithmetic: the Pallas noise-estimate
kernel ``noise_estimate_scan_u32`` in interpret mode on the gathered
windows, then the pointwise stages of ``MicroFrontendJax.nr_pcan_log_int``
(noise subtraction, PCAN gain, log or the 16-bit cap). Every comparison is
``==``: the suffix is integer arithmetic, and scaling by 10/256 is exact.

The launch plan (``cuda_frontend.launch_plan``) is held to covering every
(window, channel) exactly once, the stream's, clip batches' and one long
window's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_kws_tpu.ops import micro_int as jmi
from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.ops.pallas_frontend import noise_estimate_scan_u32
from multilingual_kws_tpu_torch.ops import cuda_frontend
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F = 49
SETTINGS = {"default": {}, "no_pcan": dict(enable_pcan=False), "no_log": dict(enable_log=False)}
STRIDES = {"1": 1, "7": 7, "F": F}
H100_SMS = 132


def _base(rows: int) -> np.ndarray:
    """(rows, 40) sqrt-filterbank-like signal: magnitudes spread over 2^0 ..
    2^26 (the prefix's range), runs of zeros and of small values, so the
    noise estimate passes through 0, 1 and 2 and the PCAN branches and log
    segments all occur."""
    rng = np.random.default_rng(21)
    x = np.floor(2.0 ** rng.uniform(0, 26, (rows, 40)))
    x[rng.random((rows, 40)) < 0.05] = 0
    run = x[rows // 3 : rows // 3 + 60]
    run[:] = rng.integers(0, 4, run.shape)
    return x.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_frontend(setting: str):
    return MicroFrontendJax(JaxFrontendConfig(**SETTINGS[setting]), use_pallas=False)


@functools.lru_cache(maxsize=None)
def _torch_frontend(setting: str):
    return MicroFrontendTorch(FrontendConfig(**SETTINGS[setting]), device="cpu")


@functools.lru_cache(maxsize=None)
def _windows(n: int, stride: int):
    """The gathered (F, n, 40) uint32 windows and their noise estimates
    from the Pallas kernel in interpret mode (the same for every setting:
    the recurrence has no PCAN or log)."""
    base = _base((n - 1) * stride + F)
    idx = np.arange(n)[:, None] * stride + np.arange(F)[None, :]
    x = np.moveaxis(base[idx], 1, 0).astype(np.uint32)  # (F, n, 40)
    fj = _jax_frontend("default")
    est = noise_estimate_scan_u32(jnp.asarray(x), fj.sm_u, fj.om_u, fj.t.smoothing_bits, interpret=True)
    return base, x, np.asarray(est)


def _jax_suffix(n: int, stride: int, setting: str) -> np.ndarray:
    """The reference's pointwise stages (``nr_pcan_log_int`` after its
    recurrence) -> (n, F, 40) int64 features."""
    _, x, est = _windows(n, stride)
    fj = _jax_frontend(setting)
    t = fj.t
    x, est = jnp.asarray(x), jnp.asarray(est)
    out = jmi.nr_subtract(x, est, fj.msr_u, t.smoothing_bits)
    if t.enable_pcan:
        out = jmi.pcan_gain(out, jmi.wide_dynamic_function(est, fj.wdf_rows_f32, fj.lut012_i32), t.snr_shift)
    if t.enable_log:
        out = jmi.log_scale_int(out, t.correction_bits, t.scale_shift, fj.log_pairs_f32)
    else:
        out = jnp.minimum(out, jnp.uint32(0xFFFF))
    return np.moveaxis(np.asarray(out), 0, 1).astype(np.int64)


@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "scaled"])
@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("stride", list(STRIDES))
@pytest.mark.parametrize("n", [1, 63, 65])
def test_stream_suffix_matches_jax(n, stride, setting, scaled):
    s = STRIDES[stride]
    base, _, _ = _windows(n, s)
    got = cuda_frontend.stream_suffix(torch.from_numpy(base), n, s, F, _torch_frontend(setting), scaled=scaled)
    want = _jax_suffix(n, s, setting)
    assert got.shape == (n, F, 40)
    if scaled:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32) * np.float32(10.0 / 256.0))
    else:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("num_windows, channels", [
    (29950, 40),  # the 10-minute stream
    (2048, 40), (64, 40), (63, 40), (65, 40),  # clip batches
    (1, 40),  # one long clip: a single window of thousands of frames
    (1, 32), (7, 33),  # other channel counts
])
def test_launch_plan_covers_every_window_once(num_windows, channels):
    """Thread i of the planned launch computes window i // (C / cpt),
    channels cpt * (i % (C / cpt)) onwards (as the kernel maps them): every
    (window, channel) exactly once."""
    cpt = cuda_frontend.launch_plan(num_windows, channels, H100_SMS)
    assert channels % cpt == 0
    groups = channels // cpt
    i = np.arange(num_windows * groups)
    w, c0 = i // groups, (i % groups) * cpt
    cells = (w[:, None] * channels + c0[:, None] + np.arange(cpt)[None, :]).ravel()
    np.testing.assert_array_equal(np.bincount(cells, minlength=num_windows * channels), 1)


def test_launch_plan_takes_four_channels_only_where_the_card_fills():
    assert cuda_frontend.launch_plan(29950, 40, H100_SMS) == 4
    assert cuda_frontend.launch_plan(2048, 40, H100_SMS) == 1
    assert cuda_frontend.launch_plan(1, 40, H100_SMS) == 1
    assert cuda_frontend.launch_plan(29950, 42, H100_SMS) == 1


@pytest.mark.parametrize("sms", [66, H100_SMS])
def test_launch_plan_switches_at_threads_per_sm(sms):
    """Four channels a thread from FOUR_FROM_THREADS_PER_SM threads of
    that layout an SM: at 40 channels, 10 threads a window."""
    first = cuda_frontend.FOUR_FROM_THREADS_PER_SM * sms // 10
    assert cuda_frontend.launch_plan(first, 40, sms) == 4
    assert cuda_frontend.launch_plan(first - 1, 40, sms) == 1


def test_one_long_window_matches_jax():
    """One window of 3000 frames (a long clip through features_from_int16:
    stride F, a single window) against the JAX package's
    ``nr_pcan_log_int`` on the same signal: the state runs on across the
    whole window."""
    base = _base(3000)
    got = cuda_frontend.stream_suffix(torch.from_numpy(base), 1, 3000, 3000, _torch_frontend("default"),
                                      scaled=False)
    want = np.asarray(jax.jit(_jax_frontend("default").nr_pcan_log_int)(jnp.asarray(base[None].astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
