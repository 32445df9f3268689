"""The port's exact frontend against the JAX package and the golden features.

Every comparison is ``==``: the frontend is integer arithmetic, and the JAX
package's exact mode is itself bit-identical to the real TFLite op. On the
CPU the port runs the plain PyTorch versions of its two CUDA kernels
(``ops/cuda_fft.stream_prefix``, ``ops/cuda_frontend.stream_suffix``); the
JAX package runs its lax.scan path, and its Pallas NR kernel in interpret
mode.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_exact import _KissFftr512
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.ops.pallas_frontend import noise_estimate_scan_u32 as pallas_scan_u32
from multilingual_kws_tpu_torch.ops import cuda_fft, cuda_frontend
from multilingual_kws_tpu_torch.ops import micro_int as mi
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import KissFftrTorch, MicroFrontendTorch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and these small models' many small ops
    then spend their time in thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = Path(__file__).parent / "golden" / "microfrontend_golden.npz"
WAVEFORMS = [
    "zeros", "sine440", "loud1k", "fullscale", "noise", "quiet", "chirp",
    "impulses", "speechlike", "mix", "long_mix", "short",
]
CONFIGS = {
    "default40": {},
    "micro32": dict(window_size_ms=25, window_step_ms=10, num_channels=32),
    "nopcan": dict(enable_pcan=False),
    "nolog": dict(enable_log=False),
    "raw": dict(enable_pcan=False, enable_log=False, min_signal_remaining=1.0),
}


def _audio(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if case == "random":  # speech-level noise with loud and quiet stretches
        x = rng.normal(0, 2500, 36000) * np.repeat(rng.uniform(0.01, 3, 36), 1000)
    elif case == "edges":  # silence, full scale of both signs, impulses
        x = np.zeros(36000)
        x[2000:5000] = 32767
        x[5000:8000] = -32768
        x[8000:12000] = np.where(np.arange(4000) % 2, 32767, -32768)
        x[15000:30000:997] = 32767
        x[20000:30000:1231] = -32768
        x[30000:] = rng.normal(0, 20000, 6000)
    elif case == "short":  # shorter than one clip: frames, but no window
        x = rng.normal(0, 1000, 12000)
    else:
        raise KeyError(case)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


CASES = ["random", "edges", "short"]


@pytest.fixture(scope="module")
def fj():
    return MicroFrontendJax(JaxFrontendConfig(), use_pallas=False)


@pytest.fixture(scope="module")
def jax_stages(fj):
    """The JAX package's two stages, jitted once (eager op-by-op dispatch
    would dominate these tests)."""
    return jax.jit(fj.base_frames), jax.jit(fj.nr_pcan_log_int)


@pytest.fixture(scope="module")
def ft():
    return MicroFrontendTorch(FrontendConfig(), device="cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _num_windows(n: int) -> int:
    return max(0, int(np.ceil((n - 16000) / 320)))


def test_kiss_fft_matches_host_oracle():
    x = np.random.default_rng(3).integers(-32768, 32768, (16, 512)).astype(np.int16)
    want_r, want_i = _KissFftr512()(x)
    got_r, got_i = KissFftrTorch()(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("case", CASES)
def test_base_frames_matches_jax(jax_stages, ft, case):
    a = _audio(case)
    want = np.asarray(jax_stages[0](jnp.asarray(a))).astype(np.int64)
    got = ft.base_frames(a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("case", CASES)
def test_nr_pcan_log_int_matches_jax(jax_stages, ft, case):
    base = np.asarray(jax_stages[0](jnp.asarray(_audio(case))))
    f = 49 if base.shape[0] >= 49 else base.shape[0]
    windows = np.stack([base[i : i + f] for i in (0, base.shape[0] - f)])  # (2, f, 40)
    want = np.asarray(jax_stages[1](jnp.asarray(windows))).astype(np.int64)
    got = ft.nr_pcan_log_int(torch.from_numpy(windows.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("top", [1 << 26, 1 << 32])
def test_noise_scan_matches_pallas_interpret(fj, top):
    """The port's plain recurrence against the Pallas kernel it replaces,
    up to the full uint32 range (where sig << 10 wraps)."""
    x = np.random.default_rng(5).integers(0, top, (49, 5, 40), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pallas_scan_u32(jnp.asarray(x), fj.sm_u, fj.om_u, 10, interpret=True))
    sm = torch.from_numpy(np.asarray(fj.sm_u).astype(np.int64))
    om = torch.from_numpy(np.asarray(fj.om_u).astype(np.int64))
    got = mi.noise_estimate_scan_u32(torch.from_numpy(x.astype(np.int64)), sm, om, 10)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("case", CASES)
def test_stream_features_matches_jax(fj, ft, case):
    a = _audio(case)
    n_w = _num_windows(a.shape[0])
    got = ft.stream_features(a, n_w).numpy()
    assert got.shape == (n_w, 49, 40) and got.dtype == np.float32
    if n_w:
        np.testing.assert_array_equal(got, np.asarray(fj.stream_features(jnp.asarray(a), n_w)))


def test_features_from_int16_batch_matches_jax(fj, ft):
    batch = _audio("random")[:32000].reshape(2, 16000)
    want = np.asarray(fj.features_from_int16(jnp.asarray(batch)))
    got = ft.features_from_int16(batch).numpy()
    assert got.shape == (2, 49, 40)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wname", WAVEFORMS)
def test_features_match_golden(ft, golden, wname):
    """to_micro_spectrogram semantics: float -> int16 -> frontend -> 10/256,
    against features captured from the real TFLite op."""
    got = ft.features(golden[f"floataudio_{wname}"]).numpy()
    np.testing.assert_array_equal(got, golden[f"spec_{wname}"])


@pytest.mark.parametrize("cname", list(CONFIGS))
def test_integer_features_match_golden_configs(golden, cname):
    fe = MicroFrontendTorch(FrontendConfig(**CONFIGS[cname]), device="cpu")
    for wname in WAVEFORMS:
        raw = fe.nr_pcan_log_int(fe.base_frames(golden[f"audio_{wname}"]))
        np.testing.assert_array_equal(
            raw.numpy().astype(np.float32), golden[f"feat_{cname}_{wname}"], err_msg=wname
        )


def test_prefix_wrapper_shapes(ft):
    assert tuple(ft.base_frames(np.zeros((3, 479), np.int16)).shape) == (3, 0, 40)
    assert tuple(ft.base_frames(np.zeros(480, np.int16)).shape) == (1, 40)
    with pytest.raises(ValueError):
        cuda_fft.stream_prefix(torch.zeros(480, dtype=torch.int16), ft)
    with pytest.raises(ValueError):
        cuda_frontend.stream_suffix(torch.zeros((60, 40), dtype=torch.int32), 13, 1, 49, ft)
