"""The port's clip-batch frontend (the ``clip_features`` kernel's plain
version, and ``features_from_int16`` routed through it) against the JAX
package.

Every comparison is ``==``: the frontend is integer arithmetic. The JAX side
is ``MicroFrontendJax(use_pallas=False)``, its composed exact path; the
kernel's two suffix halves (the serial noise estimate and the pointwise
rest, ``noise_estimate_chain_plain`` and ``suffix_pointwise_plain``) are
held to it one by one, also with PCAN or log off; the JAX
package's own tests hold that path ``==`` its fused Pallas kernel
``clip_frontend_features`` (tests/test_pallas_frontend.py), whose 36 s
interpret-mode run stays out of this file. The stateless prefix per clip
(``pallas_fft.clip_frontend``, row B6) runs here in interpret mode (~2 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_kws_tpu.data.dataset import file2spec as jax_file2spec
from multilingual_kws_tpu.ops import micro_int as jax_micro_int
from multilingual_kws_tpu.ops.micro_exact import FrontendConfig as JaxFrontendConfig
from multilingual_kws_tpu.ops.micro_jax import MicroFrontendJax
from multilingual_kws_tpu.ops.pallas_fft import clip_frontend
from multilingual_kws_tpu.settings import standard_microspeech_model_settings as jax_settings
from multilingual_kws_tpu_torch.data.dataset import file2spec
from multilingual_kws_tpu_torch.ops import cuda_clip, cuda_fft, cuda_frontend
from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.utils.wav import write_wav


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
def fj():
    return MicroFrontendJax(JaxFrontendConfig(), use_pallas=False)


@pytest.fixture(scope="module")
def ft():
    return MicroFrontendTorch(device="cpu")


def _clips(b, samples, seed):
    rng = np.random.default_rng(seed)
    return (np.clip(rng.normal(0, 0.25, (b, samples)), -1, 1) * 32767).round().astype(np.int16)


@pytest.mark.parametrize("b,samples", [(3, 16000), (2, 9000)])
def test_clip_features_match_jax(fj, ft, b, samples):
    audio = _clips(b, samples, seed=b)
    want = np.asarray(fj.features_from_int16(jnp.asarray(audio)))
    plain = cuda_clip.clip_features_plain(torch.from_numpy(audio), ft).numpy()
    routed = ft.features_from_int16(torch.from_numpy(audio)).numpy()
    assert plain.shape == want.shape == (b, ft.num_frames(samples), 40)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(routed, want)


# the cost probe's diagnostic frontends (probes/fft_cost.py) and the
# default one; the JAX package's fused kernel takes the same switches
CONFIGS = {
    "default": {},
    "no_pcan": {"enable_pcan": False},
    "no_log": {"enable_log": False},
    "no_pcan_no_log": {"enable_pcan": False, "enable_log": False},
}


@pytest.mark.parametrize("cfg", ["no_pcan", "no_log", "no_pcan_no_log"])
def test_clip_features_configs_match_jax(cfg):
    fj = MicroFrontendJax(JaxFrontendConfig(**CONFIGS[cfg]), use_pallas=False)
    ft = MicroFrontendTorch(FrontendConfig(**CONFIGS[cfg]), device="cpu")
    audio = _clips(3, 16000, seed=17)
    want = np.asarray(fj.features_from_int16(jnp.asarray(audio)))
    got = cuda_clip.clip_features_plain(torch.from_numpy(audio), ft).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_noise_chain(fj, base):
    """The JAX package's noise-estimate recurrence (its CPU path: a lax.scan
    of ``micro_int.nr_estimate_step``) over (B, F, C) uint32 signal."""
    x = jnp.moveaxis(jnp.asarray(base, jnp.uint32), -2, 0)

    def step(est, sig):
        est = jax_micro_int.nr_estimate_step(est, sig, fj.sm_u, fj.om_u, fj.t.smoothing_bits)
        return est, est

    _, est = jax.lax.scan(step, jnp.zeros(x.shape[1:], jnp.uint32), x)
    return np.asarray(jnp.moveaxis(est, 0, -2))


@pytest.mark.parametrize("cfg", ["default", "no_pcan", "no_log"])
def test_suffix_halves_match_jax(cfg):
    """The noise-estimate chain alone, then the pointwise rest from the
    signal and its estimates, against the JAX package's suffix and the
    stream suffix's plain version. One clip's rows hold large values, where
    ``sig << smoothing_bits`` wraps as in C."""
    fj = MicroFrontendJax(JaxFrontendConfig(**CONFIGS[cfg]), use_pallas=False)
    ft = MicroFrontendTorch(FrontendConfig(**CONFIGS[cfg]), device="cpu")
    base = cuda_fft.stream_prefix_plain(torch.from_numpy(_clips(3, 16000, seed=19)), ft).numpy()
    base[2, 20:30] = np.random.default_rng(19).integers(0, 2**24, (10, 40))
    x = torch.from_numpy(base.astype(np.int64))
    est = cuda_frontend.noise_estimate_chain_plain(x, ft)
    np.testing.assert_array_equal(est.numpy(), _jax_noise_chain(fj, base))
    raw = cuda_frontend.suffix_pointwise_plain(x, est, ft)
    want = np.asarray(fj.nr_pcan_log_int(jnp.asarray(base, jnp.uint32)))
    np.testing.assert_array_equal(raw.numpy(), want.astype(np.int64))
    b, f, c = base.shape
    windows = cuda_frontend.stream_suffix_plain(
        torch.from_numpy(base.reshape(b * f, c)), b, f, f, ft, scaled=False
    )
    np.testing.assert_array_equal(windows.numpy(), raw.numpy())


def test_clip_features_raw_match_jax(fj, ft):
    audio = _clips(3, 16000, seed=5)
    want = np.asarray(jax.jit(fj._raw_features_int)(jnp.asarray(audio)))
    got = cuda_clip.clip_features(torch.from_numpy(audio), ft, scaled=False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_long_audio_keeps_prefix_and_suffix(ft):
    """Audio whose (F, C) signal exceeds the kernel's shared memory routes to
    prefix + suffix; both routes give the same features."""
    audio = torch.from_numpy(_clips(2, 5 * 16000, seed=7))
    nf = ft.num_frames(audio.shape[1])
    assert not cuda_clip.fits(nf, 40) and cuda_clip.fits(49, 40)
    before = cuda_clip.clip_features.launches
    routed = ft.features_from_int16(audio)
    assert torch.equal(routed, cuda_clip.clip_features_plain(audio, ft))
    assert cuda_clip.clip_features.launches == before  # CPU tensors never count


def test_features_from_int32_audio(ft):
    """int32 audio in the int16 range is taken, as by the JAX frontend;
    values outside it raise instead of wrapping."""
    audio = _clips(2, 16000, seed=9)
    want = ft.features_from_int16(torch.from_numpy(audio))
    got = ft.features_from_int16(torch.from_numpy(audio.astype(np.int32)))
    assert torch.equal(got, want)
    bad = audio.astype(np.int32)
    bad[0, 5] = 40000
    with pytest.raises(ValueError, match="int16 range"):
        ft.features_from_int16(torch.from_numpy(bad))
    with pytest.raises(TypeError):
        ft.features_from_int16(torch.from_numpy(audio.astype(np.float32)))


def test_file2spec_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    wave = np.clip(rng.normal(0, 0.2, 14000), -1, 1).astype(np.float32)  # shorter: zero-padded
    path = tmp_path / "clip.wav"
    write_wav(path, wave)
    want = np.asarray(jax_file2spec(jax_settings(3), str(path)))
    got = file2spec(standard_microspeech_model_settings(3), str(path), device="cpu")
    assert got.shape == (49, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_stream_prefix_is_clip_frontend(fj, ft):
    """Row B6: ``stream_prefix`` on a (B, T) clip batch computes what the
    Pallas kernel ``pallas_fft.clip_frontend`` computes (interpret mode)."""
    audio = _clips(3, 16000, seed=11)
    want = np.asarray(
        clip_frontend(
            jnp.asarray(audio, jnp.int32), fj.window_coeffs, fj._fft_pr, fj._fft_pi,
            fj.fb_whi_f32, fj.fb_wlo_f32, interpret=True,
        )
    )
    got = cuda_fft.stream_prefix_plain(torch.from_numpy(audio), ft).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
