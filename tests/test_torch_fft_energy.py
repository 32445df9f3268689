"""The port's ``fft_energy`` (the FFT and energies alone, on input-permuted
rows) against the JAX package's Pallas ``kiss_fft_energy`` in interpret
mode and against the port's own kiss FFT on unpermuted frames. On the CPU
the port runs the kernel's plain version (``ops/cuda_fft.fft_energy_plain``).
Every comparison is ``==``: the FFT is fixed-point integer arithmetic and
the energies are uint32 with C's wrap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_kws_tpu.ops.micro_exact import _KissFftr512
from multilingual_kws_tpu.ops.pallas_fft import kiss_fft_energy
from multilingual_kws_tpu_torch.ops import cuda_fft
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


@pytest.fixture(scope="module")
def fe():
    return MicroFrontendTorch(device="cpu")


def _u32(e: torch.Tensor) -> np.ndarray:
    return e.numpy().astype(np.int64) & 0xFFFFFFFF


def _rows(seed: int, n: int) -> np.ndarray:
    """Full-range int16 rows, with extreme rows first."""
    x = np.random.default_rng(seed).integers(-32768, 32768, (n, 256)).astype(np.int32)
    x[0], x[1], x[2] = 32767, -32768, np.where(np.arange(256) % 2, 32767, -32768)
    return x


def test_matches_pallas_kernel_interpret(fe):
    """16 rows with the default stage variant (one interpret-mode trace)."""
    xr, xi = _rows(7, 16), _rows(8, 16)[::-1].copy()
    want = np.asarray(kiss_fft_energy(jnp.asarray(xr), jnp.asarray(xi), interpret=True)).astype(np.int64)
    got = cuda_fft.fft_energy(torch.from_numpy(xr), torch.from_numpy(xi), fe)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 257)
    np.testing.assert_array_equal(_u32(got), want)


def test_matches_kiss_fft_on_unpermuted_frames(fe):
    """Permuting a frame (even and odd samples, base-4 digit reversal) and
    running fft_energy gives the energies of the port's KissFftrTorch and of
    the host oracle on the frame itself."""
    x = np.random.default_rng(3).integers(-32768, 32768, (32, 512)).astype(np.int64)
    fr, fi = fe.kiss(torch.from_numpy(x))
    perm = torch.from_numpy(fe.kiss.perm)
    xt = torch.from_numpy(x).to(torch.int32)
    got = cuda_fft.fft_energy(xt[:, 0::2][:, perm].contiguous(), xt[:, 1::2][:, perm].contiguous(), fe)
    np.testing.assert_array_equal(_u32(got), ((fr * fr + fi * fi) & 0xFFFFFFFF).numpy())
    hr, hi = _KissFftr512()(x.astype(np.int16))
    np.testing.assert_array_equal(_u32(got), (hr.astype(np.int64) ** 2 + hi.astype(np.int64) ** 2) & 0xFFFFFFFF)


def test_prefix_frames_through_fft_input(fe):
    """The prefix's own FFT input (framed, windowed, shifted audio) through
    fft_energy gives the energies the plain prefix squares."""
    audio = torch.from_numpy(np.random.default_rng(4).normal(0, 4000, (2, 4000)).clip(-32768, 32767).astype(np.int16))
    fft_in, shift = cuda_fft.fft_input(audio, fe)
    assert tuple(fft_in.shape) == (2, fe.num_frames(4000), 512) and tuple(shift.shape) == fft_in.shape[:2]
    rows = fft_in.reshape(-1, 512)
    perm = torch.from_numpy(fe.kiss.perm)
    got = cuda_fft.fft_energy(rows[:, 0::2][:, perm].to(torch.int32), rows[:, 1::2][:, perm].to(torch.int32), fe)
    fr, fi = fe.kiss(rows)
    np.testing.assert_array_equal(_u32(got), ((fr * fr + fi * fi) & 0xFFFFFFFF).numpy())


def test_wrapper_checks_shapes(fe):
    with pytest.raises(ValueError):
        cuda_fft.fft_energy(torch.zeros((3, 255), dtype=torch.int32), torch.zeros((3, 255), dtype=torch.int32), fe)
    with pytest.raises(ValueError):
        cuda_fft.fft_energy(torch.zeros((3, 256), dtype=torch.int32), torch.zeros((2, 256), dtype=torch.int32), fe)
    assert tuple(cuda_fft.fft_energy(torch.zeros((0, 256), dtype=torch.int32),
                                     torch.zeros((0, 256), dtype=torch.int32), fe).shape) == (0, 257)
