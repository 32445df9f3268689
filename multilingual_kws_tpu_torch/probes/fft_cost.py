"""Where the exact clip frontend's time goes on the card: a decomposition by
kernels that do more and more of its work.

Counterpart of ``tools_dev/probe_fft_cost.py``. At ``batch`` clips of one
second (49 frames each: 100,352 frame rows at the default 2048), by CUDA
events, in µs per clip:

- B: ``fft_energy`` (the FFT and energies alone) on seeded input-permuted
  rows, one row per frame;
- A: ``stream_prefix`` on the clips (window, input shift, FFT, energies,
  filterbank and Sqrt64: the port's prefix is fused further than the JAX
  package's A, which stops at the energies);
- C: ``clip_features``, the whole frontend;
- D, E: ``clip_features`` of frontends with PCAN and log off (D) and log
  off (E). They are diagnostics, not the features a user gets.

Derived: A - B (window, shift, filterbank, Sqrt64) and C - A (the noise
reduction, PCAN and log, and the fused kernel's own layout).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import cuda_clip, cuda_fft
from ..ops.micro_exact import FrontendConfig
from ..ops.micro_torch import MicroFrontendTorch
from . import cuda_device, cuda_ms

SR = 16000


def fft_cost(batch: int = 2048, iters: int = 10, device="cuda", seed: int = 0) -> Dict[str, float]:
    """The A/B/C/D/E decomposition (µs per clip) and the derived
    differences. Raises without a CUDA device."""
    dev = cuda_device(device)
    fe = MicroFrontendTorch(FrontendConfig(), device=dev)
    fe_d = MicroFrontendTorch(FrontendConfig(enable_pcan=False, enable_log=False), device=dev)
    fe_e = MicroFrontendTorch(FrontendConfig(enable_log=False), device=dev)
    rng = np.random.default_rng(seed)
    wave = np.clip(rng.normal(0, 0.1, (batch, SR)), -1, 1)
    audio = torch.from_numpy(np.trunc(wave * 32768.0).clip(-32768, 32767).astype(np.int16)).to(dev)
    rows = batch * fe.num_frames(SR)
    xr, xi = (
        torch.from_numpy(rng.integers(-32768, 32768, (rows, 256)).astype(np.int32)).to(dev) for _ in range(2)
    )
    runs = {
        "B_fft_energy": lambda: cuda_fft.fft_energy(xr, xi, fe),
        "A_stream_prefix": lambda: cuda_fft.stream_prefix(audio, fe),
        "C_clip_features": lambda: cuda_clip.clip_features(audio, fe),
        "D_no_pcan_no_log": lambda: cuda_clip.clip_features(audio, fe_d),
        "E_no_log": lambda: cuda_clip.clip_features(audio, fe_e),
    }
    res = {f"{k}_us_per_clip": cuda_ms(fn, iters) * 1e3 / batch for k, fn in runs.items()}
    res["A_minus_B_us_per_clip"] = res["A_stream_prefix_us_per_clip"] - res["B_fft_energy_us_per_clip"]
    res["C_minus_A_us_per_clip"] = res["C_clip_features_us_per_clip"] - res["A_stream_prefix_us_per_clip"]
    return res
