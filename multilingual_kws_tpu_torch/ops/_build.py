"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
one ``nvcc`` call takes seconds). At first use it is compiled for
``sm_90a`` into ``_build/<name>-<hash of source>.so`` beside the package
(listed in ``.gitignore``) and loaded; a later process finds the library
and loads it directly. The C functions take device pointers and the CUDA
stream as integers and return the launch's ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# argtypes of each exported function, per source
SIGNATURES: Dict[str, Dict[str, list]] = {
    "frontend": {
        # audio (int16), batch, samples, frames, window, step, channels,
        # fb_width, window, tw_r, tw_i, stw_r, stw_i, fb_idx, fb_wgt, out,
        # stream
        "kws_stream_prefix": [P, I, L, I, I, I, I, I, P, P, P, P, P, P, P, P, P],
        # base, windows, window_stride, frames, channels, smoothing_bits,
        # min_signal_remaining, enable_pcan, snr_shift, enable_log,
        # correction_bits, scale_shift, sm, om, wdf_rows, lut012, log_lut,
        # out, out_is_float, channels_per_thread, stream
        "kws_stream_suffix": [P, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P, P, P, I, I, P],
        # kws_stream_prefix's arguments up to fb_wgt, then kws_stream_suffix's
        # from smoothing_bits to log_lut, then out, out_is_float, stream
        "kws_clip_features": [P, I, L, I, I, I, I, I, P, P, P, P, P, P, P,
                              I, I, I, I, I, I, I, P, P, P, P, P, P, I, P],
        # xr, xi, rows, tw_r, tw_i, stw_r, stw_i, out, stream
        "kws_fft_energy": [P, P, L, P, P, P, P, P, P],
        "kws_error_string": [I],
    },
    "fast": {
        # base (float32), windows, window_stride, frames, channels, sm, om,
        # sb, nrb, out, stream
        "kws_noise_scan_f32": [P, I, I, I, I, P, P, F, F, P, P],
        "kws_error_string": [I],
    },
    "probes": {
        # x, y, n, k, op, out, stream
        "kws_rate_chain": [P, P, L, I, I, P, P],
        # x (float32), w's swizzled image (bf16), rows, k, out, stream
        "kws_dot_chain": [P, P, L, I, P, P],
        "kws_error_string": [I],
    },
    "augment": {
        # fg bank (int16), its rows, batch, samples, rows, shifts, is_silence
        # (uint8), bg bank (float32), its rows, its width, bg idx, bg off,
        # sil_vol, volume, 1/t, out (int16), stream
        "kws_augment_quantize": [P, I, I, L, P, P, P, P, I, L, P, P, P, P, F, P, P],
        "kws_error_string": [I],
    },
    "epilogue": {
        # x, residual (or null), mean, var, weight, bias, eps, rows, channels,
        # dtype (0 float32, 1 bfloat16), act, out, stream
        "kws_bn_act": [P, P, P, P, P, P, F, L, I, I, I, P, P],
        "kws_error_string": [I],
    },
    "mbconv": {
        # x, out, means (or null), the expand BatchNorm's mean, var, weight,
        # bias (all null: no expand), its eps, dw weight, the depthwise
        # BatchNorm's mean, var, weight, bias, its eps, se_reduce weight,
        # bias, se_expand weight, bias, n, e, se, hin, win, hout, wout, k,
        # stride, pad top, pad left, lanes, group, pad, wp, pp, psg, osg,
        # split, stream
        "kws_mbconv_middle": [P, P, P, P, P, P, P, F, P, P, P, P, P, F, P, P, P, P,
                              I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, P],
        "kws_error_string": [I],
    },
}

# every kernel wrapper, each with two counters: ``launches``, the launches
# that ran (from the host, or as a CUDA graph's replay), and ``captured``,
# the launches recorded into CUDA graphs (train/graphs.py adds each graph's
# captured launches to ``launches`` once per replay)
WRAPPERS: List[Callable] = []

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (popen, tmp, target) or None when built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    proc, tmp, target = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return log


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile the named sources, one nvcc each, all running at once.
    Returns each fresh build's compiler output (register and shared-memory
    use from ``-Xptxas -v``); sources already built are skipped."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items() if s is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.kws_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (launches that are refused
    never run, and a later synchronize would not report them)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {lib.kws_error_string(err).decode()}")


def counted(wrapper: Callable) -> Callable:
    """Give a kernel wrapper its two launch counters, both 0, and list it in
    ``WRAPPERS``."""
    wrapper.launches = 0
    wrapper.captured = 0
    WRAPPERS.append(wrapper)
    return wrapper


def count(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``launches``, or, while
    the current stream is being captured into a CUDA graph, in ``captured``
    (a captured launch runs only when the graph replays)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
