"""ctypes bindings of the native threaded wav batch loader (``src/wavloader.cc``).

Counterpart of ``multilingual_kws_tpu/native/wavloader.py``: ``load_batch``
reads N 16-bit PCM wavs into one int16 (N, desired_samples) array with a
C++ worker pool, the role the reference gives TF's C++ decode ops under
``tf.data``. The reader declines files it does not read (not 16-bit PCM,
malformed or unusual chunks, unreadable); those rows are read by
``utils/wav.read_wav_int16``, whose semantics the C++ reader follows (channel
0 of the first ``data`` chunk, zero-padded or cut to ``desired_samples``),
so every row equals ``read_wav_int16``'s, and a file neither reads raises
there. The library is built with ``g++`` at first use; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Sequence

import numpy as np

from ..utils.wav import read_wav_int16
from . import load, target

SIGNATURES = {
    # paths (NUL-terminated, back to back), count, desired_samples, threads,
    # out (N, desired_samples) int16, status (N,) int32
    "wl_load_batch": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
                       np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")], None),
}


def available() -> bool:
    """Whether ``load_batch`` can run here: its library is built, or g++ is
    on the path to build it."""
    return target("wavloader").exists() or shutil.which("g++") is not None


def default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def load_batch(paths: Sequence[str], desired_samples: int, num_threads: int = 0) -> np.ndarray:
    """Paths -> int16 (N, desired_samples), each row ``read_wav_int16``'s."""
    paths = list(paths)
    if not paths:
        return np.zeros((0, desired_samples), np.int16)
    out = np.empty((len(paths), desired_samples), np.int16)
    status = np.empty(len(paths), np.int32)
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    load("wavloader", SIGNATURES).wl_load_batch(
        blob, len(paths), desired_samples, num_threads or default_threads(), out, status
    )
    for i in np.nonzero(status)[0]:
        out[i], _ = read_wav_int16(paths[i], desired_samples=desired_samples)
    return out
