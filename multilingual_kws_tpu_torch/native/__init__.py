"""The port's host C++ code: the threaded micro frontend and wav loader.

Each ``src/<name>.cc`` has a plain C interface, bound with ctypes. It is
compiled with ``g++`` at first use into ``<name>-<hash of source and
flags>.so`` in the package's build directory (``ops/_build.BUILD_DIR``,
``multilingual_kws_tpu_torch/_build/`` unless
``utils/compilation_cache.enable_compilation_cache`` moved it), under a
temporary name first and then renamed into place, so concurrent first
builds leave one whole library. A failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ..ops import _build

SRC = Path(__file__).resolve().parent / "src"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native host libraries build only where a C++ compiler is installed")
    return path


def target(name: str) -> Path:
    """Where ``src/<name>.cc`` is built, keyed by a hash of the source and flags."""
    digest = hashlib.sha1((SRC / f"{name}.cc").read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return _build.BUILD_DIR / f"{name}-{digest}.so"


def build_library(name: str) -> Path:
    """Compile ``src/<name>.cc`` unless it is built; returns the library's path."""
    lib = target(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    out = subprocess.run([gxx(), *GXX_FLAGS, str(SRC / f"{name}.cc"), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/src/{name}.cc:\n{out.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``src/<name>.cc``, built first if needed;
    ``signatures``: function -> (argtypes, restype)."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build_library(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return _LIBS[name]
