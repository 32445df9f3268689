"""A build directory shared across processes and checkouts.

Counterpart of ``multilingual_kws_tpu/utils/compilation_cache.py`` (JAX's
persistent executable cache). The port's compiled code is its CUDA kernels
(``ops/_build.py``, ``nvcc``) and host libraries (``native/``, ``g++``),
each named by a hash of its source and flags; by default they are built
into ``multilingual_kws_tpu_torch/_build/`` beside the package.
``enable_compilation_cache`` points that directory elsewhere, so a process
in another checkout of the same sources loads the libraries built there
instead of compiling them again. As in the JAX package it does nothing
without a card.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from ..ops import _build

DEFAULT = "~/.cache/multilingual_kws_tpu_torch/build"


def enable_compilation_cache(path: Optional[str] = None) -> bool:
    """Build and load the port's libraries in ``path``, else
    ``$MKWS_COMPILATION_CACHE``, else ``~/.cache/multilingual_kws_tpu_torch/build``
    (created). Returns True if it did; without a card it changes nothing
    and returns False. Libraries already loaded in this process stay loaded."""
    if not torch.cuda.is_available():
        return False
    path = Path(os.path.expanduser(path or os.environ.get("MKWS_COMPILATION_CACHE") or DEFAULT))
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return True
