"""PyTorch/CUDA port of ``multilingual_kws_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX). Entry points take ``device`` and default to
``"cuda"``: without a card they raise unless the caller passes
``device="cpu"``, where every CUDA kernel's plain PyTorch version runs.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            'pass device="cpu" to run the plain PyTorch path'
        )
    return dev
