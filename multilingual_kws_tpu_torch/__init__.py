"""PyTorch/CUDA port of ``multilingual_kws_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX). Entry points take ``device`` and default to
``"cuda"``: without a card they raise unless the caller passes
``device="cpu"``, where every CUDA kernel's plain PyTorch version runs.
"""

import contextlib

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


@contextlib.contextmanager
def exact_float32():
    """Inside the block, float32 convolutions (cuDNN) and matmuls run in
    float32, not TF32; the previous settings come back after it. The port's
    entry points run the model under it, so a float32 model computes on the
    card what the CPU tests hold it to, whatever the process's defaults
    (torch lets cuDNN use TF32 unless told otherwise). bfloat16 compute is
    unaffected."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul
