"""The few-shot fine-tune step, its optimizer and loss, and BN calibration.

Counterpart of ``multilingual_kws_tpu/train/steps.py`` (Keras compile/fit of
the reference, transfer_learning.py:55-93):

- ``adam``: Keras-default Adam (eps 1e-7, not torch's 1e-8) over the
  trainable parameters only. Every other parameter has requires_grad off and
  is not in the optimizer, so it never changes: the JAX package's
  ``multi_transform`` with ``set_to_zero``;
- ``sparse_ce_from_probs``: Keras sparse categorical cross-entropy on
  probabilities, clipped to [1e-7, 1] with ``clamp`` (zero gradient outside,
  as ``jnp.clip``);
- ``make_finetune_step``: a step on a model that stays in ``eval()`` mode
  (frozen BN running statistics, no drop-connect), as Keras trains a
  ``trainable=False`` trunk;
- ``calibrate_batch_stats``: BN running statistics set to the data's
  moments, for a trunk that was never pretrained.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

ParamPath = Tuple[str, ...]


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """Keras-default Adam (b1 0.9, b2 0.999, eps 1e-7)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)


def sparse_ce_from_probs(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Keras SparseCategoricalCrossentropy(from_logits=False) per sample:
    probabilities clipped to [eps, 1], then -log p[label]."""
    p = torch.clamp(probs, eps, 1.0)
    return -torch.log(p).gather(1, labels[:, None].to(torch.int64))[:, 0]


def set_trainable(model: nn.Module, trainable: Callable[[ParamPath], bool]) -> List[str]:
    """Turn requires_grad on for the parameters whose path (the name split
    at ".", the Flax path of the JAX package) ``trainable`` accepts, and off
    for the rest. Returns the trainable parameters' names."""
    names = []
    for name, p in model.named_parameters():
        on = bool(trainable(tuple(name.split("."))))
        p.requires_grad_(on)
        if on:
            names.append(name)
    return names


def _metrics(probs, labels):
    loss = sparse_ce_from_probs(probs, labels).mean()
    acc = (torch.argmax(probs, -1) == labels).to(torch.float32).mean()
    return loss, acc


def make_finetune_step(model: nn.Module, learning_rate: float, trainable: Callable[[ParamPath], bool]):
    """Few-shot fine-tune step: the parameters ``trainable`` accepts learn
    with a fresh Adam, every other one is frozen; the model stays in eval
    mode. Returns (step, evaluate, predict):

    - ``step(specs, labels)`` updates the model in place and returns
      {"loss", "accuracy"} as device scalars (no host sync); the trainable
      parameters' ``.grad`` hold the step's gradients afterwards;
    - ``evaluate(specs, labels)`` returns the same metrics without a
      gradient;
    - ``predict(specs)`` returns the (B, 3) softmax."""
    names = set(set_trainable(model, trainable))
    opt = adam([p for n, p in model.named_parameters() if n in names], learning_rate)
    model.eval()

    def step(specs, labels) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        probs = model(specs)
        loss, acc = _metrics(probs, labels)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "accuracy": acc}

    @torch.no_grad()
    def evaluate(specs, labels) -> Dict[str, torch.Tensor]:
        loss, acc = _metrics(model(specs), labels)
        return {"loss": loss, "accuracy": acc}

    @torch.inference_mode()
    def predict(specs) -> torch.Tensor:
        return model(specs)

    return step, evaluate, predict


@torch.no_grad()
def calibrate_batch_stats(model: nn.Module, specs_batches, drop_generator=None) -> nn.Module:
    """Set every BN layer's running statistics to the data's moments.

    A trunk that was never pretrained has init statistics (mean 0, var 1)
    that normalize nothing, so frozen-BN training would see unnormalized
    features. One train-mode forward per batch (BN on batch statistics,
    drop-connect from ``drop_generator``) records each BN input's mean and
    biased variance over (N, H, W) (Flax's batch moments) by forward hooks;
    the running statistics become their mean over the batches. In train
    mode no layer's output depends on the running statistics, so this is
    the fixed point the JAX package iterates towards. The model is left in
    eval mode."""
    batches = list(specs_batches)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    if not batches or not bns:
        return model
    sums = {bn: [0.0, 0.0] for bn in bns}

    def record(bn, inputs, _output):
        x = inputs[0]
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        sums[bn][0] = sums[bn][0] + mean
        sums[bn][1] = sums[bn][1] + var

    handles = [bn.register_forward_hook(record) for bn in bns]
    tracked = {bn: bn.num_batches_tracked.clone() for bn in bns}
    try:
        model.train()
        for specs in batches:
            model(specs, drop_generator=drop_generator)
    finally:
        for h in handles:
            h.remove()
        model.eval()
    for bn in bns:
        bn.running_mean.copy_(sums[bn][0] / len(batches))
        bn.running_var.copy_(sums[bn][1] / len(batches))
        bn.num_batches_tracked.copy_(tracked[bn])
    return model
