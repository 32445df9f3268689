"""DS-CNN keyword-spotting model (the reference's depthwise-separable CNN baseline).

Counterpart of ``multilingual_kws_tpu/models/dscnn.py`` (the reference's
notebooks/dscnn_comparison_filtering.py:48-150): Conv 10x4 stride 2 -> 4 x
[depthwise 3x3 + pointwise 1x1] blocks (each conv with BN and relu),
dropout, average pooling over half the input size, dense softmax. The
modules carry the Flax names (``stem``, ``stem_bn``, ``block{i}.dw``,
``dw_bn``, ``pw``, ``pw_bn``, ``out``), so ``models/convert.flax_to_state_dict``
carries the JAX package's ``params`` and ``batch_stats`` across.

Flax semantics kept:

- the stem's ``padding="SAME"`` at stride 2 pads 49x40 with 4 rows above
  and 5 below, one column each side (the extra row at the bottom), to 25x20;
- BatchNorm is ``models/efficientnet.BatchNorm`` at Flax's defaults (eps
  1e-5, momentum 0.99, the biased variance into the running statistics);
- dropout (0.2 after the stem, 0.4 before the pooling) is element-wise,
  keeps 1 - rate and scales by 1/(1 - rate); its draws come from the
  ``torch.Generator`` passed as ``dropout_generator``, never the global RNG;
- the pooling is VALID with window and stride (24, 20) on the 25x20 map (it
  drops the last row), and the output is the softmax, not logits.

The reference's L2 kernel regularization (weight decay 1e-4) is added to the
gradients of every parameter by the optimizer (``dscnn_optimizer``: optax's
``add_decayed_weights`` then Adam on the step-function learning rate), as
the JAX package does. There is no DS-CNN trainer, in either package.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .efficientnet import BatchNorm

BN_EPS = 1e-5  # Flax nn.BatchNorm's default


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in train mode each element is kept with
    probability 1 - rate and scaled by 1/(1 - rate), else zeroed; the draws
    come from ``generator`` (on its own device; the mask moves to x's)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode needs dropout_generator (a torch.Generator)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class SeparableBlock(nn.Module):
    """Depthwise 3x3 (with bias) + BN + relu, then pointwise 1x1 + BN + relu."""

    def __init__(self, channels: int, filters: int):
        super().__init__()
        self.dw = nn.Conv2d(channels, channels, 3, padding=1, groups=channels, bias=True)
        self.dw_bn = BatchNorm(channels, eps=BN_EPS)
        self.pw = nn.Conv2d(channels, filters, 1, bias=True)
        self.pw_bn = BatchNorm(filters, eps=BN_EPS)

    def forward(self, x):
        x = F.relu(self.dw_bn(self.dw(x)))
        return F.relu(self.pw_bn(self.pw(x)))


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one dimension: (before, after), the
    extra one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class DSCNN(nn.Module):
    """Input (B, 49, 40, 1) -> (B, num_labels) softmax, on ``device`` (the
    card by default: it raises without one unless given ``"cpu"``)."""

    STEM_KERNEL, STEM_STRIDE = (10, 4), 2

    def __init__(self, num_labels: int, filters: int = 64, num_blocks: int = 4,
                 input_hw: Tuple[int, int] = (49, 40), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.input_hw = tuple(input_hw)
        self.stem = nn.Conv2d(1, filters, self.STEM_KERNEL, stride=self.STEM_STRIDE, bias=True)
        self.stem_bn = BatchNorm(filters, eps=BN_EPS)
        self.stem_drop = Dropout(0.2)
        self.block_names = [f"block{i + 1}" for i in range(num_blocks)]
        for name in self.block_names:
            setattr(self, name, SeparableBlock(filters, filters))
        self.head_drop = Dropout(0.4)
        # the reference: AveragePooling2D(pool_size=(in_h // 2, in_w // 2))
        self.pool = (self.input_hw[0] // 2, self.input_hw[1] // 2)
        self.out = nn.Linear(filters, num_labels)
        self.to(dev)

    def forward(self, x, dropout_generator=None):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        (top, bottom), (left, right) = (
            same_pad(x.shape[2 + d], self.STEM_KERNEL[d], self.STEM_STRIDE) for d in range(2)
        )
        x = self.stem(F.pad(x, (left, right, top, bottom)))
        x = self.stem_drop(F.relu(self.stem_bn(x)), dropout_generator)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.head_drop(x, dropout_generator)
        x = F.avg_pool2d(x, self.pool, stride=self.pool)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax's NHWC flatten
        return torch.softmax(self.out(x), dim=-1)


def dscnn_lr_schedule() -> Callable[[int], float]:
    """Step-function learning rate by epoch (the reference's :131-141):
    5e-4 before epoch 12, 1e-4 before 24, 2e-5 before 36, then 1e-5."""

    def schedule(epoch: int) -> float:
        return 5e-4 if epoch < 12 else 1e-4 if epoch < 24 else 2e-5 if epoch < 36 else 1e-5

    return schedule


class DSCNNAdam(torch.optim.Optimizer):
    """optax's ``chain(add_decayed_weights(weight_decay), adam(lr))`` with the
    step-function learning rate of ``dscnn_lr_schedule`` at epoch ``count //
    steps_per_epoch``, where ``count`` is the number of updates before this
    one (optax's schedule count, from 0). Each update, in float32: g +=
    weight_decay * p for every parameter; mu = 0.1 g + 0.9 mu; nu = 0.001 g²
    + 0.999 nu; p -= lr * (mu / (1 - 0.9^t)) / (sqrt(nu / (1 - 0.999^t)) +
    1e-8), with t = count + 1."""

    def __init__(self, params, steps_per_epoch: int, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.count = 0
        self.schedule = dscnn_lr_schedule()

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count // self.steps_per_epoch)

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.lr()
        self.count += 1
        t = np.float32(self.count)
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            # the bias corrections in float32, as optax computes them
            bc1, bc2 = (float(np.float32(1) - np.float32(b) ** t) for b in (b1, b2))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                g = p.grad + wd * p
                mu = (1 - b1) * g + b1 * state["mu"]
                nu = (1 - b2) * (g * g) + b2 * state["nu"]
                state["mu"], state["nu"] = mu, nu
                p.add_((mu / bc1 / (torch.sqrt(nu / bc2) + eps)) * -lr)
        return None


def dscnn_optimizer(steps_per_epoch: int, weight_decay: float = 1e-4) -> Callable[..., DSCNNAdam]:
    """Adam + step LR + additive L2 (the reference's kernel_regularizer), as
    the JAX package's ``dscnn_optimizer``; call the result on the model's
    parameters to get the ``torch.optim.Optimizer``."""
    return functools.partial(DSCNNAdam, steps_per_epoch=steps_per_epoch, weight_decay=weight_decay)
