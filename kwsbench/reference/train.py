"""The pretraining step's arithmetic, plain: mean sparse cross-entropy of the
logits (float32 log-softmax), gradients by autograd, Adam with Keras'
defaults (b1 0.9, b2 0.999, eps 1e-7) over every parameter."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-7
STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def parameter_keys(p: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in p if not k.endswith(STATISTICS)]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -F.log_softmax(logits.float(), dim=-1).gather(1, labels[:, None].long())[:, 0].mean()


class Adam:
    b1, b2 = B1, B2

    def __init__(self, keys: List[str], lr: float):
        self.keys, self.lr, self.t = keys, lr, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for k in self.keys:
            b1, b2 = self.b1, self.b2
            m = self.m[k] = b1 * self.m.get(k, torch.zeros_like(g[k])) + (1 - b1) * g[k]
            v = self.v[k] = b2 * self.v.get(k, torch.zeros_like(g[k])) + (1 - b2) * g[k] * g[k]
            mhat, vhat = m / (1 - b1**self.t), v / (1 - b2**self.t)
            p[k].sub_(self.lr * mhat / (vhat.sqrt() + EPS))


def step(model, p: Dict[str, torch.Tensor], opt: Adam, specs: torch.Tensor, labels: torch.Tensor,
         drop_generator: torch.Generator, rows: slice = slice(None)):
    """One training step of ``model`` (whose parameters are ``p``) on the
    batch's ``rows``: (loss, gradients)."""
    keys = opt.keys
    for k in keys:
        p[k].requires_grad_(True)
    loss = cross_entropy(model(specs, train=True, drop_generator=drop_generator)[rows], labels[rows])
    grads = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
    for k in keys:
        p[k].requires_grad_(False)
    opt.step(p, grads)
    return float(loss.detach()), grads
