"""EfficientNetB0 keyword-spotting models in plain PyTorch, written from the
published description, with no kernel, cache or CUDA graph of the program.

- Trunk: EfficientNetB0 (Tan & Le 2019, arXiv:1905.11946, Table 1) as Keras
  builds it: Rescaling(1/255) on the 49x40x1 input; stride-2 convolutions
  pad with Keras' ``correct_pad`` and run VALID, stride-1 ones SAME;
  BatchNorm eps 1e-3; swish; squeeze-excitation of width
  ``max(1, int(block_input_filters * 0.25))``; drop-connect on residual
  blocks at rate 0.2 * block_index / 16 in training.
- Embedding head (train_monolingual_embedding.py:81-100 of
  harvard-edge/multilingual_kws): global average pooling, Dense 1024 relu,
  Dense 1024 relu, Dense 192 selu.
- Top: Dense 761 logits (the embedding model) or Dense 18 tanh and Dense 3
  softmax (transfer_learning.py:38-53, the few-shot model).

Training-mode BatchNorm follows Flax's ``nn.BatchNorm`` as the TPU package
trained it: float32 batch moments over (N, H, W), the variance as E[x^2] -
E[x]^2 clipped at 0, running statistics moved 0.01 of the way.

Parameters live in one flat dict keyed by layer path (``spec``), the key
names the program's ``state_dict`` uses, so one dict of tensors drawn by the
harness serves both sides. Float32 runs with TF32 off (``exact``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

# (kernel, repeats, filters in, filters out, expansion, stride) of B0's stages
B0_STAGES = (
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
)
EMBEDDING = 192
BN_EPS = 1e-3
BN_MOMENTUM = 0.01
DROP_CONNECT = 0.2
INPUT_SCALE = 1.0 / 255.0


@contextlib.contextmanager
def exact():
    """float32 convolutions and matmuls in float32, not TF32."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


@contextlib.contextmanager
def tf32():
    """float32 convolutions and matmuls in TF32: the precision next below
    the configurations' float32 with TF32 off, for the check's control."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def blocks(width: float = 1.0, depth: float = 1.0) -> List[Dict]:
    """The trunk's MBConv blocks in order: name, kernel, filters, stride,
    expansion, SE width, residual, drop-connect rate."""
    out = []
    total = sum(int(math.ceil(depth * s[1])) for s in B0_STAGES)
    for stage, (k, reps, fin, fout, expand, stride) in enumerate(B0_STAGES):
        fin, fout = round_filters(fin, width), round_filters(fout, width)
        for r in range(int(math.ceil(depth * reps))):
            cin = fin if r == 0 else fout
            s = stride if r == 0 else 1
            out.append({
                "name": f"block{stage + 1}{chr(ord('a') + r)}", "k": k, "cin": cin, "cout": fout,
                "stride": s, "expand": expand, "exp": cin * expand, "se": max(1, int(cin * 0.25)),
                "residual": s == 1 and cin == fout, "drop": DROP_CONNECT * len(out) / total,
            })
    return out


def spec(top: str, num_labels: int = 761, width: float = 1.0, depth: float = 1.0) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BN statistic of a model, in order: key -> shape.
    ``top`` is "classifier" (``num_labels`` logits) or "transfer" (18, 3)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(key, cout, cin, k, bias=False):
        out[key + ".weight"] = (cout, cin, k, k)
        if bias:
            out[key + ".bias"] = (cout,)

    def bn(key, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{key}.{leaf}"] = (c,)
        out[key + ".num_batches_tracked"] = ()

    def dense(key, cout, cin):
        out[key + ".weight"] = (cout, cin)
        out[key + ".bias"] = (cout,)

    stem = round_filters(32, width)
    conv("trunk.stem.conv", stem, 1, 3)
    bn("trunk.stem.bn", stem)
    cin = stem
    for b in blocks(width, depth):
        p = "trunk." + b["name"]
        if b["expand"] != 1:
            conv(p + ".expand_conv", b["exp"], b["cin"], 1)
            bn(p + ".expand_bn", b["exp"])
        conv(p + ".dw_conv", b["exp"], 1, b["k"])
        bn(p + ".dw_bn", b["exp"])
        conv(p + ".se_reduce", b["se"], b["exp"], 1, bias=True)
        conv(p + ".se_expand", b["exp"], b["se"], 1, bias=True)
        conv(p + ".project_conv", b["cout"], b["exp"], 1)
        bn(p + ".project_bn", b["cout"])
        cin = b["cout"]
    feat = round_filters(1280, width)
    conv("trunk.top.conv", feat, cin, 1)
    bn("trunk.top.bn", feat)
    dense("embedding_head.dense_0", 1024, feat)
    dense("embedding_head.dense_1", 1024, 1024)
    dense("embedding_head.dense_2", EMBEDDING, 1024)
    if top == "classifier":
        dense("classifier", num_labels, EMBEDDING)
    else:
        dense("transfer_head.hidden", 18, EMBEDDING)
        dense("transfer_head.out", 3, 18)
    return out


def correct_pad(h: int, w: int, k: int) -> Tuple[int, int, int, int]:
    """Keras ``correct_pad`` as ``F.pad`` widths (left, right, top, bottom)."""
    c = k // 2
    return (c - (1 - w % 2), c, c - (1 - h % 2), c)


class Model:
    """A model over a parameter dict ``p`` (``spec``'s keys; tensors on one
    device). ``train``: BN on batch statistics (updating the running ones
    in ``p``) and drop-connect from ``drop_generator``."""

    def __init__(self, p: Dict[str, torch.Tensor], top: str, width: float = 1.0, depth: float = 1.0):
        self.p, self.top = p, top
        self.blocks = blocks(width, depth)

    def conv(self, key, x, stride=1, groups=1):
        w = self.p[key + ".weight"]
        b = self.p.get(key + ".bias")
        k = w.shape[-1]
        if stride == 2:
            x = F.pad(x, correct_pad(x.shape[-2], x.shape[-1], k))
            pad = 0
        else:
            pad = k // 2
        return F.conv2d(x, w, b, stride, pad, 1, groups)

    def bn(self, key, x, train: bool):
        g, b = self.p[key + ".weight"], self.p[key + ".bias"]
        rm, rv = self.p[key + ".running_mean"], self.p[key + ".running_var"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                rm.copy_((1 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean)
                rv.copy_((1 - BN_MOMENTUM) * rv + BN_MOMENTUM * var)
        else:
            mean, var = rm, rv
        mul = torch.rsqrt(var + BN_EPS) * g
        return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]

    def trunk(self, x, train: bool = False, drop_generator: Optional[torch.Generator] = None):
        """(B, 49, 40, 1) features -> the pooled (B, 1280) top activations."""
        x = (x * INPUT_SCALE).permute(0, 3, 1, 2)
        x = F.silu(self.bn("trunk.stem.bn", self.conv("trunk.stem.conv", x, stride=2), train))
        for b in self.blocks:
            p = "trunk." + b["name"]
            inp = x
            if b["expand"] != 1:
                x = F.silu(self.bn(p + ".expand_bn", self.conv(p + ".expand_conv", x), train))
            x = F.silu(self.bn(p + ".dw_bn", self.conv(p + ".dw_conv", x, b["stride"], groups=b["exp"]), train))
            se = x.mean(dim=(-2, -1), keepdim=True)
            se = torch.sigmoid(self.conv(p + ".se_expand", F.silu(self.conv(p + ".se_reduce", se))))
            x = self.bn(p + ".project_bn", self.conv(p + ".project_conv", x * se), train)
            if b["residual"]:
                if train and b["drop"] > 0:
                    keep = 1.0 - b["drop"]
                    draws = torch.rand((x.shape[0], 1, 1, 1), generator=drop_generator,
                                       device=drop_generator.device)
                    x = torch.where(draws.to(x.device) < keep, x / keep, 0.0)
                x = x + inp
        x = F.silu(self.bn("trunk.top.bn", self.conv("trunk.top.conv", x), train))
        return x.mean(dim=(-2, -1))

    def dense(self, key, x):
        return F.linear(x, self.p[key + ".weight"], self.p[key + ".bias"])

    def embed(self, x, train=False, drop_generator=None):
        h = self.trunk(x, train, drop_generator)
        h = F.relu(self.dense("embedding_head.dense_0", h))
        h = F.relu(self.dense("embedding_head.dense_1", h))
        return F.selu(self.dense("embedding_head.dense_2", h))

    def __call__(self, x, train=False, drop_generator=None):
        """Logits (the embedding model) or softmax rows (the transfer model)."""
        e = self.embed(x, train, drop_generator)
        if self.top == "classifier":
            return self.dense("classifier", e)
        return torch.softmax(self.dense("transfer_head.out", torch.tanh(self.dense("transfer_head.hidden", e))), -1)


def lecun_state(keys: Dict[str, Tuple[int, ...]], generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Flax's default initialization, drawn in one call on ``device``:
    LeCun-normal kernels (a normal truncated at two standard deviations,
    variance 1/fan_in), zero biases, identity BatchNorm (scale 1, shift 0,
    mean 0, variance 1)."""
    kernels = [k for k, s in keys.items() if k.endswith(".weight") and len(s) >= 2]
    sizes = [math.prod(keys[k]) for k in kernels]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
    out: Dict[str, torch.Tensor] = {}
    for k, part in zip(kernels, flat.split(sizes)):
        fan_in = math.prod(keys[k][1:])
        out[k] = (part * ((1.0 / fan_in) ** 0.5 / 0.87962566103423978)).view(keys[k])
    for k, s in keys.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(".running_var") or (k.endswith(".weight") and len(s) == 1):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return {k: out[k] for k in keys}


@torch.no_grad()
def calibrate(model: Model, batches: Iterator[torch.Tensor]) -> None:
    """Every BN layer's running statistics := the mean over the batches of
    its input's batch moments (mean, biased variance), measured in a
    training-mode forward without drop-connect, so that a model drawn at
    random keeps every layer at unit scale in evaluation."""
    sums: Dict[str, List[torch.Tensor]] = {}
    bn = model.bn

    def record(key, x, train):
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        s = sums.setdefault(key, [0.0, 0.0])
        s[0], s[1] = s[0] + mean, s[1] + var
        return bn(key, x, True)

    saved = {k: v.clone() for k, v in model.p.items() if k.endswith(("running_mean", "running_var"))}
    model.bn = record
    n = 0
    try:
        for x in batches:
            model.trunk(x, train=False)
            n += 1
    finally:
        model.bn = bn
    for k, v in saved.items():
        model.p[k].copy_(v)
    for key, (m, v) in sums.items():
        model.p[key + ".running_mean"].copy_(m / n)
        model.p[key + ".running_var"].copy_(v / n)
