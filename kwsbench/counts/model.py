"""Floating-point operations of the EfficientNetB0 models, from layer shapes.

A frozen copy of the port's ``bench.flops_per_clip`` rule: 2 x the
multiply-adds of every convolution and dense layer (each dense layer acts
once a clip, on the pooled features). Training adds, for every layer, the
weight gradient (as many operations as the forward) and, for every layer
but the stem, whose input needs no gradient, the input gradient (as many
again)."""

from __future__ import annotations

from kwsbench.reference.model import EMBEDDING, blocks, round_filters

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores (the
# configurations compute in float32 with TF32 off)
PEAK_FP32_FLOPS = 67e12


def _layers(top: str, num_labels: int, width: float, depth: float, h: int = 49, w: int = 40):
    """(forward flops, is_stem) of each layer of one clip."""
    out = []

    def conv(cin, cout, k, oh, ow, groups=1, stem=False):
        out.append((2 * oh * ow * cout * (cin // groups) * k * k, stem))

    def down(n):
        return -(-n // 2)

    h, w = down(h), down(w)
    stem = round_filters(32, width)
    conv(1, stem, 3, h, w, stem=True)
    cin = stem
    for b in blocks(width, depth):
        if b["expand"] != 1:
            conv(b["cin"], b["exp"], 1, h, w)
        if b["stride"] == 2:
            h, w = down(h), down(w)
        conv(b["exp"], b["exp"], b["k"], h, w, groups=b["exp"])
        conv(b["exp"], b["se"], 1, 1, 1)
        conv(b["se"], b["exp"], 1, 1, 1)
        conv(b["exp"], b["cout"], 1, h, w)
        cin = b["cout"]
    feat = round_filters(1280, width)
    conv(cin, feat, 1, h, w)
    dense = [(feat, 1024), (1024, 1024), (1024, EMBEDDING)]
    dense += [(EMBEDDING, num_labels)] if top == "classifier" else [(EMBEDDING, 18), (18, 3)]
    out += [(2 * i * o, False) for i, o in dense]
    return out


def forward_flops(top: str, num_labels: int = 761, width: float = 1.0, depth: float = 1.0) -> int:
    """Forward operations of one clip."""
    return sum(f for f, _ in _layers(top, num_labels, width, depth))


def train_flops(top: str, num_labels: int = 761, width: float = 1.0, depth: float = 1.0) -> int:
    """Forward and backward operations of one clip in a training step."""
    return sum(f * (2 if stem else 3) for f, stem in _layers(top, num_labels, width, depth))
