"""Floating-point operations of the wav2vec 2.0 Conformer embedding model,
from layer shapes, in the rule of ``counts/wav2vec2.py``: 2 x the
multiply-adds of every convolution (the depthwise one's k a channel and
frame) and dense layer, and of the attention's three batched products
((q + u)K^T, (q + v)P^T over the 2T - 1 relative positions, the weights
times V); norms, activations, the GLU, the shift and the softmax are not
counted. ``linear_pos`` runs once a batch (its input, the relative
encodings, has batch 1), so a clip carries 1 / batch of it. Training adds,
for every layer, the weight gradient (as many operations as the forward;
the attention products' second operand's gradient) and the input gradient
(as many again), but for the first convolution and ``linear_pos``, whose
inputs need none."""

from __future__ import annotations

from typing import Dict, List, Tuple

from kwsbench.counts.wav2vec2 import EMBEDDING, conv_lengths


def _layers(dims: Dict, num_labels: int, samples: int, frames: int, batch: int) -> List[Tuple[float, bool]]:
    """(forward flops a clip, the layer's input needs no gradient) of each
    layer, the feature encoder's at ``samples`` input samples and the
    blocks' at ``frames`` frames."""
    out = []
    cin = 1
    for i, (t, c, k) in enumerate(zip(conv_lengths(dims, samples), dims["conv_dim"], dims["conv_kernel"])):
        out.append((2 * t * c * cin * k, i == 0))
        cin = c
    h, ff, t = dims["hidden_size"], dims["intermediate_size"], frames
    out.append((2 * t * cin * h, False))  # feature projection
    for _ in range(dims["num_hidden_layers"]):
        out += [(2 * t * h * ff, False)] * 4  # the two feed-forwards
        out += [(2 * t * h * h, False)] * 4  # q, k, v, out
        out.append((2 * (2 * t - 1) * h * h / batch, True))  # linear_pos, once a batch
        out += [(2 * t * t * h, False), (2 * t * (2 * t - 1) * h, False), (2 * t * t * h, False)]
        out += [(2 * t * h * 2 * h, False), (2 * t * h * dims["conv_depthwise_kernel_size"], False),
                (2 * t * h * h, False)]  # pointwise, depthwise, pointwise
    dense = [(h, 1024), (1024, 1024), (1024, EMBEDDING), (EMBEDDING, num_labels)]
    out += [(2 * i * o, False) for i, o in dense]
    return out


def forward_flops(dims: Dict, num_labels: int, batch: int, samples: int = 16000, frames: int = None) -> float:
    """Forward operations of one clip in a batch of ``batch`` (``frames``:
    the encoder's output at ``samples`` unless given)."""
    frames = conv_lengths(dims, samples)[-1] if frames is None else frames
    return sum(f for f, _ in _layers(dims, num_labels, samples, frames, batch))


def train_flops(dims: Dict, num_labels: int, batch: int, samples: int = 16000, frames: int = None) -> float:
    """Forward and backward operations of one clip in a training step at
    batch ``batch``."""
    frames = conv_lengths(dims, samples)[-1] if frames is None else frames
    return sum(f * (2 if constant else 3) for f, constant in _layers(dims, num_labels, samples, frames, batch))
