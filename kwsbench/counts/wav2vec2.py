"""Floating-point operations of the wav2vec 2.0 embedding model (XLS-R
layout), from layer shapes, in the rule of ``counts/model.py``: 2 x the
multiply-adds of every convolution and dense layer, and of the attention's
two batched products (QK^T and the weights times V); norms, activations and
the softmax are not counted. Training adds, for every layer, the weight
gradient (as many operations as the forward; the attention products' second
operand's gradient) and, for every layer but the first convolution, whose
input needs no gradient, the input gradient (as many again)."""

from __future__ import annotations

from typing import Dict, List, Tuple

EMBEDDING = 192


def conv_lengths(dims: Dict, samples: int) -> List[int]:
    """Each feature-encoder convolution's output frames."""
    out = []
    for k, s in zip(dims["conv_kernel"], dims["conv_stride"]):
        samples = (samples - k) // s + 1
        out.append(samples)
    return out


def _layers(dims: Dict, num_labels: int, samples: int, frames: int) -> List[Tuple[int, bool]]:
    """(forward flops, is the first convolution) of each layer of one clip,
    the encoder's at ``samples`` input samples and the transformer's at
    ``frames`` frames."""
    out = []
    cin = 1
    for i, (t, c, k) in enumerate(zip(conv_lengths(dims, samples), dims["conv_dim"], dims["conv_kernel"])):
        out.append((2 * t * c * cin * k, i == 0))
        cin = c
    h, ff, t = dims["hidden_size"], dims["intermediate_size"], frames
    out.append((2 * t * cin * h, False))  # feature projection
    groups, kernel = dims["num_conv_pos_embedding_groups"], dims["num_conv_pos_embeddings"]
    out.append((2 * t * h * (h // groups) * kernel, False))  # positional convolution
    for _ in range(dims["num_hidden_layers"]):
        out += [(2 * t * h * h, False)] * 4  # q, k, v, out
        out += [(2 * t * t * h, False)] * 2  # QK^T, weights x V over all heads
        out += [(2 * t * h * ff, False)] * 2  # feed-forward
    dense = [(h, 1024), (1024, 1024), (1024, EMBEDDING), (EMBEDDING, num_labels)]
    out += [(2 * i * o, False) for i, o in dense]
    return out


def forward_flops(dims: Dict, num_labels: int, samples: int = 16000, frames: int = None) -> int:
    """Forward operations of one clip (``frames``: the encoder's output at
    ``samples`` unless given)."""
    frames = conv_lengths(dims, samples)[-1] if frames is None else frames
    return sum(f for f, _ in _layers(dims, num_labels, samples, frames))


def train_flops(dims: Dict, num_labels: int, samples: int = 16000, frames: int = None) -> int:
    """Forward and backward operations of one clip in a training step."""
    frames = conv_lengths(dims, samples)[-1] if frames is None else frames
    return sum(f * (2 if first else 3) for f, first in _layers(dims, num_labels, samples, frames))
