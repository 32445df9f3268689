"""KWS models: embedding classifier and few-shot transfer head.

Counterpart of ``multilingual_kws_tpu/models/kws_model.py``:

- ``KWSEmbeddingModel``: a trunk -> global average pooling -> Dense 1024
  relu -> Dense 1024 relu -> Dense 192 selu (the embedding, reference layer
  "dense_2") -> Dense num_labels logits. The trunk is EfficientNetB0
  (``models/efficientnet.py``: (B, 49, 40, 1) features in, an NCHW map out,
  pooled over H and W) or a wav2vec 2.0 trunk, XLS-R 300M
  (``models/wav2vec2.py``) or the rel-pos Conformer
  (``models/wav2vec2_conformer.py``): (B, samples) normalized 16 kHz
  waveforms in, (B, frames, 1024) out, pooled over the frames. Each trunk
  declares what it takes (``takes_waveform``) and its pooled axes
  (``pool_dims``);
- ``KWSTransferModel``: the EfficientNetB0 trunk and embedding head ->
  Dense 18 tanh -> Dense 3 softmax (a trunk that takes waveforms is
  refused).

Module names follow the Flax ones, so a Flax parameter path maps onto a
``state_dict`` key by replacing "/" with "." (``models/convert.py``), and a
parameter's name split at "." is its Flax path up to the leaf's own name:
the fine-tune selects trainable parameters by that path
(``train/finetune.py``). ``drop_generator`` feeds the trunk's train-mode
drop-connect (``models/efficientnet.py``).

Compute dtype (the JAX package's mixed precision): the trunk's
``compute_dtype`` (float32 or bfloat16) also runs ``dense_0``, ``dense_1``
and ``dense_2``, which take the trunk's output dtype; the 192-d embedding is
cast to float32 before the selu, and the classifier and the whole transfer
head compute in float32, so logits, softmax rows and every parameter stay
float32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .efficientnet import EfficientNet
from .wav2vec2 import Wav2Vec2Trunk
from .wav2vec2_conformer import Wav2Vec2ConformerTrunk

EMBEDDING_DIM = 192


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in x's dtype (its float32 parameters cast at the use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class EmbeddingHead(nn.Module):
    """GAP -> 1024 relu -> 1024 relu -> 192 selu (the embedding, float32);
    the three dense layers compute in the feature map's dtype. The mean is
    over ``pool_dims``: H and W of an NCHW map, or the frames of a (B, T, C)
    sequence."""

    def __init__(self, in_features: int, pool_dims=(-2, -1)):
        super().__init__()
        self.pool_dims = tuple(pool_dims)
        self.dense_0 = nn.Linear(in_features, 1024)
        self.dense_1 = nn.Linear(1024, 1024)
        self.dense_2 = nn.Linear(1024, EMBEDDING_DIM)

    def forward(self, feature_map):
        x = feature_map.mean(dim=self.pool_dims)  # GlobalAveragePooling
        x = F.relu(_dense(self.dense_0, x))
        x = F.relu(_dense(self.dense_1, x))
        return F.selu(_dense(self.dense_2, x).float())


class TransferHead(nn.Module):
    """Dense 18 tanh -> Dense num_categories softmax."""

    def __init__(self, num_categories: int = 3):
        super().__init__()
        self.hidden = nn.Linear(EMBEDDING_DIM, 18)
        self.out = nn.Linear(18, num_categories)

    def forward(self, embedding):
        return torch.softmax(self.out(torch.tanh(self.hidden(embedding))), dim=-1)


class KWSEmbeddingModel(nn.Module):
    """Trunk + embedding head + classifier logits (the pretraining model).

    ``trunk``: an ``EfficientNet``, which takes (B, 49, 40, 1) features, or
    a ``Wav2Vec2Trunk`` or ``Wav2Vec2ConformerTrunk``, which take (B,
    samples) normalized waveforms (``trunk.takes_waveform``); the head pools
    over ``trunk.pool_dims``."""

    def __init__(self, num_labels: int, trunk: Union[EfficientNet, Wav2Vec2Trunk, Wav2Vec2ConformerTrunk]):
        super().__init__()
        self.trunk = trunk
        self.embedding_head = EmbeddingHead(trunk.out_channels, trunk.pool_dims)
        self.classifier = nn.Linear(EMBEDDING_DIM, num_labels)

    def embed(self, x, drop_generator=None):
        """The trunk's input ((B, 49, 40, 1) features, or (B, samples)
        waveforms) -> the 192-d embedding."""
        return self.embedding_head(self.trunk(x, drop_generator))

    def forward(self, x, return_embedding: bool = False, drop_generator=None):
        emb = self.embed(x, drop_generator)
        logits = self.classifier(emb)
        return (logits, emb) if return_embedding else logits


class KWSTransferModel(nn.Module):
    """Embedding trunk + few-shot head: (B, 49, 40, 1) -> (B, 3) softmax.
    The trunk must take features: the fine-tune, scan and realtime paths
    feed it feature windows, and pool over an NCHW map's H and W."""

    def __init__(self, trunk: EfficientNet, num_categories: int = 3):
        super().__init__()
        if trunk.takes_waveform:
            raise ValueError(
                f"a transfer model needs a trunk that takes (B, 49, 40, 1) features, and {type(trunk).__name__} "
                "takes waveforms, as both wav2vec 2.0 trunks (Wav2Vec2Trunk, Wav2Vec2ConformerTrunk) do: the "
                "fine-tune, scan and realtime paths feed features"
            )
        self.trunk = trunk
        self.embedding_head = EmbeddingHead(trunk.out_channels)
        self.transfer_head = TransferHead(num_categories)

    def embed(self, x, drop_generator=None):
        return self.embedding_head(self.trunk(x, drop_generator))

    def forward(self, x, drop_generator=None):
        return self.transfer_head(self.embed(x, drop_generator))


def make_transfer_model(num_categories: int = 3, device="cuda", **trunk_kw) -> KWSTransferModel:
    """Full-width EfficientNetB0 transfer model on ``device``, in eval mode,
    with PyTorch's default initialization (see ``seeded_init_``);
    ``trunk_kw`` go to the trunk (e.g. ``compute_dtype="bfloat16"``, or
    ``width_coefficient`` and ``depth_coefficient`` for a narrower one)."""
    dev = resolve_device(device)
    return KWSTransferModel(EfficientNet(**trunk_kw), num_categories).to(dev).eval()


def make_embedding_model(num_labels: int, device="cuda", trunk: Optional[nn.Module] = None,
                         **trunk_kw) -> KWSEmbeddingModel:
    """An embedding model (``num_labels`` logits) on ``device``, in eval
    mode. Without ``trunk``: the full-width EfficientNetB0, which takes
    (B, 49, 40, 1) features, with PyTorch's default initialization
    (pretraining starts from ``lecun_init_``, Flax's); ``trunk_kw`` go to
    it, as for ``make_transfer_model``. ``trunk``: a built trunk, such as
    ``models.wav2vec2.Wav2Vec2Trunk()`` (XLS-R 300M) or
    ``models.wav2vec2_conformer.Wav2Vec2ConformerTrunk()`` (the rel-pos
    Conformer), which take (B, samples) normalized 16 kHz waveforms
    (``models.wav2vec2.wav2vec2_init_`` draws ``transformers``'
    initialization of either); ``trunk_kw`` must then be empty."""
    dev = resolve_device(device)
    if trunk is not None and trunk_kw:
        raise ValueError(f"a built trunk takes no trunk arguments: {sorted(trunk_kw)}")
    return KWSEmbeddingModel(num_labels, trunk if trunk is not None else EfficientNet(**trunk_kw)).to(dev).eval()


def transfer_params_from_embedding(embedding_state, transfer_state):
    """A transfer model's ``state_dict`` with the trunk and embedding head
    (parameters and BN statistics) of a pretrained embedding model's: the
    reference's load-and-truncate at "dense_2" (transfer_learning.py:36-43),
    by key prefix. Returns a new dict; neither input changes."""
    new = dict(transfer_state)
    for k, v in embedding_state.items():
        if k.split(".")[0] in ("trunk", "embedding_head"):
            if k not in new:
                raise KeyError(f"{k} of the embedding model is not in the transfer model")
            new[k] = v
    return new


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic from one seeded CPU generator
    (He-normal weights, small biases, BN stats near identity), so a model
    with random weights is the same on every device and run."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, std, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(draw(w.shape, (2.0 / fan_in) ** 0.5))
            if mod.bias is not None:
                mod.bias.copy_(draw(mod.bias.shape, 0.01))
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.copy_(draw(mod.weight.shape, 0.05, 1.0))
            mod.bias.copy_(draw(mod.bias.shape, 0.05))
            mod.running_mean.copy_(draw(mod.running_mean.shape, 0.05))
            mod.running_var.copy_(draw(mod.running_var.shape, 0.05, 1.0).abs())
    return model


@torch.no_grad()
def lecun_init_(model: nn.Module, seed: int) -> nn.Module:
    """Flax's default initialization, from one seeded CPU generator:
    LeCun-normal kernels (normal truncated at two standard deviations,
    variance 1/fan_in), zero biases, identity BatchNorm (scale 1, bias 0,
    statistics mean 0, var 1). The fine-tune's fresh trunk starts here, as
    the JAX package's ``model.init`` does (with other random bits)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2 * std, 2 * std, generator=gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model
