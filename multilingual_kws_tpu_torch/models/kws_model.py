"""KWS models: embedding classifier and few-shot transfer head.

Counterpart of ``multilingual_kws_tpu/models/kws_model.py``:

- ``KWSEmbeddingModel``: EfficientNetB0 trunk (49x40x1 input) ->
  GlobalAveragePooling -> Dense 1024 relu -> Dense 1024 relu -> Dense 192
  selu (the embedding, reference layer "dense_2") -> Dense num_labels logits;
- ``KWSTransferModel``: the same trunk and embedding head -> Dense 18 tanh
  -> Dense 3 softmax.

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

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .efficientnet import EfficientNet

EMBEDDING_DIM = 192


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in x's dtype (its float32 parameters cast at the use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class EmbeddingHead(nn.Module):
    """GAP -> 1024 relu -> 1024 relu -> 192 selu (the embedding, float32);
    the three dense layers compute in the feature map's dtype."""

    def __init__(self, in_features: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, 1024)
        self.dense_1 = nn.Linear(1024, 1024)
        self.dense_2 = nn.Linear(1024, EMBEDDING_DIM)

    def forward(self, feature_map):
        x = feature_map.mean(dim=(-2, -1))  # GlobalAveragePooling2D (NCHW)
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
    """Trunk + embedding head + classifier logits (the pretraining model)."""

    def __init__(self, num_labels: int, trunk: EfficientNet):
        super().__init__()
        self.trunk = trunk
        self.embedding_head = EmbeddingHead(trunk.out_channels)
        self.classifier = nn.Linear(EMBEDDING_DIM, num_labels)

    def embed(self, x, drop_generator=None):
        """(B, 49, 40, 1) -> the 192-d embedding."""
        return self.embedding_head(self.trunk(x, drop_generator))

    def forward(self, x, return_embedding: bool = False, drop_generator=None):
        emb = self.embed(x, drop_generator)
        logits = self.classifier(emb)
        return (logits, emb) if return_embedding else logits


class KWSTransferModel(nn.Module):
    """Embedding trunk + few-shot head: (B, 49, 40, 1) -> (B, 3) softmax."""

    def __init__(self, trunk: EfficientNet, num_categories: int = 3):
        super().__init__()
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


def make_embedding_model(num_labels: int, device="cuda", **trunk_kw) -> KWSEmbeddingModel:
    """Full-width EfficientNetB0 embedding model (``num_labels`` logits) on
    ``device``, in eval mode, with PyTorch's default initialization
    (pretraining starts from ``lecun_init_``, Flax's); ``trunk_kw`` go to
    the trunk, as for ``make_transfer_model``."""
    dev = resolve_device(device)
    return KWSEmbeddingModel(num_labels, EfficientNet(**trunk_kw)).to(dev).eval()


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
