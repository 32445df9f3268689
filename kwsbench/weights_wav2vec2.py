"""The XLS-R cell's weights, drawn from ``--seed`` on the run's device, and
the program's model built from them.

One dict of tensors (keys as ``reference.wav2vec2.spec`` and the program's
``state_dict`` name them) is handed to both sides: the program's model
loads a copy (``load_state_dict(strict=True)``), the reference reads the
dict itself.

The trunk's draw is ``transformers``' ``Wav2Vec2PreTrainedModel._init_weights``:
dense layers N(0, 0.02) with zero bias; LayerNorm identity; the feature
projection U(+-1/sqrt(fan_in)), bias too; the feature encoder's convolutions
Kaiming-normal (std sqrt(2 / fan_in)), bias U(+-sqrt(groups / (cin x
kernel))); the positional convolution's weight N(0, 2 / sqrt(kernel x
channels)) with zero bias, held under weight norm as ``v`` = the draw and
``g`` = its norm over dims 0 and 1, so the weight is the draw. The
embedding head and the classifier take Flax's initialization, as the B0
configurations' do (``reference.model.lecun_state``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from kwsbench.reference import wav2vec2 as ref
from kwsbench.reference.model import lecun_state
from kwsbench.weights import generator
# the program's trunk, imported with the driver: a checkout without it stops
# when the cell is resolved, before set-up
from multilingual_kws_tpu_torch.models.kws_model import make_embedding_model
from multilingual_kws_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk

HEAD = ("embedding_head.", "classifier.")


@torch.no_grad()
def xlsr_state(config: Dict, seed: int, device: str) -> Dict[str, torch.Tensor]:
    """The embedding model's weights, drawn from the seed."""
    keys = ref.spec(config, int(config["num_labels"]))
    d = ref.dims(config)
    gen = generator(seed, device, 3)
    out = lecun_state({k: s for k, s in keys.items() if k.startswith(HEAD)}, generator(seed, device, 4), device)
    pos = "trunk.encoder.pos_conv_embed.conv."
    for k, shape in keys.items():
        if k.startswith(HEAD) or k.startswith(pos + "parametrizations"):
            continue
        t = torch.empty(shape, device=device)
        if ".layer_norm." in k or ".final_layer_norm." in k:
            t.fill_(1.0 if k.endswith(".weight") else 0.0)
        elif k.startswith("trunk.feature_projection.projection."):
            bound = 1.0 / math.sqrt(d["conv_dim"][-1])
            t.uniform_(-bound, bound, generator=gen)
        elif k.startswith("trunk.feature_extractor."):
            w = keys[k.rsplit(".", 1)[0] + ".weight"]
            if k.endswith(".weight"):
                t.normal_(0.0, math.sqrt(2.0 / (w[1] * w[2])), generator=gen)
            else:
                bound = math.sqrt(1.0 / (w[1] * w[2]))
                t.uniform_(-bound, bound, generator=gen)
        elif k.endswith(".weight"):
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.zero_()
        out[k] = t
    kernel, h = d["num_conv_pos_embeddings"], d["hidden_size"]
    v = torch.empty(keys[pos + "parametrizations.weight.original1"], device=device)
    v.normal_(0.0, 2.0 * math.sqrt(1.0 / (kernel * h)), generator=gen)
    out[pos + "parametrizations.weight.original1"] = v
    out[pos + "parametrizations.weight.original0"] = v.norm(dim=(0, 1), keepdim=True)
    return {k: out[k] for k in keys}


def program_model(config: Dict, state: Dict[str, torch.Tensor], device: str):
    """The program's XLS-R embedding model of the configuration, built on
    ``device``, holding a copy of ``state``, in eval mode."""
    with torch.device(device):
        trunk = Wav2Vec2Trunk(Wav2Vec2Config.from_dict(ref.dims(config)), compute_dtype=config["compute_dtype"])
    model = make_embedding_model(int(config["num_labels"]), device=device, trunk=trunk)
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
    return model.eval()
