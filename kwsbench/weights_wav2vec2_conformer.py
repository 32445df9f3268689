"""The Conformer cell's weights, drawn from ``--seed`` on the run's device,
and the program's model built from them.

One dict of tensors (keys as ``reference.wav2vec2_conformer.spec`` and the
program's ``state_dict`` name them, BN statistics included) is handed to
both sides: the program's model loads a copy
(``load_state_dict(strict=True)``), the reference reads the dict itself.

The trunk's draw is ``transformers``' ``Wav2Vec2ConformerPreTrainedModel._init_weights``:
dense layers N(0, 0.02) with zero bias (``linear_pos`` has none); LayerNorm
identity; the feature projection U(+-1/sqrt(fan_in)), bias too; every
convolution Kaiming-normal (std sqrt(2 / fan_in): the feature encoder's,
the pointwise ones' (fan_in = channels) and the depthwise one's (fan_in =
kernel)), the feature encoder's biases U(+-sqrt(groups / (cin x kernel)));
``pos_bias_u`` and ``pos_bias_v`` Xavier-uniform; BatchNorm at torch's
default (scale 1, shift 0, statistics 0 and 1, no batches tracked). The
embedding head and the classifier take Flax's initialization, as the other
configurations' do (``reference.model.lecun_state``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from kwsbench.reference import wav2vec2_conformer as ref
from kwsbench.reference.model import lecun_state
from kwsbench.weights import generator
# the program's trunk, imported with the driver: a checkout without it stops
# when the cell is resolved, before set-up
from multilingual_kws_tpu_torch.models.kws_model import make_embedding_model
from multilingual_kws_tpu_torch.models.wav2vec2_conformer import Wav2Vec2ConformerConfig, Wav2Vec2ConformerTrunk

HEAD = ("embedding_head.", "classifier.")
NORMS = (".layer_norm.", "_layer_norm.", ".batch_norm.")


@torch.no_grad()
def conformer_state(config: Dict, seed: int, device: str) -> Dict[str, torch.Tensor]:
    """The embedding model's weights and BN statistics, drawn from the seed."""
    keys = ref.spec(config, int(config["num_labels"]))
    d = ref.dims(config)
    gen = generator(seed, device, 5)
    out = lecun_state({k: s for k, s in keys.items() if k.startswith(HEAD)}, generator(seed, device, 6), device)
    for k, shape in keys.items():
        if k.startswith(HEAD):
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        t = torch.empty(shape, device=device)
        if k.endswith((".running_mean",)):
            t.zero_()
        elif k.endswith(".running_var"):
            t.fill_(1.0)
        elif any(n in k for n in NORMS):
            t.fill_(1.0 if k.endswith(".weight") else 0.0)
        elif k.startswith("trunk.feature_projection.projection."):
            bound = 1.0 / math.sqrt(d["conv_dim"][-1])
            t.uniform_(-bound, bound, generator=gen)
        elif k.endswith((".pos_bias_u", ".pos_bias_v")):
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            t.uniform_(-bound, bound, generator=gen)
        elif len(shape) == 3:  # a convolution's weight
            t.normal_(0.0, math.sqrt(2.0 / (shape[1] * shape[2])), generator=gen)
        elif k.startswith("trunk.feature_extractor."):  # a convolution's bias
            w = keys[k.rsplit(".", 1)[0] + ".weight"]
            bound = math.sqrt(1.0 / (w[1] * w[2]))
            t.uniform_(-bound, bound, generator=gen)
        elif k.endswith(".weight"):
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.zero_()
        out[k] = t
    return {k: out[k] for k in keys}


def program_model(config: Dict, state: Dict[str, torch.Tensor], device: str):
    """The program's Conformer embedding model of the configuration, built on
    ``device``, holding a copy of ``state``, in eval mode."""
    with torch.device(device):
        trunk = Wav2Vec2ConformerTrunk(Wav2Vec2ConformerConfig.from_dict(config),
                                       compute_dtype=config["compute_dtype"])
    model = make_embedding_model(int(config["num_labels"]), device=device, trunk=trunk)
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
    return model.eval()
