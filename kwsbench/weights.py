"""The cells' weights, drawn from ``--seed`` on the run's device, and the
program's models built from them.

One dict of tensors (keys as ``reference.model.spec`` and the program's
``state_dict`` name them) is handed to both sides: the program's model
loads a copy (``load_state_dict(strict=True)``, so the two key sets and
shapes must agree), the reference reads the dict itself.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kwsbench.reference import frontend as ref_frontend
from kwsbench.reference.model import Model, calibrate, lecun_state, spec


def generator(seed: int, device: str, salt: int) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed and a salt, so
    that each use draws a stream of its own."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2**63))
    return g


def dims(config: Dict) -> Tuple[float, float]:
    return float(config["width_coefficient"]), float(config["depth_coefficient"])


def transfer_state(config: Dict, seed: int, device: str, calib_int16: np.ndarray,
                   target_median: float = 0.5) -> Dict[str, torch.Tensor]:
    """The few-shot model's weights: Flax's initialization from the seed,
    then, by the reference, BN statistics calibrated on the clips
    ``calib_int16`` (so that every layer works at unit scale) and the target
    logit's bias raised so that the target's softmax on those clips has the
    median ``target_median`` (so that the detector has work at the cell's
    thresholds)."""
    width, depth = dims(config)
    state = lecun_state(spec("transfer", width=width, depth=depth), generator(seed, device, 1), device)
    ref = Model(state, "transfer", width, depth)
    feats = torch.from_numpy(ref_frontend.clip_features(calib_int16)).to(device)[..., None]
    with torch.no_grad():
        calibrate(ref, feats.split(int(config["calibration_batch"])))
        e = ref.embed(feats)
        z = ref.dense("transfer_head.out", torch.tanh(ref.dense("transfer_head.hidden", e)))
        margin = torch.logsumexp(z[:, :2], dim=-1) - z[:, 2]
        state["transfer_head.out.bias"][2] += margin.median() + float(np.log(target_median / (1 - target_median)))
    return state


def embedding_state(config: Dict, seed: int, device: str) -> Dict[str, torch.Tensor]:
    """The embedding model's weights: Flax's initialization from the seed."""
    width, depth = dims(config)
    return lecun_state(spec("classifier", int(config["num_labels"]), width, depth), generator(seed, device, 2), device)


def program_model(config: Dict, state: Dict[str, torch.Tensor], device: str, compute_dtype: str = None):
    """The program's model of the configuration, holding a copy of
    ``state``, in eval mode."""
    from multilingual_kws_tpu_torch.models.kws_model import make_embedding_model, make_transfer_model

    width, depth = dims(config)
    kw = dict(device=device, width_coefficient=width, depth_coefficient=depth,
              compute_dtype=compute_dtype or config["compute_dtype"],
              drop_connect_rate=float(config["drop_connect_rate"]))
    if config["top"] == "classifier":
        model = make_embedding_model(int(config["num_labels"]), **kw)
    else:
        model = make_transfer_model(int(config["num_categories"]), **kw)
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
    return model.eval()


def clips_of(stream_int16: np.ndarray, count: int, seed: int, samples: int = 16000) -> np.ndarray:
    """``count`` one-second windows of the stream at seeded offsets."""
    rng = np.random.default_rng([int(seed), 7])
    starts = rng.integers(0, stream_int16.shape[0] - samples, count)
    return np.stack([stream_int16[s : s + samples] for s in starts])
