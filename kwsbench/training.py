"""What the training cells' checks share: a recorder of the program's own
state at each epoch's start, the program's and the reference's features of
a recorded epoch's steps, and the measure of a gap between two sets of
leaves.

The reference cannot replay the program's generators without their states,
so the harness keeps, while the program trains, what its objects hold at
each epoch's start (the epoch's uploaded rows, labels and silence flags, the
generators' states and the trained parameters) and what each epoch returns
(its steps' losses), and, after the first step, which runs eagerly, the
parameters and the optimizer's state, from which the first gradient as the
optimizer got it follows. It changes nothing the program computes.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from kwsbench.reference import augment as ref_augment
from kwsbench.reference import frontend as ref_frontend
from kwsbench.traffic.audio import SR


class Recorder:
    def __init__(self, model):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.epochs: List[Dict] = []
        self.g1: Dict[str, torch.Tensor] = {}
        # by parameter name: "param", "exp_avg", "exp_avg_sq", "step" after
        # the first step
        self.after1: Dict[str, Dict[str, torch.Tensor]] = {}
        self.dataset = self.bank = self.optimizer = None
        self._hook = None

    def watch(self, optimizer, dataset, bank) -> None:
        """Keep the data set and bank the epochs read, and the parameters
        and the optimizer's state after its first step."""
        self.dataset, self.bank, self.optimizer = dataset, bank, optimizer
        if self._hook is None:
            self._hook = optimizer.register_step_post_hook(self._after_step)

    def epoch(self, run: Callable, drop: Optional[torch.Generator] = None) -> "RecordedEpoch":
        """``run`` (an epoch of the program), keeping its inputs and the
        generators' states before it runs."""
        return RecordedEpoch(self, run, drop)

    @contextlib.contextmanager
    def patch(self, module, name: str, wrap: Callable):
        """``module.name`` replaced by ``wrap(original)`` inside the block."""
        original = getattr(module, name)
        setattr(module, name, wrap(original))
        try:
            yield self
        finally:
            setattr(module, name, original)
            if self._hook is not None:
                self._hook.remove()
                self._hook = None

    def _after_step(self, optimizer, args, kwargs):
        # the first step only, and never while a CUDA graph captures one
        if self.g1 or (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            return
        for group in optimizer.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                name, state = self.names[id(p)], optimizer.state[p]
                self.g1[name] = state["exp_avg"].detach().clone() / (1 - b1)
                self.after1[name] = {"param": p.detach().clone(), "step": state["step"].detach().clone(),
                                     **{k: state[k].detach().clone() for k in ("exp_avg", "exp_avg_sq")}}

    def release(self) -> None:
        self.dataset = self.bank = self.optimizer = None


class RecordedEpoch:
    """An epoch of the program that records, before it runs, its inputs,
    the generators' states and the trained parameters, and after it, what
    it returned (``out``: the steps' losses and accuracies); its attributes
    are the epoch's."""

    def __init__(self, rec: Recorder, run: Callable, drop: Optional[torch.Generator]):
        self._rec, self._run, self._drop = rec, run, drop

    def __call__(self, *inputs):
        rec = self._rec
        rec.epochs.append({"t": time.perf_counter(), "inputs": [t.clone() for t in inputs],
                           "gen": rec.dataset.gen.get_state(),
                           "drop": self._drop.get_state() if self._drop is not None else None,
                           "params": {rec.names[id(p)]: p.detach().clone()
                                      for g in rec.optimizer.param_groups for p in g["params"]}})
        out = self._run(*inputs)
        rec.epochs[-1]["out"] = out
        return out

    def __getattr__(self, name):
        return getattr(self._run, name)


def program_specs(rec: Recorder, ep: Dict, steps: int, device) -> List[np.ndarray]:
    """The program's features of an epoch's first ``steps`` steps: its
    resident transform (``AudioDataset.resident_specs``: the augment kernel
    B4 and the features kernel B1) on each step's rows, the data set's
    generator set to the epoch's starting state and moving on as the epoch's
    steps move it."""
    rec.dataset.gen.set_state(ep["gen"])
    out = []
    for j in range(steps):
        rows, sil = (ep["inputs"][i][j].to(device) for i in (0, 2))
        out.append(rec.dataset.resident_specs(rec.bank, rows, sil).cpu().numpy())
    return out


def reference_specs(ep: Dict, steps: int, bank_clips: Sequence[np.ndarray], background: Sequence[np.ndarray],
                    device) -> List[np.ndarray]:
    """The reference's features of an epoch's first ``steps`` steps: the
    augmentation and SpecAugment drawn in the program's order from a
    generator in the data set's state at the epoch's start, the reference's
    augment and exact frontend."""
    gen = torch.Generator(device=device)
    gen.set_state(ep["gen"])
    sizes = torch.tensor([b.shape[0] for b in background], device=device)
    out = []
    for j in range(steps):
        idx = ep["inputs"][0][j].cpu().numpy()
        sil = ep["inputs"][2][j].cpu().numpy()
        draws = ref_augment.draw_augment(gen, idx.shape[0], SR, sizes)
        wav = ref_augment.augment_int16(np.stack([bank_clips[r] for r in idx]), sil, background, draws)
        feats = ref_frontend.clip_features(wav)
        masks = ref_augment.draw_spec(gen, idx.shape[0], feats.shape[1], feats.shape[2])
        out.append(ref_augment.apply_spec(feats, masks)[..., None].astype(np.float32))
    return out


def mismatch_share(prog: Sequence[np.ndarray], ref: Sequence[np.ndarray]) -> float:
    """The share of feature values that differ."""
    if len(prog) != len(ref) or any(a.shape != b.shape for a, b in zip(prog, ref)):
        return float("inf")
    return float(np.mean([np.mean(a != b) for a, b in zip(prog, ref)]))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of norm(ref) and
    the median leaf's norm."""
    rn = {k: float(ref[k].norm()) for k in keys}
    pn = {k: float(prog[k].float().norm()) for k in keys}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}


def moving_leaves(ref_g1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move by round-off alone."""
    norms = {k: float(v.norm()) for k, v in ref_g1.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def step_gaps(prog_losses, ref_losses, prog_g1, ref_g1, prog_change, ref_change) -> Dict[str, float]:
    """loss_gap (largest relative gap of the steps' losses), grad_gap (the
    worst leaf of the first gradient), update_gap (the median moving leaf
    of the parameters' change) and update_gap_worst_leaf (its worst)."""
    keys = list(ref_g1)
    if len(prog_losses) != len(ref_losses) or not prog_g1:
        return dict.fromkeys(("loss_gap", "grad_gap", "update_gap", "update_gap_worst_leaf"), float("inf"))
    update = leaf_gaps(prog_change, ref_change, moving_leaves(ref_g1))
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses)),
            "grad_gap": max(leaf_gaps(prog_g1, ref_g1, keys).values()),
            "update_gap": statistics.median(update.values()),
            "update_gap_worst_leaf": max(update.values())}


def compared(limits: Dict, readings: Dict[str, float], verdict) -> Dict:
    """The readings the cell's limits name, each beside its limit; the
    others are printed as information."""
    import json
    import sys

    others = {k: v for k, v in readings.items() if k not in limits}
    if others:
        print("info " + json.dumps(others), file=sys.stderr)
    return {k: verdict(v, limits[k], exact=limits[k] == 0) for k, v in readings.items() if k in limits}
