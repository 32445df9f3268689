"""Embedding pretraining: ``train/pretrain.pretrain`` on a seeded corpus of
tone-sequence words, resident data and graphed epochs (the defaults).

Set-up writes the corpus under the run's scratch directory (``words``
words of ``clips`` clips, the last of each to validate, and background
noise), draws the embedding model's initialization from the seed, builds
the program's model and warms it with one short ``pretrain()`` call (one
epoch of ``check_steps`` steps: an eager step, the epoch graph's capture,
replays, BN calibration, validation); then the model is set back to its
initialization.

The window is one ``pretrain()`` call on that model of ``steps_per_epoch``
steps an epoch and as many epochs as ``expected_clips_per_s`` says fill
``--seconds``: a fixed amount of work. ``pretrain_clips_per_s`` is the
clips stepped over the call's wall, its start-up, BN calibration and
validation included. A traced run traces a call of ``traced_epochs``.
While the call runs the harness keeps what the program's objects hold at
each epoch's start (the epoch's uploaded rows, labels and silence flags,
the data set's and drop-connect's generator states), the losses each epoch
returns, and the parameters and the optimizer's state after the first step
(``training.Recorder``); it changes nothing the program computes.

The check compares the window's own call: the first ``check_steps`` steps
of its first epoch, of which the first runs eagerly and the others are
replays of the epoch's CUDA graph. The reference cannot replay the
program's generators without their states, and it cannot repeat the
augment kernel's order of summation: a feature value in some ten thousand
moves by one step of the integer log where a sample of the augmented clip
rounds the other way, and a step of the untrained model moves a gradient
leaf's norm by up to a few hundredths for such a change. So the steps start
from the program's features of each step, and the features are held to
the reference's by themselves:

- ``host_draw_mismatch``: the first step's rows, labels and silence flags
  against the reference's draw from the seed (==);
- ``spec_mismatch_share``: the program's resident transform (the augment
  kernel B4 and the features kernel B1, as each step runs them) on each
  step's rows and generator state against the reference's augment and
  frontend on the same draws: the share of feature values that differ;
- ``loss_gap``: the first step's loss against the reference's step from
  the same initialization with the same drop-connect draws (relative gap);
- ``grad_gap``: the first step's gradient as the optimizer got it
  (Adam's first moment after one step over 1 - b1) against the
  reference's, leaf by leaf: the gap between the two norms over the larger
  of the reference leaf's norm and the median leaf's (the worst leaf);
- ``update_gap``: the same measure of each parameter's change over the
  first step, leaving out the leaves whose reference gradient is below a
  thousandth of the median leaf's (they move by round-off alone);
- ``replay_loss_gap``: the replayed steps' losses (steps 2 to
  ``check_steps``) against the reference's, which follows them from the
  program's parameters and Adam state after the first step (largest
  relative gap): step 2's loss reads the replay's rows, features and
  forward, step 3's also Adam's second update (its moments and bias
  correction).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from kwsbench import training
from kwsbench.checks import verdict
from kwsbench.counts import frontend as fcounts
from kwsbench.counts import model as mcounts
from kwsbench.reference import augment as ref_augment
from kwsbench.reference import train as ref_train
from kwsbench.reference.model import Model, exact, tf32
from kwsbench.traffic import audio
from kwsbench.weights import dims, embedding_state, program_model


def pretrain_config(cell, epochs: int, steps: int):
    from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig

    c = cell.config
    return PretrainConfig(num_labels=int(c["num_labels"]), batch_size=int(c["batch_size"]), num_epochs=epochs,
                          learning_rate=float(c["learning_rate"]), silence_percentage=float(c["silence_percentage"]),
                          unknown_percentage=float(c["unknown_percentage"]), shuffle_seed=cell.seed % (2**31),
                          steps_per_epoch=steps, resident_data=True, scan_epoch=True,
                          compute_dtype=c["compute_dtype"], device=cell.device)


def run_pretrain(cell, st, config):
    from multilingual_kws_tpu_torch.train.pretrain import pretrain

    corpus = st["corpus"]
    return pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"], config=config,
                    model=st["model"], verbose=0)


def recorded_call(cell, st, epochs: int, steps: int) -> training.Recorder:
    """One ``pretrain()`` call on the cell's model, recorded."""
    import multilingual_kws_tpu_torch.train.pretrain as program

    rec = training.Recorder(st["model"])

    def wrap(build):
        def recording_build(model, optimizer, group, dataset, bank, drop, device="cuda"):
            rec.watch(optimizer, dataset, bank)
            return rec.epoch(build(model, optimizer, group, dataset, bank, drop, device=device), drop)

        return recording_build

    with rec.patch(program, "build_fused_resident_epoch", wrap):
        run_pretrain(cell, st, pretrain_config(cell, epochs, steps))
    return rec


def setup(cell) -> Dict:
    t = cell.traffic
    corpus = audio.words_corpus(cell.workdir / "corpus", cell.seed, int(t["words"]), int(t["clips"]))
    state = embedding_state(cell.config, cell.seed, cell.device)
    model = program_model(cell.config, state, cell.device)
    st = {"corpus": corpus, "state": state, "model": model}
    # the warm call; its record serves the control's readings
    st["rec"] = recorded_call(cell, st, 1, int(t["check_steps"]))
    model.load_state_dict(state, strict=True)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    return st


def window(cell, st) -> Dict:
    t = cell.traffic
    steps = int(t["steps_per_epoch"])
    batch = int(cell.config["batch_size"])
    if cell.trace:
        epochs = int(t["traced_epochs"])
    else:
        epochs = max(1, round(cell.seconds * float(t["expected_clips_per_s"]) / (steps * batch)))
    cell.tracer.start()
    t0 = time.perf_counter()
    with cell.spans.span("pretrain"):
        st["rec"] = recorded_call(cell, st, epochs, steps)
    if cell.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cell.tracer.stop()
    width, depth = dims(cell.config)
    # steps: the call's; traced_steps: its first epoch's, which the step's
    # readers bound by the augment kernel's launches
    cell.counts.update(steps=epochs * steps, traced_steps=steps, batch=batch,
                       transform_least_s=fcounts.augment_quantize_s(batch) + fcounts.clip_features_s(batch),
                       train_flops=mcounts.train_flops("classifier", int(cell.config["num_labels"]), width, depth))
    # the epochs' starts on the host clock, from the call's start: the
    # window's rate over fewer epochs, for the look at the spread
    marks = [round(e["t"] - t0, 4) for e in st["rec"].epochs]
    return {"attempted": epochs * steps, "failed": 0, "metrics": {"pretrain_clips_per_s": epochs * steps * batch / wall},
            "work": {"epochs": epochs, "epoch_starts_s": marks, "wall_s": wall}}


class NoFirstMoment(ref_train.Adam):
    """A fault: Adam with b1 = 0 (no first-moment history)."""

    b1 = 0.0


class StaleStep(ref_train.Adam):
    """A fault: Adam whose step count stays at 1 (the first step's bias
    correction at every step)."""

    def step(self, p, g):
        self.t = 0
        super().step(p, g)


def reference_run(cell, st, specs: List[np.ndarray], rows=slice(None), precision=exact, adam=ref_train.Adam):
    """The reference's steps on each step's ``specs``: the first from the
    initialization, the next ones from the program's parameters and Adam
    state after its first step. (losses, first gradients, the parameters'
    change over the first step)."""
    width, depth = dims(cell.config)
    rec = st["rec"]
    ep = rec.epochs[0]
    p = {k: v.clone() for k, v in st["state"].items()}
    ref = Model(p, "classifier", width, depth)
    opt = adam(ref_train.parameter_keys(p), float(cell.config["learning_rate"]))
    drop = torch.Generator(device=cell.device)
    drop.set_state(ep["drop"])
    labels = [y.to(cell.device) for y in ep["inputs"][1][: len(specs)]]
    with precision():
        loss, g1 = ref_train.step(ref, p, opt, torch.from_numpy(specs[0]).to(cell.device), labels[0], drop, rows)
        losses = [loss]
        change = {k: p[k] - st["state"][k] for k in opt.keys}
        for k in opt.keys:
            after = rec.after1[k]
            p[k].copy_(after["param"])
            opt.m[k], opt.v[k] = after["exp_avg"].clone(), after["exp_avg_sq"].clone()
        opt.t = int(next(iter(rec.after1.values()))["step"])
        for x, y in zip(specs[1:], labels[1:]):
            losses.append(ref_train.step(ref, p, opt, torch.from_numpy(x).to(cell.device), y, drop, rows)[0])
    return losses, g1, change


def program_side(st, steps: int):
    """The program's (losses of the first ``steps`` steps, first gradient,
    the parameters' change over the first step)."""
    rec = st["rec"]
    return ([float(x) for x in rec.epochs[0]["out"][0][:steps].cpu()], rec.g1,
            {k: a["param"] - st["state"][k] for k, a in rec.after1.items()})


def gaps(prog, ref) -> Dict[str, float]:
    """The compared numbers of the steps: the first step's loss, gradient
    and parameter change, and the replayed steps' losses."""
    out = training.step_gaps(prog[0][:1], ref[0][:1], prog[1], ref[1], prog[2], ref[2])
    later = [abs(a - b) / abs(b) for a, b in zip(prog[0][1:], ref[0][1:])]
    out["replay_loss_gap"] = max(later) if len(later) == len(ref[0]) - 1 == len(prog[0]) - 1 else float("inf")
    out["replay_loss_gap_by_step"] = later
    return out


def check(cell, st, out) -> Dict:
    limits = cell.workload["limits"]
    steps = int(cell.traffic["check_steps"])
    rec, corpus = st["rec"], st["corpus"]
    first = rec.epochs[0]
    # the stage the step-by-step reference skips: the first host draw
    label_ids = np.array([corpus["words"].index(f.split("/")[-2]) + 1 for f in corpus["train"]])
    want = ref_augment.host_draw(cell.seed % (2**31), len(corpus["train"]), int(cell.config["batch_size"]),
                                 label_ids, 0, float(cell.config["silence_percentage"]))
    draw_mismatch = sum(int((t[0].cpu().numpy() != w).sum()) for t, w in zip(first["inputs"], want))
    # the transform by itself, at the epoch's generator state
    prog_specs = training.program_specs(rec, first, steps, cell.device)
    bank_clips = [corpus["audio"][f] for f in corpus["train"]]
    ref_specs = training.reference_specs(first, steps, bank_clips, corpus["background"], cell.device)
    prog = program_side(st, steps)
    st.pop("model")
    rec.release()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    own = gaps(prog, reference_run(cell, st, ref_specs))
    print("info the steps' gaps on the reference's own features: " + json.dumps(own), file=sys.stderr)
    return training.compared(limits, {
        "host_draw_mismatch": draw_mismatch,
        "spec_mismatch_share": training.mismatch_share(prog_specs, ref_specs),
        **gaps(prog, reference_run(cell, st, prog_specs)),
    }, verdict)


def _specs(cell, st):
    return training.program_specs(st["rec"], st["rec"].epochs[0], int(cell.traffic["check_steps"]), cell.device)


def fault_readings(cell, st) -> Dict[str, Dict[str, float]]:
    """The compared numbers of each fault planted in the reference put in
    the program's place, read against the sound reference: the loss taken
    over half of the batch (the mean over the rest), Adam without its first
    moment (b1 = 0), Adam's step count left at 1."""
    specs = _specs(cell, st)
    sound = reference_run(cell, st, specs)
    half = slice(0, int(cell.config["batch_size"]) // 2)
    return {"half_batch": gaps(reference_run(cell, st, specs, rows=half), sound),
            "no_first_moment": gaps(reference_run(cell, st, specs, adam=NoFirstMoment), sound),
            "stale_step": gaps(reference_run(cell, st, specs, adam=StaleStep), sound)}


def tf32_readings(cell, st) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    specs = _specs(cell, st)
    return gaps(reference_run(cell, st, specs, precision=tf32), reference_run(cell, st, specs))
