"""Embedding pretraining of the wav2vec 2.0 Conformer (rel-pos large) trunk:
``train/pretrain.pretrain`` on raw 16 kHz waveforms of the seeded tone-word
corpus, resident data and graphed epochs (the defaults), the model's trunk
choosing the waveform path. The traffic, the set-up, the window and the
recorded call are the XLS-R cell's (``drivers/pretrain_xlsr.py``): only the
trunk differs. The warm call and the window's call run no BN calibration
(``pretrain()`` calibrates B0's BatchNorm2d only): the blocks' BatchNorm1d
statistics move inside the steps.

The check compares the window's own call, its first ``check_steps`` steps
(the first eager, the others replays of the epoch graph), with the XLS-R
cell's numbers against ``reference/wav2vec2_conformer.py`` in float32
without TF32 (``host_draw_mismatch``, ``wave_mismatch_share``,
``loss_gap``, ``grad_gap``, ``update_gap``, ``replay_loss_gap``), and one
more:

- ``bn_stats_gap``: each block's BatchNorm running mean and variance after
  step ``check_steps``, as the call's replays left them, against the
  reference's after the same steps fed the same waveforms (its statistics
  moved by its own batches): the largest, over the 24 blocks, of
  ||program - reference|| / ||reference - start||, a block's mean and
  variance taken together, the relative gap of what the steps moved. A
  replay that skipped the update leaves step 1's movement, some 0.6 of the
  reference's away.

The program's statistics after step ``check_steps`` are copied once, on the
device, where the epoch has taken that many steps: after the eager step's
function, or after the replay of the epoch graph that completes it
(``keep_statistics``); it changes nothing the program computes.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from kwsbench import training
from kwsbench.checks import verdict
from kwsbench.drivers import pretrain as b0
from kwsbench.drivers import pretrain_xlsr as xlsr
from kwsbench.reference import augment as ref_augment
from kwsbench.reference import train as ref_train
from kwsbench.reference import wav2vec2_conformer as ref
from kwsbench.reference.model import exact, tf32
from kwsbench.traffic import audio
from kwsbench.weights_wav2vec2_conformer import conformer_state, program_model


class _CountingGraph:
    """A CUDA graph whose replays call ``after()`` once each."""

    def __init__(self, graph, after):
        self._graph, self._after = graph, after

    def replay(self):
        self._graph.replay()
        self._after()

    def __getattr__(self, name):
        return getattr(self._graph, name)


def keep_statistics(epoch, model, after_steps: int, into: List[torch.Tensor]) -> None:
    """Append each BatchNorm1d's running mean and variance of ``model``
    (device copies) to ``into`` once ``epoch`` (a ``train/graphs.EpochGraph``)
    has taken ``after_steps`` steps: counted after each eager step's
    function (not its capture) and after each replay of its graph."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    taken = [0]

    def count():
        taken[0] += 1
        if taken[0] == after_steps:
            for bn in bns:
                into.extend((bn.running_mean.detach().clone(), bn.running_var.detach().clone()))

    one_step, capture = epoch._one_step, epoch._capture

    def stepping():
        one_step()
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            count()

    def capturing():
        capture()
        epoch.graph = _CountingGraph(epoch.graph, count)

    epoch._one_step, epoch._capture = stepping, capturing


def recorded_call(cell, st, epochs: int, steps: int) -> training.Recorder:
    """One ``pretrain()`` call on the cell's model, recorded as
    ``drivers/pretrain.recorded_call`` records it; ``rec.statistics`` holds
    the BN statistics after the first epoch's ``check_steps`` steps."""
    import multilingual_kws_tpu_torch.train.pretrain as program

    rec = training.Recorder(st["model"])
    rec.statistics = []
    check = int(cell.traffic["check_steps"])

    def wrap(build):
        def recording_build(model, optimizer, group, dataset, bank, drop, device="cuda"):
            rec.watch(optimizer, dataset, bank)
            epoch = build(model, optimizer, group, dataset, bank, drop, device=device)
            keep_statistics(epoch, model, check, rec.statistics)
            return rec.epoch(epoch, drop)

        return recording_build

    with rec.patch(program, "build_fused_resident_epoch", wrap):
        b0.run_pretrain(cell, st, b0.pretrain_config(cell, epochs, steps))
    return rec


def setup(cell) -> Dict:
    t = cell.traffic
    corpus = audio.words_corpus(cell.workdir / "corpus", cell.seed, int(t["words"]), int(t["clips"]))
    state = conformer_state(cell.config, cell.seed, cell.device)
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
    # steps: the call's; traced_steps: its first epoch's, which the step's
    # readers bound by the augment kernel's launches; the operations a clip
    # follow from the shapes the trunk's spans record
    cell.counts.update(steps=epochs * steps, traced_steps=steps, batch=batch, dims=ref.dims(cell.config),
                       num_labels=int(cell.config["num_labels"]))
    marks = [round(e["t"] - t0, 4) for e in st["rec"].epochs]
    return {"attempted": epochs * steps, "failed": 0, "metrics": {"pretrain_clips_per_s": epochs * steps * batch / wall},
            "work": {"epochs": epochs, "epoch_starts_s": marks, "wall_s": wall}}


def reference_run(cell, st, waves: List[np.ndarray], rows=slice(None), precision=exact, adam=ref_train.Adam,
                  stale_statistics: bool = False):
    """The reference's steps on each step's normalized ``waves``: the first
    from the initialization, the next ones from the program's parameters and
    Adam state after its first step, the BN statistics moved by the
    reference's own batches throughout. (losses, first gradients, the
    parameters' change over the first step, the BN statistics after the
    last step). ``stale_statistics``: a fault, the statistics moved by the
    first step only, as a replay that skipped the update would leave them."""
    rec = st["rec"]
    ep = rec.epochs[0]
    p = {k: v.clone() for k, v in st["state"].items()}
    model = ref.Model(p, cell.config)
    opt = adam(ref_train.parameter_keys(p), float(cell.config["learning_rate"]))
    labels = [y.to(cell.device) for y in ep["inputs"][1][: len(waves)]]
    x = [torch.from_numpy(w).to(cell.device) for w in waves]
    keys = [k for pair in ref.batch_norm_keys(cell.config) for k in pair]
    loss, g1 = ref.step(model, p, opt, x[0], labels[0], rows, precision)
    losses = [loss]
    change = {k: p[k] - st["state"][k] for k in opt.keys}
    after1 = {k: p[k].clone() for k in keys}
    for k in opt.keys:
        after = rec.after1[k]
        p[k].copy_(after["param"])
        opt.m[k], opt.v[k] = after["exp_avg"].clone(), after["exp_avg_sq"].clone()
    opt.t = int(next(iter(rec.after1.values()))["step"])
    for w, y in zip(x[1:], labels[1:]):
        losses.append(ref.step(model, p, opt, w, y, rows, precision)[0])
        if stale_statistics:
            for k in keys:
                p[k].copy_(after1[k])
    return losses, g1, change, [p[k].clone() for k in keys]


def statistics_gap(prog: List[torch.Tensor], want: List[torch.Tensor], start: List[torch.Tensor]) -> float:
    """``bn_stats_gap``: over the blocks, the largest gap of a block's
    running mean and variance (taken together) from the reference's, over
    how far the reference's moved from ``start``; inf where the program kept
    none. The mean and variance of a block count together because the
    batch means lie near 0 at initialization, so a mean's own movement can
    be too small to divide by."""
    if len(prog) != len(want) or not want:
        return float("inf")

    def norm(ts):
        return float(torch.sqrt(sum(t.double().square().sum() for t in ts)))

    return max(norm([a.float() - b for a, b in zip(prog[i:i + 2], want[i:i + 2])])
               / norm([b - s for b, s in zip(want[i:i + 2], start[i:i + 2])]) for i in range(0, len(want), 2))


def gaps(cell, st, prog, prog_stats, want) -> Dict[str, float]:
    """The compared numbers of the steps (``drivers/pretrain.gaps``) and of
    the BN statistics."""
    start = [st["state"][k] for pair in ref.batch_norm_keys(cell.config) for k in pair]
    return {**b0.gaps(prog, want), "bn_stats_gap": statistics_gap(prog_stats, want[3], start)}


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
    prog_waves = training.program_specs(rec, first, steps, cell.device)
    bank_clips = [corpus["audio"][f] for f in corpus["train"]]
    ref_int16 = xlsr.reference_waves(first, steps, bank_clips, corpus["background"], cell.device)
    prog = b0.program_side(st, steps)
    prog_stats = rec.statistics
    release_program(cell, st)
    waves = xlsr.wave_gaps(prog_waves, ref_int16)
    own = gaps(cell, st, prog, prog_stats, reference_run(cell, st, [ref.normalize(w) for w in ref_int16]))
    print("info the steps' gaps on the reference's own waveforms: " + json.dumps(own), file=sys.stderr)
    return training.compared(limits, {
        "host_draw_mismatch": draw_mismatch,
        **waves,
        **gaps(cell, st, prog, prog_stats, reference_run(cell, st, prog_waves)),
    }, verdict)


def release_program(cell, st) -> None:
    """Drop the program's model (its epoch and validation graphs and their
    memory pools with it) and what the record holds of the data set, before
    the reference's steps: at the published widths both do not fit the card
    together."""
    st.pop("model", None)
    st["rec"].release()
    gc.collect()
    if cell.device != "cpu":
        torch.cuda.empty_cache()


def _waves(cell, st):
    """The program's waveforms of the recorded steps; the program is
    released after them."""
    waves = training.program_specs(st["rec"], st["rec"].epochs[0], int(cell.traffic["check_steps"]), cell.device)
    release_program(cell, st)
    return waves


def _as_program(run):
    """A reference run put in the program's place: its steps and its
    statistics."""
    return run[:3], run[3]


def fault_readings(cell, st) -> Dict[str, Dict[str, float]]:
    """The compared numbers of each fault planted in the reference put in
    the program's place, read against the sound reference: the loss over
    half of the batch, Adam without its first moment (b1 = 0), Adam's step
    count left at 1, the BN statistics moved by the first step only."""
    waves = _waves(cell, st)
    sound = reference_run(cell, st, waves)
    half = slice(0, int(cell.config["batch_size"]) // 2)
    faults = {"half_batch": reference_run(cell, st, waves, rows=half),
              "no_first_moment": reference_run(cell, st, waves, adam=b0.NoFirstMoment),
              "stale_step": reference_run(cell, st, waves, adam=b0.StaleStep),
              "stale_statistics": reference_run(cell, st, waves, stale_statistics=True)}
    return {name: gaps(cell, st, *_as_program(run), sound) for name, run in faults.items()}


def tf32_readings(cell, st) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    waves = _waves(cell, st)
    return gaps(cell, st, *_as_program(reference_run(cell, st, waves, precision=tf32)), reference_run(cell, st, waves))
