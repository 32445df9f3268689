"""Embedding pretraining of the XLS-R 300M trunk: ``train/pretrain.pretrain``
on raw 16 kHz waveforms of the seeded tone-word corpus, resident data and
graphed epochs (the defaults), the model's trunk choosing the waveform path.

Set-up, window and the recorded call are ``drivers/pretrain.py``'s: the
corpus under the run's scratch directory, the weights drawn from the seed
(``weights_wav2vec2.py``), one warm ``pretrain()`` call of one
``check_steps``-step epoch (an eager step, the epoch graph's capture,
replays, validation; no BN calibration: the model has no BN), the model set
back to its initialization, then the window's one call of
``steps_per_epoch``-step epochs, as many as ``expected_clips_per_s`` says
fill ``--seconds`` (``traced_epochs`` when traced). ``pretrain_clips_per_s``
is the clips stepped over the call's wall, start-up and validation
included.

The check compares the window's own call, its first ``check_steps`` steps
(the first eager, the others replays of the epoch graph):

- ``host_draw_mismatch``: the first step's rows, labels and silence flags
  against the reference's draw from the seed (==);
- ``wave_mismatch_share``: the program's resident transform (the augment
  kernel B4, then the per-clip normalization) on each step's rows and
  generator state against the reference's augment on the same draws and its
  normalization in float64: the share of samples that differ by more than
  1.5 int16 steps of their clip (``wave_gaps``). B4 rounds a sample the
  other way on a few millionths of samples (one step), which the
  normalization carries over as one step; anything beyond is a fault;
- ``loss_gap``, ``grad_gap``, ``update_gap`` and ``replay_loss_gap``:
  ``drivers/pretrain.py``'s measures of step 1 (from the initialization)
  and steps 2 to ``check_steps`` (from the program's parameters and Adam
  state after step 1), the steps fed the program's waveforms, the reference
  ``reference/wav2vec2.py`` in float32 without TF32.
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
from kwsbench.counts import wav2vec2 as wcounts
from kwsbench.drivers import pretrain as b0
from kwsbench.reference import augment as ref_augment
from kwsbench.reference import train as ref_train
from kwsbench.reference import wav2vec2 as ref
from kwsbench.reference.model import exact, tf32
from kwsbench.traffic import audio
from kwsbench.traffic.audio import SR
from kwsbench.weights_wav2vec2 import program_model, xlsr_state

# a sample differs where the program's and the reference's normalized values
# lie more than this many int16 steps of the clip apart
WAVE_STEPS = 1.5


def setup(cell) -> Dict:
    t = cell.traffic
    corpus = audio.words_corpus(cell.workdir / "corpus", cell.seed, int(t["words"]), int(t["clips"]))
    state = xlsr_state(cell.config, cell.seed, cell.device)
    model = program_model(cell.config, state, cell.device)
    st = {"corpus": corpus, "state": state, "model": model}
    # the warm call; its record serves the control's readings
    st["rec"] = b0.recorded_call(cell, st, 1, int(t["check_steps"]))
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
        st["rec"] = b0.recorded_call(cell, st, epochs, steps)
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


def reference_waves(ep: Dict, steps: int, bank_clips, background, device) -> List[np.ndarray]:
    """The reference's int16 clips of an epoch's first ``steps`` steps: the
    augmentation drawn in the program's order from a generator in the data
    set's state at the epoch's start (no SpecAugment draws on the waveform
    path), the reference's augment."""
    gen = torch.Generator(device=device)
    gen.set_state(ep["gen"])
    sizes = torch.tensor([b.shape[0] for b in background], device=device)
    out = []
    for j in range(steps):
        idx = ep["inputs"][0][j].cpu().numpy()
        sil = ep["inputs"][2][j].cpu().numpy()
        draws = ref_augment.draw_augment(gen, idx.shape[0], SR, sizes)
        out.append(ref_augment.augment_int16(np.stack([bank_clips[r] for r in idx]), sil, background, draws))
    return out


def wave_gaps(prog: List[np.ndarray], ref_int16: List[np.ndarray]) -> Dict[str, float]:
    """The program's normalized waveforms against the reference's
    normalization of its int16 clips, in int16 steps of each clip (a step is
    1 / 32768 / sqrt(var + 1e-7) in normalized units): the share of samples
    more than ``WAVE_STEPS`` apart, and the largest gap."""
    if len(prog) != len(ref_int16) or any(a.shape != b.shape for a, b in zip(prog, ref_int16)):
        return {"wave_mismatch_share": float("inf"), "wave_max_steps": float("inf")}
    shares, worst = [], 0.0
    for a, w in zip(prog, ref_int16):
        x = w.astype(np.float64) / 32768.0
        scale = np.sqrt(x.var(axis=-1, keepdims=True) + 1e-7) * 32768.0
        steps = np.abs(a.astype(np.float64) - ref.normalize(w)) * scale
        shares.append(float(np.mean(steps > WAVE_STEPS)))
        worst = max(worst, float(steps.max()))
    return {"wave_mismatch_share": float(np.mean(shares)), "wave_max_steps": worst}


def reference_run(cell, st, waves: List[np.ndarray], rows=slice(None), precision=exact, adam=ref_train.Adam):
    """The reference's steps on each step's normalized ``waves``: the first
    from the initialization, the next ones from the program's parameters and
    Adam state after its first step. (losses, first gradients, the
    parameters' change over the first step)."""
    rec = st["rec"]
    ep = rec.epochs[0]
    p = {k: v.clone() for k, v in st["state"].items()}
    model = ref.Model(p, cell.config)
    opt = adam(ref_train.parameter_keys(p), float(cell.config["learning_rate"]))
    labels = [y.to(cell.device) for y in ep["inputs"][1][: len(waves)]]
    x = [torch.from_numpy(w).to(cell.device) for w in waves]
    loss, g1 = ref.step(model, p, opt, x[0], labels[0], rows, precision)
    losses = [loss]
    change = {k: p[k] - st["state"][k] for k in opt.keys}
    for k in opt.keys:
        after = rec.after1[k]
        p[k].copy_(after["param"])
        opt.m[k], opt.v[k] = after["exp_avg"].clone(), after["exp_avg_sq"].clone()
    opt.t = int(next(iter(rec.after1.values()))["step"])
    for w, y in zip(x[1:], labels[1:]):
        losses.append(ref.step(model, p, opt, w, y, rows, precision)[0])
    return losses, g1, change


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
    ref_int16 = reference_waves(first, steps, bank_clips, corpus["background"], cell.device)
    prog = b0.program_side(st, steps)
    st.pop("model")
    rec.release()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    waves = wave_gaps(prog_waves, ref_int16)
    own = b0.gaps(prog, reference_run(cell, st, [ref.normalize(w) for w in ref_int16]))
    print("info the steps' gaps on the reference's own waveforms: " + json.dumps(own), file=sys.stderr)
    return training.compared(limits, {
        "host_draw_mismatch": draw_mismatch,
        **waves,
        **b0.gaps(prog, reference_run(cell, st, prog_waves)),
    }, verdict)


def _waves(cell, st):
    return training.program_specs(st["rec"], st["rec"].epochs[0], int(cell.traffic["check_steps"]), cell.device)


def fault_readings(cell, st) -> Dict[str, Dict[str, float]]:
    """The compared numbers of each fault planted in the reference put in
    the program's place, read against the sound reference: the loss over
    half of the batch, Adam without its first moment (b1 = 0), Adam's step
    count left at 1."""
    waves = _waves(cell, st)
    sound = reference_run(cell, st, waves)
    half = slice(0, int(cell.config["batch_size"]) // 2)
    return {"half_batch": b0.gaps(reference_run(cell, st, waves, rows=half), sound),
            "no_first_moment": b0.gaps(reference_run(cell, st, waves, adam=b0.NoFirstMoment), sound),
            "stale_step": b0.gaps(reference_run(cell, st, waves, adam=b0.StaleStep), sound)}


def tf32_readings(cell, st) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    waves = _waves(cell, st)
    return b0.gaps(reference_run(cell, st, waves, precision=tf32), reference_run(cell, st, waves))


def plant_altered_sample() -> None:
    """A planted fault for the control: one sample of one clip in every
    training batch altered (+1.0 in normalized units, about its clip's
    standard deviation) where the program's transform produces it."""
    from multilingual_kws_tpu_torch.data import dataset

    augment = dataset.augment_waveform

    def altering(*args, **kw):
        waves = augment(*args, **kw).clone()
        waves[0, 8000] += 1.0
        return waves

    dataset.augment_waveform = altering
