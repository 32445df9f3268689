"""The few-shot fine-tune: ``train/finetune.transfer_learn`` at the
reference's defaults (4 epochs of 64 steps at batch 64, LR 1e-3, unknown
50 %, SpecAugment 80 %, the head alone trained), one call per new keyword,
closed loop, call after call.

Set-up writes a seeded corpus under the run's scratch directory (``keywords``
tone-sequence keywords of ``shots`` training clips and ``held_out`` more,
``unknown`` clips of other words, background noise) and the base embedding
checkpoint: the ``b0-embed761`` trunk and embedding head drawn from the seed,
BN calibrated by the reference on the corpus' clips, saved with the
program's ``save_model``. Each call gets a transfer model holding the
harness's weights (its head drawn from the seed) and loads the trunk
through ``base_model_path``, as ``run.py train`` loads it; like
``run.py train`` it validates on the shots. Set-up runs the first keyword's
call (cuDNN's and the programs' first calls, ``torch._dynamo``'s import);
the window calls the next keywords, in turn and from the second again when
all have had a call, until ``--seconds`` have passed. Each call is
recorded (``training.Recorder``: each epoch's uploaded rows, labels and
silence flags, the data set's generator state, the losses, the optimizer's
state after the first step); it changes nothing the program computes.

The check follows the window's last call from the program's own state: the
reference cannot repeat the augment kernel's order of summation, so its
steps start from the program's features of each step, and the features are
held to the reference's by themselves.

- ``host_draw_mismatch``: the first step's rows, labels and silence flags
  against the reference's draw from the seed (==);
- ``spec_mismatch_share``: the program's resident transform (B4, B1) on the
  first ``check_steps`` steps against the reference's augment and frontend
  on the same draws: the share of feature values that differ;
- ``loss_gap``: the first ``check_steps`` steps' losses against the
  reference's (largest relative gap);
- ``grad_gap``: the first gradient as the optimizer got it against the
  reference's, by the worst leaf (``training.leaf_gaps``);
- ``update_gap``: the head's change over the call's every step against the
  reference's, which follows all of them (the program's parameters after
  the third step are not reachable from outside the call);
- ``softmax_gap`` (printed, not compared: the 256 steps drift apart on
  some seeds, see PERF.md): the trained model's softmax rows, through the
  program's frontend, on the keyword's held-out clips and unknown clips,
  against the reference-trained head's on the reference's features (widest
  gap).
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
from kwsbench.reference import augment as ref_augment
from kwsbench.reference import frontend as ref_frontend
from kwsbench.reference.model import Model, calibrate, exact, lecun_state, spec, tf32
from kwsbench.reference.train import EPS, Adam
from kwsbench.traffic import audio
from kwsbench.weights import dims, generator, program_model

HEAD = ("transfer_head.hidden.weight", "transfer_head.hidden.bias", "transfer_head.out.weight", "transfer_head.out.bias")


def corpus_of(cell) -> Dict:
    """The keywords' shots and held-out clips, the unknown clips and the
    background, written under the scratch directory; int16 by path."""
    t = cell.traffic
    rng = np.random.default_rng([int(cell.seed), 3])
    root = cell.workdir / "corpus"
    out = {"keywords": [], "audio": {}}

    def clip(path, freqs):
        a = audio.to_int16(audio.tone_clip(rng, freqs))
        audio.write_wav(path, a)
        out["audio"][str(path)] = a
        return str(path)

    for k in range(int(t["keywords"])):
        word, freqs = f"k{k:03d}", tuple(rng.uniform(300, 3500, 3))
        clips = [clip(root / word / f"{word}_{i}.wav", freqs) for i in range(int(t["shots"]) + int(t["held_out"]))]
        out["keywords"].append({"word": word, "shots": clips[: int(t["shots"])], "held_out": clips[int(t["shots"]):]})
    out["unknown"] = [clip(root / "_unknown_" / f"u{i:04d}.wav", tuple(rng.uniform(300, 3500, 3)))
                      for i in range(int(t["unknown"]))]
    out["background"] = audio.background(rng)
    for i, a in enumerate(out["background"]):
        audio.write_wav(root / "_background_noise_" / f"noise_{i}.wav", a)
    out["bg_dir"] = str(root / "_background_noise_")
    return out


def base_state(cell, corpus) -> Dict[str, torch.Tensor]:
    """The transfer model's weights: the trunk and embedding head of the
    seeded 761-way embedding model, BN calibrated by the reference on the
    corpus' clips, and a head drawn from the seed (Flax's initialization)."""
    width, depth = dims(cell.config)
    keys = spec("transfer", width=width, depth=depth)
    state = lecun_state(keys, generator(cell.seed, cell.device, 3), cell.device)
    ref = Model(state, "transfer", width, depth)
    clips = [corpus["audio"][p] for p in corpus["unknown"][: int(cell.config["calibration_clips"])]]
    feats = torch.from_numpy(ref_frontend.clip_features(np.stack(clips))).to(cell.device)[..., None]
    calibrate(ref, feats.split(int(cell.config["calibration_batch"])))
    return state


def transfer_call(cell, st, keyword: Dict, model):
    from multilingual_kws_tpu_torch.train.finetune import transfer_learn

    t = cell.traffic
    return transfer_learn(keyword["word"], keyword["shots"], keyword["shots"], st["corpus"]["unknown"],
                          num_epochs=int(t["epochs"]), num_batches=int(t["batches"]), batch_size=int(t["batch_size"]),
                          primary_lr=float(t["learning_rate"]), base_model_path=st["base_path"],
                          unknown_percentage=float(t["unknown_percentage"]), bg_datadir=st["corpus"]["bg_dir"],
                          seed=cell.seed % (2**31), verbose=0, model=model, device=cell.device)


def recorded_call(cell, st, index: int, model):
    """Keyword ``index``'s ``transfer_learn`` call on ``model``, recorded:
    (the keyword's index, the recorder, the call's result)."""
    import multilingual_kws_tpu_torch.train.finetune as program

    rec = training.Recorder(model)

    def wrap(make):
        def recording_make(model, lr, trainable, dataset, bank, device="cuda"):
            epoch = make(model, lr, trainable, dataset, bank, device=device)
            rec.watch(epoch.optimizer, dataset, bank)
            return rec.epoch(epoch)

        return recording_make

    with rec.patch(program, "make_finetune_epoch_scan", wrap):
        result = transfer_call(cell, st, st["corpus"]["keywords"][index], model)
    return index, rec, result


def setup(cell) -> Dict:
    from multilingual_kws_tpu_torch.train.checkpoints import save_model

    corpus = corpus_of(cell)
    state = base_state(cell, corpus)
    base_path = cell.workdir / "embedding"
    width, depth = dims(cell.config)
    save_model(base_path, {k: v for k, v in state.items() if k.split(".")[0] != "transfer_head"},
               {"kind": "embedding", "width_coefficient": width, "depth_coefficient": depth})
    st = {"corpus": corpus, "state": state, "base_path": str(base_path)}
    # the warm call; its record serves the control's readings
    st["checked"] = recorded_call(cell, st, 0, program_model(cell.config, state, cell.device))
    if cell.device != "cpu":
        torch.cuda.synchronize()
    return st


def window(cell, st) -> Dict:
    n = len(st["corpus"]["keywords"]) - 1
    walls = []
    cell.tracer.start()
    t_end = time.perf_counter() + cell.seconds
    while True:
        st["checked"] = None  # the previous call's objects go before the next call's come
        model = program_model(cell.config, st["state"], cell.device)
        t0 = time.perf_counter()
        with cell.spans.span("transfer_learn"):
            st["checked"] = recorded_call(cell, st, 1 + len(walls) % n, model)
        walls.append(time.perf_counter() - t0)
        if cell.trace and len(walls) >= int(cell.traffic["traced_calls"]):
            break
        if not cell.trace and t0 + walls[-1] >= t_end:
            break
    cell.tracer.stop()
    cell.counts.update(keywords=len(walls))
    return {"attempted": len(walls), "failed": 0, "metrics": {"finetune_s": sum(walls) / len(walls)},
            "work": {"calls": len(walls), "walls_s": [round(w, 4) for w in walls]}}


def reference_train(cell, st, specs: List[List[np.ndarray]], labels: List[torch.Tensor], precision=exact):
    """The reference's fine-tune: the frozen trunk in evaluation, the head
    trained by Adam on Keras' cross-entropy of the softmax (clipped to [1e-7,
    1]) over every step. (step losses, first gradient, head change, the
    reference's parameters)."""
    width, depth = dims(cell.config)
    p = {k: v.clone() for k, v in st["state"].items()}
    ref = Model(p, "transfer", width, depth)
    opt = Adam(list(HEAD), float(cell.traffic["learning_rate"]))
    losses, g1 = [], None
    with precision():
        for ep_specs, ep_labels in zip(specs, labels):
            for x, y in zip(ep_specs, ep_labels):
                with torch.no_grad():
                    emb = ref.embed(torch.from_numpy(x).to(cell.device))
                for k in HEAD:
                    p[k].requires_grad_(True)
                probs = torch.softmax(ref.dense("transfer_head.out", torch.tanh(ref.dense("transfer_head.hidden", emb))), -1)
                loss = -torch.log(torch.clamp(probs, EPS, 1.0)).gather(1, y[:, None].long())[:, 0].mean()
                grads = dict(zip(HEAD, torch.autograd.grad(loss, [p[k] for k in HEAD])))
                for k in HEAD:
                    p[k].requires_grad_(False)
                opt.step(p, grads)
                losses.append(float(loss.detach()))
                if g1 is None:
                    g1 = grads
    return losses, g1, {k: p[k] - st["state"][k] for k in HEAD}, p


def check(cell, st, out) -> Dict:
    limits = cell.workload["limits"]
    index, rec, result = st["checked"]
    corpus = st["corpus"]
    kw = corpus["keywords"][index]
    steps = int(cell.traffic["check_steps"])
    first = rec.epochs[0]
    bank_clips = [corpus["audio"][f] for f in kw["shots"] + corpus["unknown"]]
    nf, nu = len(kw["shots"]), len(corpus["unknown"])
    want = ref_augment.host_draw(cell.seed % (2**31), nf, int(cell.traffic["batch_size"]), np.full(nf, 2), 0,
                                 float(cell.traffic["silence_percentage"]), 1, nu,
                                 float(cell.traffic["unknown_percentage"]))
    draw_mismatch = sum(int((t[0].cpu().numpy() != w).sum()) for t, w in zip(first["inputs"], want))
    # every step's program features; the first steps' held to the reference's
    prog_specs, labels = _recorded(cell, st)
    ref_specs = training.reference_specs(first, steps, bank_clips, corpus["background"], cell.device)
    # the trained model's softmax rows on held-out clips, through the program's frontend
    held = _held_out(st)
    with torch.no_grad():
        x = result.dataset.frontend.features_from_int16(torch.from_numpy(held).to(cell.device))
        rows = result.predict_fn()(x[..., None]).float().cpu().numpy()
    prog_change = {k: dict(result.model.named_parameters())[k].detach() - st["state"][k] for k in HEAD}
    prog_losses = [x for e in result.history[0]["step_loss"] for x in e]
    st["checked"] = (index, rec, None)
    rec.release()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    own = reference_train(cell, st, [ref_specs], [labels[0][:steps]])
    losses, g1, change, p = reference_train(cell, st, prog_specs, labels)
    # the first steps' losses and the loss of the step after them, which
    # the three updates give
    gaps = training.step_gaps(prog_losses[: steps + 1], losses[: steps + 1], rec.g1, g1, prog_change, change)
    per_step = [abs(a - b) / abs(b) for a, b in zip(prog_losses, losses)]
    n = len(per_step) // len(rec.epochs)
    print(f"info keyword {index}'s call; the steps' relative loss gaps, largest by epoch: " + json.dumps(
        [max(per_step[e * n:(e + 1) * n]) for e in range(len(rec.epochs))]) + "; first step above 1e-4: "
        + str(next((i for i, g in enumerate(per_step) if g > 1e-4), None)), file=sys.stderr)
    print("info the first steps' losses on the reference's own features: " + json.dumps(
        {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog_losses, own[0]))}), file=sys.stderr)
    ref_rows = _reference_rows(cell, p, held)
    return training.compared(limits, {
        "host_draw_mismatch": draw_mismatch,
        "spec_mismatch_share": training.mismatch_share(prog_specs[0][:steps], ref_specs),
        **gaps,
        "softmax_gap": float(np.max(np.abs(rows - ref_rows))),
    }, verdict)


def _recorded(cell, st):
    """The program's features of every recorded step of the checked call,
    and the labels."""
    rec = st["checked"][1]
    specs = [training.program_specs(rec, ep, ep["inputs"][0].shape[0], cell.device) for ep in rec.epochs]
    return specs, [[y.to(cell.device) for y in ep["inputs"][1]] for ep in rec.epochs]


def tf32_readings(cell, st) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    specs, labels = _recorded(cell, st)
    steps = int(cell.traffic["check_steps"])
    ref = reference_train(cell, st, specs, labels)
    tf = reference_train(cell, st, specs, labels, precision=tf32)
    out = training.step_gaps(tf[0][: steps + 1], ref[0][: steps + 1], tf[1], ref[1], tf[2], ref[2])
    held = _held_out(st)
    out["softmax_gap"] = float(np.max(np.abs(_reference_rows(cell, tf[3], held, tf32) - _reference_rows(cell, ref[3], held))))
    return out


def fault_readings(cell, st) -> Dict[str, float]:
    """The compared numbers of a fault planted in the reference put in the
    program's place: the loss taken over half of the batch (the mean over
    the rest), read against the sound reference."""
    specs, labels = _recorded(cell, st)
    steps = int(cell.traffic["check_steps"])
    ref = reference_train(cell, st, specs, labels)
    half = reference_train(cell, st, [[x[: x.shape[0] // 2] for x in e] for e in specs],
                           [[y[: y.shape[0] // 2] for y in e] for e in labels])
    out = training.step_gaps(half[0][: steps + 1], ref[0][: steps + 1], half[1], ref[1], half[2], ref[2])
    held = _held_out(st)
    out["softmax_gap"] = float(np.max(np.abs(_reference_rows(cell, half[3], held) - _reference_rows(cell, ref[3], held))))
    return out


def _held_out(st) -> np.ndarray:
    """The checked keyword's held-out clips and as many unknown clips (int16)."""
    corpus = st["corpus"]
    kw = corpus["keywords"][st["checked"][0]]
    return np.stack([corpus["audio"][p] for p in kw["held_out"] + corpus["unknown"][: len(kw["held_out"])]])


def _reference_rows(cell, p, held: np.ndarray, precision=exact) -> np.ndarray:
    width, depth = dims(cell.config)
    with torch.no_grad(), precision():
        x = torch.from_numpy(ref_frontend.clip_features(held)).to(cell.device)[..., None]
        return Model(p, "transfer", width, depth)(x).cpu().numpy()
