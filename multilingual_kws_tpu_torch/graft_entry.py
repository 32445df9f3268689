"""Graft entry points of the port: the flagship forward, and a multi-card
dry run of the data-parallel paths.

The counterpart of the root ``__graft_entry__.py`` (the JAX package's).

- ``entry()`` returns the flagship forward as an ``nn.Module`` (the exact
  micro frontend, then the full-width EfficientNetB0 761-way embedding
  classifier in eval mode) and its example arguments: 8 one-second float32
  waveforms of zeros, on the card.
- ``dryrun_multichip(n)`` spawns ``n`` ranks that meet through a file
  store (gloo on the CPU, NCCL on cards, one card a rank) and runs, over
  them, one data-parallel pretraining step on a global batch of ``n`` rows
  and one eval; one resident fused step and one resident epoch of two steps
  (``build_fused_resident_epoch``: on cards a CUDA graph) on a bank of a
  tiny written corpus; and three seconds of stream featurized on the
  device, windows sharded over the ranks (``parallel/mesh.make_sharded_predict``)
  and the detector at 0.5. Rank 0 prints one line for each of the four, as
  the JAX package's dry run does. A slim trunk (width 0.25, depth 0.1, 16
  labels) unless ``full_size``.

    python -m multilingual_kws_tpu_torch.graft_entry             # entry() on the card
    python -c "from multilingual_kws_tpu_torch import graft_entry as g; g.dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from . import exact_float32, resolve_device

NUM_LABELS = 761
# seconds: the process group's timeout, and each rank's join
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 180


class EntryForward(nn.Module):
    """1-second float waveforms (B, 16000) in [-1, 1] -> (B, 761) logits:
    the exact frontend, then the embedding classifier."""

    def __init__(self, model: nn.Module, frontend):
        super().__init__()
        self.model = model
        self.frontend = frontend

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        with exact_float32():
            return self.model(self.frontend.features(audio)[..., None])


def entry(device="cuda"):
    """(forward, example_args): the flagship forward on ``device`` (the
    full-width B0 761-way embedding classifier, Flax's default
    initialization from seed 0, eval mode, behind the exact frontend) and
    ``(audio,)``, 8 x 16000 float32 zeros on ``device``."""
    from .models.kws_model import lecun_init_, make_embedding_model
    from .ops.micro_torch import MicroFrontendTorch

    dev = resolve_device(device)
    model = lecun_init_(make_embedding_model(NUM_LABELS, device="cpu"), seed=0).to(dev).eval()
    forward = EntryForward(model, MicroFrontendTorch(device=dev)).eval()
    return forward, (torch.zeros((8, 16000), dtype=torch.float32, device=dev),)


def dryrun_trunk(full_size: bool):
    """The dry run's trunk: EfficientNetB0, or the slim one."""
    from .models.efficientnet import EfficientNet

    return EfficientNet() if full_size else EfficientNet(width_coefficient=0.25, depth_coefficient=0.1)


def dryrun_embedding_model(full_size: bool):
    """The dry run's embedding model on the CPU: 761 labels with the full
    trunk, 16 with the slim one; Flax's default initialization, seed 0."""
    from .models.kws_model import KWSEmbeddingModel, lecun_init_

    return lecun_init_(KWSEmbeddingModel(NUM_LABELS if full_size else 16, dryrun_trunk(full_size)), seed=0)


def dryrun_batch(n: int):
    """The step's global batch: ``n`` seeded feature windows, label 0."""
    specs = np.random.default_rng(0).normal(0, 1, (n, 49, 40, 1)).astype(np.float32)
    return torch.from_numpy(specs), torch.zeros(n, dtype=torch.int64)


def _drop(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _rank_main(rank: int, n: int, store: str, out: str, full_size: bool, backend: str) -> None:
    import torch.distributed as dist

    from .parallel import mesh

    if backend == "gloo":  # ranks share the host's cores
        torch.set_num_threads(1)
    else:
        from .utils.compilation_cache import enable_compilation_cache

        enable_compilation_cache()
    mesh.initialize_distributed(backend, init_method=f"file://{store}", world_size=n, rank=rank,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    try:
        res = {"lines": []}
        for run in (_dryrun_step, _dryrun_resident_fused, _dryrun_sharded_streaming):
            part = run(dev, n, full_size)
            res["lines"] += part.pop("lines")
            res.update(part)
        if rank == 0:
            torch.save(res, os.path.join(out, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _say(n: int, msg: str) -> str:
    """Rank 0 prints the line; every rank returns it."""
    from .parallel import mesh

    line = f"dryrun_multichip({n}): {msg}"
    if mesh.rank() == 0:
        print(line, flush=True)
    return line


def _dryrun_step(dev, n: int, full_size: bool) -> Dict:
    """One data-parallel pretraining step on the global batch of ``n``
    rows (this rank's), then one eval; the correct count summed over the
    ranks."""
    import torch.distributed as dist

    from .parallel import mesh
    from .train.steps import flat_adam, make_pretrain_step

    model = dryrun_embedding_model(full_size).to(dev)
    step, evaluate = make_pretrain_step(model, flat_adam(model.parameters(), 1e-3), mesh.default_group())
    specs, labels = dryrun_batch(n)
    rows = mesh.local_rows(n)
    sp, lb = specs[rows].to(dev), labels[rows].to(dev)
    loss = float(step(sp, lb, _drop(dev, 1))["loss"])
    correct = evaluate(sp, lb)["accuracy"] * sp.shape[0]
    dist.all_reduce(correct)
    line = _say(n, f"step ok, loss={loss:.4f}, eval_correct={float(correct):.0f}")
    return {"step_loss": loss, "eval_correct": float(correct), "lines": [line]}


def _dryrun_resident_fused(dev, n: int, full_size: bool) -> Dict:
    """The flagship training path over the ranks: a resident int16 bank of
    a tiny written corpus, one fused step (gather, augment, featurize,
    forward, backward, Adam) on the global batch's rows, then one resident
    epoch of two steps (``build_fused_resident_epoch``)."""
    from .data.dataset import AudioDataset
    from .parallel import mesh
    from .settings import standard_microspeech_model_settings
    from .train.pretrain import build_fused_resident_epoch
    from .train.steps import flat_adam, make_pretrain_step
    from .utils.wav import write_wav

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="dryrun_bank_") as tmp:
        files = []
        for i in range(4):
            p = os.path.join(tmp, f"clip{i}.wav")
            write_wav(p, rng.normal(0, 0.1, 16000).clip(-1, 1).astype(np.float32))
            files.append(p)
        bg = os.path.join(tmp, "_bg_")
        os.mkdir(bg)
        write_wav(os.path.join(bg, "n.wav"), rng.normal(0, 0.05, 32000).clip(-1, 1).astype(np.float32))
        ds = AudioDataset(standard_microspeech_model_settings(3), ["w"], bg, [], silence_percentage=10, seed=0,
                          device=dev, shard=(mesh.rank(), n))
        bank = ds.build_resident_bank(files)

    group = mesh.default_group()
    model = dryrun_embedding_model(full_size).to(dev)
    opt = flat_adam(model.parameters(), 1e-3)
    drop = _drop(dev, 2)
    step, _ = make_pretrain_step(model, opt, group)
    idx, lbl, sil = ds._put_batch((np.arange(n, dtype=np.int32) % len(files), np.ones(n, np.int32),
                                   np.zeros(n, bool)))
    keep = ds._keep(n)
    loss = float(step(ds._train_device(bank["bank"], idx, sil, keep), lbl[keep], drop)["loss"])
    lines = [_say(n, f"resident fused step ok, loss={loss:.4f}")]

    steps = 2
    epoch = build_fused_resident_epoch(model, opt, group, ds, bank["bank"], drop, device=dev)
    losses, _ = epoch(*ds._put_batch(((np.arange(steps * n, dtype=np.int32) % len(files)).reshape(steps, n),
                                      np.ones((steps, n), np.int32), np.zeros((steps, n), bool))))
    losses = losses.cpu().numpy()
    lines.append(_say(n, f"resident scanned epoch ok ({steps} steps), last loss={float(losses[-1]):.4f}"))
    return {"fused_loss": loss, "epoch_losses": losses.tolist(), "lines": lines}


def _dryrun_sharded_streaming(dev, n: int, full_size: bool) -> Dict:
    """Long-form streaming with the window axis sharded over the ranks:
    three seconds of seeded audio featurized on the device, the window
    batch through the transfer model's sharded forward, then the
    detector at 0.5."""
    from .models.kws_model import KWSTransferModel, lecun_init_
    from .parallel import mesh
    from .stream.detector import detect_all_thresholds
    from .stream.engine import StreamFlags, model_predict_fn, stream_feature_chunks

    model = lecun_init_(KWSTransferModel(dryrun_trunk(full_size), num_categories=3), seed=0).to(dev)
    sharded = mesh.make_sharded_predict(model_predict_fn(model))
    audio = np.random.default_rng(3).normal(0, 0.05, 3 * 16000).clip(-1, 1).astype(np.float32)
    flags = StreamFlags(wav="<in-memory>", ground_truth="<none>", target_keyword="w", detection_thresholds=[0.5])
    outs = [sharded(chunk[..., None]) for chunk in stream_feature_chunks(audio, 16000, flags, device=dev)]
    inferences = torch.cat(outs).float().cpu().numpy()
    times_ms = np.arange(inferences.shape[0]) * flags.clip_stride_ms
    found = detect_all_thresholds(inferences, times_ms, [0.5], target_name="w")
    line = _say(n, f"window-sharded streaming ok, {inferences.shape[0]} windows, {len(found[0.5][0])} detections @0.5")
    return {"windows": int(inferences.shape[0]), "detections": len(found[0.5][0]), "lines": [line]}


def dryrun_multichip(n_devices: int, full_size: bool = False, device="cuda") -> Dict:
    """Run the four data-parallel paths over ``n_devices`` spawned ranks:
    NCCL, one card a rank, on ``device="cuda"`` (it raises without a card,
    or with fewer cards than ranks); gloo on the CPU with ``device="cpu"``.
    Rank 0 prints four lines; returns rank 0's numbers (the step's loss
    and eval correct count, the fused step's loss, the epoch's losses, the
    stream's windows and detections) and the lines. Raises if a rank fails or outlives
    JOIN_TIMEOUT_S."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} CUDA device(s) visible, "
                           f"one rank a card needs {n_devices}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, str(Path(tmp) / "store"), tmp, full_size,
                                                      backend)) for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(timeout=10)
        if hung or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks exited {[p.exitcode for p in procs]}"
                               f"{' (killed after the join timeout)' if hung else ''}")
        return torch.load(Path(tmp) / "rank0.pt", weights_only=True)


if __name__ == "__main__":
    forward, args = entry()
    with torch.inference_mode():
        print("entry forward:", tuple(forward(*args).shape))
