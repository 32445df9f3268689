"""Few-shot transfer learning: the reference's transfer_learn.

Counterpart of ``multilingual_kws_tpu/train/finetune.py`` (reference
multilingual_kws/embedding/transfer_learning.py:14-123): the trunk and
embedding head are frozen, the 18-tanh -> 3-softmax head trains on a
single-target ``AudioDataset`` (unknown 50 %, SpecAugment 80 %), and an
optional phase 2 ("backprop into embedding") also trains the embedding head
and the trunk's top convolution at ``embedding_lr``, with a fresh optimizer.

Defaults are those of the reference's run.py train (run.py:212-300): 4 epochs
x 1 batch x batch 64, LR 1e-3, and its quirk steps_per_epoch = batch_size x
num_batches (256 steps in all).

The base weights come from a checkpoint (``base_model_path``, the trunk
sized from its metadata, ``train/checkpoints.py``), as a ``state_dict`` of
a port model, or as the JAX package's Flax numpy trees (converted by
``models/convert.py``); the trunk and embedding head are taken with the
trunk's BN statistics. Without them the trunk is fresh, and its BN
statistics are first calibrated to the data on two train batches
(``train/steps.calibrate_batch_stats``).

Small training sets stay on the device (``AudioDataset.build_resident_bank``,
chosen automatically below 4 GiB): each epoch then uploads its bank indices
once and runs as one device program, as in the JAX package
(``train/steps.make_finetune_epoch_scan``: on the card a CUDA graph of the
step, replayed once a step; each phase captures its own, with its own
optimizer). The streaming pipeline (``resident=False``) runs a step at a
time from host batches, the transform and the step each a program
(``AudioDataset.train_batches``, ``make_finetune_step``: on the card a CUDA
graph per shape after one eager call, as the JAX package jits its step);
both pipelines take the same steps on the same batches. Each epoch's
evaluation (``evaluate_dataset``) runs the eval featurization and
``evaluate`` as programs too.

Under a profiler a call records its stages as spans
(``utils/profiling.annotate``): the root ``finetune.call`` (counting
``graphs_kept``, the CUDA graphs alive as it returns), ``finetune.start``
(the model, the base weights, the dataset, the bank), and an epoch's
``finetune.draws`` (the host draws and their upload), ``finetune.epoch``
(the steps' launches; counts ``steps``), ``finetune.wait`` (the losses'
pull) and ``finetune.evaluate`` (counts ``batches``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import AudioDataset
from ..models.convert import flax_to_state_dict
from ..models.efficientnet import as_dtype
from ..models.kws_model import KWSTransferModel, lecun_init_
from ..ops.augment import SpecAugParams
from ..settings import ModelSettings, standard_microspeech_model_settings
from ..utils.profiling import annotate, spanned
from . import checkpoints as ckpt
from . import graphs
from .graphs import eval_forward, serve
from .metrics import CSVLogger
from .steps import calibrate_batch_stats, make_finetune_epoch_scan, make_finetune_step

HEAD_PREFIX = "transfer_head"


def _head_only(path: Tuple[str, ...]) -> bool:
    return path[0] == HEAD_PREFIX


def _head_and_top(path: Tuple[str, ...]) -> bool:
    """Phase-2 unfreezing: head + embedding head + trunk top conv, excluding
    BatchNorm (reference transfer_learning.py:94-99 unfreezes the top layers
    while leaving BN frozen)."""
    if path[0] == HEAD_PREFIX or path[0] == "embedding_head":
        return True
    if path[0] == "trunk" and path[1] == "top":
        return "bn" not in path
    return False


@dataclass
class FinetuneResult:
    name: str
    model: KWSTransferModel
    details: Dict
    dataset: AudioDataset
    # per phase: {"loss", "accuracy", "val_loss", "val_accuracy"} per epoch
    # and "step_loss", "step_accuracy", each epoch's per-step metrics; on
    # the card, with the resident bank, "graph": the CUDA graph's replays,
    # the eager steps before its capture and the capture's seconds
    history: List[Dict] = field(default_factory=list)
    # the last phase's optimizer (the JAX package's ``state.opt_state``)
    optimizer: Optional[torch.optim.Optimizer] = None

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def predict_fn(self):
        """(B, 49, 40, 1) float32 (a tensor, or numpy) -> (B, 3) softmax
        tensor on the model's device; it takes the form the streaming engine
        (``stream.engine.calculate_streaming_accuracy``) and
        ``train/evaluate.py`` pass. It serves the model's predict program
        (``train/graphs.serve``; the program is cached on the model, so
        every call of this method shares it): on a card a CUDA graph a batch
        shape, a host array uploaded straight into its input."""
        program = serve(self.model, eval_forward)

        def predict(specs) -> torch.Tensor:
            return program(torch.as_tensor(specs, dtype=torch.float32))

        return predict


def _base_state_dict(base_params, base_batch_stats) -> Optional[Dict[str, torch.Tensor]]:
    """The trunk and embedding-head tensors of the base weights: from a port
    ``state_dict`` (keys with ".") or from Flax numpy trees."""
    if base_params is None:
        return None
    if any("." in k for k in base_params):
        sd = dict(base_params)
    else:
        stats = {"trunk": base_batch_stats["trunk"]} if base_batch_stats is not None else {}
        params = {k: base_params[k] for k in ("trunk", "embedding_head")}
        sd = flax_to_state_dict({"params": params, "batch_stats": stats})
    return {k: v for k, v in sd.items() if k.split(".")[0] in ("trunk", "embedding_head")}


@spanned("finetune.call", lambda: {"graphs_kept": graphs.kept})
def transfer_learn(
    target: str,
    train_files: Sequence[str],
    val_files: Sequence[str],
    unknown_files: Sequence[str],
    num_epochs: int = 4,
    num_batches: int = 1,
    batch_size: int = 64,
    primary_lr: float = 1e-3,
    backprop_into_embedding: bool = False,
    embedding_lr: float = 0.0,
    model_settings: Optional[ModelSettings] = None,
    base_model_path=None,
    unknown_percentage: float = 50.0,
    bg_datadir=None,
    csvlog_dest=None,
    seed: Optional[int] = None,
    verbose: int = 1,
    resident: Optional[bool] = None,
    resident_max_bytes: Optional[int] = None,
    base_params: Optional[Mapping] = None,
    base_batch_stats: Optional[Mapping] = None,
    model: Optional[KWSTransferModel] = None,
    compute_dtype: Optional[str] = None,
    device="cuda",
) -> FinetuneResult:
    """Few-shot fine-tune of ``target`` on ``device``; the JAX package's
    signature, plus ``device``.

    base_model_path: a checkpoint of a pretrained embedding (or transfer)
    model; its trunk and embedding head are loaded, and BN is not
    calibrated.
    base_params: the base weights, a port ``state_dict`` or Flax trees (with
    base_batch_stats), when no base_model_path is given.
    model: a ``KWSTransferModel`` to train in place (e.g. a narrower trunk);
    by default one with the checkpoint's trunk (``checkpoints.sized_trunk``;
    a trunk that takes waveforms is refused; B0 without a checkpoint) and
    Flax's default initialization
    (``models/kws_model.lecun_init_``) from ``seed``.
    compute_dtype: "bfloat16" runs the trunk's convolutions, BN and the
    embedding head's dense layers in bf16 (parameters, BN statistics, the
    192-d embedding and the transfer head stay float32: the JAX package's
    mixed-precision contract); None or "float32": float32. It builds the
    default model; a ``model`` given computes in its own dtype."""
    with annotate("finetune.start"):
        trunk_dtype = as_dtype(compute_dtype)
        dev = resolve_device(device)
        model_settings = model_settings or standard_microspeech_model_settings(3)
        if model is None:
            meta = ckpt.load_metadata(base_model_path) if base_model_path is not None else {}
            model = lecun_init_(KWSTransferModel(ckpt.sized_trunk(meta, trunk_dtype), num_categories=3), seed or 0)
        model = model.to(dev).eval()
        if base_params is None and base_model_path is not None:
            base_params = ckpt.load_embedding_variables(base_model_path, dev)
        base = _base_state_dict(base_params, base_batch_stats)
        if base is not None:
            with torch.no_grad():
                own = model.state_dict()
                for k, v in base.items():
                    own[k].copy_(torch.as_tensor(v))

        dataset = AudioDataset(
            model_settings=model_settings,
            commands=[target],
            background_data_dir=bg_datadir,
            unknown_files=unknown_files,
            unknown_percentage=unknown_percentage,
            spec_aug_params=SpecAugParams(percentage=80),
            seed=seed,
            device=dev,
        )

        if base_params is None:
            # a fresh trunk: calibrate its BN statistics to the data, so that
            # frozen-BN training sees normalized features (drop-connect draws
            # from their own generator, as the JAX package's fixed dropout key)
            t0 = time.time()
            calib = [
                specs
                for specs, _ in dataset.train_batches(
                    train_files, batch_size=min(batch_size, 64), num_steps=2
                )
            ]
            drop = torch.Generator(device=dev)
            drop.manual_seed(0)
            calibrate_batch_stats(model, calib, drop_generator=drop)
            if verbose:
                print(f"calibrated BN statistics on {len(calib)} batches ({time.time()-t0:.1f}s)", flush=True)

        logger = CSVLogger(csvlog_dest) if csvlog_dest else None

        if resident is None:
            uniq = set(train_files) | set(unknown_files)
            cap = resident_max_bytes if resident_max_bytes is not None else AudioDataset.RESIDENT_MAX_BYTES
            resident = len(uniq) * model_settings.desired_samples * 2 <= cap
        bank = dataset.build_resident_bank(train_files) if resident else None
    # the reference's quirk: steps_per_epoch = batch_size * num_batches
    steps_per_epoch = batch_size * num_batches

    def run_phase(lr, trainable) -> Tuple[Dict, torch.optim.Optimizer]:
        step, evaluate, _ = make_finetune_step(model, lr, trainable)
        optimizer = step.optimizer
        if resident:
            # one device program an epoch (the JAX package's scanned epoch)
            epoch_scan = make_finetune_epoch_scan(model, lr, trainable, dataset, bank["bank"], device=dev)
            optimizer = epoch_scan.optimizer
        history = {"val_accuracy": [], "val_loss": [], "accuracy": [], "loss": [], "step_loss": [],
                   "step_accuracy": []}
        for epoch in range(num_epochs):
            t0 = time.time()
            if resident:
                with annotate("finetune.draws"):
                    # one upload of the epoch's bank indices
                    draws = list(dataset.host_train_indices(train_files, batch_size, steps_per_epoch, bank))
                    uploaded = dataset._put_batch(tuple(np.stack(a) for a in zip(*draws)))
            with annotate("finetune.epoch") as span:
                if resident:
                    losses, accs = epoch_scan(*uploaded)
                else:
                    metrics = [
                        step(specs, labels)
                        for specs, labels in dataset.train_batches(
                            train_files, batch_size=batch_size, num_steps=steps_per_epoch, prefetch=2
                        )
                    ]
                    losses = torch.stack([m["loss"] for m in metrics])
                    accs = torch.stack([m["accuracy"] for m in metrics])
                span.count(steps=steps_per_epoch)
            with annotate("finetune.wait"):
                losses, accs = losses.cpu().numpy(), accs.cpu().numpy()
            val = evaluate_dataset(evaluate, dataset, val_files, batch_size)
            ep = {
                "epoch": epoch,
                "loss": float(np.mean(losses)),
                "accuracy": float(np.mean(accs)),
                "val_loss": val["loss"],
                "val_accuracy": val["accuracy"],
            }
            for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
                history[k].append(ep[k])
            history["step_loss"].append(losses.tolist())
            history["step_accuracy"].append(accs.tolist())
            if logger:
                logger.log(ep)
            if verbose:
                print(
                    f"epoch {epoch+1}/{num_epochs} loss={ep['loss']:.4f} "
                    f"acc={ep['accuracy']:.4f} val_acc={ep['val_accuracy']:.4f} "
                    f"({time.time()-t0:.1f}s)",
                    flush=True,
                )
        if resident and epoch_scan.graph is not None:
            history["graph"] = {"replays": epoch_scan.replays, "eager_steps": epoch_scan.eager_steps,
                                "capture_s": epoch_scan.capture_s}
        return history, optimizer

    phases = []
    try:
        history, optimizer = run_phase(primary_lr, _head_only)
        phases.append(history)
        if backprop_into_embedding:
            history, optimizer = run_phase(embedding_lr, _head_and_top)
            phases.append(history)
    finally:
        if logger:
            logger.close()

    va = phases[-1]["val_accuracy"][-1]
    name = (
        f"xfer_epochs_{num_epochs}_bs_{batch_size}_nbs_{num_batches}"
        f"_val_acc_{va:0.2f}_target_{target}"
    )
    details = dict(
        num_epochs=num_epochs,
        batch_size=batch_size,
        num_batches=num_batches,
        val_accuracy=va,
        target=target,
    )
    return FinetuneResult(name=name, model=model, details=details, dataset=dataset, history=phases,
                          optimizer=optimizer)


def evaluate_dataset(evaluate_fn, dataset: AudioDataset, files, batch_size) -> Dict[str, float]:
    """Weighted-mean metrics over eval batches (``evaluate_fn`` from
    ``make_finetune_step``, a program; the JAX package's function also
    takes its train state, which the port keeps in the model). The span
    ``finetune.evaluate``, counting ``batches``."""
    tot_n = 0
    tot_loss = 0.0
    tot_acc = 0.0
    with annotate("finetune.evaluate") as span:
        for specs, labels in dataset.eval_batches(files, batch_size=batch_size):
            m = evaluate_fn(specs, labels)
            n = labels.shape[0]
            tot_n += n
            tot_loss += float(m["loss"]) * n
            tot_acc += float(m["accuracy"]) * n
            span.count(batches=1)
    if tot_n == 0:
        return {"loss": float("nan"), "accuracy": float("nan")}
    return {"loss": tot_loss / tot_n, "accuracy": tot_acc / tot_n}
