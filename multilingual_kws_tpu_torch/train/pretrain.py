"""Embedding-model pretraining, optionally data-parallel over processes.

Counterpart of ``multilingual_kws_tpu/train/pretrain.py`` (reference
train_monolingual_embedding.py / train_multilingual_embedding.py: a Keras
fit with ModelCheckpoint and CSVLogger). The JAX package shards one global
batch over a device mesh inside one program; here each process of a
``torch.distributed`` group (one per card, ``parallel/mesh.py``) holds its
rows of the global batch:

- every rank makes the same host draw and the same device draws of the
  global batch from the same seed and keeps its rows
  (``AudioDataset(shard=...)``): the augment kernel and the frontend run on
  them only;
- the step (``train/steps.make_pretrain_step``) averages the gradients by
  one all-reduce; BN normalizes over the global batch and drop-connect
  draws the global batch's masks (``models/efficientnet.py``);
- validation spreads each eval batch over the ranks and all-reduces the
  sums, padded rows not counted;
- rank 0 alone writes checkpoints, the CSV log and the history.

A step on W ranks is thus the step of one process on the global batch
(``tests/test_torch_parallel.py``). Without a group, or with one rank, it is
a plain single-device loop.

The model's trunk chooses the data path: a trunk that takes waveforms
(``trunk.takes_waveform``: the wav2vec 2.0 trunks of ``models/wav2vec2.py``
and ``models/wav2vec2_conformer.py``) gets a data set of normalized
waveforms (``AudioDataset(waveform=True)``: the augment kernel, no
frontend, no SpecAugment) for its steps and its validation. BN calibration
is B0's (its BatchNorm2d moves 0.01 a step, so short runs would validate on
stale statistics); a model without BatchNorm2d skips it, so nothing is drawn
for it. The Conformer's BatchNorm1d (momentum 0.1) keeps the running
statistics its training steps move, inside the epoch's CUDA graph, and
validation reads those, as ``transformers`` trains and evaluates it.

Small training sets stay on the device (``AudioDataset.build_resident_bank``,
chosen automatically below ``resident_max_bytes``): each epoch uploads its
bank indices once, and each step gathers, augments and featurizes on the
device. With ``scan_epoch`` (the default, as in the JAX package) the
resident epoch is one device program (``build_fused_resident_epoch``: on
the card a CUDA graph of the step, replayed once a step); without it the
same steps run one at a time, each one program (``build_fused_resident_step``).
Larger sets stream: a host batch is uploaded a step, its transform and the
step are programs (``AudioDataset.train_batches``, ``make_pretrain_step``),
and so is validation's scoring of each eval batch; on the card each is a
CUDA graph per shape after one eager call (``train/graphs.ProgramGraphs``),
as the JAX package jits them. BN calibration and checkpoints run eagerly
between epochs. Every step and evaluation runs under ``exact_float32``.

Under a profiler a call records its stages as spans
(``utils/profiling.annotate``): the root ``pretrain.call`` (counting
``graphs_kept``, the CUDA graphs alive as it returns), ``pretrain.start``
(from the entry to the first epoch), and an epoch's ``pretrain.draws`` (the
host draws and their upload), ``pretrain.epoch`` (the steps' launches;
counts ``steps``), ``pretrain.wait`` (the losses' pull),
``pretrain.calibrate`` and ``pretrain.validate``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import exact_float32, resolve_device
from ..data.dataset import AudioDataset
from ..data.manifests import label_from_parent_dir
from ..models.kws_model import KWSEmbeddingModel, lecun_init_, make_embedding_model
from ..ops.augment import SpecAugParams
from ..parallel import mesh
from ..settings import ModelSettings, standard_microspeech_model_settings
from ..utils.profiling import annotate, spanned
from . import graphs
from .checkpoints import BestValCheckpoint, trunk_metadata
from .graphs import EpochGraph, ProgramGraphs, check_on_device, module_program
from .metrics import CSVLogger, save_history
from .steps import calibrate_batch_stats, flat_adam, make_pretrain_step, sparse_ce_from_logits


@dataclass
class PretrainConfig:
    """The JAX package's ``PretrainConfig``; defaults mirror
    train_multilingual_embedding.py:40-55 (batch 64, silence 1 % for
    multilingual; the monolingual script used silence 10 % / unknown 10 %).
    ``batch_size`` is the global batch: it must divide over the ranks."""

    num_labels: int = 761
    batch_size: int = 64
    num_epochs: int = 40
    learning_rate: float = 1e-3
    silence_percentage: float = 1.0
    unknown_percentage: float = 0.0
    shuffle_seed: int = 0
    csvlog_dest: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    history_dest: Optional[str] = None
    steps_per_epoch: Optional[int] = None  # default: len(train) // batch
    # BN re-estimation before each validation pass: with momentum 0.99 the
    # running statistics need ~500 steps to settle, so short runs would
    # evaluate (and checkpoint) with stale ones. 0 disables.
    bn_calibration_batches: int = 2
    # host batches assembled (and uploaded) that many steps ahead on a
    # background thread when the resident bank is off; the same batches
    # either way
    prefetch: int = 2
    # keep the training clips on the device and gather batches there
    # (None: on when the bank fits resident_max_bytes)
    resident_data: Optional[bool] = None
    resident_max_bytes: int = AudioDataset.RESIDENT_MAX_BYTES
    # run each resident epoch as one device program (True: on the card a
    # CUDA graph of the step, build_fused_resident_epoch) or a step at a
    # time (False); the same steps on the same draws either way
    scan_epoch: bool = True
    # "bfloat16": convolutions, BN and the embedding head's dense layers in
    # bf16; parameters, BN statistics, the 192-d embedding, logits and the
    # optimizer stay float32. "float32": float32 throughout (no TF32)
    compute_dtype: str = "float32"
    device: str = "cuda"


def build_fused_resident_epoch(model, optimizer, group, dataset: AudioDataset, bank: torch.Tensor,
                               drop_generator: torch.Generator, device="cuda") -> EpochGraph:
    """A resident pretraining epoch as one device program: the counterpart
    of the JAX package's ``build_fused_resident_epoch`` (a ``lax.scan`` of
    the fused gather + augment + featurize + step, ``_resident_step``).

    Returns ``epoch(idx_all, lbl_all, sil_all) -> (losses, accs)``
    (``train/graphs.EpochGraph``): the epoch's (steps, B) global-batch bank
    rows, label ids and silence flags from ``dataset.host_train_indices``,
    uploaded once; (steps,) losses and accuracies on the device. Each step
    is ``dataset._train_device(bank, rows, is_silence, keep)`` (this rank's
    rows ``keep`` of the global batch) followed by ``make_pretrain_step``'s
    update of ``model`` with ``optimizer`` over ``group``, drop-connect drawn
    from ``drop_generator``. On the card (``device``, default ``cuda``: it
    raises without one) the epoch is a CUDA graph of the step, replayed once
    a step, collectives included; on the CPU the same step runs as a plain
    loop. The model, the dataset and ``bank`` must be on ``device``."""
    dev = resolve_device(device)
    check_on_device(dev, model, dataset, bank)
    body = _resident_step(model, optimizer, group, dataset, bank, drop_generator)
    return EpochGraph(body, dev, generators=[dataset.gen, drop_generator], optimizer=optimizer)


def build_fused_resident_step(model, optimizer, group, dataset: AudioDataset, bank: torch.Tensor,
                              drop_generator: torch.Generator, device="cuda") -> ProgramGraphs:
    """One resident pretraining step as one device program: the counterpart
    of the JAX package's ``build_fused_resident_step``, the step of
    ``pretrain(scan_epoch=False)``.

    Returns ``step(rows, labels, is_silence) -> (loss, accuracy)``: the
    same step as ``build_fused_resident_epoch``'s on one step's (B,) bank
    rows, label ids and silence flags (a row of the epoch's upload), its
    metrics as device scalars. On the card (``device``, default ``cuda``:
    it raises without one) it is a ``train/graphs.ProgramGraphs``, a CUDA
    graph after one eager step; on the CPU the plain step. The model, the
    dataset and ``bank`` must be on ``device``."""
    dev = resolve_device(device)
    check_on_device(dev, model, dataset, bank)
    body = _resident_step(model, optimizer, group, dataset, bank, drop_generator)
    return ProgramGraphs(body, [model], optimizer=optimizer, generators=[dataset.gen, drop_generator], train=True)


def _resident_step(model, optimizer, group, dataset: AudioDataset, bank: torch.Tensor,
                   drop_generator: torch.Generator):
    """The fused resident step, eager: ``dataset._train_device(bank, rows,
    is_silence, keep)`` (this rank's rows ``keep`` of the global batch),
    then ``make_pretrain_step``'s update; (loss, accuracy) device scalars."""
    step = make_pretrain_step(model, optimizer, group)[0].fn

    def body(rows, labels, is_silence):
        keep = dataset._keep(rows.shape[0])
        m = step(dataset._train_device(bank, rows, is_silence, keep), labels[keep], drop_generator)
        return m["loss"], m["accuracy"]

    return body


def _validation_sums(model, specs, labels, real):
    """One eval batch's (loss sum, correct count), float64, over the rows
    where ``real``: the JAX package's ``eval_fn``, its padding an input."""
    with torch.no_grad(), exact_float32():
        logits = model(specs)
    loss = torch.where(real, sparse_ce_from_logits(logits, labels), 0.0)
    correct = real & (torch.argmax(logits, -1) == labels)
    return torch.stack([loss.sum(), correct.sum()]).double()


def _validate(model, dataset: AudioDataset, val_files, val_labels, batch_size: int, group):
    """(loss sum, correct count, rows) over all ``val_files``: each eval
    batch is padded to a multiple of the ranks (``mesh.pad_to_multiple``),
    each rank (``dataset.shard``) featurizes and scores its rows through the
    model's validation program (``_validation_sums``), padded rows are not
    counted, and the sums are all-reduced over ``group``, outside the
    program."""
    world = dataset.shard[1]
    dev = dataset.device
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    model.eval()
    scores = module_program(model, _validation_sums)
    for start in range(0, len(val_files), batch_size):
        n = min(batch_size, len(val_files) - start)
        idx, _ = mesh.pad_to_multiple(np.arange(start, start + n), world)
        rows = mesh.local_rows(len(idx), dataset.shard)
        mine = idx[rows]
        real = torch.from_numpy(np.arange(len(idx))[rows] < n).to(dev)
        files = [val_files[i] for i in mine]
        labels = [val_labels[i] for i in mine]
        for specs, lbl in dataset.eval_batches(files, batch_size=len(files), labels=labels, single_target=False):
            sums += scores(specs, lbl, real)
    if group is not None:
        dist.all_reduce(sums, group=group)
    loss_sum, correct = sums.tolist()
    return loss_sum, correct, len(val_files)


@spanned("pretrain.call", lambda: {"graphs_kept": graphs.kept})
def pretrain(
    train_files: Sequence[str],
    val_files: Sequence[str],
    commands: Sequence[str],
    background_data_dir,
    unknown_files: Sequence[str] = (),
    config: PretrainConfig = PretrainConfig(),
    model_settings: Optional[ModelSettings] = None,
    resume_params: Optional[Mapping[str, torch.Tensor]] = None,
    verbose: int = 1,
    model: Optional[KWSEmbeddingModel] = None,
    checkpoint_meta: Optional[Dict] = None,
):
    """Pretraining loop; the JAX package's signature without ``mesh``: it
    runs data-parallel over the default process group (the one
    ``mesh.initialize_distributed`` joined), or in one process without one.
    BN and drop-connect span that group too, so no other is taken.
    Labels come from the parent directories' names (init_from_parent_dir
    semantics, input_data.py:473-508).

    model: an embedding model to train in place; by default a full-width
    EfficientNetB0 with ``len(commands)`` + silence / unknown labels,
    ``config.compute_dtype`` and Flax's default initialization from
    ``config.shuffle_seed``. A model whose trunk takes waveforms (XLS-R
    300M: ``make_embedding_model(n, trunk=Wav2Vec2Trunk())``; the Conformer:
    ``trunk=Wav2Vec2ConformerTrunk()``) trains on normalized waveforms
    (module docstring). resume_params: a port
    ``state_dict`` of an embedding checkpoint (parameters and BN
    statistics) to start from; the optimizer starts fresh, as in the JAX
    package. checkpoint_meta: extra
    checkpoint metadata (``kind: embedding`` and the trunk's
    ``checkpoints.trunk_metadata`` are always written).

    Returns (model, history, dataset): the model in eval mode, and per epoch
    "loss", "accuracy" (the train steps' means), "val_loss" and
    "val_accuracy"."""
    with annotate("pretrain.start"):
        group = mesh.default_group()
        world = dist.get_world_size(group) if group is not None else 1
        rank = dist.get_rank(group) if group is not None else 0
        dev = resolve_device(config.device)
        model_settings = model_settings or standard_microspeech_model_settings(config.num_labels)
        waveform = model is not None and model.trunk.takes_waveform

        dataset = AudioDataset(
            model_settings=model_settings,
            commands=list(commands),
            background_data_dir=background_data_dir,
            unknown_files=list(unknown_files),
            silence_percentage=config.silence_percentage,
            unknown_percentage=config.unknown_percentage,
            spec_aug_params=SpecAugParams(percentage=80),
            seed=config.shuffle_seed,
            device=dev,
            shard=(rank, world),
            waveform=waveform,
        )
        num_labels = len(dataset.commands)
        if model is None:
            model = lecun_init_(
                make_embedding_model(num_labels, device="cpu", compute_dtype=config.compute_dtype), config.shuffle_seed
            )
        model = model.to(dev)
        if resume_params is not None:
            model.load_state_dict(resume_params, strict=True)

        optimizer = flat_adam(model.parameters(), config.learning_rate)
        step, _ = make_pretrain_step(model, optimizer, group)

        train_labels = [label_from_parent_dir(f) for f in train_files]
        val_labels = [label_from_parent_dir(f) for f in val_files]
        writer = rank == 0
        logger = CSVLogger(config.csvlog_dest) if config.csvlog_dest and writer else None
        ckpt = BestValCheckpoint(config.checkpoint_dir) if config.checkpoint_dir and writer else None
        meta = {"kind": "embedding", **trunk_metadata(model.trunk), **(checkpoint_meta or {})}
        history: Dict[str, List[float]] = {"loss": [], "accuracy": [], "val_loss": [], "val_accuracy": []}

        steps_per_epoch = config.steps_per_epoch or max(1, len(train_files) // config.batch_size)
        use_resident = config.resident_data
        if use_resident is None:
            uniq = set(train_files) | set(unknown_files)
            use_resident = len(uniq) * model_settings.desired_samples * 2 <= config.resident_max_bytes
        bank = dataset.build_resident_bank(train_files) if use_resident else None
        keep = dataset._keep(config.batch_size)

        def resident_draws(num_steps):
            """One upload of a pass's (steps, B) bank indices, labels and
            silence flags."""
            draws = list(dataset.host_train_indices(
                train_files, config.batch_size, num_steps, bank, labels=train_labels, single_target=False
            ))
            return dataset._put_batch(tuple(np.stack(a) for a in zip(*draws)))

        def epoch_batches(num_steps):
            if not use_resident:
                yield from dataset.train_batches(
                    train_files, batch_size=config.batch_size, num_steps=num_steps, labels=train_labels,
                    single_target=False, prefetch=config.prefetch,
                )
                return
            idx, lbl, sil = resident_draws(num_steps)
            for i in range(num_steps):
                yield dataset.resident_specs(bank["bank"], idx[i], sil[i]), lbl[i, keep]

        # B0's BatchNorm2d only: a BatchNorm1d (the Conformer's) keeps the
        # statistics its own steps move, as its model trains them
        calibrate = config.bn_calibration_batches > 0 and any(isinstance(m, nn.BatchNorm2d) for m in model.modules())
        drop = torch.Generator(device=dev)
        drop.manual_seed(config.shuffle_seed + 1)
        if use_resident:
            # one device program an epoch, or a step (the JAX package's fused
            # resident epoch and step)
            build = build_fused_resident_epoch if config.scan_epoch else build_fused_resident_step
            resident = build(model, optimizer, group, dataset, bank["bank"], drop, device=dev)
    try:
        for epoch in range(config.num_epochs):
            t0 = time.time()
            if use_resident:
                with annotate("pretrain.draws"):
                    idx, lbl, sil = resident_draws(steps_per_epoch)
            with annotate("pretrain.epoch") as span:
                if use_resident and config.scan_epoch:
                    losses, accs = resident(idx, lbl, sil)
                elif use_resident:
                    metrics = [resident(idx[i], lbl[i], sil[i]) for i in range(steps_per_epoch)]
                    losses, accs = (torch.stack(m) for m in zip(*metrics))
                else:
                    metrics = [step(specs, labels, drop) for specs, labels in epoch_batches(steps_per_epoch)]
                    losses = torch.stack([m["loss"] for m in metrics])
                    accs = torch.stack([m["accuracy"] for m in metrics])
                span.count(steps=steps_per_epoch)
            with annotate("pretrain.wait"):
                losses, accs = losses.cpu().numpy(), accs.cpu().numpy()

            if calibrate:
                with annotate("pretrain.calibrate"):
                    calib = [specs for specs, _ in epoch_batches(config.bn_calibration_batches)]
                    fixed = torch.Generator(device=dev)
                    fixed.manual_seed(0)
                    calibrate_batch_stats(model, calib, drop_generator=fixed)

            with annotate("pretrain.validate"):
                loss_sum, correct, tot = _validate(model, dataset, val_files, val_labels, config.batch_size, group)
            ep = {
                "epoch": epoch,
                "loss": float(np.mean(losses)),
                "accuracy": float(np.mean(accs)),
                "val_loss": loss_sum / max(tot, 1),
                "val_accuracy": correct / max(tot, 1),
            }
            for k in history:
                history[k].append(ep[k])
            if logger:
                logger.log(ep)
            if ckpt:
                ckpt.update(ep, model, extra_meta={"epoch": epoch, "num_labels": num_labels,
                                                   "commands": list(dataset.commands), **meta})
            if verbose and writer:
                print(
                    f"epoch {epoch+1}/{config.num_epochs} loss={ep['loss']:.4f} acc={ep['accuracy']:.4f} "
                    f"val_acc={ep['val_accuracy']:.4f} ({time.time()-t0:.1f}s)",
                    flush=True,
                )
    finally:
        if logger:
            logger.close()
    if config.history_dest and writer:
        save_history(history, config.history_dest)
    return model.eval(), history, dataset
