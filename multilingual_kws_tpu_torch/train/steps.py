"""Train steps: the few-shot fine-tune and embedding pretraining, their
optimizers and losses, and BN calibration.

Counterpart of ``multilingual_kws_tpu/train/steps.py`` (Keras compile/fit of
the reference, transfer_learning.py:55-93 and
train_monolingual_embedding.py:103-137):

- ``adam``: Keras-default Adam (eps 1e-7, not torch's 1e-8) over the
  trainable parameters only. Every other parameter has requires_grad off and
  is not in the optimizer, so it never changes: the JAX package's
  ``multi_transform`` with ``set_to_zero``. On the card it is
  ``capturable`` (a CUDA graph can hold its step): the step count lives on
  the device and the bias corrections are computed there in float32, as
  optax computes them; on the CPU they are computed in Python's float64
  (a last-bit difference in the update);
- ``flat_adam``: the same Adam over every parameter, for pretraining;
- ``sparse_ce_from_probs``: Keras sparse categorical cross-entropy on
  probabilities, clipped to [1e-7, 1] with ``clamp`` (zero gradient outside,
  as ``jnp.clip``); ``sparse_ce_from_logits`` on logits;
- ``make_finetune_step``: a step on a model that stays in ``eval()`` mode
  (frozen BN running statistics, no drop-connect), as Keras trains a
  ``trainable=False`` trunk;
- ``make_pretrain_step``: a train-mode step of the embedding model (BN on
  batch statistics, updating its running ones; drop-connect), optionally
  data-parallel over a process group;
- both return their step, evaluate and predict as programs
  (``train/graphs.ProgramGraphs``: on the card a CUDA graph per input shape
  after one eager call), as the JAX package's return jitted functions; a
  program's eager function is its ``fn``;
- ``make_finetune_epoch_scan``: a whole resident fine-tune epoch (bank
  gather, augment, featurize, step), on the card as a CUDA graph
  (``train/graphs.py``);
- ``calibrate_batch_stats``: BN running statistics set to the data's
  moments, for a trunk that was never pretrained.

Every step runs under ``exact_float32`` (no TF32 on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import exact_float32, resolve_device
from ..parallel import mesh
from .graphs import EpochGraph, ProgramGraphs, check_on_device, eval_forward, module_program

ParamPath = Tuple[str, ...]


def _on_card(params: List[torch.nn.Parameter]) -> bool:
    return bool(params) and all(p.is_cuda for p in params)


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """Keras-default Adam (b1 0.9, b2 0.999, eps 1e-7); ``capturable`` when
    the parameters are on the card."""
    params = list(params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7, capturable=_on_card(params))


def flat_adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """``adam`` over all of a model's parameters, as the multi-tensor
    (``foreach``) Adam. The JAX package flattens the parameters into one
    vector (``optax.flatten``) so that the TPU runs a few large vector ops
    instead of a small loop per leaf; ``foreach`` gets the same from the
    leaves as they are (each elementwise stage over all of them in a few
    multi-tensor launches), with the same update rule, so nothing needs
    flattening. ``capturable`` when the parameters are on the card."""
    params = list(params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7, foreach=True,
                            capturable=_on_card(params))


def sparse_ce_from_probs(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Keras SparseCategoricalCrossentropy(from_logits=False) per sample:
    probabilities clipped to [eps, 1], then -log p[label]."""
    p = torch.clamp(probs, eps, 1.0)
    return -torch.log(p).gather(1, labels[:, None].to(torch.int64))[:, 0]


def sparse_ce_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy of logits: -log_softmax(logits)[label], in
    float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].to(torch.int64))[:, 0]


def set_trainable(model: nn.Module, trainable: Callable[[ParamPath], bool]) -> List[str]:
    """Turn requires_grad on for the parameters whose path (the name split
    at ".", the Flax path of the JAX package) ``trainable`` accepts, and off
    for the rest. Returns the trainable parameters' names."""
    names = []
    for name, p in model.named_parameters():
        on = bool(trainable(tuple(name.split("."))))
        p.requires_grad_(on)
        if on:
            names.append(name)
    return names


def _metrics(probs, labels):
    loss = sparse_ce_from_probs(probs, labels).mean()
    acc = (torch.argmax(probs, -1) == labels).to(torch.float32).mean()
    return loss, acc


def make_finetune_step(model: nn.Module, learning_rate: float, trainable: Callable[[ParamPath], bool]):
    """Few-shot fine-tune step: the parameters ``trainable`` accepts learn
    with a fresh Adam, every other one is frozen; the model stays in eval
    mode. Returns (step, evaluate, predict), programs
    (``train/graphs.ProgramGraphs``, the JAX package's jitted functions):

    - ``step(specs, labels)`` updates the model in place and returns
      {"loss", "accuracy"} as device scalars (no host sync); the trainable
      parameters' ``.grad`` hold the step's gradients afterwards, and
      ``step.optimizer`` is its Adam;
    - ``evaluate(specs, labels)`` returns the same metrics without a
      gradient;
    - ``predict(specs)`` returns the (B, 3) softmax (the model's predict
      program, ``graphs.module_program(model, graphs.eval_forward)``)."""
    names = set(set_trainable(model, trainable))
    opt = adam([p for n, p in model.named_parameters() if n in names], learning_rate)
    model.eval()

    def step(specs, labels) -> Dict[str, torch.Tensor]:
        with exact_float32():
            opt.zero_grad(set_to_none=True)
            probs = model(specs)
            loss, acc = _metrics(probs, labels)
            loss.backward()
            opt.step()
        return {"loss": loss.detach(), "accuracy": acc}

    @torch.no_grad()
    def evaluate(specs, labels) -> Dict[str, torch.Tensor]:
        with exact_float32():
            loss, acc = _metrics(model(specs), labels)
        return {"loss": loss, "accuracy": acc}

    return (ProgramGraphs(step, [model], optimizer=opt, train=False), ProgramGraphs(evaluate, [model], train=False),
            module_program(model, eval_forward))


def make_pretrain_step(model: nn.Module, optimizer: torch.optim.Optimizer, group=None):
    """Embedding-pretraining step (the JAX package's ``make_pretrain_step``):
    the model in train mode (BN on batch statistics, updating its running
    ones; drop-connect), logits, cross-entropy and accuracy. Returns (step,
    evaluate), programs (``train/graphs.ProgramGraphs``, the JAX package's
    jitted ``step_fn`` and ``eval_fn``):

    - ``step(specs, labels, drop_generator)`` updates the model in place and
      returns {"loss", "accuracy"} as device scalars (no host sync);
    - ``evaluate(specs, labels)`` returns the same metrics in eval mode,
      without a gradient.

    ``group``: the default process group (``mesh.default_group()``) to run
    data-parallel over: each rank passes its rows of the global batch
    (``mesh.local_rows``); the gradients are averaged over the ranks by one
    all-reduce of all of them, flattened, after the backward pass; BN
    normalizes over the global batch, and the loss and accuracy returned are
    averaged over the ranks, so every rank sees the metrics of the global
    batch. BN and drop-connect span the default group
    (``models/efficientnet.py``), so another group is refused, and so is
    none while the default group has more than one rank.

    The step makes no host sync and no host-side collective bookkeeping, so
    a CUDA graph holds it, collectives included (``train/graphs.py``); the
    drop-connect generator is part of its key.
    ``DistributedDataParallel`` is not used: its reducer needs a dozen eager
    iterations and NCCL's asynchronous error handling off before it can be
    captured, and on one card it overlaps nothing."""
    if group is not None and group != mesh.default_group():
        raise ValueError("make_pretrain_step runs over the default process group only: BN and drop-connect span it")
    if group is None and mesh.world_size() > 1:
        raise ValueError("make_pretrain_step: pass the default process group of "
                         f"{mesh.world_size()} ranks, over which BN and drop-connect run")
    params = [p for p in model.parameters() if p.requires_grad]

    def metrics(logits, labels):
        loss = sparse_ce_from_logits(logits, labels).mean()
        acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
        return loss, acc

    def step(specs, labels, drop_generator=None) -> Dict[str, torch.Tensor]:
        model.train()  # for a caller of the eager function, step.fn
        with exact_float32():
            optimizer.zero_grad(set_to_none=True)
            loss, acc = metrics(model(specs, drop_generator=drop_generator), labels)
            loss.backward()
            if group is not None:
                _average_gradients(params, group)
            optimizer.step()
        out = torch.stack([loss.detach(), acc])
        if group is not None:
            dist.all_reduce(out, group=group)
            out /= dist.get_world_size(group)
        return {"loss": out[0], "accuracy": out[1]}

    @torch.no_grad()
    def evaluate(specs, labels) -> Dict[str, torch.Tensor]:
        model.eval()
        with exact_float32():
            loss, acc = metrics(model(specs), labels)
        return {"loss": loss, "accuracy": acc}

    return (ProgramGraphs(step, [model], optimizer=optimizer, train=True),
            ProgramGraphs(evaluate, [model], train=False))


@torch.no_grad()
def _average_gradients(params: List[torch.nn.Parameter], group) -> None:
    """Each gradient := its mean over the ranks of ``group``: one all-reduce
    of all of them, flattened."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def make_finetune_epoch_scan(model: nn.Module, learning_rate: float, trainable: Callable[[ParamPath], bool],
                             dataset, bank: torch.Tensor, device="cuda") -> EpochGraph:
    """One resident fine-tune epoch as one device program: the counterpart
    of the JAX package's ``make_finetune_epoch_scan``, a ``lax.scan`` of
    (bank gather -> augment -> featurize -> step).

    Returns ``epoch(idx_all, lbl_all, sil_all) -> (losses, accs)``
    (``train/graphs.EpochGraph``): the epoch's (steps, B) bank rows, label
    ids and silence flags from ``dataset.host_train_indices``, uploaded
    once; (steps,) losses and accuracies on the device, pulled once. Each
    step is the resident step: ``dataset._train_device(bank, rows,
    is_silence)`` (the device draws from ``dataset.gen``, the augment
    kernel, the frontend kernel, SpecAugment), then ``make_finetune_step``'s
    update with a fresh Adam (``epoch.optimizer``), eager inside the
    epoch's capture (``step.fn``). On the card (``device``,
    default ``cuda``: it raises without one) the epoch is a CUDA graph of
    the step replayed once a step; on the CPU the same step runs as a plain
    loop. The model, the dataset and ``bank`` must be on ``device``."""
    dev = resolve_device(device)
    check_on_device(dev, model, dataset, bank)
    step, _, _ = make_finetune_step(model, learning_rate, trainable)

    def body(rows, labels, is_silence):
        m = step.fn(dataset._train_device(bank, rows, is_silence), labels)
        return m["loss"], m["accuracy"]

    return EpochGraph(body, dev, generators=[dataset.gen], optimizer=step.optimizer)


@torch.no_grad()
def calibrate_batch_stats(model: nn.Module, specs_batches, drop_generator=None) -> nn.Module:
    """Set every BN layer's running statistics to the data's moments.

    A trunk that was never pretrained has init statistics (mean 0, var 1)
    that normalize nothing, so frozen-BN training would see unnormalized
    features. One train-mode forward per batch (BN on batch statistics,
    drop-connect from ``drop_generator``) records each BN input's mean and
    biased variance over (N, H, W) (Flax's batch moments) by forward hooks;
    the running statistics become their mean over the batches. In train
    mode no layer's output depends on the running statistics, so this is
    the fixed point the JAX package iterates towards. Under a process group
    of more than one rank each rank passes its rows of the global batches,
    and the moments are those of the global batches (the BN inputs' means
    are all-reduced, then their squared deviations), as the JAX package
    computes them over its batch-sharded mesh. The model is left in eval
    mode."""
    batches = list(specs_batches)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    if not batches or not bns:
        return model
    sums = {bn: [0.0, 0.0] for bn in bns}
    world = mesh.world_size()

    def global_mean(local):
        if world > 1:
            dist.all_reduce(local)
            local /= world
        return local

    def record(bn, inputs, _output):
        x = inputs[0].float()
        mean = global_mean(x.mean(dim=(0, 2, 3)))
        var = global_mean((x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3)))
        sums[bn][0] = sums[bn][0] + mean
        sums[bn][1] = sums[bn][1] + var

    handles = [bn.register_forward_hook(record) for bn in bns]
    try:
        model.train()
        with exact_float32():
            for specs in batches:
                model(specs, drop_generator=drop_generator)
    finally:
        for h in handles:
            h.remove()
        model.eval()
    for bn in bns:
        bn.running_mean.copy_(sums[bn][0] / len(batches))
        bn.running_var.copy_(sums[bn][1] / len(batches))
    return model
