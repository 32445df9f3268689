"""A resident training epoch as a CUDA graph: one step captured, then
replayed once a step.

The JAX package runs a resident epoch (bank gather, augment, featurize,
step) as one scanned XLA program (``train/steps.make_finetune_epoch_scan``,
``train/pretrain.build_fused_resident_epoch``), so that the host is off the
critical path. PyTorch runs eagerly: a fine-tune step issues some 450
launches from Python and a pretraining step some 3,800, and the card waits
for them. ``EpochGraph`` is the port's counterpart: on the card it captures
one step as a CUDA graph and replays it, one host call a step.

- The step reads its inputs through a device step counter. The epoch's
  (steps, B) bank rows, labels and silence flags sit in static buffers; the
  step takes row ``counter`` of each (``index_select``), writes its loss and
  accuracy at ``counter`` into static (steps,) buffers and adds one to the
  counter, all on the device. Each epoch copies its draws into the same
  buffers and resets the counter.
- A captured step does not run, so warm-up steps are real steps. The first
  ``WARMUP_STEPS`` steps of the first epoch run eagerly, on a side stream,
  where the one-off work happens: Adam's state, the kernels' attribute
  queries and the frontend's tables, the process group's communicator.
  Then the step is captured and replayed for the rest. Every step is taken
  once, in order, as the eager loop takes it.
- The random draws are the eager ones. The generators the step draws from
  (the dataset's, drop-connect's) are registered with the graph: each
  replay draws from the generator's offset at the time and moves it on by
  what one eager step takes (``CUDAGraph.register_generator_state``).
- Launch counts stay what the eager loop would count. A kernel wrapper
  called while the stream is capturing counts in ``captured``
  (``ops/_build.count``); each replay adds the captured launches to the
  wrappers' ``launches``.
- There is no fallback: a capture or a replay that fails raises.

The graph holds the addresses of what it reads and writes: the model's
parameters and buffers, the optimizer's state, the resident and background
banks, the frontend's tables. They must stay where they are while the epoch
object is used: no ``load_state_dict`` of new tensors' storage, no
``.to()``; a new optimizer takes a new epoch object. The parameters'
gradients live in the graph's memory after the first replay. A tensor that
keeps an autograd graph of the parameters alive from before the epoch (a
clone of a parameter that requires grad, say) ties their gradient
accumulation to the stream it was made on; if that is the default stream,
the capture fails, and raises.

On the CPU the same step runs as a plain Python loop, counter and all.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import _build

# eager steps before the capture; one makes every lazy allocation and
# one-off call of the step (Adam's state, the kernels' attributes, the
# tables, NCCL's communicator), and each is a real step
WARMUP_STEPS = 1


def resolved_device(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on_device(device, model: torch.nn.Module, dataset, bank: torch.Tensor) -> None:
    """Raise unless the model, the dataset and the bank are on ``device``."""
    where = {resolved_device(p.device) for p in model.parameters()}
    where |= {resolved_device(dataset.device), resolved_device(bank.device)}
    if where != {resolved_device(device)}:
        raise ValueError(f"the epoch runs on {device}; the model, dataset and bank are on {sorted(map(str, where))}")


Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class EpochGraph:
    """``epoch(idx_all, lbl_all, sil_all) -> (losses, accs)``: one epoch of
    ``step``, the (steps, B) inputs on ``device``, the (steps,) float32
    losses and accuracies returned as new device tensors.

    step(rows, labels, is_silence) -> (loss, accuracy): one training step
    on a batch's (B,) bank rows, labels and silence flags, updating the
    model in place, its metrics device scalars (no host sync).
    generators: the ``torch.Generator``s the step draws from.
    optimizer: the step's optimizer (kept for the caller: its state is part
    of what the graph holds in place).

    ``replays``, ``eager_steps`` and ``capture_s`` (the capture's seconds)
    say how the steps ran; ``per_replay`` maps each kernel wrapper to its
    launches in one replay."""

    def __init__(self, step: Step, device, generators: Sequence[torch.Generator] = (),
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.step = step
        self.device = resolved_device(device)
        self.generators = list(generators)
        self.optimizer = optimizer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.eager_steps = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.per_replay: Dict[Callable, int] = {}
        self._inputs: Optional[Tuple[torch.Tensor, ...]] = None

    def __call__(self, idx_all: torch.Tensor, lbl_all: torch.Tensor, sil_all: torch.Tensor):
        given = (idx_all, lbl_all, sil_all)
        if any(t.device != self.device for t in given):
            raise ValueError(f"the epoch runs on {self.device}; its inputs are on {[str(t.device) for t in given]}")
        if self._inputs is None:
            steps = idx_all.shape[0]
            self._inputs = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in given)
            self._losses = torch.zeros(steps, dtype=torch.float32, device=self.device)
            self._accs = torch.zeros(steps, dtype=torch.float32, device=self.device)
            self._counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        shapes = [(tuple(t.shape), t.dtype) for t in self._inputs]
        if [(tuple(t.shape), t.dtype) for t in given] != shapes:
            raise ValueError(f"every epoch of one EpochGraph takes inputs of {shapes}")
        for buf, t in zip(self._inputs, given):
            buf.copy_(t)
        self._counter.zero_()
        steps = idx_all.shape[0]
        if self.device.type == "cuda":
            self._run_graph(steps)
        else:
            for _ in range(steps):
                self._one_step()
        return self._losses.clone(), self._accs.clone()

    def _one_step(self):
        c = self._counter
        idx, lbl, sil = (t.index_select(0, c)[0] for t in self._inputs)
        loss, acc = self.step(idx, lbl, sil)
        self._losses.index_copy_(0, c, loss.reshape(1).to(torch.float32))
        self._accs.index_copy_(0, c, acc.reshape(1).to(torch.float32))
        c.add_(1)

    def _run_graph(self, steps: int):
        done = 0
        if self.graph is None:
            n = min(steps, max(0, WARMUP_STEPS - self.eager_steps))
            if n:
                current = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    for _ in range(n):
                        self._one_step()
                current.wait_stream(side)
                self.eager_steps += n
                done = n
            if done == steps:
                return
            self._capture()
        for _ in range(steps - done):
            self.graph.replay()
        self.replays += steps - done
        for wrapper, n in self.per_replay.items():
            wrapper.launches += n * (steps - done)

    def _capture(self):
        """Capture one step (it does not run: the first replay takes it)."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = {w: w.captured for w in _build.WRAPPERS}
        t0 = time.perf_counter()
        # thread_local: another thread's CUDA calls (NCCL's watchdog, a
        # prefetch thread) do not invalidate the capture
        with torch.cuda.device(self.device), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._one_step()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.per_replay = {w: w.captured - n for w, n in before.items() if w.captured != n}
        self.graph = graph
