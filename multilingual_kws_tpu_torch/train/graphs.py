"""CUDA graphs of the port's device programs: a resident training epoch
(``EpochGraph``) and the inference programs (``ProgramGraphs``).

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
- Two process-wide counters: ``captures``, every capture by an
  ``EpochGraph`` or a ``ProgramGraphs``, and ``kept``, the graphs alive now
  (one added a capture, one taken away when a graph is freed: a program's
  eviction of a key, or its owner's end). Each capture is the span
  ``graphs.capture``, each eager warm-up before one ``graphs.warmup``
  (``utils/profiling.annotate``), and an epoch's replays ``graphs.wait``:
  the host waits on the device there, since a replay blocks once CUDA's
  launch queue is full (a pretraining step's graph holds some 3,800
  kernels), so the device's idle there is the graph's own.

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

The JAX package's other device programs are ``jax.jit`` functions compiled
once per input shape: the inference entry points
(``train/finetune._cached_predict``, the engine's predict,
``analysis/distance_filtering.make_embedding_fn``, the bench's steps), the
per-step training programs (``make_pretrain_step``'s and
``make_finetune_step``'s step and evaluate, the fused resident step, the
dataset's train, resident-train and eval transforms, validation),
``kmeans_fit`` and the frontend's entry points (``features``,
``features_from_int16``, ``stream_features``).
``ProgramGraphs`` is their counterpart: one CUDA graph per key (the
arguments' shapes, dtypes and devices, the generators they draw from, the
addresses of the modules' parameters and buffers and of the optimizer's
state), captured on the key's second call, after one eager call, and
replayed from then on; ``module_program`` caches one per module and method,
as ``_cached_predict`` caches one per model, and ``serve`` gives the
callable that the inference entry points return. A program is never called
inside another capture: an epoch's step is the program's eager function,
``program.fn``. ``disable_graphs()`` runs every program eagerly, as
``jax.disable_jit()`` runs jitted functions.

The frontend's entry points (``ops/micro_torch.MicroFrontendTorch``) are
programs of their own that code inside another program or an epoch step
also calls: there (``inside_program()``) they run their eager function,
which the enclosing graph records, as a jitted function called inside
another jitted function is inlined. A program can run on a device of its
own, whatever device its arguments lie on, and can read some tensor
arguments in place (``resident``: a corpus bank, keyed by its storage like
a weight, never copied into a static input).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .. import exact_float32
from ..ops import _build
from ..utils.profiling import annotate

# eager steps before the capture; one makes every lazy allocation and
# one-off call of the step (Adam's state, the kernels' attributes, the
# tables, NCCL's communicator), and each is a real step
WARMUP_STEPS = 1

# every capture in this process, and the graphs alive now
captures = 0
kept = 0


def _track(graph) -> None:
    """Count a new graph in ``captures`` and ``kept``; its finalizer takes
    it out of ``kept`` when it is freed."""
    global captures, kept
    captures += 1
    kept += 1
    weakref.finalize(graph, _release)


def _release() -> None:
    global kept
    kept -= 1


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
        loss, acc = _inside(self.step, idx, lbl, sil)
        self._losses.index_copy_(0, c, loss.reshape(1).to(torch.float32))
        self._accs.index_copy_(0, c, acc.reshape(1).to(torch.float32))
        c.add_(1)

    def _run_graph(self, steps: int):
        done = 0
        if self.graph is None:
            n = min(steps, max(0, WARMUP_STEPS - self.eager_steps))
            if n:
                on_side_stream(self.device, lambda: [self._one_step() for _ in range(n)])
                self.eager_steps += n
                done = n
            if done == steps:
                return
            self._capture()
        with annotate("graphs.wait"):
            for _ in range(steps - done):
                self.graph.replay()
        self.replays += steps - done
        count_replays(self.per_replay, steps - done)

    def _capture(self):
        """Capture one step (it does not run: the first replay takes it)."""
        self.graph, _, self.per_replay, self.capture_s = capture(self._one_step, self.device,
                                                                 generators=self.generators)


def on_side_stream(device: torch.device, run: Callable):
    """``run()`` on a side stream that waits for the current stream, which
    then waits for it: the eager warm-up before a capture (PyTorch's CUDA
    graph notes), whose one-off allocations and set-up stay off the stream
    that later replays."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with annotate("graphs.warmup"), torch.cuda.stream(side):
        out = run()
    current.wait_stream(side)
    return out


def capture(run: Callable, device: torch.device, pool=None, generators: Sequence[torch.Generator] = ()):
    """(graph, what ``run()`` returned, {kernel wrapper: launches one replay
    adds}, the capture's seconds): ``run`` captured as a CUDA graph on
    ``device``, in ``pool`` (a ``torch.cuda.graph_pool_handle()``; None: a
    pool of its own), with ``generators`` registered. A captured call does
    not run: the first replay runs it."""
    with annotate("graphs.capture"):
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = {w: w.captured for w in _build.WRAPPERS}
        t0 = time.perf_counter()
        # thread_local: another thread's CUDA calls (NCCL's watchdog, a
        # prefetch thread) do not invalidate the capture
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = run()
        torch.cuda.synchronize(device)
    _track(graph)
    per_replay = {w: w.captured - n for w, n in before.items() if w.captured != n}
    return graph, out, per_replay, time.perf_counter() - t0


def count_replays(per_replay: Dict[Callable, int], replays: int) -> None:
    """Add ``replays`` replays' captured launches to each wrapper's
    ``launches``."""
    for wrapper, n in per_replay.items():
        wrapper.launches += n * replays


# keys a program keeps, dropped least recently used first: the JAX
# package's ``lru_cache(maxsize=8)`` of jitted predicts
MAX_SHAPES = 8

# set inside ``disable_graphs()``
_GRAPHS_OFF = contextvars.ContextVar("graphs_off", default=False)
# set while a program's or an epoch step's function runs
_INSIDE = contextvars.ContextVar("inside_program", default=False)


def inside_program() -> bool:
    """Whether the caller runs inside a program's or an epoch step's
    function (its eager call, its capture, or its plain run on the CPU),
    where another program must not be called: code that runs both there
    and outside, as the frontend's entry points do, calls its eager
    function there, and the enclosing graph records it."""
    return _INSIDE.get()


def _inside(fn: Callable, *args):
    """``fn(*args)`` with ``inside_program()`` true."""
    token = _INSIDE.set(True)
    try:
        return fn(*args)
    finally:
        _INSIDE.reset(token)


@contextlib.contextmanager
def disable_graphs():
    """Inside the block every ``ProgramGraphs`` call runs its function
    eagerly, on the current stream, and keeps no key: the counterpart of
    ``jax.disable_jit()``, for an eager run of an entry point beside its
    graphed one (the same calls, the same draws). Epochs (``EpochGraph``)
    are not affected."""
    token = _GRAPHS_OFF.set(True)
    try:
        yield
    finally:
        _GRAPHS_OFF.reset(token)


class _Graphed:
    """One key's program: no graph after its eager call; then the graph,
    its static arguments (a generator argument as it is) and outputs, the
    launches one replay adds, and for a training step the gradients the
    graph writes."""

    __slots__ = ("graph", "inputs", "outputs", "per_replay", "grads")

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.outputs = None
        self.per_replay: Dict[Callable, int] = {}
        self.grads: list = []


def _weights(module: torch.nn.Module, into: list) -> list:
    """Append the training flag and the parameters' and buffers' addresses
    of ``module`` and its submodules to ``into``."""
    into.append(module.training)
    into.extend(0 if t is None else t.data_ptr() for t in module._parameters.values())
    into.extend(0 if t is None else t.data_ptr() for t in module._buffers.values())
    for child in module._modules.values():
        if child is not None:
            _weights(child, into)
    return into


def _arg_key(a):
    """A tensor argument's shape, dtype and device; a generator's identity
    (the graph draws from the generator it was captured with); None."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype, a.device
    if isinstance(a, torch.Generator):
        return "generator", id(a)
    if a is None:
        return None
    raise TypeError(f"a program takes tensors, generators and None, not {type(a).__name__}")


def _map_tensors(fn: Callable, out):
    """``out`` (a tensor, or a tuple, list or dict of tensors) with ``fn``
    applied to each tensor."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: fn(t) for k, t in out.items()}
    return type(out)(fn(t) for t in out)


class ProgramGraphs:
    """``program(*args)``: ``fn(*args)``, on a card as one CUDA graph per
    key, the way ``jax.jit`` keeps one executable per input shape.

    fn: tensors, ``torch.Generator``s and None -> a tensor, or a tuple, list
    or dict of tensors, on the device, with no host sync and no
    shape-dependent branch it does not take again for the same shapes.
    modules: the ``nn.Module``s whose weights ``fn`` reads (held by weak
    references: the program does not keep them alive). optimizer: for a
    training step, the optimizer ``fn`` steps. generators: the generators
    ``fn`` draws from besides its generator arguments. train: the modules'
    mode (``module.train(train)``) set before each call; None leaves it.
    device: where every call runs, whatever device the arguments lie on
    (None: the modules' device, without parameters the first argument's).
    resident: the positions of tensor arguments read in place, which must
    lie on the program's device (a corpus bank).

    - The key is the tensor arguments' shapes, dtypes and devices, the
      generator arguments' identities, and the training flag and
      ``data_ptr()`` of every parameter and buffer of ``modules`` and of
      every tensor of the optimizer's state. An in-place update (an
      optimizer step, ``copy_``, ``load_state_dict``) keeps the key, and the
      replay reads the new weights; new storage (``.to()``,
      ``load_state_dict(assign=True)``, a swap of ``.data``, new optimizer
      state) gives a new key and drops the old weights' graphs, so a graph
      never replays against storage that was freed.
    - A resident argument is keyed like a weight, by its ``data_ptr()``
      (and its shape, dtype and device): the graph reads it where it lies,
      so an in-place edit keeps the key and the replay reads the edit, and
      new storage is a new key that drops the old storage's graphs. It is
      never copied: a graph holds a reference to what it reads for as long
      as the graph lives.
    - A key's first call runs eagerly, on a side stream: the warm-up
      (cuDNN's choice of algorithm, the kernels' lazy build, the frontend's
      tables, the optimizer's lazy state, a process group's communicator),
      so a shape seen once never pays for a capture. The key it is kept
      under is taken after that call, once the optimizer's state exists.
      The second call captures, in one private memory pool that the
      program's graphs share, and replays; later calls copy their tensor
      arguments but the resident ones into the graph's static inputs (from
      any device: a host array is uploaded into them) and replay. Every call takes its step
      once, in order, as an eager loop takes it. The outputs are fresh
      tensors, cloned out of the graph's memory before the next replay can
      overwrite it; replays run in turn on the current stream.
    - The generators (``generators`` and the generator arguments) are
      registered with each graph: a replay draws from each generator's
      offset at the time and moves it on by what the eager call takes
      (``CUDAGraph.register_generator_state``), so graphed draws are the
      eager ones. After a replay of a training step the parameters'
      ``.grad`` are the gradients it wrote.
    - At most ``max_shapes`` keys are kept, dropped least recently used
      first.
    - Launches of a kernel wrapper inside the capture count in its
      ``captured``; each replay adds them to its ``launches``.
    - There is no fallback: on a card a capture or a replay that fails
      raises. A program called inside another program's or an epoch step's
      function raises (an ``EpochGraph``'s step calls ``fn``; see
      ``inside_program``).

    On the CPU there is no graph: every call is ``fn``, and the keys and
    their order are kept as on a card. ``eager_calls``,
    ``captures``, ``replays`` and ``capture_s`` (seconds, summed) say how
    the calls ran."""

    def __init__(self, fn: Callable, modules: Sequence[torch.nn.Module] = (), max_shapes: int = MAX_SHAPES,
                 optimizer: Optional[torch.optim.Optimizer] = None, generators: Sequence[torch.Generator] = (),
                 train: Optional[bool] = None, device=None, resident: Sequence[int] = ()):
        self.fn = fn
        self._modules = [weakref.ref(m) for m in modules]
        self.max_shapes = max_shapes
        self.optimizer = optimizer
        self.generators = list(generators)
        self.train = train
        self._device = device
        self.resident = frozenset(resident)
        self._graphed: "OrderedDict[tuple, _Graphed]" = OrderedDict()
        self._pool = None
        self.eager_calls = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def _live_modules(self):
        mods = [ref() for ref in self._modules]
        if any(m is None for m in mods):
            raise RuntimeError("a module of this program has been freed")
        return mods

    def key(self, *args) -> tuple:
        """The key a call on ``args`` runs under."""
        weights = []
        for m in self._live_modules():
            _weights(m, weights)
        if self.optimizer is not None:
            weights.extend(t.data_ptr() for state in self.optimizer.state.values()
                           for t in state.values() if isinstance(t, torch.Tensor))
        weights.extend(args[i].data_ptr() for i in sorted(self.resident))
        return tuple(_arg_key(a) for a in args), tuple(weights)

    def keys(self):
        """The kept keys, least recently used first."""
        return list(self._graphed)

    def device(self, *args) -> torch.device:
        """Where a call on ``args`` runs: the program's device, else the
        modules', else the first argument's."""
        if self._device is not None:
            return resolved_device(self._device)
        for m in self._live_modules():
            for p in m.parameters():
                return resolved_device(p.device)
        return resolved_device(args[0].device)

    def __call__(self, *args):
        if self.train is not None:
            for m in self._live_modules():
                if any(mod.training != self.train for mod in m.modules()):  # reading is cheaper than setting
                    m.train(self.train)
        dev = self.device(*args)
        for i in self.resident:
            if not isinstance(args[i], torch.Tensor) or resolved_device(args[i].device) != dev:
                raise ValueError(f"argument {i} is read in place on {dev}: pass a tensor there, not "
                                 f"{getattr(args[i], 'device', type(args[i]).__name__)}")
        if _GRAPHS_OFF.get():
            return _inside(self.fn, *_on(dev, args))
        if _INSIDE.get():
            raise RuntimeError("a program called inside another program or an epoch step: call its fn")
        prog = self._graphed.get(self.key(*args))
        if prog is None or dev.type != "cuda":
            out = self._eager(dev, args)
            self._keep(self.key(*args))
            return out
        if prog.graph is None:
            self._capture(prog, args, dev)
        for i, (buf, a) in enumerate(zip(prog.inputs, args)):
            if isinstance(buf, torch.Tensor) and i not in self.resident:
                buf.copy_(a)
        prog.graph.replay()
        self.replays += 1
        count_replays(prog.per_replay, 1)
        for p, g in prog.grads:
            if p.grad is not g:
                p.grad = g
        return _map_tensors(torch.Tensor.clone, prog.outputs)

    def _eager(self, dev: torch.device, args):
        self.eager_calls += 1
        if dev.type != "cuda":
            return _inside(self.fn, *_on(dev, args))
        out = on_side_stream(dev, lambda: _inside(self.fn, *_on(dev, args)))
        current = torch.cuda.current_stream(dev)
        # made on the side stream, read on this one
        _map_tensors(lambda t: t.record_stream(current), out)
        return out

    def _keep(self, key: tuple) -> None:
        """Make ``key`` the most recently used; drop the graphs of other
        weights (their storage may be gone) and the least recently used
        beyond ``max_shapes``."""
        if key in self._graphed:
            self._graphed.move_to_end(key)
            return
        for old in [k for k in self._graphed if k[1] != key[1]]:
            del self._graphed[old]
        self._graphed[key] = _Graphed()
        while len(self._graphed) > self.max_shapes:
            self._graphed.popitem(last=False)

    def _capture(self, prog: _Graphed, args, dev: torch.device) -> None:
        with torch.inference_mode(False):  # static inputs take copies whatever mode a later call is in
            prog.inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=dev)
                                if isinstance(a, torch.Tensor) and i not in self.resident else a
                                for i, a in enumerate(args))
        if not any(g.graph is not None for g in self._graphed.values()):
            # a pool lives while a graph uses it: with none left, a new one
            self._pool = torch.cuda.graph_pool_handle()
        generators = self.generators + [a for a in args if isinstance(a, torch.Generator)]
        prog.graph, prog.outputs, prog.per_replay, seconds = capture(lambda: _inside(self.fn, *prog.inputs), dev,
                                                                     pool=self._pool, generators=generators)
        if self.optimizer is not None:
            prog.grads = [(p, p.grad) for group in self.optimizer.param_groups for p in group["params"]]
        self.captures += 1
        self.capture_s += seconds

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the program's memory pool holds (its graphs'
        intermediates and outputs), from the allocator's snapshot; None
        before a capture, or if the snapshot does not name pools."""
        if self._pool is None:
            return None
        segments = torch.cuda.memory_snapshot()
        if any("segment_pool_id" not in s for s in segments):
            return None
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(self._pool))


def _on(dev: torch.device, args) -> tuple:
    """The tensor arguments on ``dev`` (a host array's upload), the others
    as they are."""
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)


class _ProgramCache(dict):
    """The programs cached on a module. A copy of the module
    (``copy.deepcopy``, pickling) starts with none: a program serves the
    module it was made for."""

    def __deepcopy__(self, memo):
        return _ProgramCache()

    def __reduce__(self):
        return _ProgramCache, ()


def module_program(module: torch.nn.Module, method: Callable) -> ProgramGraphs:
    """The ``ProgramGraphs`` of ``method(module, *tensors)``, one per module
    and method, cached on the module (as the JAX package's ``lru_cache``
    keeps one jitted predict per model). It reaches the module through a
    weak reference, so the cache makes no cycle: the module's graphs and
    their pool go with it."""
    cache = module.__dict__.setdefault("_inference_programs", _ProgramCache())
    prog = cache.get(method)
    if prog is None:
        ref = weakref.ref(module)
        prog = cache[method] = ProgramGraphs(lambda *xs: method(ref(), *xs), [module])
    return prog


def _run_program(module: torch.nn.Module, method: Callable, *args: torch.Tensor):
    return module_program(module, method)(*args)


def serve(module: torch.nn.Module, method: Callable) -> Callable:
    """``(*tensors) -> method(module, *tensors)`` through the module's
    program (``module_program``), the module put in eval mode; the callable
    keeps the module alive, as a jitted predict keeps its variables. On a
    card each input shape replays one CUDA graph after one eager call; call
    the module itself for eager calls."""
    return functools.partial(_run_program, module.eval(), method)


def eval_forward(model: torch.nn.Module, specs: torch.Tensor) -> torch.Tensor:
    """The predict programs' body: the model's forward in inference mode,
    float32 computing in float32 (``exact_float32``, so a capture chooses
    the eager call's algorithms)."""
    with torch.inference_mode(), exact_float32():
        return model(specs)


def eval_embed(model: torch.nn.Module, specs: torch.Tensor) -> torch.Tensor:
    """The embedding programs' body: ``model.embed`` as ``eval_forward``
    runs the forward."""
    with torch.inference_mode(), exact_float32():
        return model.embed(specs)
