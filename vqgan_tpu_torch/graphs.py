"""CUDA graphs: a training step, a block of steps or a sampler step,
captured once on the card and replayed.

The port's counterpart of a jitted JAX program (a `lax.scan` over whole
steps included). PyTorch runs eagerly, one host call per kernel, and the
small stage-2 models spend most of each step on the host; a captured graph
replays every kernel of the captured call from one host call.

`ChainStep` and `run_chain` run a sampler's chain of steps: one step
body, run eagerly (the CPU, or `graph=False`) or as the replay of its
captured graph, kept in the sampler's `ChainGraphs` under a key.
`BlockRunner` runs blocks of training steps through the same `ChainStep`:
one step's graph replayed once per step of the block.

`Graphed(fn)` wraps fn(generators, *tensors) -> a tensor or a tuple of
tensors, following PyTorch's documented capture pattern:

- the first call runs fn eagerly on a side stream, as a real call (the
  one-time work happens there: the kernels' shared-memory attribute,
  cuDNN's plans, lazily made state);
- the next call copies its inputs into static buffers, captures fn on them
  into a private memory pool and replays the graph; every later call copies
  its inputs in and replays;
- every call returns copies of the outputs, which the next replay
  overwrites in place.

Random draws: fn draws from the generators it is given. For each caller's
`torch.Generator` the graph holds one of its own, registered with the graph
at capture; a call moves the caller's state (seed and offset) into it,
replays and moves the advanced state back, so a replay draws exactly what
the same eager call would have drawn and leaves the caller's generator
where the eager call would have. A None generator stands for PyTorch's
default one, which every capture registers itself.

Launch accounting (`LaunchRecord`): each kernel wrapper counts a launch in
Python (`CudaKernel.count`), which runs when a graph is captured and not
when it replays. The counts a capture makes are taken back and added again
at every replay, so a captured path counts exactly the launches the eager
path counts.

A capture or replay that fails raises; nothing runs eagerly in its place.
CPU tensors raise `ValueError`: a CPU caller runs its body eagerly.

Collectives: a step body's NCCL collectives (a training step on a mesh)
are captured with it, onto the capture stream; the warm-up call makes
their communicators. A gloo collective, or one staged through host
memory, raises inside a capture (`parallel/comm.py`).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Iterable, Optional, Sequence

import torch

__all__ = ["BlockRunner", "ChainGraphs", "ChainStep", "GraphPool",
           "Graphed", "LaunchRecord", "resolve_graph", "run_chain"]


def _check_cuda(name: str, tensors: Iterable[torch.Tensor]) -> torch.device:
    """The one CUDA device of `tensors`; raises ValueError for a CPU tensor
    or for tensors on several devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: a CUDA graph captures CUDA tensors of one device, got "
            f"{sorted(map(str, devices))}; on the CPU the body runs eagerly")
    return devices.pop()


def _default_counters() -> dict:
    from .kernels import KERNELS

    return KERNELS


class LaunchRecord:
    """The kernel launches that one capture recorded, per counter, added
    again at every replay. A counter has `launches` (an int) and
    `launches_by_shape` ({shape: int}) and counts one launch with
    `count(shape)`, as `kernels.build.CudaKernel` does."""

    def __init__(self, counters: Optional[dict] = None):
        """`counters`: {name: counter}, by default every kernel of the
        port (`kernels.KERNELS`)."""
        counters = _default_counters() if counters is None else counters
        self.names = list(counters)
        self.counters = list(counters.values())
        self.deltas = [{} for _ in self.counters]

    @contextlib.contextmanager
    def capturing(self):
        """Inside the block the wrappers count the launches they record;
        on leaving it those counts are taken back and kept as the deltas
        (a capture launches nothing)."""
        before = [(c.launches, dict(c.launches_by_shape))
                  for c in self.counters]
        try:
            yield
        finally:
            for i, (c, (n, shapes)) in enumerate(zip(self.counters, before)):
                self.deltas[i] = {
                    key: m - shapes.get(key, 0)
                    for key, m in c.launches_by_shape.items()
                    if m != shapes.get(key, 0)}
                c.launches = n
                c.launches_by_shape.clear()
                c.launches_by_shape.update(shapes)

    def replay(self) -> None:
        """Count the recorded launches once more: one replay ran them."""
        for c, delta in zip(self.counters, self.deltas):
            for key, n in delta.items():
                for _ in range(n):
                    c.count(key)

    def per_replay(self) -> dict:
        """{counter name: launches per replay}, counters that launch."""
        return {name: sum(d.values())
                for name, d in zip(self.names, self.deltas) if d}


def _register(graph, generator) -> None:
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a torch.Generator "
            f"with a CUDA graph (CUDAGraph.register_generator_state); the "
            f"captured modes need it")
    register(generator)


def _on_side_stream(device, fn, *args):
    """fn(*args) on a new stream that waits for the current one, which then
    waits for it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    return out


class GraphPool:
    """One private memory pool for several graphs that never run at the
    same time (one stream, one replay after another), made at the first
    capture. Each graph's outputs stay allocated; the intermediates that a
    capture frees are reused by the next capture, so the pool holds about
    the largest graph's intermediates, not their sum."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class Graphed:
    """fn(generators, *tensors) captured once and replayed; see the module
    docstring. `capture_seconds` (the capture and its instantiation) and
    `pool_bytes` (device memory reserved by the capture: what it added to
    the private pool of the graph's intermediates and outputs) are set by
    the capture; `replays` counts the calls that replayed. `pool`, a
    `GraphPool`, shares the pool with other graphs; by default the graph
    has its own."""

    def __init__(self, fn: Callable, *, name: str = "graph",
                 counters: Optional[dict] = None,
                 pool: Optional[GraphPool] = None):
        self.fn = fn
        self.name = name
        self.pool = pool
        self.launches = LaunchRecord(counters)
        self.graph = None
        self.capture_seconds = None
        self.pool_bytes = None
        self.replays = 0
        self._warmed = False
        self._static_in = None
        self._static_out = None
        self._single = False
        self._own = []

    def __call__(self, *inputs: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]] = ()):
        device = _check_cuda(self.name, inputs)
        generators = list(generators)
        if not self._warmed:
            self._warmed = True
            return _on_side_stream(device, self.fn, generators, *inputs)
        if self.graph is None:
            self._capture(device, generators, inputs)
        else:
            self._check_inputs(inputs, generators)
            for static, x in zip(self._static_in, inputs):
                static.copy_(x)
        for own, gen in zip(self._own, generators):
            if own is not None:
                own.set_state(gen.get_state())
        self.graph.replay()
        for own, gen in zip(self._own, generators):
            if own is not None:
                gen.set_state(own.get_state())
        self.launches.replay()
        self.replays += 1
        out = tuple(t.clone() for t in self._static_out)
        return out[0] if self._single else out

    def _check_inputs(self, inputs, generators):
        got = [(tuple(x.shape), x.dtype) for x in inputs]
        want = [(tuple(x.shape), x.dtype) for x in self._static_in]
        if got != want:
            raise ValueError(f"{self.name}: the graph was captured for "
                             f"inputs {want}, got {got}")
        if [g is None for g in generators] != [o is None for o in self._own]:
            raise ValueError(f"{self.name}: the graph was captured with "
                             f"other generators")

    def _capture(self, device, generators, inputs):
        self._static_in = [x.detach().clone() for x in inputs]
        graph = torch.cuda.CUDAGraph()
        self._own = []
        for gen in generators:
            own = None
            if gen is not None:
                own = torch.Generator(device)
                own.set_state(gen.get_state())
                _register(graph, own)
            self._own.append(own)
        # torch.cuda.graph empties the allocator's cache as it enters:
        # empty it first, so that the reserved bytes after the capture,
        # less those before, are the pool's
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with self.launches.capturing():
            with torch.cuda.graph(
                    graph, pool=self.pool.handle() if self.pool else None,
                    capture_error_mode="thread_local"):
                out = self.fn(self._own, *self._static_in)
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self._single = torch.is_tensor(out)
        self._static_out = (out,) if self._single else tuple(out)
        self.graph = graph

    def stats(self) -> dict:
        """Capture seconds, pool bytes, replays and the launches of each
        hand-written kernel per replay."""
        return {"capture_seconds": self.capture_seconds,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "kernel_launches_per_replay": self.launches.per_replay()}


def resolve_graph(graph: Optional[bool], device) -> bool:
    """Whether a sampler on `device` replays CUDA graphs: None gives True
    on the card and False on the CPU; True on the CPU raises ValueError."""
    on_card = torch.device(device).type == "cuda"
    if graph and not on_card:
        raise ValueError(f"graph=True needs the card; the sampler runs on "
                         f"{device}, where its steps run eagerly")
    return on_card if graph is None else bool(graph)


class ChainGraphs(dict):
    """Captured steps (`Graphed`) by key, every one in one `GraphPool`
    (`pool`, by default its own): the steps kept together never run at
    the same time. `latest` holds, per key, the value that a key's graph
    was captured for when that value may change without bound between
    calls (a guide's cond_fn): a new value replaces the key's graph."""

    def __init__(self, pool: Optional[GraphPool] = None):
        super().__init__()
        self.pool = pool or GraphPool()
        self.latest = {}

    def stats(self) -> dict:
        """Each graph's `Graphed.stats()` with its name, and the sums of
        their capture seconds and pool bytes."""
        graphs = [{"name": g.name, **g.stats()} for g in self.values()
                  if g.graph is not None]
        return {"graphs": graphs,
                "capture_seconds": sum(g["capture_seconds"] for g in graphs),
                "pool_bytes": sum(g["pool_bytes"] for g in graphs)}


def _live(tensors: Optional[dict]) -> dict:
    return {k: v for k, v in (tensors or {}).items() if v is not None}


class ChainStep:
    """One step of a chain: body(generators, carry, consts, row) -> a
    {name: tensor} dict (None entries are left out): the next carry, its
    entries of the given carry's names, or with no carry (a block of
    training steps) every entry:

    - carry: what one step hands the next (the image, a self-condition
      estimate, DPM++'s previous denoised);
    - consts: the same tensors at every step (classes, RePaint's ground
      truth and mask, a guide's targets);
    - row: this step's row of the chain's per-step table (times, host
      scalars, given noise; a training block's batch).

    With `graph` False the body runs eagerly. Otherwise each call replays
    the body's CUDA graph (`Graphed`: its first call runs eagerly as the
    warm-up, the second captures), kept in `graphs` under (`key`, the
    names, shapes, dtypes and strides of the tensors, which generators are
    the default one): the key must name every Python value the body reads
    that differs between calls. A value with no bound on its count
    (a guide's cond_fn) goes in `latest` instead: only the graph of the
    latest value is kept. The strides keep a replay in the memory layout
    the eager call computes in (a channels-last image takes other cuDNN
    kernels than a contiguous one, which round otherwise). Drawn noise
    comes from the generators inside the body, so a replay draws what the
    eager call draws."""

    def __init__(self, body: Callable, *, graphs: ChainGraphs, key,
                 graph: bool, name: str = "sampler step", latest=None):
        self.body = body
        self.graphs = graphs
        self.key = key
        self.graph = graph
        self.name = name
        self.latest = latest

    def __call__(self, carry: dict, consts: Optional[dict] = None,
                 row: Optional[dict] = None,
                 generators: Sequence[Optional[torch.Generator]] = ()
                 ) -> dict:
        parts = (_live(carry), _live(consts), _live(row))
        generators = list(generators)
        if not self.graph:
            return _outputs(self.body(generators, *parts), parts[0])
        names = tuple(tuple(p) for p in parts)
        tensors = [t for p in parts for t in p.values()]
        gkey = (self.key, names,
                tuple((tuple(t.shape), t.dtype, t.stride()) for t in tensors),
                tuple(g is None for g in generators))
        step = self.graphs.get(gkey)
        if step is None or self.graphs.latest.get(gkey) != self.latest:
            # a graph for another `latest` is dropped: its pool blocks go
            # back to the pool
            self.graphs.latest[gkey] = self.latest
            step = self.graphs[gkey] = Graphed(
                _flat_body(self.body, names), name=self.name,
                pool=self.graphs.pool)
        out = step(*tensors, generators=generators)
        return dict(zip(step.fn.out_names,
                        (out,) if torch.is_tensor(out) else out))


def _outputs(out: dict, carry: dict) -> dict:
    """A step's returned entries: the carry's names, or with no carry
    every entry that is not None."""
    return {k: out[k] for k in carry} if carry else _live(out)


def _flat_body(body: Callable, names) -> Callable:
    """body over dicts as fn(generators, *tensors) -> a tuple, for
    `Graphed`; `fn.out_names` are the names of the tuple's tensors."""
    def fn(generators, *tensors):
        parts, i = [], 0
        for keys in names:
            parts.append(dict(zip(keys, tensors[i:i + len(keys)])))
            i += len(keys)
        out = _outputs(body(generators, *parts), parts[0])
        fn.out_names = tuple(out)
        return tuple(out.values())

    return fn


class BlockRunner:
    """body(generators, *inputs) -> a tuple of outputs, every input and
    output with the steps on its leading axis, run over blocks of steps:
    eagerly on the CPU, as one call over the block; on the card one step
    (`ChainStep`, the step's inputs as its row) replayed once per step of
    the block, so a block of any length, and the single steps before an
    event, share one graph. The graphs are kept in `graphs`, a
    `ChainGraphs`, under the caller's `key` and the per-step tensors.
    `graph` False runs the body eagerly on the card too (the reference a
    captured run is held against). `pool`, a `GraphPool`, is shared with
    other runners whose graphs never run at the same time; by default the
    runner has its own."""

    def __init__(self, body: Callable, *, name: str = "block",
                 graph: bool = True, pool: Optional[GraphPool] = None):
        self.body = body
        self.name = name
        self.graph = graph
        self.graphs = ChainGraphs(pool)

    def _one(self, generators, carry, consts, row):
        return dict(enumerate(self.body(generators, *row.values())))

    def __call__(self, *inputs: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]] = (),
                 key=()) -> tuple:
        if not self.graph or inputs[0].device.type != "cuda":
            return tuple(self.body(list(generators), *inputs))
        step = ChainStep(self._one, graphs=self.graphs, key=key, graph=True,
                         name=f"{self.name}, one step")
        parts = [step({}, row={str(j): x[i:i + 1]
                               for j, x in enumerate(inputs)},
                      generators=generators)
                 for i in range(inputs[0].shape[0])]
        return tuple(torch.cat(col) for col in
                     zip(*(p.values() for p in parts)))

    def stats(self) -> list:
        """`Graphed.stats()` of each graph, with its name."""
        return [{"name": g.name, **g.stats()} for g in self.graphs.values()]


def run_chain(step: ChainStep, carry: dict, steps: int, *,
              consts: Optional[dict] = None, table: Optional[dict] = None,
              generators: Sequence[Optional[torch.Generator]] = (),
              each: Optional[Callable] = None) -> dict:
    """`steps` calls of `step`, row i of each `table` column ([steps,
    ...]) at step i; `each(carry)` after every step. Returns the last
    carry."""
    table = _live(table)
    for i in range(steps):
        carry = step(carry, consts, {k: v[i] for k, v in table.items()},
                     generators)
        if each is not None:
            each(carry)
    return carry
