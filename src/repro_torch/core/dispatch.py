"""Compile-once / dispatch-many on PyTorch: program cache, stream, routing.

After `src/repro/core/dispatch.py`. The pieces this port's serving path uses:

  * `ProgramCache` (reference :68) — programs keyed by function identity,
    argument shapes and dtypes, and options, with hit/miss statistics,
    `is_new_compile_required`, `force_recompilation` and `purge`. The
    reference compiles a miss once (`lowered.compile()`); the port's
    counterpart is a CUDA graph. On the card `compile` returns a
    `GraphProgram`: its first dispatch runs the function eagerly (that run
    is the dispatch's result, and it builds any missing kernel), then
    captures it into a `torch.cuda.CUDAGraph` with a private memory pool;
    every later dispatch copies its per-call inputs into the graph's static
    buffers and replays the graph as one launch. Capture time, and nothing
    else, goes to `CacheStats.compile_seconds`. On the CPU a program is the
    function itself, run eagerly.
  * `DispatchRecord` / `ExecutionStream` (:126, :145) — every model
    dispatch is timed to completion (`torch.cuda.synchronize` on the card)
    and split into `work_s = max(0, wall - floor)`, with the floor measured
    on the stream's device, not taken from a table. A capture's time is
    left out of its dispatch's wall.
  * `AsyncExecutionStream` (:273) — encode -> submit -> sync with a bounded
    in-flight window: `submit` hands programs over without waiting, a
    daemon thread confirms them in submission order through CUDA events.
    It drains its window before a program captures.
  * `KernelRoute` / `KernelDispatcher` (:413, :427) — the routing rule of
    the port: a tensor on a CUDA device routes to the hand-written kernel
    (backend "cuda"), a tensor on the CPU to the kernel's plain PyTorch
    version (backend "torch", reason "cpu requested"). Any other device, and
    a dtype outside a kernel's surface on CUDA, raises: nothing reroutes.
    Routes taken inside a capture are recorded with the graph and counted
    at each replay, as the kernels' launches are (`kernels/native.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import queue as queue_mod
import threading
import time
import weakref
from collections import Counter, deque
from typing import Any, Callable, Iterator

import torch

from repro_torch.core import hal
from repro_torch.tree import flatten_node, leaves_with_path, tree_map


def _spec(x: Any) -> Any:
    """Shape/dtype signature of an argument tree (tensors by shape and dtype,
    containers recursively, other leaves by type). A node registered with
    `tree.register_node` (a packed weight) renders as its type, its static
    data (a packed weight's form) and its children's specs, so program keys
    tell the weight forms apart, as the reference's jit keys do through the
    pytree aux data."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    node = flatten_node(x)
    if node is not None:
        static, children = node
        return ("N", type(x).__name__, static, _spec(children))
    if isinstance(x, dict):
        return ("D", tuple((k, _spec(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_spec(v) for v in x))
    return (type(x).__name__,)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compile_seconds: float = 0.0   # on the card: CUDA-graph capture time only
    captures: int = 0              # graphs captured: misses' first dispatches,
    recaptures: int = 0            # and, of those, new storage of a resident argument
    replays: int = 0               # dispatches that replayed a graph


def _leaves(tree: Any) -> list:
    """The leaves of an argument tree, in the order `tree_map` rebuilds it."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def _on_cuda(args: tuple) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in _leaves(args))


def _bound(t: Any) -> Any:
    """What a graph binds of a resident leaf: a tensor's storage (address,
    shape, strides, dtype), any other value itself."""
    if isinstance(t, torch.Tensor):
        return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
    return ("value", type(t).__name__, repr(t))


@dataclasses.dataclass
class _Graph:
    """One capture of a program: the graph, the per-call static inputs (one
    per argument leaf; None for a resident leaf, bound by storage), the
    output tree's structure and its leaves' sources (a static output, or
    the index of the argument leaf returned), and the launches and routes
    one replay makes."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: Any
    sources: list
    launches: Counter
    routes: Counter


class GraphProgram:
    """A program on the card: captured into a CUDA graph on its first
    dispatch for each binding of its resident arguments, replayed after.

    `per_call` names the arguments (by position) whose values change from
    call to call: token ids, positions, a prefill batch, drafts. Each of
    their tensors is copied into the graph's static input before a replay
    (not when it already is that buffer). Every other argument is resident
    (params, caches, arenas): bound by storage, never copied. A call whose
    resident tensors lie elsewhere (another address, shape, stride or dtype)
    than any capture's gets a capture of its own; it never replays against
    storage it was not captured on.

    A replay overwrites the graph's static outputs: an output that must
    outlive the next dispatch of the same program is read or cloned before
    it. An output that is one of the arguments (a cache written in place)
    comes back as the caller's own tensor.

    The first dispatch of a binding runs the function eagerly on the
    current stream and returns that run's result; then it captures the same
    call on a side stream (global capture mode: the capture executes
    nothing, and any unsafe CUDA call in the process fails it). A failed
    capture or replay raises; nothing reruns eagerly."""

    def __init__(self, fn: Callable, per_call: tuple[int, ...], stats: CacheStats) -> None:
        self.fn = fn
        self.per_call = frozenset(per_call)
        self.stats = stats
        self.capture_seconds = 0.0
        self._graphs: dict[tuple, _Graph] = {}

    def _flat(self, args: tuple) -> tuple[list, list[bool]]:
        leaves, per_call = [], []
        for i, a in enumerate(args):
            more = _leaves(a)
            leaves += more
            per_call += [i in self.per_call] * len(more)
        return leaves, per_call

    @staticmethod
    def _binding(leaves: list, per_call: list[bool]) -> tuple:
        """The resident leaves' storage, and every non-tensor value (a
        capture bakes those in)."""
        return tuple(_bound(t) for t, pc in zip(leaves, per_call)
                     if not pc or not isinstance(t, torch.Tensor))

    def needs_capture(self, *args) -> bool:
        """Would this call capture (no graph is bound to its resident
        storage yet)?"""
        leaves, per_call = self._flat(args)
        return self._binding(leaves, per_call) not in self._graphs

    def release(self) -> None:
        """Drop every graph and its static buffers (the private pools go
        back to the allocator); the next call captures again."""
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()

    def __call__(self, *args):
        leaves, per_call = self._flat(args)
        binding = self._binding(leaves, per_call)
        g = self._graphs.get(binding)
        if g is None:
            return self._run_and_capture(args, leaves, per_call, binding)
        for t, buf in zip(leaves, g.inputs):
            if buf is None:
                continue
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(f"per-call input {tuple(t.shape)} {t.dtype} does not fit "
                                 f"the captured {tuple(buf.shape)} {buf.dtype}")
            if t.data_ptr() != buf.data_ptr() or t.stride() != buf.stride():
                buf.copy_(t)
        g.graph.replay()
        _count_routes(g.routes)
        from repro_torch.kernels import native   # lazy: core imports alone
        native.add_launches(g.launches)
        self.stats.replays += 1
        it = iter(g.sources)
        return tree_map(lambda _: _source(next(it), leaves), g.outputs)

    def _run_and_capture(self, args, leaves, per_call, binding):
        from repro_torch.kernels import native

        out = self.fn(*args)                         # eager: the dispatch's result
        inputs = [t.clone() if pc and isinstance(t, torch.Tensor) else None
                  for t, pc in zip(leaves, per_call)]
        static = [t if buf is None else buf for t, buf in zip(leaves, inputs)]
        cargs = _rebuild(args, static)
        device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        t0 = time.perf_counter()
        # the capture allocates from its own private pool, which cannot take
        # the blocks the general pool caches (the eager run's temporaries,
        # e.g. a widened fp32 head): return those to CUDA first
        torch.cuda.empty_cache()
        # a garbage collection during the capture could destroy another
        # program's graph, a CUDA call the capture forbids (it invalidates it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with native.recording_launches() as launches, _recording_routes() as routes:
                graph, cout = _capture(self.fn, cargs, device)
        finally:
            if collecting:
                gc.enable()
        dt = time.perf_counter() - t0
        self.capture_seconds += dt
        self.stats.compile_seconds += dt
        self.stats.captures += 1
        self.stats.recaptures += bool(self._graphs)
        # an output that is an argument is not held (a resident cache must
        # not outlive its owner through the graph): the replay returns the
        # caller's leaf at that index
        by_id = {id(t): i for i, t in enumerate(static) if isinstance(t, torch.Tensor)}
        sources = [("arg", by_id[id(t)]) if id(t) in by_id else ("out", t)
                   for t in _leaves(cout)]
        self._graphs[binding] = _Graph(graph, inputs, tree_map(lambda _: None, cout),
                                       sources, launches, routes)
        return out


def _source(src: tuple, leaves: list) -> Any:
    """An output leaf at replay: the caller's argument leaf it is, else the
    static output (or non-tensor value) itself."""
    kind, value = src
    return leaves[value] if kind == "arg" else value


def _rebuild(args: tuple, new_leaves: list) -> tuple:
    it = iter(new_leaves)
    return tuple(tree_map(lambda _: next(it), a) for a in args)


def _capture(fn: Callable, args: tuple, device: torch.device):
    """Capture `fn(*args)` into a CUDA graph (its own private memory pool)
    on a side stream (a capture may not run on the default one) that waits
    for the current one; the current stream then waits for the side
    stream. Returns (graph, outputs)."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            out = fn(*args)
        except BaseException:
            _abandon(graph)
            raise
        graph.capture_end()
    current.wait_stream(side)
    return graph, out


def _abandon(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture whose function raised, so the stream leaves capture
    mode; the function's own error is the one raised."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


def _cell_key(cell) -> str:
    """A closure cell in a program key: a plain value by its repr, any other
    object by its type and identity."""
    try:
        v = cell.cell_contents
    except ValueError:                       # an empty cell
        return "<empty>"
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    return f"{type(v).__name__}@{id(v)}"


class ProgramCache:
    """Program cache keyed like the reference's content hash: the same
    function on arguments of the same shapes, dtypes and options resolves to
    the same key; a change of any of them is a new program (a miss). A hit
    returns the stored program, a `GraphProgram` on the card."""

    def __init__(self) -> None:
        self._programs: dict[str, Callable] = {}
        self.stats = CacheStats()

    @staticmethod
    def key(fn: Callable, args_spec: tuple, options: str = "") -> str:
        # bound methods are re-created per attribute access: key on the
        # underlying function + the receiver's identity (the stored program
        # holds the receiver, so the id is not recycled while it lives); a
        # closure keys on what it closes over too (values, or the identity
        # of objects, held by the stored program the same way), so two
        # schedules' programs from one `def` never share an entry
        func = getattr(fn, "__func__", fn)
        receiver = id(getattr(fn, "__self__", None))
        cells = tuple(_cell_key(c) for c in getattr(func, "__closure__", None) or ())
        body = (f"{func.__module__}.{func.__qualname__}@{receiver}{cells}|"
                f"{_spec(args_spec)}|{options}")
        inner = hashlib.sha256(body.encode()).digest()
        return hashlib.sha256(inner).hexdigest()

    def compile(self, fn: Callable, *args_spec, options: str = "",
                per_call: tuple[int, ...] = (),
                force_recompilation: bool = False) -> tuple[Callable, str]:
        """compile-or-hit: returns (program, key). `per_call` names the
        arguments whose values change per dispatch (`GraphProgram`); the rest
        are resident. `force_recompilation` rewrites the entry and counts a
        miss, as the reference's does."""
        key = self.key(fn, args_spec, options)
        if not force_recompilation and key in self._programs:
            self.stats.hits += 1
            return self._programs[key], key
        self.stats.misses += 1
        program = GraphProgram(fn, per_call, self.stats) if _on_cuda(args_spec) else fn
        self._programs[key] = program
        return program, key

    def is_new_compile_required(self, fn: Callable, *args_spec, options: str = "") -> bool:
        return self.key(fn, args_spec, options) not in self._programs

    def purge(self) -> None:
        """Forget every program and release its graphs and their memory."""
        released = False
        for program in self._programs.values():
            if isinstance(program, GraphProgram):
                program.release()
                released = True
        self._programs.clear()
        if released:
            torch.cuda.empty_cache()


@dataclasses.dataclass
class DispatchRecord:
    key: str
    wall_s: float
    work_s: float          # wall minus the measured floor, >= 0
    floor_s: float = 0.0   # the per-dispatch floor charged against this call
    batch: int = 1         # samples this dispatch carried (amortization denom)
    seq: int = 0           # submission index on this stream (total order)
    submit_ts: float = 0.0     # perf_counter when the host handed it over
    complete_ts: float = 0.0   # perf_counter when it was seen complete
    inflight_depth: int = 0    # submissions not yet complete when it was
                               # submitted: 0 on a sync stream, < the window
                               # on an async one
    span: tuple[int, int] | None = None
                               # the prompt tokens [lo, hi) a chunked-prefill
                               # dispatch covered (None for any other)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _capture_seconds(program: Callable) -> float:
    return getattr(program, "capture_seconds", 0.0)


def measure_dispatch_floor(device: str | torch.device = "cuda",
                           n: int = 200) -> dict[str, float]:
    """The per-dispatch floor t0 on `device` (reference :513): the wall time
    of an empty launch plus a synchronize, in a hot loop — the smallest
    command the host can hand the device and see complete."""
    dev = torch.device(device)
    x = torch.zeros(1, device=dev)

    def step():
        x.zero_()
        _sync(dev)

    step()                                     # warm
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    return {"per_call_s": (time.perf_counter() - t0) / n}


class ExecutionStream:
    """One dispatch queue with per-call floor accounting. `execute_sync`
    runs every encoded op in order and times each one to completion, so
    `work_s = max(0, wall - floor)` splits each dispatch into fixed overhead
    and useful work — the split the batching scheduler amortizes."""

    def __init__(self, cache: ProgramCache | None = None, *,
                 device: str | torch.device = "cuda") -> None:
        self.cache = cache or ProgramCache()
        self.device = torch.device(device)
        self.floor_s = measure_dispatch_floor(self.device)["per_call_s"]
        self.records: list[DispatchRecord] = []
        self._encoded: list[tuple[Callable, tuple, str, int, tuple | None]] = []
        self._seq = 0

    def encode_operation(self, program: Callable, args: tuple, key: str = "", *,
                         batch: int = 1, span: tuple[int, int] | None = None) -> None:
        """Queue one program call; `span` tags the prompt tokens a
        chunked-prefill dispatch covers."""
        self._encoded.append((program, args, key, batch, span))

    def execute_sync(self) -> list:
        """Run everything encoded, in order, each to completion. Returns one
        output per encoded op, in encode order."""
        outs = []
        for program, args, key, batch, span in self._encoded:
            captured = _capture_seconds(program)
            t0 = time.perf_counter()
            out = program(*args)
            _sync(self.device)
            t1 = time.perf_counter()
            # a capture is compile time (`CacheStats.compile_seconds`): the
            # record starts after it
            t0 += _capture_seconds(program) - captured
            wall = t1 - t0
            self.records.append(DispatchRecord(
                key, wall, max(0.0, wall - self.floor_s), self.floor_s, batch,
                self._seq, submit_ts=t0, complete_ts=t1, span=span))
            self._seq += 1
            outs.append(out)
        self._encoded.clear()
        return outs

    def total_floor_s(self) -> float:
        return sum(r.floor_s for r in self.records)

    def total_work_s(self) -> float:
        return sum(r.work_s for r in self.records)


@dataclasses.dataclass
class _Inflight:
    """One submitted, unconfirmed dispatch: its record, its outputs, the
    event recorded after it on the card (None on the CPU, where a program
    has finished when it returns), and the completion latch."""

    record: DispatchRecord
    out: Any
    event: Any = None
    returned_ts: float = 0.0
    error: BaseException | None = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


def _drain_loop(stream_ref, drain_q) -> None:
    """Confirm submissions in order: wait on each one's CUDA event (on the
    CPU it completed when it returned), stamp `complete_ts`, retire its
    record. Launches no work. Holds only a weak reference to the stream, so
    a dropped stream (and its finalizer's sentinel) ends the thread. An
    error that surfaces at the event is kept for the next `sync()`."""
    while True:
        h = drain_q.get()
        if h is None:
            return
        t = h.returned_ts
        if h.event is not None and h.error is None:
            try:
                h.event.synchronize()
            except Exception as e:   # a fault of the program, seen at its event
                h.error = e
            t = time.perf_counter()
        stream = stream_ref()
        if stream is None:
            h.done.set()
            return
        r = h.record
        r.complete_ts = t
        r.wall_s = t - r.submit_ts
        r.work_s = max(0.0, r.wall_s - r.floor_s)
        with stream._lock:
            stream.records.append(r)
            if h.error is not None:
                stream._errors.append(h.error)
            stream._pending.remove(h)   # FIFO: h is the leftmost entry
        h.done.set()
        del stream, h, r   # hold nothing while parked on the queue


class AsyncExecutionStream(ExecutionStream):
    """Overlapped dispatch: encode -> submit -> sync, with a bounded window of
    `max_in_flight` unconfirmed submissions (reference :273-395).

    `submit` runs each encoded program without waiting for the device: its
    kernels are queued on the current CUDA stream, and the outputs it returns
    are live tensors that the next encoded program may take as inputs (the
    card runs them in order). An event recorded after each program lets a
    daemon drain thread confirm completions in submission order and stamp
    `complete_ts`, so `wall_s = complete_ts - submit_ts` includes the
    overlap. `sync` is the barrier and re-raises any error a program raised
    or its event reported; `execute_sync` drains first, then keeps the base
    contract. The floor is the one measured on the device."""

    def __init__(self, cache: ProgramCache | None = None, *,
                 device: str | torch.device = "cuda", max_in_flight: int = 2) -> None:
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        super().__init__(cache, device=device)
        self.max_in_flight = max_in_flight
        self._pending: deque[_Inflight] = deque()
        self._errors: list[BaseException] = []
        self._lock = threading.Lock()
        self._drain_q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._drainer: threading.Thread | None = None

    @property
    def in_flight_depth(self) -> int:
        """Submissions handed over and not yet confirmed complete."""
        with self._lock:
            return len(self._pending)

    def _ensure_drainer(self) -> None:
        if self._drainer is None or not self._drainer.is_alive():
            self._drainer = threading.Thread(
                target=_drain_loop, args=(weakref.ref(self), self._drain_q),
                name="stream-drain", daemon=True)
            weakref.finalize(self, self._drain_q.put, None)
            self._drainer.start()

    def _throttle(self) -> None:
        """Block until the in-flight window has a free slot."""
        while True:
            with self._lock:
                if len(self._pending) < self.max_in_flight:
                    return
                oldest = self._pending[0]
            oldest.done.wait()

    def submit(self) -> list:
        """Run every encoded program without waiting for the device. Returns
        the outputs in encode order (None for a program that raised: its
        error surfaces at `sync()`)."""
        self._ensure_drainer()
        outs = []
        for program, args, key, batch, span in self._encoded:
            # no event may be waited on (nor destroyed, by the drain thread
            # dropping the last reference) during a capture: drain first and
            # hold the confirmed submissions until the program returned
            held = self._drain() if isinstance(program, GraphProgram) and \
                program.needs_capture(*args) else []
            self._throttle()
            with self._lock:
                depth = len(self._pending)
            captured = _capture_seconds(program)
            t_sub = time.perf_counter()
            out, event, error = None, None, None
            try:
                out = program(*args)
            except Exception as e:   # kept for sync(), like a device fault
                error = e
            t_sub += _capture_seconds(program) - captured
            del held
            if self.device.type == "cuda" and error is None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            rec = DispatchRecord(key, 0.0, 0.0, self.floor_s, batch, self._seq,
                                 submit_ts=t_sub, inflight_depth=depth, span=span)
            self._seq += 1
            h = _Inflight(rec, out, event, time.perf_counter(), error)
            with self._lock:
                self._pending.append(h)
            self._drain_q.put(h)
            outs.append(out)
        self._encoded.clear()
        return outs

    def _drain(self) -> list[_Inflight]:
        """Wait until every submission is confirmed, raising nothing: errors
        stay for `sync`. Returns the confirmed submissions."""
        with self._lock:
            handles = list(self._pending)
        for h in handles:
            h.done.wait()
        return handles

    def sync(self) -> list:
        """Barrier: wait for every in-flight submission. Returns the outputs
        still in flight, in submission order; re-raises the first error."""
        with self._lock:
            handles = list(self._pending)
        for h in handles:
            h.done.wait()
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]
        return [h.out for h in handles]

    def execute_sync(self) -> list:
        """The base contract: drain the window, then run everything encoded
        in order, each to completion."""
        self.sync()
        return super().execute_sync()

    def close(self) -> None:
        """Drain outstanding work and stop the drain thread."""
        self.sync()
        if self._drainer is not None and self._drainer.is_alive():
            self._drain_q.put(None)
            self._drainer.join(timeout=5.0)
            self._drainer = None


# ---------------------------------------------------------------------------
# Registry-routed kernel dispatch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """One resolved cell of the operation-by-device matrix."""

    kernel: str
    target: str
    dtype: str
    backend: str           # "cuda" | "torch"
    reason: str            # why the plain version ran ("" for the kernel)

    @property
    def native(self) -> bool:
        return self.backend == "cuda"


# open captures' route tallies, innermost last: (dispatcher, route) -> n
_ROUTE_TALLIES: list[Counter] = []


@contextlib.contextmanager
def _recording_routes() -> Iterator[Counter]:
    tally: Counter = Counter()
    _ROUTE_TALLIES.append(tally)
    try:
        yield tally
    finally:
        _ROUTE_TALLIES.pop()


def _count_routes(tally: Counter) -> None:
    for (dispatcher, route), n in tally.items():
        dispatcher.routes[route] += n


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class KernelDispatcher:
    """Route kernel calls by the device of their activation tensor.

    `routes` counts every route taken, by route: the port resolves once per
    call (the reference's log counts traces), so a serving loop makes tens
    of thousands of routes and a bounded log would drop the early ones."""

    def __init__(self, target: hal.Target | None = None) -> None:
        self.target = target or hal.H100
        self.routes: Counter[KernelRoute] = Counter()

    def count(self, route: KernelRoute) -> None:
        """Count one route taken; inside a capture, record it with the graph
        instead (each replay counts it)."""
        if _ROUTE_TALLIES:
            _ROUTE_TALLIES[-1][self, route] += 1
        else:
            self.routes[route] += 1

    def census(self) -> dict[tuple[str, str], int]:
        """Route counts by (kernel, backend)."""
        out: Counter[tuple[str, str]] = Counter()
        for route, n in self.routes.items():
            out[route.kernel, route.backend] += n
        return dict(out)

    def resolve(self, name: str, x: torch.Tensor) -> KernelRoute:
        from repro_torch.kernels import registry   # lazy: core imports alone

        spec = registry.get(name)
        dt = dtype_name(x.dtype)
        if x.device.type == "cpu":
            return KernelRoute(name, self.target.name, dt, "torch",
                               "cpu requested")
        if x.device.type != "cuda":
            raise ValueError(f"{name}: no route for a tensor on {x.device}")
        if x.dtype not in spec.dtypes:
            raise TypeError(f"{name}: dtype {dt} outside the kernel surface "
                            f"{[dtype_name(d) for d in spec.dtypes]}")
        return KernelRoute(name, self.target.name, dt, "cuda", "")
