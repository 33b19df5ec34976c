"""Compile-once / dispatch-many on PyTorch: program cache, stream, routing.

After `src/repro/core/dispatch.py`. The pieces this port's serving path uses:

  * `ProgramCache` (reference :68) — programs keyed by function identity,
    argument shapes and dtypes, and options, with hit/miss statistics. The
    port runs eagerly, so a "program" is the function itself; the cache
    keeps the reference's compile accounting so the schedulers' program
    counts compare one for one. CUDA graphs arrive in a later change.
  * `DispatchRecord` / `ExecutionStream` (:126, :145) — every model
    dispatch is timed to completion (`torch.cuda.synchronize` on the card)
    and split into `work_s = max(0, wall - floor)`, with the floor measured
    on the stream's device, not taken from a table.
  * `AsyncExecutionStream` (:273) — encode -> submit -> sync with a bounded
    in-flight window: `submit` hands programs over without waiting, a
    daemon thread confirms them in submission order through CUDA events.
  * `KernelRoute` / `KernelDispatcher` (:413, :427) — the routing rule of
    the port: a tensor on a CUDA device routes to the hand-written kernel
    (backend "cuda"), a tensor on the CPU to the kernel's plain PyTorch
    version (backend "torch", reason "cpu requested"). Any other device, and
    a dtype outside a kernel's surface on CUDA, raises: nothing reroutes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue as queue_mod
import threading
import time
import weakref
from collections import Counter, deque
from typing import Any, Callable

import torch

from repro_torch.core import hal
from repro_torch.tree import flatten_node


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


class ProgramCache:
    """Program cache keyed like the reference's content hash: the same
    function on arguments of the same shapes, dtypes and options resolves to
    the same key; a change of any of them is a new program (a miss)."""

    def __init__(self) -> None:
        self._programs: dict[str, Callable] = {}
        self.stats = CacheStats()

    @staticmethod
    def key(fn: Callable, args_spec: tuple, options: str = "") -> str:
        # bound methods are re-created per attribute access: key on the
        # underlying function + the receiver's identity
        func = getattr(fn, "__func__", fn)
        receiver = id(getattr(fn, "__self__", None))
        body = (f"{func.__module__}.{func.__qualname__}@{receiver}|"
                f"{_spec(args_spec)}|{options}")
        inner = hashlib.sha256(body.encode()).digest()
        return hashlib.sha256(inner).hexdigest()

    def compile(self, fn: Callable, *args_spec,
                options: str = "") -> tuple[Callable, str]:
        """compile-or-hit: returns (program, key)."""
        key = self.key(fn, args_spec, options)
        if key in self._programs:
            self.stats.hits += 1
            return self._programs[key], key
        self.stats.misses += 1
        self._programs[key] = fn
        return fn, key


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        self._encoded: list[tuple[Callable, tuple, str, int]] = []
        self._seq = 0

    def encode_operation(self, program: Callable, args: tuple, key: str = "", *,
                         batch: int = 1) -> None:
        self._encoded.append((program, args, key, batch))

    def execute_sync(self) -> list:
        """Run everything encoded, in order, each to completion. Returns one
        output per encoded op, in encode order."""
        outs = []
        for program, args, key, batch in self._encoded:
            t0 = time.perf_counter()
            out = program(*args)
            _sync(self.device)
            t1 = time.perf_counter()
            wall = t1 - t0
            self.records.append(DispatchRecord(
                key, wall, max(0.0, wall - self.floor_s), self.floor_s, batch,
                self._seq, submit_ts=t0, complete_ts=t1))
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
        for program, args, key, batch in self._encoded:
            self._throttle()
            with self._lock:
                depth = len(self._pending)
            t_sub = time.perf_counter()
            out, event, error = None, None, None
            try:
                out = program(*args)
            except Exception as e:   # kept for sync(), like a device fault
                error = e
            if self.device.type == "cuda" and error is None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            rec = DispatchRecord(key, 0.0, 0.0, self.floor_s, batch, self._seq,
                                 submit_ts=t_sub, inflight_depth=depth)
            self._seq += 1
            h = _Inflight(rec, out, event, time.perf_counter(), error)
            with self._lock:
                self._pending.append(h)
            self._drain_q.put(h)
            outs.append(out)
        self._encoded.clear()
        return outs

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
