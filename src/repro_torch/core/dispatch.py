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
  * `KernelRoute` / `KernelDispatcher` (:413, :427) — the routing rule of
    the port: a tensor on a CUDA device routes to the hand-written kernel
    (backend "cuda"), a tensor on the CPU to the kernel's plain PyTorch
    version (backend "torch", reason "cpu requested"). Any other device, and
    a dtype outside a kernel's surface on CUDA, raises: nothing reroutes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter
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
            wall = time.perf_counter() - t0
            self.records.append(DispatchRecord(
                key, wall, max(0.0, wall - self.floor_s), self.floor_s, batch,
                self._seq))
            self._seq += 1
            outs.append(out)
        self._encoded.clear()
        return outs

    def total_floor_s(self) -> float:
        return sum(r.floor_s for r in self.records)

    def total_work_s(self) -> float:
        return sum(r.work_s for r in self.records)


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
