"""Fault tolerance: heartbeats, straggler detection, restart policy (pure
Python).

A copy of `src/repro/runtime/fault_tolerance.py`: `Heartbeat` (:31),
`StragglerDetector` (:39), `Watchdog` (:79), `RestartPolicy` (:94),
`TrainingAborted` (:100) and `run_with_restarts` (:104). The failure model:
hosts vanish, hosts slow down, and steps hang.

  * every step emits a heartbeat; a `Watchdog` with a step deadline turns
    hangs into restarts-from-checkpoint instead of infinite stalls;
  * a `StragglerDetector` tracks per-host step times against the fleet
    median and flags persistent outliers for replacement;
  * `run_with_restarts` is the supervisor loop: run -> crash/hang -> restore
    the latest committed checkpoint -> continue, with bounded retries. The
    data pipeline is a pure function of (seed, step), so restarts are
    deterministic.

The tests exercise each by injecting failures into a training loop on one
host.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable


@dataclasses.dataclass
class Heartbeat:
    host: int
    step: int
    wall_s: float
    t: float


class StragglerDetector:
    """Flags hosts whose recent step times exceed `threshold` x fleet median
    for at least `patience` consecutive windows (paper §2.4's single-queue
    serialization means one slow host gates the whole step — finding it fast
    matters)."""

    def __init__(self, window: int = 16, threshold: float = 1.5,
                 patience: int = 3):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self._times: dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._strikes: dict[int, int] = defaultdict(int)

    def record(self, hb: Heartbeat) -> None:
        self._times[hb.host].append(hb.wall_s)

    def evaluate(self) -> list[int]:
        """Returns hosts currently flagged as stragglers."""
        import statistics

        medians = {h: statistics.median(t) for h, t in self._times.items() if t}
        if len(medians) < 2:
            return []
        fleet = statistics.median(medians.values())
        flagged = []
        for h, m in medians.items():
            if m > self.threshold * fleet:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                flagged.append(h)
        return flagged


class Watchdog:
    """Step-deadline watchdog: `poke()` every step; `expired()` turns a hang
    into a supervisor-visible failure."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._last = time.monotonic()

    def poke(self) -> None:
        self._last = time.monotonic()

    def expired(self) -> bool:
        return (time.monotonic() - self._last) > self.deadline_s


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 0.0            # real deployments back off; tests don't


class TrainingAborted(RuntimeError):
    pass


def run_with_restarts(
    run_fn: Callable[[int], int],
    *,
    policy: RestartPolicy | None = None,
    on_restart: Callable[[int, BaseException], None] | None = None,
) -> int:
    """Supervisor loop. `run_fn(start_step)` trains from `start_step` (the
    caller restores its own checkpoint inside) and returns the final step;
    raising simulates/relays a node failure. Returns the final step.

    `policy=None` constructs a fresh `RestartPolicy` per call — a dataclass
    instance in the signature default would be one object shared by every
    caller, so a caller mutating e.g. `max_restarts` would silently change
    the retry budget of unrelated supervisors.
    """
    policy = policy if policy is not None else RestartPolicy()
    restarts = 0
    start_step = 0
    while True:
        try:
            return run_fn(start_step)
        except TrainingAborted:
            raise
        except Exception as e:  # noqa: BLE001 — any crash triggers restart
            restarts += 1
            if restarts > policy.max_restarts:
                raise TrainingAborted(
                    f"exceeded {policy.max_restarts} restarts") from e
            if on_restart is not None:
                on_restart(restarts, e)
            if policy.backoff_s:
                time.sleep(policy.backoff_s)
            # run_fn restores from the latest committed checkpoint; we pass
            # -1 to signal "resume from checkpoint".
            start_step = -1
