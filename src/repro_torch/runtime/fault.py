"""Fault tolerance & straggler mitigation for 1000+-node runs.

The port's own copy of ``src/repro/runtime/fault.py`` (which imports no
JAX, but the port imports nothing of the reference).  The mechanisms are
tested against simulated workers; the coordinator protocol below is what
runs per host:

  * Heartbeat      — every host ticks; the coordinator declares a host dead
                     after ``timeout`` missed ticks.
  * StepWatchdog   — per-step wall-time tracker; hosts slower than
                     ``factor`` × rolling-median are flagged stragglers
                     (on real pods: demote to spare, re-shard, restart from
                     the last checkpoint — the checkpoint format is
                     mesh-agnostic precisely so the survivor set can differ).
  * ElasticController — decides the restart mesh from the live-host set
                     (largest (pod, data, model) grid that divides the
                     survivors) and hands train.py the re-mesh parameters.
  * run_with_retries — in-process supervisor: restarts the train loop from
                     the latest checkpoint on (injected) failures; the
                     restart-equivalence test proves bitwise continuation.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Heartbeat", "StepWatchdog", "ElasticController",
           "run_with_retries", "FaultInjector"]


class Heartbeat:
    def __init__(self, timeout: float = 5.0):
        self.timeout = timeout
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def tick(self, host: str, now: Optional[float] = None) -> None:
        with self._lock:
            self._last[host] = now if now is not None else time.monotonic()

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.monotonic()
        with self._lock:
            return sorted(h for h, t in self._last.items()
                          if now - t > self.timeout)

    def live_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.monotonic()
        with self._lock:
            return sorted(h for h, t in self._last.items()
                          if now - t <= self.timeout)


class StepWatchdog:
    """Flags hosts whose step time exceeds factor × rolling median."""

    def __init__(self, factor: float = 2.0, window: int = 16):
        self.factor = factor
        self.window = window
        self._times: Dict[str, List[float]] = {}

    def record(self, host: str, step_time: float) -> None:
        self._times.setdefault(host, []).append(step_time)
        self._times[host] = self._times[host][-self.window:]

    def stragglers(self) -> List[str]:
        latest = {h: ts[-1] for h, ts in self._times.items() if ts}
        if len(latest) < 2:
            return []
        med = statistics.median(latest.values())
        return sorted(h for h, t in latest.items()
                      if t > self.factor * med)


@dataclasses.dataclass
class ElasticDecision:
    n_hosts: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]


class ElasticController:
    """Pick the restart mesh for a survivor set.  Keeps the model axis fixed
    (TP degree is a model property) and shrinks data/pod parallelism to the
    largest size the survivors support — checkpoints are mesh-agnostic, so
    restore works unchanged."""

    def __init__(self, chips_per_host: int = 4, model_axis: int = 16):
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis

    def decide(self, n_live_hosts: int) -> ElasticDecision:
        chips = n_live_hosts * self.chips_per_host
        model = self.model_axis
        if chips < model:
            raise RuntimeError(
                f"{chips} chips cannot host a {model}-way model axis")
        data = chips // model
        # largest power-of-two data axis for even sharding
        d = 1
        while d * 2 <= data:
            d *= 2
        return ElasticDecision(n_hosts=n_live_hosts,
                               mesh_shape=(d, model),
                               mesh_axes=("data", "model"))


class FaultInjector:
    """Deterministic failure schedule for tests: fail at given steps."""

    def __init__(self, fail_at_steps: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.failures = 0

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected failure at step {step}")


def run_with_retries(train_fn: Callable[[Optional[int]], int],
                     max_restarts: int = 3) -> Tuple[int, int]:
    """Supervise ``train_fn(resume_step) -> final_step``; on failure,
    restart from the latest checkpoint (train_fn reads it itself).
    Returns (final_step, n_restarts)."""
    restarts = 0
    while True:
        try:
            return train_fn(None), restarts
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
