"""Admission queue for the serving engine.

Holds arrived-but-not-yet-admitted requests and decides, at each step
boundary, which of them may join the running batch.  Two ordering
policies:

``fcfs``
    strict arrival order — the latency-fairness baseline;
``sjf``
    shortest-prompt-first — admits cheap prefills ahead of long ones,
    trading worst-case fairness for decode-batch occupancy (the classic
    serving throughput lever).

Admission is bounded by TWO resources, both supplied by the engine:

* free KV-cache slots (one per request, from ``kvpool``), and
* a **max-batch-tokens budget**: the sum of ``prompt + max_new_tokens``
  over every in-flight request must stay under a token budget the
  engine derives from device-bytes accounting (weight residency bytes
  measured by ``core.residency.DeviceResidency`` + per-token cache
  bytes from ``init_cache`` shapes — see ``engine.derive_capacity``).

A request that does not fit WAITS — it is never dropped and never
OOMs the pool; ``stats()`` reports peak depth so saturation is visible.
"""
from __future__ import annotations

from typing import List

from .request import Request

__all__ = ["AdmissionQueue", "POLICIES"]

POLICIES = ("fcfs", "sjf")


class AdmissionQueue:
    def __init__(self, policy: str = "fcfs", max_batch_tokens: int = 0):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; have {POLICIES}")
        self.policy = policy
        # <= 0 disables the token budget (slots remain the only bound)
        self.max_batch_tokens = int(max_batch_tokens)
        self._items: List[Request] = []
        self._arrived = 0
        self._peak_depth = 0

    def __len__(self) -> int:
        return len(self._items)

    def push(self, req: Request) -> None:
        self._items.append(req)
        self._arrived += 1
        self._peak_depth = max(self._peak_depth, len(self._items))

    def _ordered(self) -> List[Request]:
        if self.policy == "sjf":
            # stable: equal prompt lengths keep arrival order
            return sorted(self._items, key=lambda r: r.prompt_len)
        return list(self._items)

    def pop_admissible(self, free_slots: int,
                       tokens_in_flight: int) -> List[Request]:
        """Remove and return the requests that may be admitted now:
        policy order, one slot each, and (when a budget is set) keeping
        ``tokens_in_flight + sum(total_tokens)`` under the budget.  A
        budget-blocked request blocks everything behind it in policy
        order — admission stays an ordered queue, not a knapsack."""
        admitted: List[Request] = []
        budget = tokens_in_flight
        for req in self._ordered():
            if len(admitted) >= free_slots:
                break
            if (self.max_batch_tokens > 0
                    and budget + req.total_tokens > self.max_batch_tokens):
                break
            admitted.append(req)
            budget += req.total_tokens
        for req in admitted:
            self._items.remove(req)
        return admitted

    def stats(self) -> dict:
        return {
            "policy": self.policy,
            "max_batch_tokens": self.max_batch_tokens,
            "arrived": self._arrived,
            "depth": len(self._items),
            "peak_depth": self._peak_depth,
        }
