"""Continuous batcher: host-side occupancy bookkeeping for the decode batch.

The device steps a FIXED-capacity padded decode batch every iteration;
this class tracks which rows are live, how many tokens each owes, and
when a row finishes — all with plain Python counters, so the decode loop
never downloads anything per step (the engine fetches generated tokens
lazily, in batches, at retirement).

Two join policies:

``continuous``
    a freed / free slot may be (re)filled at ANY step boundary — the
    decode batch stays occupied and short requests never wait out long
    ones (no head-of-line blocking);
``static``
    the legacy batch-serving discipline used as the benchmark baseline:
    new requests may only join when the batch has fully drained, so
    every group runs to its slowest member.
"""
from __future__ import annotations

from typing import Dict, List

from .request import Request

__all__ = ["ContinuousBatcher", "JOIN_POLICIES"]

JOIN_POLICIES = ("continuous", "static")


class ContinuousBatcher:
    def __init__(self, join_policy: str = "continuous"):
        if join_policy not in JOIN_POLICIES:
            raise ValueError(
                f"unknown join policy {join_policy!r}; have {JOIN_POLICIES}")
        self.join_policy = join_policy
        self.active: Dict[int, Request] = {}       # slot -> request
        self._remaining: Dict[int, int] = {}       # slot -> tokens still owed
        self.steps = 0
        self.occupied_row_steps = 0   # sum over steps of live rows

    def __len__(self) -> int:
        return len(self.active)

    @property
    def tokens_in_flight(self) -> int:
        """Admission-budget units currently held by live rows."""
        return sum(r.total_tokens for r in self.active.values())

    def can_join(self) -> bool:
        if self.join_policy == "static":
            return not self.active
        return True

    def join(self, req: Request, slot: int) -> None:
        """Account an admitted request.  The prefill already produced its
        first token, so the row owes ``max_new_tokens - 1`` decode steps
        (a gen=1 request finishes without ever decoding)."""
        assert slot not in self.active, slot
        self.active[slot] = req
        self._remaining[slot] = req.max_new_tokens - 1

    def finished_now(self) -> List[int]:
        """Slots that owe zero further tokens (gen=1 admissions)."""
        return [s for s, n in self._remaining.items() if n <= 0]

    def step(self) -> List[int]:
        """Account one decode step over every live row; returns the slots
        that just produced their final token."""
        self.steps += 1
        self.occupied_row_steps += len(self.active)
        done = []
        for slot in self.active:
            self._remaining[slot] -= 1
            if self._remaining[slot] == 0:
                done.append(slot)
        return done

    def leave(self, slot: int) -> Request:
        """Detach a finished row (its slot goes back to the pool)."""
        req = self.active.pop(slot)
        del self._remaining[slot]
        return req

    def occupancy(self, capacity: int) -> float:
        """Mean fraction of the padded batch doing useful work."""
        if self.steps == 0:
            return 0.0
        return self.occupied_row_steps / (self.steps * capacity)
