"""Request lifecycle for the continuous-batching serving engine.

A ``Request`` is one user's generation job: a prompt (tokens, or embeds
for frontend-stub archs) plus a token budget.  Its life is a strict
state machine —

    QUEUED ──admit──▶ PREFILLING ──insert──▶ DECODING ──last token──▶ FINISHED

mirroring the paper's residency policy at request granularity: admission
triggers the prompt upload + prefill (advancedload of the request's
only bulk input), decoding moves nothing but the per-step token, and the
generated tokens are fetched back in one lazy batched download when the
request retires (delegatestore).

Timestamps are recorded at every transition so the load generator can
report end-to-end latency (``t_finish - arrival_s``), queueing delay,
and time-to-first-token without instrumenting the engine.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestState"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


_LEGAL = {
    RequestState.QUEUED: (RequestState.PREFILLING,),
    RequestState.PREFILLING: (RequestState.DECODING,),
    RequestState.DECODING: (RequestState.FINISHED,),
    RequestState.FINISHED: (),
}


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token array — or a (L, d_model) float
    array for ``input_embeds`` archs.  ``max_new_tokens`` counts the
    prefill's first sampled token, matching ``launch.serve``'s ``gen``.
    """
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0

    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    tokens: Optional[np.ndarray] = None   # filled at retirement
    t_admit: Optional[float] = None       # QUEUED -> PREFILLING
    t_first_token: Optional[float] = None  # PREFILLING -> DECODING
    t_finish: Optional[float] = None      # DECODING -> FINISHED

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt)
        if self.prompt.ndim not in (1, 2) or self.prompt.shape[0] < 1:
            raise ValueError(
                f"request {self.rid}: prompt must be (L,) tokens or "
                f"(L, d) embeds with L >= 1, got {self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        """Prompt + generation budget — the admission-queue unit for the
        max-batch-tokens budget (every admitted token eventually owns a
        KV/state slot position)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.arrival_s

    # -- transitions --------------------------------------------------------
    def _to(self, new: RequestState) -> None:
        if new not in _LEGAL[self.state]:
            raise RuntimeError(
                f"request {self.rid}: illegal transition "
                f"{self.state.value} -> {new.value}")
        self.state = new

    def to_prefilling(self, now: float) -> None:
        self._to(RequestState.PREFILLING)
        self.t_admit = now

    def to_decoding(self, slot: int, now: float) -> None:
        self._to(RequestState.DECODING)
        self.slot = slot
        self.t_first_token = now

    def to_finished(self, now: float) -> None:
        self._to(RequestState.FINISHED)
        self.t_finish = now

    def retire(self, tokens: np.ndarray) -> None:
        """Attach the fetched generation (called at the lazy batched
        download, after ``to_finished``)."""
        assert self.state is RequestState.FINISHED, self.state
        assert tokens.shape[0] == self.max_new_tokens, (
            tokens.shape, self.max_new_tokens)
        self.tokens = np.asarray(tokens)

    def record(self) -> dict:
        """JSON-friendly per-request metrics row."""
        return {
            "rid": self.rid,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "arrival_s": self.arrival_s,
            "t_admit": self.t_admit,
            "t_first_token": self.t_first_token,
            "t_finish": self.t_finish,
            "latency_s": self.latency_s,
            "state": self.state.value,
        }
