"""Continuous-batching serving engine (request-level plan executor), the
port of ``src/repro/serve``.

``request``/``queue`` hold the host-side lifecycle and admission policy,
``kvpool`` the fixed-capacity device slot allocator, ``batcher`` the
decode-batch occupancy bookkeeping, ``engine`` the scheduling loop with
shape-bucketed prefills mapped onto the persistent tune cache, and
``load`` the seeded open-loop trace generator the benchmark replays.
``request``, ``queue``, ``load`` and ``batcher`` are numpy / plain Python
copies of the reference's.
"""
from .batcher import JOIN_POLICIES, ContinuousBatcher
from .engine import Engine, ServeRuntime, bucket_len, derive_capacity
from .kvpool import KVSlotPool, cache_bytes_per_slot, infer_batch_axes
from .load import make_trace
from .queue import POLICIES, AdmissionQueue
from .request import Request, RequestState

__all__ = [
    "Request", "RequestState", "AdmissionQueue", "POLICIES",
    "ContinuousBatcher", "JOIN_POLICIES", "KVSlotPool", "infer_batch_axes",
    "cache_bytes_per_slot", "ServeRuntime", "Engine", "derive_capacity",
    "bucket_len", "make_trace",
]
