"""Continuous-batching serving engine: request-level plan executor.

The port of ``src/repro/serve/engine.py``.  The engine runs ONE
device-resident decode batch of fixed capacity and streams requests
through it:

    arrivals ─▶ AdmissionQueue ─▶ prefill (stream 1, shape-bucketed)
                                      │ insert row (in place, stream 0)
                                      ▼
                   ┌──────── decode batch (capacity C) ────────┐
                   │  every step: ONE decode over all C rows   │
                   │  (stream 0); finished rows retire at      │
                   │  step boundaries                          │
                   └───────────────┬───────────────────────────┘
                                   ▼
                  lazy batched token download ─▶ slot recycled

Residency follows the paper end to end: weights are uploaded once
through ``DeviceResidency`` and never move again (noupdate); admission
uploads only the request's prompt (advancedload — the single bulk input
it owns); the decode loop carries tokens/positions/output buffer ON
DEVICE, so steady-state host↔device traffic is zero; generated tokens
come back in one batched fetch per retirement flush (delegatestore).

The reference's three jitted bodies (decode, admit, park) are plain
methods here that write their (donated, in the reference) arguments in
place, eagerly.  Two logical streams of the ``TorchDeviceBackend``: 0
runs decode, inserts and admission writes, 1 runs prompt uploads,
prefills and the token download.  CUDA orders nothing across streams,
so each hand-over is explicit (``_hand_over``): the consuming stream
waits on an event recorded on the producing one, and every handed-over
tensor is ``record_stream``-ed there, so the caching allocator cannot
give its memory to the producer's next allocation while the consumer
still reads it.

Shape buckets & the plan cache: prompts are right-padded to power-of-two
buckets (exact lengths for recurrent archs, where padding would corrupt
the carried state) so repeated traffic reuses a handful of prefill
shapes.  Each bucket maps onto a persistent ``TuneCache`` entry keyed by
(cfg, backend fingerprint, bucket dims): the first time a bucket is seen
across ALL processes it is measured once (blocking), and every later run
looks it up and stays on the asynchronous path with zero measurements.

Under a ``torch.profiler`` the engine records a span (``repro_torch.trace``)
around each ``ServeRuntime.prefill_request`` and ``.decode`` call.

An MoE layer's expert capacity is shared by every token of a prefill
bucket (its padding included) and by every row of a decode step (idle
rows too), so where capacity drops tokens the engine's tokens can rightly
differ from a batch-1 decode's; with ``capacity_factor = n_experts /
top_k`` nothing drops and they are equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import trace
from ..core.backend import TorchDeviceBackend, get_backend
from ..core.residency import DeviceResidency
from ..core.tunecache import (COST_MODEL_VERSION, _sha, backend_fingerprint,
                              default_cache)
from ..models import Transformer
from ..models.attention import drop_rows_set
from .batcher import ContinuousBatcher
from .kvpool import KVSlotPool, cache_bytes_per_slot, tree_flatten
from .queue import AdmissionQueue
from .request import Request, RequestState

__all__ = ["ServeRuntime", "Engine", "derive_capacity", "bucket_len"]


def bucket_len(prompt_len: int, max_seq: int, *, exact: bool) -> int:
    """Padded prompt length for a shape bucket: next power of two (min 8),
    capped at ``max_seq``.  ``exact`` archs (recurrent state) get their
    true length — padding would pollute the carried state."""
    if exact:
        return prompt_len
    return min(max(8, 1 << (prompt_len - 1).bit_length()), max_seq)


def derive_capacity(model, max_seq: int, device_bytes: int,
                    weights_bytes: int) -> int:
    """Decode-batch capacity from a device-bytes budget: whatever is left
    after resident weights, divided by one slot's cache footprint."""
    per_slot = cache_bytes_per_slot(model, max_seq)
    return max(1, (device_bytes - weights_bytes) // max(per_slot, 1))


def _host_leaf(t: torch.Tensor) -> np.ndarray:
    """A param as the numpy array the residency uploads.  numpy has no
    bfloat16, so a bf16 leaf travels as its bits (an int16 view, the same
    bytes) and is viewed back as bf16 on the device."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _unflatten(paths: List[str], leaves: List[Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


class ServeRuntime:
    """Machinery shared by engines (and by benchmark modes, so
    continuous-vs-static comparisons run the same resident params):
    resident params, the bucketed prefill, the whole-batch decode, the
    admission row writes, and the bucket↔tunecache bookkeeping.

    ``backend`` is a ``TorchDeviceBackend`` (None: the torch backend on
    ``cuda:0``, which raises without a card; ``TorchDeviceBackend("cpu")``
    runs on the host).  ``params`` is a tree of tensors on any device (the
    model's seeded init when None); they are uploaded through the
    residency layer whatever device they are on.  ``kv_quant`` serves
    from an int8 KV pool."""

    def __init__(self, cfg, *, max_seq: int, backend: Any = None,
                 params: Any = None, seed: int = 0, kv_quant: bool = False):
        self.cfg = cfg
        self.max_seq = int(max_seq)
        be = get_backend(backend)
        if not isinstance(be, TorchDeviceBackend):
            raise TypeError(f"ServeRuntime needs a TorchDeviceBackend, got "
                            f"{type(be).__name__}")
        # two logical streams: 0 = decode compute, 1 = prefill + fetches
        self.be = be.variant(n_streams=max(be.n_streams, 2))
        self.device = self.be.device
        self.model = Transformer(cfg, kv_quant=kv_quant)
        self.exact_buckets = cfg.layer_pattern in ("rwkv", "griffin")

        # weights resident once, through the instrumented residency layer
        if params is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            params = self.model.init(gen, device=self.device)
        paths, leaves = tree_flatten(params)
        self.residency = DeviceResidency(backend=self.be)
        for i, leaf in enumerate(leaves):
            self.residency.put_host(f"w{i:04d}", _host_leaf(leaf))
        t0 = time.perf_counter()
        for i in range(len(leaves)):
            self.residency.prefetch(f"w{i:04d}")   # advancedload, async
        # every later stream reads the weights: one wait, at start-up
        self.residency.wait()
        self.weights_h2d_s = time.perf_counter() - t0
        self.params = _unflatten(paths, [
            self.residency.device_value(f"w{i:04d}").view(leaf.dtype)
            for i, leaf in enumerate(leaves)])
        self.weights_bytes = self.residency.stats.h2d_bytes

        # bucket -> "measured" | "cached"; persisted across processes via
        # the tune cache (None when REPRO_TORCH_TUNE_CACHE is off)
        self.tune = default_cache()
        self._buckets: Dict[int, str] = {}
        self.tune_measurements = 0
        self.tune_hits = 0

    # -- streams -------------------------------------------------------------
    def on_stream(self, stream: int):
        """Context that runs the enclosed launches on logical ``stream``."""
        s = self.be.torch_stream(stream)
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def _hand_over(self, tensors, src: int, dst: int) -> None:
        """Order logical stream ``dst`` after the work enqueued so far on
        ``src``, which produced ``tensors``, and keep their memory from
        being reused before ``dst`` has read them.  A no-op on the CPU."""
        s_src, s_dst = self.be.torch_stream(src), self.be.torch_stream(dst)
        if s_src is None or s_src == s_dst:
            return
        ev = torch.cuda.Event()
        ev.record(s_src)
        s_dst.wait_event(ev)
        for t in tensors:
            t.record_stream(s_dst)

    # -- device bodies (write their arguments in place) ----------------------
    @torch.no_grad()
    def decode(self, cache, tok, pos, out_buf, gen_idx) -> None:
        """One step for the WHOLE padded batch, on stream 0.  Inactive rows
        are stepped too: a full cache drops their writes past its end (as
        JAX drops an out-of-bounds index), an output row whose cursor is
        at ``gen_cap`` drops its token, and their cache rows are dead until
        the next admission's insert overwrites them.  ``input_embeds``
        archs step on zero embeds, as the reference's engine does (its
        frontend is a stub), and every codebook arch samples codebook 0."""
        C, gen_cap = out_buf.shape
        with self.on_stream(0):
            if self.cfg.input_embeds:
                step_in = {"embeds": torch.zeros(
                    (C, self.cfg.d_model), dtype=torch.float32,
                    device=out_buf.device)}
            else:
                step_in = {"tokens": tok}
            logits, _ = self.model.decode_step(self.params, cache, step_in,
                                               pos)
            ntok = torch.argmax(self._first_codebook(logits),
                                dim=-1).to(torch.int32)
            rows = torch.arange(C, device=out_buf.device)
            drop_rows_set(out_buf, rows, gen_idx, ntok, gen_cap)
            gen_idx.add_((gen_idx < gen_cap).to(gen_idx.dtype))
            pos.add_(1)
            tok.copy_(ntok)

    @torch.no_grad()
    def admit(self, logits, tok, pos, out_buf, gen_idx, slot: int,
              p0: int) -> None:
        """Write one admitted row's metadata on stream 0: first sampled
        token (argmax of the prefill's real-last-token logits, computed on
        the device — no host sync at admission), next decode position,
        output cursor."""
        with self.on_stream(0):
            t0 = torch.argmax(self._first_codebook(logits[0])).to(
                torch.int32)
            tok[slot] = t0
            pos[slot] = p0
            out_buf[slot, 0] = t0
            gen_idx[slot] = 1

    def _first_codebook(self, logits):
        """The logits greedy sampling reads: codebook 0's for codebook
        archs ((..., n_codebooks, vocab) -> (..., vocab))."""
        return logits[..., 0, :] if self.cfg.n_codebooks else logits

    def park(self, park_buf, out_buf, slot: int, idx: int) -> None:
        """Copy a finished row's tokens into the park buffer on the device
        (stream 0), so its slot can be reused WITHOUT a host sync."""
        with self.on_stream(0):
            park_buf[idx].copy_(out_buf[slot])

    def fetch(self, park_buf) -> np.ndarray:
        """delegatestore: download the park buffer on stream 1, after the
        parks enqueued on stream 0."""
        self._hand_over([park_buf], 0, 1)
        return self.be.download(park_buf, stream=1)

    # -- bucketed prefill ----------------------------------------------------
    def bucket_of(self, prompt_len: int) -> int:
        return bucket_len(prompt_len, self.max_seq,
                          exact=self.exact_buckets)

    def _bucket_fingerprint(self, padded: int) -> str:
        return _sha({
            "cost_model_version": COST_MODEL_VERSION,
            "cfg": dataclasses.asdict(self.cfg),
            "backend": backend_fingerprint(self.be),
            "bucket": {"padded_len": padded, "max_seq": self.max_seq},
        })

    @torch.no_grad()
    def _prefill(self, req: Request, padded: int):
        """Upload the padded prompt (tokens, or fp32 embeds for
        ``input_embeds`` archs) and run the prefill, both on stream 1; the
        cache comes back in the pool's layout."""
        L = req.prompt_len
        if self.cfg.input_embeds:
            key, buf = "embeds", np.zeros((1, padded, self.cfg.d_model),
                                          np.float32)
        else:
            key, buf = "tokens", np.zeros((1, padded), np.int32)
        buf[0, :L] = req.prompt
        prompt = self.be.upload(buf, stream=1)
        last_pos = self.be.upload(np.asarray([L - 1], np.int32), stream=1)
        with self.on_stream(1):
            logits, cache = self.model.prefill(
                self.params, {key: prompt}, max_seq=self.max_seq,
                last_pos=last_pos)
            cache = self.model.quantize_cache(cache)
        return logits, cache

    def prefill_request(self, req: Request):
        """Pad to the request's bucket, run the prefill on logical stream 1,
        and return (last-real-token logits, cache tree), handed over to
        stream 0.  Cold buckets are measured once (blocking) and stored in
        the persistent tune cache; warm buckets stay fully asynchronous."""
        padded = self.bucket_of(req.prompt_len)
        state = self._buckets.get(padded)
        measure = False
        if state is None:
            slot = f"serve--{self.cfg.name}--p{padded}"
            fp = self._bucket_fingerprint(padded)
            hit = self.tune.lookup(slot, fp) if self.tune else None
            if hit is not None:
                self._buckets[padded] = "cached"
                self.tune_hits += 1
            else:
                measure = True
        else:
            self.tune_hits += 1
        t0 = time.perf_counter()
        logits, cache = self._prefill(req, padded)
        if measure:
            s1 = self.be.torch_stream(1)
            if s1 is not None:
                s1.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.tune_measurements += 1
            self._buckets[padded] = "measured"
            if self.tune:
                self.tune.store(slot, fp, {"prefill_ms": ms,
                                           "padded_len": padded})
        self._hand_over([logits] + tree_flatten(cache)[1], 1, 0)
        return logits, cache


class Engine:
    """The scheduling loop: admission, continuous decode, lazy
    retirement."""

    def __init__(self, runtime: ServeRuntime, *, capacity: int,
                 join_policy: str = "continuous", policy: str = "fcfs",
                 max_batch_tokens: Optional[int] = None):
        self.rt = runtime
        self.capacity = int(capacity)
        if max_batch_tokens is None:
            max_batch_tokens = self.capacity * runtime.max_seq
        self.pool = KVSlotPool(runtime.model, self.capacity, runtime.max_seq,
                               device=runtime.device)
        self.queue = AdmissionQueue(policy, max_batch_tokens)
        self.batcher = ContinuousBatcher(join_policy)
        self.completed: List[Request] = []
        self.fetch_batches = 0

    # -- internals -----------------------------------------------------------
    def _admit_one(self, req: Request, now: float) -> None:
        req.to_prefilling(now)
        slot = self.pool.alloc()
        assert slot is not None   # pop_admissible was bounded by free_count
        with trace.span(trace.SERVE_PREFILL, rid=req.rid):
            logits, cache = self.rt.prefill_request(req)
        with self.rt.on_stream(0):
            self.pool.insert(cache, 0, slot)
        self.rt.admit(logits, self._tok, self._pos, self._out, self._gidx,
                      slot, req.prompt_len)
        req.to_decoding(slot, now)
        self.batcher.join(req, slot)

    def _finish(self, slot: int, now: float) -> None:
        """Retire a row at a step boundary: copy its tokens into the park
        buffer DEVICE-SIDE (async, no sync) and recycle the slot at once —
        the host never waits on a finished request mid-run."""
        req = self.batcher.leave(slot)
        req.to_finished(now)
        idx = self._n_fetched + len(self._parked)
        self.rt.park(self._park_buf, self._out, slot, idx)
        self._parked.append(req)
        self.pool.free(slot)

    def _flush_retired(self, t0: float) -> None:
        """delegatestore: ONE download covers every request finished since
        the last flush; each request's tokens reach the host there
        (``Request.t_delivered``, counted from the run's start ``t0``)."""
        if not self._parked:
            return
        buf = self.rt.fetch(self._park_buf)
        now = time.perf_counter() - t0
        self.fetch_batches += 1
        for idx, req in enumerate(self._parked, start=self._n_fetched):
            req.retire(np.asarray(buf[idx, :req.max_new_tokens]), now)
            self.completed.append(req)
        self._n_fetched += len(self._parked)
        self._parked = []

    # -- run -----------------------------------------------------------------
    def run(self, requests: List[Request], *,
            respect_arrivals: bool = True) -> Dict[str, Any]:
        rt, cfg = self.rt, self.rt.cfg
        for r in requests:
            want = 2 if cfg.input_embeds else 1
            if r.prompt.ndim != want:
                raise ValueError(
                    f"request {r.rid}: prompt ndim {r.prompt.ndim} for "
                    f"{'embeds' if cfg.input_embeds else 'token'} arch")
            if r.total_tokens > rt.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt+gen {r.total_tokens} exceeds "
                    f"max_seq {rt.max_seq}")
            if (self.queue.max_batch_tokens > 0
                    and r.total_tokens > self.queue.max_batch_tokens):
                raise ValueError(
                    f"request {r.rid}: {r.total_tokens} tokens can never "
                    f"fit the batch budget {self.queue.max_batch_tokens}")
        if not requests:
            self._parked, self._n_fetched = [], 0
            return self._report(0.0)

        C, dev = self.capacity, rt.device
        gen_cap = max(r.max_new_tokens for r in requests)
        i32 = torch.int32
        with rt.on_stream(0):
            self._tok = torch.zeros((C,), dtype=i32, device=dev)
            self._pos = torch.zeros((C,), dtype=i32, device=dev)
            self._out = torch.zeros((C, gen_cap), dtype=i32, device=dev)
            # gen_idx == gen_cap ⇒ row inactive: its writes are dropped
            self._gidx = torch.full((C,), gen_cap, dtype=i32, device=dev)
            self._park_buf = torch.zeros((len(requests), gen_cap), dtype=i32,
                                         device=dev)
        self._parked: List[Request] = []
        self._n_fetched = 0

        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        i, t0 = 0, time.perf_counter()
        while i < len(pending) or len(self.queue) or self.batcher.active:
            now = time.perf_counter() - t0
            while i < len(pending) and (not respect_arrivals
                                        or pending[i].arrival_s <= now):
                self.queue.push(pending[i])
                i += 1

            if (len(self.queue) and self.batcher.can_join()
                    and self.pool.free_count > 0):
                for req in self.queue.pop_admissible(
                        self.pool.free_count, self.batcher.tokens_in_flight):
                    self._admit_one(req, time.perf_counter() - t0)
                now = time.perf_counter() - t0
                for slot in self.batcher.finished_now():   # gen == 1
                    self._finish(slot, now)

            if self.batcher.active:
                with trace.span(trace.SERVE_DECODE):
                    rt.decode(self.pool.cache, self._tok, self._pos,
                              self._out, self._gidx)
                done = self.batcher.step()
                if done:
                    now = time.perf_counter() - t0
                    for slot in done:
                        self._finish(slot, now)
            elif i < len(pending) and not len(self.queue):
                time.sleep(2e-4)   # idle: next arrival not due yet

        self._flush_retired(t0)   # delegatestore: one download for all
        wall = time.perf_counter() - t0
        self.pool.assert_no_leaks()
        return self._report(wall)

    def _report(self, wall: float) -> Dict[str, Any]:
        done = self.completed
        assert all(r.state is RequestState.FINISHED for r in done)
        # due arrival -> tokens on the host (all at the end of run())
        deliver = np.array([r.t_delivered - r.arrival_s for r in done])
        gen_tokens = sum(r.max_new_tokens for r in done)
        rt = self.rt
        return {
            "n_requests": len(done),
            "dropped": 0,
            "wall_s": wall,
            "requests_per_s": len(done) / max(wall, 1e-9),
            "tokens_per_s": gen_tokens / max(wall, 1e-9),
            "gen_tokens": gen_tokens,
            "delivery_p50_s": float(np.percentile(deliver, 50))
            if len(deliver) else float("nan"),
            "delivery_p99_s": float(np.percentile(deliver, 99))
            if len(deliver) else float("nan"),
            "steps": self.batcher.steps,
            "occupancy": self.batcher.occupancy(self.capacity),
            "join_policy": self.batcher.join_policy,
            "capacity": self.capacity,
            "fetch_batches": self.fetch_batches,
            "queue": self.queue.stats(),
            "pool": self.pool.stats(),
            "tune": {
                "measurements": rt.tune_measurements,
                "hits": rt.tune_hits,
                "buckets": dict(rt._buckets),
                "persistent": rt.tune is not None,
            },
            "residency": {
                "weights_h2d_bytes": rt.weights_bytes,
                "h2d_transfers": rt.residency.stats.h2d_transfers,
                "elided": rt.residency.stats.elided,
            },
        }
