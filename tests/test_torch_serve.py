"""The port's serving engine (``repro_torch.serve``, ``launch.serve``,
``benchmarks/port_serve_bench.py``) against the reference's.

Bottom-up, as the reference's ``tests/test_serve.py``: request lifecycle,
admission queue, KV-slot pool (churn, LIFO reuse, double free, leaks,
Griffin's per-leaf batch axes, in-place inserts), batcher, buckets, the
trace generator (the reference's arrays for the same seed); then the
engine end to end: on the same seeded trace with the same weights (the
reference's init, carried across), every request's tokens equal the
reference ``Engine``'s and the port's own standalone greedy decode, for
the three reduced archs (padded buckets, exact buckets, gen = 1,
over-capacity queueing), and for reduced qwen3-moe-30b-a3b (MoE at the
published capacity factor: both engines' bucketed prefills and decode
batches drop the same tokens) and musicgen-large (embeds prompts padded
to the bucket, zero embeds a decode step, codebook 0 sampled).  Tokens are compared for equality; pooled caches
with rtol 1e-5 and atol 1e-5 of the leaf's scale (``test_torch_decode``),
integer leaves equal.  Each test points ``REPRO_TORCH_TUNE_CACHE`` at its
own ``tmp_path``.
"""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import (assert_leaf_close, assert_tree_close,
                               numpy_params)

import repro.serve as ref_serve
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch.configs import get_config, reduced
from repro_torch.core import TorchDeviceBackend
from repro_torch.models import params_from_numpy
from repro_torch.serve import (AdmissionQueue, ContinuousBatcher, Engine,
                               KVSlotPool, Request, RequestState,
                               ServeRuntime, bucket_len, cache_bytes_per_slot,
                               make_trace)
from repro_torch.serve.kvpool import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-14b", "rwkv6-3b", "recurrentgemma-2b")
ENGINE_ARCHS = ARCHS + ("qwen3-moe-30b-a3b", "musicgen-large")
MAX_SEQ = 48
CPU = TorchDeviceBackend("cpu")


@pytest.fixture(autouse=True)
def _port_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port_tc"))


def _tokens(L, seed=0):
    return np.random.default_rng(seed).integers(0, 257, (L,)).astype(np.int32)


def _req(rid, L=8, gen=4, arrival=0.0, seed=None, cls=Request, d=0):
    """A request of an L-token prompt, or of L embeds of width ``d``."""
    seed = seed if seed is not None else rid
    prompt = (np.random.default_rng(seed).standard_normal((L, d))
              .astype(np.float32) if d else _tokens(L, seed))
    return cls(rid=rid, prompt=prompt, max_new_tokens=gen, arrival_s=arrival)


# ---------------------------------------------------------------------------
# Request lifecycle
# ---------------------------------------------------------------------------

class TestRequestLifecycle:
    def test_legal_path(self):
        r = _req(0, gen=2)
        assert r.state is RequestState.QUEUED
        r.to_prefilling(0.1)
        r.to_decoding(slot=3, now=0.2)
        r.to_finished(0.5)
        r.retire(np.zeros((2,), np.int32))
        assert r.slot == 3 and r.latency_s == pytest.approx(0.5)

    def test_illegal_transitions_raise(self):
        r = _req(0)
        with pytest.raises(RuntimeError, match="illegal transition"):
            r.to_decoding(slot=0, now=0.0)
        r.to_prefilling(0.0)
        with pytest.raises(RuntimeError, match="illegal transition"):
            r.to_finished(0.0)

    def test_validation(self):
        with pytest.raises(ValueError, match="max_new_tokens"):
            _req(0, gen=0)
        with pytest.raises(ValueError, match="prompt"):
            Request(rid=0, prompt=np.zeros((0,), np.int32), max_new_tokens=1)

    def test_total_tokens(self):
        assert _req(0, L=8, gen=4).total_tokens == 12


# ---------------------------------------------------------------------------
# Admission queue
# ---------------------------------------------------------------------------

class TestAdmissionQueue:
    @pytest.mark.parametrize("policy,free,want", [
        ("fcfs", 3, [24, 8, 16]), ("sjf", 2, [8, 16])])
    def test_order(self, policy, free, want):
        q = AdmissionQueue(policy)
        for rid, L in enumerate((24, 8, 16)):
            q.push(_req(rid, L=L))
        got = q.pop_admissible(free, 0)
        assert [r.prompt_len for r in got] == want
        assert len(q) == 3 - free              # the rest waits, not dropped

    def test_budget_blocks_in_order(self):
        q = AdmissionQueue("fcfs", max_batch_tokens=30)
        q.push(_req(0, L=8, gen=4))   # 12
        q.push(_req(1, L=20, gen=4))  # 24: 12 + 24 > 30 -> blocks
        q.push(_req(2, L=8, gen=4))   # behind the blocked one: waits too
        got = q.pop_admissible(3, 0)
        assert [r.rid for r in got] == [0]
        assert len(q) == 2
        s = q.stats()
        assert s["arrived"] == 3 and s["peak_depth"] == 3

    def test_slot_bound(self):
        q = AdmissionQueue("fcfs")
        for rid in range(4):
            q.push(_req(rid))
        assert len(q.pop_admissible(2, 0)) == 2

    def test_unknown_policy(self):
        with pytest.raises(ValueError, match="policy"):
            AdmissionQueue("priority")


# ---------------------------------------------------------------------------
# KV-slot pool
# ---------------------------------------------------------------------------

def _model(name="rwkv6-3b"):
    from repro_torch.models import Transformer
    return Transformer(reduced(get_config(name)))


class TestKVSlotPool:
    def test_churn_never_exceeds_capacity(self):
        pool = KVSlotPool(_model(), capacity=3, max_seq=16, device="cpu")
        held = []
        for _ in range(50):
            s = pool.alloc()
            if s is None:
                assert pool.in_use == 3
                pool.free(held.pop(0))
            else:
                held.append(s)
            assert pool.in_use <= 3
        for s in held:
            pool.free(s)
        pool.assert_no_leaks()
        assert pool.stats()["peak_in_use"] == 3
        assert pool.stats()["reused_slots"] > 0

    def test_lifo_reuse(self):
        pool = KVSlotPool(_model(), capacity=4, max_seq=16, device="cpu")
        a, b = pool.alloc(), pool.alloc()
        pool.free(b)
        assert pool.alloc() == b     # the just-freed slot comes back first
        pool.free(a)
        assert pool.alloc() == a

    def test_double_free_raises(self):
        pool = KVSlotPool(_model(), capacity=2, max_seq=16, device="cpu")
        s = pool.alloc()
        pool.free(s)
        with pytest.raises(RuntimeError, match="double free"):
            pool.free(s)

    def test_leak_detection(self):
        pool = KVSlotPool(_model(), capacity=2, max_seq=16, device="cpu")
        pool.alloc()
        with pytest.raises(RuntimeError, match="leak"):
            pool.assert_no_leaks()

    def test_insert_requires_allocated_slot(self):
        m = _model()
        pool = KVSlotPool(m, capacity=2, max_seq=16, device="cpu")
        with pytest.raises(RuntimeError, match="unallocated"):
            pool.insert(m.init_cache(1, 16, device="cpu"), 0, 0)

    @pytest.mark.parametrize("name", ARCHS)
    def test_batch_axes_equal_reference(self, name):
        """The axes the meta-device diff finds are the reference's
        (eval_shape diff); Griffin's differ per leaf."""
        from repro.models import Transformer as RefTransformer
        want = ref_serve.infer_batch_axes(
            RefTransformer(ref_reduced(ref_get_config(name))), 16)
        got = KVSlotPool(_model(name), capacity=2, max_seq=16,
                         device="cpu").batch_axes
        assert got == want
        assert (len(set(got)) > 1) == (name == "recurrentgemma-2b")

    @pytest.mark.parametrize("name", ARCHS)
    def test_bytes_per_slot_equal_reference(self, name):
        from repro.models import Transformer as RefTransformer
        want = ref_serve.cache_bytes_per_slot(
            RefTransformer(ref_reduced(ref_get_config(name))), 16)
        assert cache_bytes_per_slot(_model(name), 16) == want > 0

    @pytest.mark.parametrize("name", ARCHS)
    def test_insert_is_in_place(self, name):
        """The torch counterpart of the reference's donation test: every
        pooled leaf keeps its storage across inserts, and the inserted row
        is the prefill's (cast to the pool's dtype); other rows stay."""
        rt = _runtime(name)
        pool = KVSlotPool(rt.model, capacity=3, max_seq=MAX_SEQ,
                          device="cpu")
        before = [(t.untyped_storage().data_ptr(), t.data_ptr())
                  for t in tree_flatten(pool.cache)[1]]
        for slot, L in ((pool.alloc(), 8), (pool.alloc(), 12)):
            _, cache = rt.prefill_request(_req(slot, L=L, gen=2))
            pool.insert(cache, 0, slot)
        after = [(t.untyped_storage().data_ptr(), t.data_ptr())
                 for t in tree_flatten(pool.cache)[1]]
        assert after == before
        _, new = tree_flatten(cache)
        for got, want, ax in zip(tree_flatten(pool.cache)[1], new,
                                 pool.batch_axes):
            torch.testing.assert_close(got.select(ax, 1),
                                       want.select(ax, 0).to(got.dtype),
                                       rtol=0, atol=0)
        empty = tree_flatten(rt.model.init_cache(3, MAX_SEQ,
                                                 device="cpu"))[1]
        for got, want, ax in zip(tree_flatten(pool.cache)[1], empty,
                                 pool.batch_axes):
            assert torch.equal(got.select(ax, 2), want.select(ax, 2))
        pool.free(0)
        pool.free(1)
        pool.assert_no_leaks()


# ---------------------------------------------------------------------------
# Batcher, buckets, trace
# ---------------------------------------------------------------------------

class TestBatcher:
    def test_continuous_joins_any_time(self):
        b = ContinuousBatcher("continuous")
        b.join(_req(0, gen=3), 0)
        assert b.can_join()

    def test_static_joins_only_when_empty(self):
        b = ContinuousBatcher("static")
        assert b.can_join()
        b.join(_req(0, gen=3), 0)
        assert not b.can_join()
        b.step()
        b.step()
        assert b.leave(0).rid == 0
        assert b.can_join()

    def test_step_counts_down(self):
        b = ContinuousBatcher()
        b.join(_req(0, gen=3), 0)
        b.join(_req(1, gen=1), 1)
        assert b.finished_now() == [1]           # gen=1: done pre-decode
        b.leave(1)
        assert b.step() == [] and b.step() == [0]


def test_bucket_len():
    assert bucket_len(3, 64, exact=False) == 8       # floor
    assert bucket_len(9, 64, exact=False) == 16      # next pow2
    assert bucket_len(16, 64, exact=False) == 16     # exact pow2 kept
    assert bucket_len(60, 64, exact=False) == 64     # capped at max_seq
    assert bucket_len(13, 64, exact=True) == 13      # recurrent: exact
    for L in range(1, 70):
        for exact in (False, True):
            assert bucket_len(L, 64, exact=exact) == \
                ref_serve.bucket_len(L, 64, exact=exact)


class TestLoadGenerator:
    @pytest.mark.parametrize("max_seq", [None, 16])
    def test_equals_reference(self, max_seq):
        """Same seed, same requests: arrivals, prompts and budgets."""
        cfg, ref_cfg = (reduced(get_config("rwkv6-3b")),
                        ref_reduced(ref_get_config("rwkv6-3b")))
        got = make_trace(cfg, n_requests=40, rate_rps=100.0, seed=7,
                         max_seq=max_seq)
        want = ref_serve.make_trace(ref_cfg, n_requests=40, rate_rps=100.0,
                                    seed=7, max_seq=max_seq)
        assert [(r.rid, r.arrival_s, r.max_new_tokens) for r in got] == \
            [(r.rid, r.arrival_s, r.max_new_tokens) for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert a.prompt.dtype == b.prompt.dtype
        assert all(got[i].arrival_s <= got[i + 1].arrival_s
                   for i in range(len(got) - 1))
        if max_seq:
            assert all(r.total_tokens <= max_seq for r in got)


# ---------------------------------------------------------------------------
# Engine end to end
# ---------------------------------------------------------------------------

_RUNTIMES: dict = {}


def _runtime(name, kv_quant=False):
    """The port's runtime on the CPU with the reference's (perturbed)
    weights, bucket cache off; one per (arch, kv_quant) per process."""
    key = (name, kv_quant)
    if key not in _RUNTIMES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_TORCH_TUNE_CACHE", "off")
            _RUNTIMES[key] = ServeRuntime(
                reduced(get_config(name)), max_seq=MAX_SEQ, backend=CPU,
                params=params_from_numpy(numpy_params(name), "cpu"),
                kv_quant=kv_quant)
    return _RUNTIMES[key]


@pytest.fixture(scope="module")
def ref_runtimes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE", "off")
        out = {name: ref_serve.ServeRuntime(
            ref_reduced(ref_get_config(name)), max_seq=MAX_SEQ,
            params=jax.tree.map(jnp.asarray, numpy_params(name)))
            for name in ENGINE_ARCHS}
    for rt in out.values():
        rt.tune = None
    return out


def standalone_decode(rt, req):
    """Per-request greedy decode straight through the port's model:
    ``prefill`` at batch 1 with no padding, then ``decode_step`` (zero
    embeds a step for an embeds arch; codebook 0 sampled)."""
    model, params, cfg = rt.model, rt.params, rt.cfg
    key = "embeds" if cfg.input_embeds else "tokens"

    def sample(logits):
        logits = logits[..., 0, :] if cfg.n_codebooks else logits
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits, cache = model.prefill(
        params, {key: torch.from_numpy(req.prompt[None])},
        max_seq=rt.max_seq)
    cache = model.quantize_cache(cache)
    tok = sample(logits)
    out = [int(tok[0])]
    for i in range(req.max_new_tokens - 1):
        pos = torch.full((1,), req.prompt_len + i, dtype=torch.int32)
        step = ({"embeds": torch.zeros((1, cfg.d_model))}
                if cfg.input_embeds else {"tokens": tok})
        logits, cache = model.decode_step(params, cache, step, pos)
        tok = sample(logits)
        out.append(int(tok[0]))
    return np.array(out, np.int32)


def _mixed(cls=Request, d=0):
    """Lengths across the dense buckets 8, 16 and 32, two gen = 1
    requests, and more requests than the engine's capacity of 3 (token
    prompts, or embeds of width ``d``)."""
    lens = (5, 8, 11, 16, 7, 9, 24, 3)
    gens = (4, 6, 1, 5, 3, 6, 2, 1)
    return [_req(r, L=L, gen=g, cls=cls, d=d)
            for r, (L, g) in enumerate(zip(lens, gens))]


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_engine_tokens_equal_reference_engine(name, ref_runtimes):
    """Same trace, same weights: every request's tokens are the
    reference Engine's, and the port's standalone greedy decode's (for
    MoE, where capacity drops nothing: an unpadded prefill and a batch
    of one keep every token the engine's padded bucket or full batch
    may drop, so its tokens equal the standalone decode's only there)."""
    rt = _runtime(name)
    d = rt.cfg.d_model if rt.cfg.input_embeds else 0
    got = Engine(rt, capacity=3)
    rep = got.run(_mixed(d=d), respect_arrivals=False)
    want = ref_serve.Engine(ref_runtimes[name], capacity=3)
    want.run(_mixed(ref_serve.Request, d=d), respect_arrivals=False)
    assert rep["n_requests"] == 8 and rep["queue"]["peak_depth"] >= 5
    ref_tokens = {r.rid: r.tokens for r in want.completed}
    for r in got.completed:
        np.testing.assert_array_equal(r.tokens, ref_tokens[r.rid],
                                      err_msg=f"rid={r.rid}")
        if not rt.cfg.is_moe:
            np.testing.assert_array_equal(r.tokens, standalone_decode(rt, r),
                                          err_msg=f"rid={r.rid} standalone")


def test_moe_engine_without_drops_equals_standalone_decode():
    """With capacity_factor = n_experts / top_k no bucket or batch drops a
    token (C >= T), so the MoE engine's tokens equal each request's
    standalone decode, as the card's fp32 exactness run holds them."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    rt = ServeRuntime(cfg, max_seq=MAX_SEQ, backend=CPU, params=_runtime(
        "qwen3-moe-30b-a3b").params)
    rt.tune = None
    eng = Engine(rt, capacity=3)
    eng.run(_mixed(), respect_arrivals=False)
    assert len(eng.completed) == 8
    for r in eng.completed:
        np.testing.assert_array_equal(r.tokens, standalone_decode(rt, r),
                                      err_msg=f"rid={r.rid}")


def test_prompt_rank_must_match_the_arch():
    """Token prompts on an embeds arch, or embeds on a token arch, are
    refused before anything runs, as the reference's engine refuses
    them."""
    for name, d in (("musicgen-large", 0), ("qwen2.5-14b", 64)):
        with pytest.raises(ValueError, match="prompt ndim"):
            Engine(_runtime(name), capacity=2).run([_req(0, d=d)])


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-2b"])
def test_kv_quant_engine_equals_standalone_int8_decode(name):
    """An int8 pool: the prefill's float KV is quantized on insert, as the
    standalone decode quantizes it; tokens equal."""
    rt = _runtime(name, kv_quant=True)
    eng = Engine(rt, capacity=3)
    eng.run(_mixed(), respect_arrivals=False)
    kv = eng.pool.cache["attn"] if "attn" in eng.pool.cache \
        else eng.pool.cache
    assert kv["k"].dtype == torch.int8
    for r in eng.completed:
        np.testing.assert_array_equal(r.tokens, standalone_decode(rt, r),
                                      err_msg=f"rid={r.rid}")


def _one_at_a_time(capacity, cls=Request):
    """Four requests whose token budgets admit one at a time: slot 0 is
    reused (LIFO) and, with capacity 2, slot 1 stays idle for 76 decode
    steps, its position running past max_seq (48)."""
    reqs = [_req(r, L=8, gen=20, cls=cls) for r in range(4)]
    return reqs, dict(capacity=capacity, max_batch_tokens=28)


@pytest.mark.parametrize("name", ARCHS)
def test_idle_row_past_max_seq_writes_nothing(name, ref_runtimes):
    """An idle row steps past the end of a full cache: its writes are
    dropped, as JAX drops them.  The live row's pooled cache and tokens
    equal those of a run without the idle row, and the whole pool (the
    idle row included) equals the reference engine's."""
    rt = _runtime(name)
    reqs, kw = _one_at_a_time(2)
    two = Engine(rt, **kw)
    rep = two.run(reqs, respect_arrivals=False)
    assert rep["steps"] == 76 > MAX_SEQ and rep["pool"]["peak_in_use"] == 1
    reqs1, kw1 = _one_at_a_time(1)
    one = Engine(rt, **kw1)
    one.run(reqs1, respect_arrivals=False)
    for a, b in zip(sorted(two.completed, key=lambda r: r.rid),
                    sorted(one.completed, key=lambda r: r.rid)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for path, got, want, ax in zip(*tree_flatten(two.pool.cache),
                                   tree_flatten(one.pool.cache)[1],
                                   two.pool.batch_axes):
        assert_leaf_close(got.select(ax, 0).numpy(),
                          want.select(ax, 0).numpy(), path)
    if name == "qwen2.5-14b":
        # the idle row's positions 0..47 landed, 48..75 were dropped
        idle = two.pool.cache["pos"][:, 1]
        assert torch.equal(idle, torch.arange(MAX_SEQ, dtype=torch.int32)
                           .expand_as(idle))
    ref_reqs, ref_kw = _one_at_a_time(2, ref_serve.Request)
    ref = ref_serve.Engine(ref_runtimes[name], **ref_kw)
    ref.run(ref_reqs, respect_arrivals=False)
    assert_tree_close(two.pool.cache, ref.pool.cache)


def test_griffin_pool_shorter_than_window_raises():
    """A griffin prefill builds a ring of the full local window, a pool
    of max_seq < window holds fewer slots: the reference's insert fails
    (a shape error in its scatter) and so does the port's, with the leaf
    named, before anything is decoded."""
    cfg = reduced(get_config("recurrentgemma-2b"))
    assert cfg.local_window == 32
    rt = ServeRuntime(cfg, max_seq=16, backend=CPU)
    with pytest.raises(ValueError, match="attn/k: prefill row"):
        Engine(rt, capacity=2).run([_req(0, L=8, gen=2)],
                                   respect_arrivals=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE", "off")
        ref = ref_serve.ServeRuntime(ref_reduced(ref_get_config(
            "recurrentgemma-2b")), max_seq=16)
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        ref_serve.Engine(ref, capacity=2).run(
            [_req(0, L=8, gen=2, cls=ref_serve.Request)],
            respect_arrivals=False)


@pytest.mark.parametrize("name,max_seq", [
    ("recurrentgemma-2b", 640), ("qwen2.5-14b", 1000)])
def test_prefill_past_one_chunk_needs_a_chunk_multiple(name, max_seq):
    """A 600-token prompt reaches the prefill as 600 tokens (griffin's
    exact bucket) or as max_seq (a dense bucket capped at a max_seq that
    is not a power of two).  Past one 512-token chunk the prefill's
    blockwise attention needs a multiple of 512: the reference asserts,
    the port raises, before any token is decoded."""
    cfg = reduced(get_config(name))
    rt = ServeRuntime(cfg, max_seq=max_seq, backend=CPU)
    assert rt.bucket_of(600) == (600 if name == "recurrentgemma-2b"
                                 else max_seq)
    with pytest.raises(ValueError, match="chunks do not divide"):
        Engine(rt, capacity=1).run([_req(0, L=600, gen=2)],
                                   respect_arrivals=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TUNE_CACHE", "off")
        ref = ref_serve.ServeRuntime(ref_reduced(ref_get_config(name)),
                                     max_seq=max_seq)
    with pytest.raises(AssertionError, match=rf"\({rt.bucket_of(600)}, 512"):
        ref_serve.Engine(ref, capacity=1).run(
            [_req(0, L=600, gen=2, cls=ref_serve.Request)],
            respect_arrivals=False)


class TestEngineScheduling:
    def test_over_capacity_queues_not_ooms(self):
        reqs = [_req(i, L=8, gen=3) for i in range(7)]
        rep = Engine(_runtime("rwkv6-3b"), capacity=2).run(
            reqs, respect_arrivals=False)
        assert rep["n_requests"] == 7 and rep["dropped"] == 0
        assert rep["pool"]["peak_in_use"] <= 2
        assert rep["queue"]["peak_depth"] >= 5
        assert rep["pool"]["reused_slots"] >= 5

    def test_static_mode_takes_more_steps(self):
        rt = _runtime("rwkv6-3b")
        reqs = [_req(i, L=8, gen=(12 if i % 2 else 2)) for i in range(6)]
        c = Engine(rt, capacity=2, join_policy="continuous").run(
            [_req(r.rid, L=r.prompt_len, gen=r.max_new_tokens)
             for r in reqs], respect_arrivals=False)
        s = Engine(rt, capacity=2, join_policy="static").run(
            reqs, respect_arrivals=False)
        assert s["n_requests"] == c["n_requests"] == 6
        assert s["steps"] > c["steps"]
        assert c["occupancy"] > s["occupancy"]

    def test_token_budget_respected(self):
        reqs = [_req(i, L=8, gen=4) for i in range(4)]      # 12 tokens each
        rep = Engine(_runtime("rwkv6-3b"), capacity=4,
                     max_batch_tokens=25).run(reqs, respect_arrivals=False)
        assert rep["n_requests"] == 4
        assert rep["pool"]["peak_in_use"] <= 2

    def test_oversized_request_rejected(self):
        eng = Engine(_runtime("rwkv6-3b"), capacity=2)
        with pytest.raises(ValueError, match="max_seq"):
            eng.run([_req(0, L=MAX_SEQ, gen=8)])

    def test_p99_throughput_and_residency_reported(self):
        rt = _runtime("rwkv6-3b")
        rep = Engine(rt, capacity=2).run([_req(i, gen=2) for i in range(3)],
                                         respect_arrivals=False)
        assert math.isfinite(rep["latency_p99_s"])
        assert rep["requests_per_s"] > 0 and rep["tokens_per_s"] > 0
        assert rep["fetch_batches"] >= 1   # delegatestore: batched fetches
        # weights uploaded once, their bytes exactly
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(rt.params)[1])
        assert rep["residency"]["weights_h2d_bytes"] == n_bytes

    def test_respects_arrival_times(self):
        reqs = [_req(0, gen=2, arrival=0.0), _req(1, gen=2, arrival=0.05)]
        eng = Engine(_runtime("rwkv6-3b"), capacity=2)
        eng.run(reqs, respect_arrivals=True)
        r1 = next(r for r in eng.completed if r.rid == 1)
        assert r1.t_admit >= 0.05


def test_bf16_weights_travel_as_their_bits():
    """bf16 params cross the numpy-typed residency as an int16 view: the
    device copy is bitwise the host's and the byte count is bf16's."""
    cfg = reduced(get_config("rwkv6-3b"))
    params = params_from_numpy(numpy_params("rwkv6-3b"), "cpu",
                               torch.bfloat16)
    rt = ServeRuntime(cfg, max_seq=16, backend=CPU, params=params)
    got, want = tree_flatten(rt.params)[1], tree_flatten(params)[1]
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w)
               for g, w in zip(got, want))
    assert rt.weights_bytes == sum(2 * t.numel() for t in want)


# ---------------------------------------------------------------------------
# Shape buckets ↔ persistent tune cache
# ---------------------------------------------------------------------------

class TestBucketTuneCache:
    def test_warm_runtime_measures_nothing(self):
        """A fresh runtime in the same (isolated) cache dir finds every
        bucket already measured: repeated traffic is pure cache hits."""
        cfg = reduced(get_config("rwkv6-3b"))
        reqs = lambda: [_req(i, L=8, gen=2) for i in range(3)]  # noqa: E731
        rt1 = ServeRuntime(cfg, max_seq=16, seed=0, backend=CPU)
        assert rt1.tune is not None
        Engine(rt1, capacity=2).run(reqs(), respect_arrivals=False)
        assert rt1.tune_measurements == 1          # one bucket, one measure
        assert rt1._buckets == {8: "measured"}

        rt2 = ServeRuntime(cfg, max_seq=16, seed=0, backend=CPU)
        Engine(rt2, capacity=2).run(reqs(), respect_arrivals=False)
        assert rt2.tune_measurements == 0          # warm: zero measurements
        assert rt2.tune_hits >= 3
        assert rt2._buckets == {8: "cached"}

    def test_fingerprint_varies_with_bucket(self):
        rt = _runtime("rwkv6-3b")
        assert rt._bucket_fingerprint(8) != rt._bucket_fingerprint(16)


# ---------------------------------------------------------------------------
# Entry points, and the rule on the CPU
# ---------------------------------------------------------------------------

class TestServeOneShot:
    @pytest.mark.parametrize("name", ["musicgen-large", "arctic-480b"])
    def test_embeds_and_moe_archs(self, name):
        """One-shot serving of the embeds/codebook arch and the MoE arch
        with its dense branch: one greedy token a request a step."""
        from repro_torch.launch.serve import serve
        out = serve(reduced(get_config(name)), batch=2, prompt_len=6,
                    gen=3, device="cpu")
        assert out["generated"].shape == (2, 3)
        assert out["generated"].dtype == np.int32
        assert out["decode_tok_s"] > 0.0

    def test_gen1_reports_sane_metrics(self):
        from repro_torch.launch.serve import serve
        out = serve(reduced(get_config("rwkv6-3b")), batch=2, prompt_len=4,
                    gen=1, device="cpu")
        assert out["generated"].shape == (2, 1)
        assert out["decode_tok_s"] == 0.0
        assert math.isfinite(out["tokens_per_s"])
        total = out["prefill_s"] + out["decode_s"]
        assert out["tokens_per_s"] == pytest.approx(2 / total, rel=1e-6)

    def test_gen2_decode_rate_positive(self):
        from repro_torch.launch.serve import serve
        out = serve(reduced(get_config("rwkv6-3b")), batch=2, prompt_len=4,
                    gen=2, device="cpu")
        assert out["generated"].shape == (2, 2)
        assert out["decode_tok_s"] > 0.0


def test_main_engine_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rep = main(["--arch", "rwkv6-3b", "--reduced", "--engine", "--backend",
                "cpu", "--n-requests", "6", "--capacity", "2",
                "--rate", "1e6"])
    assert rep["n_requests"] == 6 and rep["pool"]["in_use"] == 0
    assert "[serve.engine] 6 requests" in capsys.readouterr().out


def test_main_engine_embeds_arch_on_cpu(capsys):
    """``launch.serve --engine`` on musicgen-large: the trace's prompts
    are embeds, every request finishes."""
    from repro_torch.launch.serve import main
    rep = main(["--arch", "musicgen-large", "--reduced", "--engine",
                "--backend", "cpu", "--n-requests", "6", "--capacity", "2",
                "--rate", "1e6"])
    assert rep["n_requests"] == 6 and rep["pool"]["in_use"] == 0
    assert "[serve.engine] 6 requests" in capsys.readouterr().out


def test_port_serve_bench_quick_invariants(tmp_path):
    """Both modes finish everything, p99 finite, zero leaks, the warm run
    measures nothing (no speedup gate at this size)."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import port_serve_bench
    finally:
        sys.path.pop(0)
    out = tmp_path / "bench.json"
    rows = port_serve_bench.main(["--quick", "--backend", "cpu", "--arch",
                                  "rwkv6-3b", "--n-requests", "8",
                                  "--max-seq", "32", "--out", str(out)])
    row = rows[0]
    assert row["n_requests"] == 20 and row["warm_tune_measurements"] == 0
    assert row["pool"]["in_use"] == 0
    assert math.isfinite(row["continuous"]["latency_p99_s"])
    assert math.isfinite(row["static"]["latency_p99_s"])
    assert out.exists()


def test_port_serve_bench_embeds_arch(tmp_path):
    """The bench's warm-up builds embeds prompts for an ``input_embeds``
    arch, as the reference's does: musicgen-large runs both modes."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import port_serve_bench
    finally:
        sys.path.pop(0)
    rows = port_serve_bench.main(["--quick", "--backend", "cpu", "--arch",
                                  "musicgen-large", "--n-requests", "6",
                                  "--max-seq", "32", "--out",
                                  str(tmp_path / "bench.json")])
    assert rows[0]["warm_tune_measurements"] == 0
    assert rows[0]["pool"]["in_use"] == 0


@pytest.mark.parametrize("entry", ["runtime", "main"])
def test_default_entry_points_need_a_card(entry):
    """No card: the default backend raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    cfg = reduced(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "runtime":
            ServeRuntime(cfg, max_seq=16)
        else:
            from repro_torch.launch.serve import main
            main(["--arch", "rwkv6-3b", "--reduced", "--engine"])
