"""The serving window.

Set-up builds the port's ``ServeRuntime`` over the benchmark's seeded
weights (``TimedRuntime``, below) and warms each prompt length of the
cell's mix and the decode step at the cell's capacity through a
throw-away ``Engine``.  The window is one ``Engine(...).run(requests,
respect_arrivals=True)`` over the requests due in ``seconds`` (open loop:
arrivals do not wait for the engine), run to its end.

The engine synchronises nothing inside ``run()`` and hands tokens to the
host only when it returns, so token times are CUDA events:
``TimedRuntime`` records one on stream 0 right after each ``admit`` (the
request's first token, made on the device) and each ``decode`` (one
token for every live row), and a pair on stream 1 around each
``prefill_request``, which also says which request the next ``admit`` is
for.  It calls the program's methods unchanged and adds no
synchronisation.  A request of n tokens admitted after d decode calls has
its last token at decode call d + n - 2.  Events are read after the
window, against an anchor event recorded at a known host time.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serve.engine import ServeRuntime

from .. import devicetrace, traffic
from ..program import arch, check_layout
from ..reference import full_fp32, make_params, model_for
from .common import (free, on_cuda, peak_bytes, profiler, reset_peak, sync,
                     verdict, warm_profiler)

# the traced spans (start as a share of the window, seconds, with the
# host's ops): the device alone first (busy, idle, kernels), then a
# shorter one with the host's ops (the causes of the idle gaps).  Both
# slow the host and back up the queue after them, so a traced run's
# host and event readings (queue wait, prefill, decode step) are taken
# before the first span starts.
TRACE_SPANS = ((0.75, 3.0, False), (0.9, 1.5, True))


class Clock:
    """Marks on a logical stream of the runtime: CUDA events on the card,
    host times on the CPU (where every launch has finished on return)."""

    def __init__(self, rt):
        self.rt, self.cuda = rt, on_cuda(rt.device)
        self.h0, self.ev0 = 0.0, None

    def mark(self, stream: int):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.rt.be.torch_stream(stream))
        return ev

    def anchor(self) -> None:
        sync(self.rt.device)
        self.h0 = time.perf_counter()
        self.ev0 = self.mark(0)
        sync(self.rt.device)

    def host_s(self, m) -> float:
        """A mark as a host time (``time.perf_counter``'s clock)."""
        if not self.cuda:
            return m
        return self.h0 + self.ev0.elapsed_time(m) / 1e3


class TimedRuntime(ServeRuntime):
    """``ServeRuntime`` with event marks after its calls (see the module
    docstring); ``on_decode`` runs after each decode's mark."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.clock = Clock(self)
        self.on_decode = None
        self.reset()

    def reset(self) -> None:
        self.t0_cands: List[float] = []
        self.prefills: List[tuple] = []     # (rid, host call, ev0, ev1)
        self.first: Dict[int, tuple] = {}   # rid -> (decodes before, mark)
        self.decodes: List[tuple] = []      # (admits before, mark)
        self._cur = None

    def prefill_request(self, req):
        now = time.perf_counter()
        self.t0_cands.append(now - req.t_admit)
        e0 = self.clock.mark(1)
        out = super().prefill_request(req)
        self.prefills.append((req.rid, now, e0, self.clock.mark(1)))
        self._cur = req.rid
        return out

    def admit(self, *args, **kw):
        super().admit(*args, **kw)
        self.first[self._cur] = (len(self.decodes), self.clock.mark(0))

    def decode(self, *args, **kw):
        super().decode(*args, **kw)
        self.decodes.append((len(self.first), self.clock.mark(0)))
        if self.on_decode is not None:
            self.on_decode()


def _requests(dicts):
    from repro_torch.serve import Request
    return [Request(rid=d["rid"], prompt=d["prompt"],
                    max_new_tokens=d["max_new_tokens"],
                    arrival_s=d["arrival_s"]) for d in dicts]


def _engine(rt, eng):
    from repro_torch.serve import Engine
    return Engine(rt, capacity=eng["capacity"],
                  join_policy=eng["join_policy"], policy=eng["policy"])


class Setup:
    def __init__(self, c: dict, seed: int, dev):
        from repro_torch.core.backend import TorchDeviceBackend
        cfg, work = c["cfg"], c["work"]
        self.c, self.dev, self.eng = c, dev, work["engine"]
        params = make_params(cfg, seed, dev, getattr(torch, cfg["dtype"]))
        a = arch(cfg)
        from repro_torch.models import Transformer
        check_layout(Transformer(a), params)
        backend = None if on_cuda(dev) else TorchDeviceBackend("cpu")
        self.rt = TimedRuntime(a, max_seq=self.eng["max_seq"],
                               backend=backend, params=params)
        del params
        free(dev)
        # every prompt length of the mix once, and the decode step at the
        # cell's capacity: the shapes the window uses, and no others
        rng = np.random.default_rng(0)
        warm = [{"rid": i, "arrival_s": 0.0, "max_new_tokens": 2,
                 "prompt": rng.integers(0, cfg["vocab"], L).astype(np.int32)}
                for i, (L, _) in enumerate(work["traffic"]["prompt_lens"])]
        _engine(self.rt, self.eng).run(_requests(warm),
                                       respect_arrivals=False)
        warm_profiler(dev)
        sync(dev)

    def window(self, reqs: List[dict], seconds: float, trace: bool) -> dict:
        rt, dev = self.rt, self.dev
        rt.reset()
        reset_peak(dev)
        eng = _engine(rt, self.eng)
        profs, spans, on = [], [], {}
        if trace:
            profs = [profiler(dev, host_ops=h) for _, _, h in TRACE_SPANS]

            def on_decode():
                i = len(spans)
                if i == len(TRACE_SPANS):
                    return
                now = time.perf_counter()
                a, length, _ = TRACE_SPANS[i]
                if not on and now - rt.t0_cands[0] >= a * seconds:
                    profs[i].start()
                    on["t"] = now
                elif on and now - on["t"] >= length:
                    profs[i].stop()
                    spans.append((on.pop("t"), now))
            rt.on_decode = on_decode
        rt.clock.anchor()
        t_host = time.perf_counter()
        eng.run(_requests(reqs), respect_arrivals=True)
        sync(dev)
        wall = time.perf_counter() - t_host
        if trace:
            rt.on_decode = None
            if on:
                profs[len(spans)].stop()
                spans.append((on.pop("t"), time.perf_counter()))
        got = profs[:len(spans)] + [None, None]
        cut = rt.t0_cands[0] + TRACE_SPANS[0][0] * seconds if trace \
            else float("inf")
        times = self._times(reqs, {r.rid for r in eng.completed}, seconds,
                            cut)
        done = {r.rid: r for r in eng.completed}
        return {"done": done, "wall_s": wall, "prof": got[0],
                "prof_ops": got[1],
                "trace_window_s": self._untraced(spans, times),
                **times, "peak_bytes": peak_bytes(dev)}

    def _untraced(self, spans, times):
        """The first traced span's length had it not been traced: the
        tracer slows the host (tens of µs a launch), not the device, so
        the span is scaled by the mean decode step outside the traced
        spans over the mean inside the first."""
        if not spans:
            return None
        a, b = spans[0]
        inside, outside = [], []
        for t0, t1 in times["decode_step_at"]:
            if a <= t0 and t1 <= b:
                inside.append(t1 - t0)
            elif not any(x <= t1 and t0 <= y for x, y in spans):
                outside.append(t1 - t0)
        if not inside or not outside:
            return b - a
        return (b - a) * (sum(outside) / len(outside)) / \
            (sum(inside) / len(inside))

    def _times(self, reqs, done, seconds, cut=float("inf")) -> dict:
        """Token times of the finished requests; the per-layer lists
        (queue wait, prefill, decode step) only from before host time
        ``cut``."""
        rt = self.rt
        hs = rt.clock.host_s
        t0 = min(rt.t0_cands)
        dec = [hs(m) for _, m in rt.decodes]
        ttft, tpot, last, n_tok = [], [], {}, 0
        dspan, dtok = 0.0, 0
        for d in reqs:
            rid, n = d["rid"], d["max_new_tokens"]
            if rid not in done:
                continue
            before, mark = rt.first[rid]
            t_first = hs(mark)
            t_last = dec[before + n - 2] if n > 1 else t_first
            last[rid] = t_last
            due = t0 + d["arrival_s"]
            ttft.append(t_first - due)
            if n > 1:
                tpot.append((t_last - t_first) / (n - 1))
                dspan += t_last - t_first
                dtok += n - 1
            n_tok += n
        due_at = {d["rid"]: t0 + d["arrival_s"] for d in reqs}
        qwait = [host - due_at[rid] for rid, host, _, _ in rt.prefills
                 if host < cut]
        pre = [hs(b) - hs(a) for _, host, a, b in rt.prefills if host < cut]
        at = [(dec[i - 1], dec[i]) for i in range(1, len(dec))
              if rt.decodes[i][0] == rt.decodes[i - 1][0]]
        steps = [b - a for a, b in at if b < cut]
        first_due = t0 + min(d["arrival_s"] for d in reqs)
        end = max(last.values()) if last else first_due
        finished_by = sorted(last.values())
        arrivals = sorted(t0 + d["arrival_s"] for d in reqs)

        def backlog(t):
            return int(np.searchsorted(arrivals, t, side="right")
                       - np.searchsorted(finished_by, t, side="right"))
        return {"ttft_s": ttft, "tpot_s": tpot, "queue_wait_s": qwait,
                "prefill_s": pre, "decode_step_s": steps,
                "decode_step_at": at,
                "tokens": n_tok, "span_s": end - first_due,
                "decode_span_s": dspan, "decode_tokens": dtok,
                "backlog_mid": backlog(t0 + seconds / 2),
                "backlog_end": backlog(t0 + seconds)}

    def close(self) -> None:
        self.rt = None
        free(self.dev)


def e2e(w: dict) -> Dict[str, float]:
    """Over all of the window's finished requests: the tokens served a
    second, and the latencies (time to first token and per output token:
    50th/90th/99th percentiles and means, and all decode time over all
    decode tokens); the manifest names those that are end-to-end
    metrics, the line's ``readings`` carry the rest."""
    out = {f"{k}_p{q}_ms": float(np.percentile(w[f"{k}_s"], q)) * 1e3
           for k in ("ttft", "tpot") for q in (50, 90, 99) if w[f"{k}_s"]}
    if w["ttft_s"]:
        out["ttft_mean_ms"] = float(np.mean(w["ttft_s"])) * 1e3
    if w["decode_tokens"]:
        out["tpot_token_mean_ms"] = w["decode_span_s"] / \
            w["decode_tokens"] * 1e3
    if w["span_s"] > 0:
        out["serve_tokens_per_s"] = w["tokens"] / w["span_s"]
    return out


def sample(done: dict, seed: int, want_tokens: int, most: int) -> List:
    """Finished requests for the check, drawn by the seed: the two with
    the longest output first, then others until ``want_tokens`` served
    tokens or ``most`` requests."""
    reqs = sorted(done.values(), key=lambda r: (-r.max_new_tokens, r.rid))
    rng = np.random.default_rng([int(seed), 0xc4ec])
    rest = [reqs[i] for i in rng.permutation(len(reqs)) if i >= 2]
    out = reqs[:2]
    for r in rest:
        if sum(x.max_new_tokens for x in out) >= want_tokens or \
                len(out) >= most:
            break
        out.append(r)
    return out


@torch.no_grad()
def reference_logits(c: dict, seed: int, dev, chosen, precision="fp32"):
    """The reference's logits at the positions that predict each chosen
    request's served tokens: a list of (n, vocab) fp32 tensors."""
    cfg = c["cfg"]
    seqs = [np.concatenate([r.prompt, r.tokens[:-1]]) for r in chosen]
    T = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), T), np.int64)     # right padding: causal
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    with full_fp32():
        # the tree in the served type: the reference takes each layer in
        # float32 as it reaches it (exact), so a model whose float32 copy
        # would not fit beside it on the card is checked whole
        p = make_params(cfg, seed, dev, getattr(torch, cfg["dtype"]))
        logits = model_for(cfg, precision).logits(
            p, torch.from_numpy(toks).to(dev))
        out = [logits[i, r.prompt_len - 1:r.prompt_len - 1 + r.max_new_tokens]
               for i, r in enumerate(chosen)]
    del p
    return out


def gaps(ref_logits, tokens_list) -> np.ndarray:
    """Each token's gap: how far its reference logit lies below the
    reference's best at its position."""
    out = []
    for lg, toks in zip(ref_logits, tokens_list):
        t = torch.as_tensor(np.asarray(toks), device=lg.device).long()
        g = lg.max(dim=-1).values - lg.gather(-1, t[:, None])[:, 0]
        out.append(g.float().cpu().numpy())
    return np.concatenate(out)


def gap_stats(g: np.ndarray) -> Dict[str, float]:
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p99_gap": float(np.percentile(g, 99)),
            "off_top1": float((g > 0).mean())}


def check_readings(c, seed, dev, done) -> dict:
    chk = c["work"]["check"]
    chosen = sample(done, seed, chk["sample_tokens"], chk["sample_requests"])
    ref = reference_logits(c, seed, dev, chosen)
    g = gap_stats(gaps(ref, [r.tokens for r in chosen]))
    return {**g, "n_checked": len(chosen),
            "tokens_checked": sum(r.max_new_tokens for r in chosen)}


def run(c: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> tuple:
    work = c["work"]
    reqs = traffic.serve_requests(work["traffic"], c["cfg"]["vocab"], seconds,
                                  seed)
    st = Setup(c, seed, dev)
    setup_s = time.perf_counter() - t_start
    w = st.window(reqs, seconds, trace)
    st.close()
    chk = check_readings(c, seed, dev, w["done"])
    free(dev)
    limits = {k: v for k, v in work["check"].items()
              if k not in ("sample_tokens", "sample_requests")}
    ok, checks = verdict(chk, limits)
    lat = e2e(w)
    ctx = {"cell": c, "window": w, "prof": w["prof"],
           "prof_ops": w["prof_ops"], "e2e": {"setup_s": setup_s, **lat}}
    summ = None if w["prof"] is None else devicetrace.summary(w["prof"], w)
    result = {"correct": ok, "attempted": len(reqs),
              "failed": len(reqs) - len(w["done"]),
              "peak_bytes": w["peak_bytes"], "summary": summ,
              "readings": {**lat, **{k: v for k, v in chk.items()
                                     if k.endswith("gap")},
                           "backlog_mid": w["backlog_mid"],
                           "backlog_end": w["backlog_end"],
                           "wall_s": w["wall_s"],
                           "checked_requests": chk["n_checked"],
                           "checked_tokens": chk["tokens_checked"]}}
    if w["prof"] is not None:
        result["breakdown"] = devicetrace.breakdown(w["prof"], w["prof_ops"])
    return result, checks, ctx
