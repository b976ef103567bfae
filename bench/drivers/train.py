"""The training window.

Set-up builds one training step: the port's ``Transformer`` with its
kernels (``use_pallas=True``), the cell's optimizer (AdamW on the card or
``offloaded_optimizer``), the benchmark's seeded weights and the cell's
token batches fed through the port's ``PrefetchIterator``.  It drives that
step through its first ``CHECKED`` steps (which also warm every shape),
and reads their losses, the norm of each leaf's first gradient as the
optimizer got it (its first moment after one step) and the norm of each
leaf's change after the last of them.  The window then runs the same
step back to back for ``seconds``, keeping one step in flight.  A traced
run then records a few more steps run the same way, and takes the device's
busy time and its span from one interval of that trace, between two
steps' device starts (``devicetrace.summary``).  After the window the
program's state is freed and the reference follows the checked steps from
the same weights and batches.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, Optional

import torch

from .. import devicetrace, yardstick
from ..program import arch, check_layout, flat
from ..reference import AdamW, full_fp32, make_params, model_for
from ..traffic import TokenBatches
from .common import (free, leaf_gap, on_cuda, peak_bytes, profiler,
                     reset_peak, sync, tree_map, verdict, warm_profiler)

CHECKED = 3          # steps the reference follows
FILL_STEPS = 1       # traced steps before the measured ones
TRACED_STEPS = 2     # the measured steps of a traced run


def _norms(tree, dev) -> Dict[str, float]:
    """Each leaf's L2 norm in fp32 (host-resident state is read on the
    device a leaf at a time)."""
    return {k: float(torch.linalg.vector_norm(t.to(dev), dtype=torch.float32))
            for k, t in flat(tree).items()}


def _change_norms(now, start) -> Dict[str, float]:
    a, b = flat(now), flat(start)
    return {k: float(torch.linalg.vector_norm(a[k].detach().float() - b[k].float()))
            for k in a}


def _optimizer(work):
    from repro_torch.optim import adamw, offloaded_optimizer
    opt = adamw(**work["optimizer"]["adamw"])
    return offloaded_optimizer(opt) if work["optimizer"]["offload"] else opt


class Setup:
    """The training step set up and driven through its checked steps."""

    def __init__(self, c: dict, seed: int, dev,
                 wrap: Optional[Callable] = None):
        import repro_torch.launch.train as launch
        from repro_torch.data import PrefetchIterator
        from repro_torch.models import Transformer
        cfg, work = c["cfg"], c["work"]
        self.dev = dev
        self.model = Transformer(arch(cfg), use_pallas=True)
        params = make_params(cfg, seed, dev, getattr(torch, cfg["dtype"]))
        check_layout(self.model, params)
        start = tree_map(torch.clone, params)
        self.opt = _optimizer(work)
        self.state = self.opt.init(params)
        self.source = TokenBatches(work["traffic"], cfg["vocab"], seed)
        self.it = PrefetchIterator(self.source, device=dev)
        step = launch.make_train_step(self.model, self.opt)
        self.step = wrap(step) if wrap else step
        losses = []
        for i in range(CHECKED):
            params, self.state, met = self.step(params, self.state,
                                                next(self.it))
            losses.append(met["loss"])
            if i == 0:
                sync(dev)
                m1 = _norms(self.state["m"], dev)
        warm_profiler(dev)
        sync(dev)
        self.readings = {"losses": [float(x) for x in losses], "m1": m1,
                         "change": _change_norms(params, start)}
        del start
        self.params = params

    def window(self, seconds: float, trace: bool) -> dict:
        dev, tokens = self.dev, self.source.tokens_per_step
        reset_peak(dev)
        steps, wait, prev = 0, 0.0, None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            tw = time.perf_counter()
            batch = next(self.it)
            wait += time.perf_counter() - tw
            self.params, self.state, met = self.step(self.params, self.state,
                                                     batch)
            steps += 1
            if on_cuda(dev):
                # one step in flight: the host never runs far ahead
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
        sync(dev)
        window_s = time.perf_counter() - t0
        out = {"steps": steps, "window_s": window_s,
               "train_tokens_per_s": steps * tokens / window_s,
               "data_wait_s": wait / steps, "step_s": window_s / steps,
               "last_loss": float(met["loss"]),
               "peak_bytes": peak_bytes(dev), "prof": None, "prof_ops": None}
        if trace:
            out["prof"] = self._traced(dev)
            out["trace_steps"] = TRACED_STEPS
            # then one step with the host's ops too (ranges, idle gaps)
            with profiler(dev, host_ops=True) as ops:
                self.params, self.state, _ = self.step(
                    self.params, self.state, next(self.it))
                sync(dev)
            out["prof_ops"] = ops
        return out

    def _traced(self, dev):
        """A trace of the device alone over steps run as the window runs
        them (one in flight, no drain between), each after its mark
        (``devicetrace.STEP_MARK``): FILL_STEPS steps fill the pipeline
        (and hold whatever the tracer loses as it starts), the next
        TRACED_STEPS are measured, and the last step's mark ends them.
        The store copies an offloaded step leaves in flight overlap the
        next step here as they do in the window."""
        prev = None
        with profiler(dev, host_ops=False) as prof:
            for _ in range(FILL_STEPS + TRACED_STEPS + 1):
                batch = next(self.it)
                if on_cuda(dev):
                    torch.cuda._sleep(0)
                self.params, self.state, _ = self.step(self.params,
                                                       self.state, batch)
                if on_cuda(dev):
                    ev = torch.cuda.Event()
                    ev.record()
                    if prev is not None:
                        prev.synchronize()
                    prev = ev
            sync(dev)
        return prof

    def close(self) -> None:
        self.it.close()
        self.params = self.state = self.step = self.model = self.opt = None
        free(self.dev)


def reference_readings(c: dict, seed: int, dev,
                       precision: str = "fp32") -> dict:
    """The reference's readings over the checked steps, in fp32 with TF32
    off (``precision="fp8"``: the control)."""
    cfg, work = c["cfg"], c["work"]
    dt = getattr(torch, cfg["dtype"])
    ref = model_for(cfg, precision)
    hp = work["optimizer"]["adamw"]
    opt = AdamW(param_dtype=dt, **hp)
    src = TokenBatches(work["traffic"], cfg["vocab"], seed)
    with full_fp32():
        p = tree_map(lambda t: t.float(), make_params(cfg, seed, dev, dt))
        free(dev)
        keys = list(flat(p))
        leaves = [flat(p)[k] for k in keys]
        m, v = opt.init(leaves)
        losses = []
        for i in range(CHECKED):
            b = {k: torch.from_numpy(a).to(dev)
                 for k, a in src.batch_at(i).items()}
            for t in leaves:
                t.requires_grad_(True)
            loss = ref.loss(p, b["tokens"], b["labels"])
            grads = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
            losses.append(float(loss.detach()))
            opt.step(leaves, grads, m, v)
            del grads, loss
            if i == 0:
                m1 = {k: float(torch.linalg.vector_norm(t))
                      for k, t in zip(keys, m)}
        del m, v
        free(dev)
        start = flat(make_params(cfg, seed, dev, dt))
        change = {k: float(torch.linalg.vector_norm(t - start[k].float()))
                  for k, t in zip(keys, leaves)}
    del p, leaves, start
    free(dev)
    return {"losses": losses, "m1": m1, "change": change}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers ``correct`` holds to their limits: the worst step's
    relative loss gap, and the worst leaf's gap in first-gradient norm and
    in the change over the checked steps (leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of the
    change: Adam moves them by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med = statistics.median(ref["m1"].values())
    keep = {k for k, n in ref["m1"].items() if n >= 1e-3 * med}
    finite = all(math.isfinite(x) for x in prog["losses"])
    return {"loss_rel": loss if finite else math.inf,
            "grad_norm_gap": leaf_gap(prog["m1"], ref["m1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets each leaf-wise gap (for the result line)."""
    out = {}
    for key in ("m1", "change"):
        med = statistics.median(ref[key].values())
        out[key] = max(ref[key], key=lambda k: abs(prog[key][k] - ref[key][k])
                       / max(ref[key][k], med, 1e-30))
    return out


def trace_context(c: dict, w: dict) -> dict:
    """What the per-layer readers of a train cell read."""
    cfg, tr = c["cfg"], c["work"]["traffic"]
    ctx = {"cell": c, "window": w, "prof": w["prof"],
           "prof_ops": w["prof_ops"], "steps_traced": TRACED_STEPS,
           "step_flops": yardstick.train_step_flops(cfg, tr["batch"],
                                                    tr["seq"])}
    return ctx


def run(c: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> tuple:
    st = Setup(c, seed, dev)
    setup_s = time.perf_counter() - t_start
    w = st.window(seconds, trace)
    st.close()
    ref = reference_readings(c, seed, dev)
    ok, checks = verdict(compare(st.readings, ref), c["work"]["check"])
    ctx = trace_context(c, w)
    ctx["e2e"] = {"setup_s": setup_s,
                  "train_tokens_per_s": w["train_tokens_per_s"]}
    summ = None if w["prof"] is None else devicetrace.summary(w["prof"], w)
    result = {"correct": ok, "attempted": w["steps"], "failed": 0,
              "peak_bytes": w["peak_bytes"], "summary": summ,
              "readings": {"worst_leaves": worst_leaves(st.readings, ref),
                           "losses": st.readings["losses"],
                           "ref_losses": ref["losses"],
                           "steps": w["steps"], "window_s": w["window_s"],
                           "step_s": w["step_s"],
                           "traced_step_s": None if summ is None
                           else summ["window_s"] / TRACED_STEPS}}
    if w["prof"] is not None:
        result["breakdown"] = devicetrace.breakdown(w["prof"], w["prof_ops"])
    return result, checks, ctx
