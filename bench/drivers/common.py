"""Helpers both drivers use."""
from __future__ import annotations

import gc
import statistics
from typing import Dict, Optional

import torch


def on_cuda(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    if on_cuda(dev):
        torch.cuda.synchronize()


def reset_peak(dev) -> None:
    if on_cuda(dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated() if on_cuda(dev) else 0


def free(dev) -> None:
    gc.collect()
    if on_cuda(dev):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def profiler(dev, host_ops: bool):
    """A profiler of the device's operations; ``host_ops`` also records
    the host's (the program's ranges and what the host ran in the device's
    idle gaps), which slows the host several times over, so busy and idle
    shares are read from a trace without them."""
    from torch.profiler import ProfilerActivity, profile
    if not on_cuda(dev):
        return profile(activities=[ProfilerActivity.CPU])
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    return profile(activities=acts)


def warm_profiler(dev) -> None:
    """Start and stop each kind of trace once, so that a traced window
    does not pay the tracer's start-up (on the card about a second)."""
    for host_ops in (False, True):
        with profiler(dev, host_ops):
            sync(dev)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[set] = None) -> float:
    """The worst leaf's gap between two norms, over the larger of that
    leaf's reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    worst = 0.0
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        worst = max(worst, abs(prog[k] - r) / max(r, med, 1e-30))
    return worst


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): each reading beside its limit."""
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])}
              for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks
