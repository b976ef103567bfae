"""Pipeline parallelism over the pod axis (a GPipe forward).

The port of ``src/repro/distributed/pipeline.py``.  An alternative use of
the multi-pod mesh: instead of cross-pod data parallelism, the pods hold
disjoint layer ranges and microbatches stream through them (F-then-B
GPipe; bubble = (P-1)/(M+P-1)).  Stage ``s`` (the rank's coordinate on
``stage_axis``) runs its own parameter slice on microbatch ``t - s`` at
tick ``t``; boundary activations move to the next stage by
``batch_isend_irecv`` over the axis's process group (the reference's
``ppermute``), each tick's send paired with the next stage's receive.
The last stage holds the outputs and broadcasts them to every stage.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import tree_map
from .sharding import is_dtensor

__all__ = ["pipeline_forward"]


def pipeline_forward(mesh, layer_fn: Callable[[Any, torch.Tensor],
                                              torch.Tensor],
                     n_microbatches: int, stage_axis: str = "pod"):
    """Build ``fn(stage_params, x)`` running a GPipe forward on ``mesh``.

    stage_params: a tree whose leaves have a leading [n_stages] dim, the
      whole stack on every rank or DTensors sharded on it over
      ``stage_axis``; each stage takes its own slice.
    x: (B, ...) the global batch (equal on every rank), split into
      ``n_microbatches`` along B.
    layer_fn(stage_params_slice, mb) -> mb of the same shape.
    Returns the (B, ...) output of the last stage on every rank."""
    names = mesh.mesh_dim_names
    axis = names.index(stage_axis)
    n_stages = mesh.size(axis)
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)

    def peer(s: int) -> int:
        return dist.get_global_rank(group, s)

    def own_slice(t):
        if is_dtensor(t):
            return t.to_local()[0]
        return t[stage]

    def run(stage_params, x):
        p = tree_map(own_slice, stage_params)
        B = x.shape[0]
        M = n_microbatches
        mbs = x.reshape((M, B // M) + tuple(x.shape[1:]))
        outputs = torch.zeros_like(mbs)
        inbox = torch.empty_like(mbs[0])
        for t in range(M + n_stages - 1):
            m = t - stage
            if 0 <= m < M:
                out = layer_fn(p, mbs[m] if stage == 0 else inbox)
                if stage == n_stages - 1:
                    outputs[m] = out
            ops = []
            if stage < n_stages - 1 and 0 <= m < M:
                ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                      peer(stage + 1), group))
            if stage > 0 and 0 <= m + 1 < M:
                inbox = torch.empty_like(mbs[0])
                ops.append(dist.P2POp(dist.irecv, inbox, peer(stage - 1),
                                      group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        dist.broadcast(outputs, src=peer(n_stages - 1), group=group)
        return outputs.reshape((B,) + tuple(x.shape[1:]))

    return run
