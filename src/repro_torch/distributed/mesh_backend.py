"""Mesh-sharded execution backend: the OMP2MPI leap.

The port of ``src/repro/distributed/mesh_backend.py``.  The paper's
sibling tool OMP2MPI generated *distributed* programs from the same
pragma source OMP2HMPP compiled for one accelerator.  This module is that
leap for the plan runtime: a ``Backend`` whose ``AdvancedLoad`` /
``DelegateStore`` become sharded uploads and gathering downloads over a
``DeviceMesh``, so the same ``Plan`` that drove one card drives an SPMD
group; DTensor inserts the collectives when the block bodies consume
sharded operands.

``MeshBackend``
    A ``TorchDeviceBackend`` over a ``DeviceMesh`` of every rank of the
    default process group (shape auto-derived: 8 ranks → ``(2, 4)`` over
    ``("data", "model")``, 1 → ``(1, 1)``).  Every rank runs the same
    plan on the same host inputs.  ``upload(host, name=...)`` copies only
    this rank's shard of ``host`` by the per-variable placement the tuner
    chose and returns a DTensor; unmapped variables replicate.
    ``download`` gathers the whole value (``full_tensor``) on every rank.
    ``with_placement`` returns a memoized twin per placement and
    ``variant`` twins keep the mesh and the placement.

``placement_specs``
    One placement *policy* (``replicate`` / ``fsdp`` / ``tp``) as
    per-variable spec entries through ``distributed.sharding``'s
    divisibility-guarded rules: fsdp shards dim 0 over "data" (logical
    ``embed``), tp the last dim over "model" (logical ``ffn``);
    non-dividing dims stay replicated with the drop recorded.

``mesh_cost_terms``
    Prices a placement for the tuner without running it: each offload
    block runs once on ``meta`` DTensors placed by the specs under
    ``roofline.analysis.collective_trace``, which gives its per-device
    FLOPs (the products on the local shards) and the ring-volume bytes of
    the collectives DTensor inserted, partial sums of its outputs reduced
    as ``MeshBackend.launch`` reduces them; plus a per-variable h2d factor (a
    replicated upload copies to every device, a sharded one moves each
    byte once).  A kernel-tagged block is not sharded: its FLOPs are
    priced per tile variant as on one device, and its collectives are the
    redistribution of its inputs to ``Replicate()``, which its launch
    performs (``core.executor.kernel_fn``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.backend import TorchDeviceBackend, register_backend
from ..core.dtypes import torch_dtype
from .sharding import (from_global, host_shard, is_dtensor, local_shard,
                       make_rules, mesh_shape, placements, reduced,
                       spec_for_axes, wrap_shard)

__all__ = [
    "MeshBackend", "DEFAULT_PLACEMENTS", "auto_mesh_shape",
    "canonical_placement", "placement_specs", "mesh_cost_terms",
]

# the tuner's placement axis: replicate everywhere / FSDP-shard dim 0
# over "data" / TP-shard the last dim over "model"
DEFAULT_PLACEMENTS = ("replicate", "fsdp", "tp")


def auto_mesh_shape(n_devices: int,
                    axes: Tuple[str, str] = ("data", "model")
                    ) -> Tuple[int, int]:
    """(data, model) shape for ``n_devices``: model = largest of (4, 2, 1)
    dividing it, data = the rest.  8 → (2, 4); 1 → (1, 1)."""
    model = next(m for m in (4, 2, 1) if n_devices % m == 0)
    return (n_devices // model, model)


def canonical_placement(placement: Any) -> Tuple[Tuple[str, tuple], ...]:
    """Normalize a placement (dict / item-iterable, entries possibly
    JSON-round-tripped lists) to a hashable, sorted
    ``((var, (entry, ...)), ...)`` tuple — the identity ``MeshBackend``
    memoizes twins on."""
    if not placement:
        return ()
    items = placement.items() if hasattr(placement, "items") else placement
    out = []
    for var, entries in sorted(items):
        ent = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                    for e in (entries or ()))
        out.append((str(var), ent))
    return tuple(out)


class MeshBackend(TorchDeviceBackend):
    """SPMD backend over a ``DeviceMesh`` with per-variable placements.
    ``device`` is ``"cuda"`` (NCCL; the default) or ``"cpu"`` (gloo); the
    default process group must be initialised with one rank per device
    (``launch.mesh.init_process_group``)."""

    name = "mesh"

    def __init__(self, device: Any = "cuda", *, mesh=None, shape=None,
                 axes: Tuple[str, ...] = ("data", "model"),
                 n_streams: int = 2, donate: bool = False,
                 placement: Any = ()):
        if mesh is None:
            import torch.distributed as dist

            from ..launch.mesh import make_mesh
            dev_type = torch.device(device).type
            if not dist.is_initialized():
                raise RuntimeError("MeshBackend: no process group; "
                                   "initialise one first "
                                   "(launch.mesh.init_process_group)")
            if shape is None:
                shape = auto_mesh_shape(dist.get_world_size(), tuple(axes))
            mesh = make_mesh(shape, axes, device=dev_type)
        super().__init__(mesh.device_type, n_streams=n_streams, donate=donate)
        self.mesh = mesh
        key = canonical_placement(placement)
        self.placement: Dict[str, tuple] = dict(key)
        self.placement_key = key
        # (placement_key, n_streams, donate) -> twin; shared by the family
        self._placement_twins: Dict[Any, "MeshBackend"] = {
            (key, n_streams, donate): self}

    # -- identity ----------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return int(self.mesh.size())

    @property
    def mesh_desc(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        shape = mesh_shape(self.mesh)
        return tuple(shape.values()), tuple(shape)

    @property
    def mesh_key(self) -> str:
        """Mesh identity for tune-cache fingerprints (shape + axes only:
        the placement is a per-candidate knob of the grid)."""
        shape, axes = self.mesh_desc
        return "x".join(f"{a}{s}" for a, s in zip(axes, shape))

    # -- agreement across ranks ---------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Rank 0 writes shared state (the tune cache)."""
        import torch.distributed as dist
        return dist.get_rank() == 0

    def agree_max(self, values: List[float]) -> List[float]:
        """``values`` reduced by MAX over every rank of the mesh, so every
        rank ranks the same measured times."""
        import torch.distributed as dist
        if self.n_devices == 1:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [float(x) for x in t.tolist()]

    def from_writer(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (a broadcast of the object)."""
        import torch.distributed as dist
        if self.n_devices == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        import torch.distributed as dist
        if self.n_devices > 1:
            dist.barrier()

    # -- twins -------------------------------------------------------------
    def _twin(self, key, ns: int, dn: bool) -> "MeshBackend":
        pool_key = (key, ns, dn)
        twin = self._placement_twins.get(pool_key)
        if twin is None:
            twin = MeshBackend(mesh=self.mesh, n_streams=ns, donate=dn,
                               placement=key)
            twin._placement_twins = self._placement_twins
            self._placement_twins[pool_key] = twin
        return twin

    def variant(self, *, n_streams: Optional[int] = None,
                donate: Optional[bool] = None) -> "MeshBackend":
        ns = self.n_streams if n_streams is None else max(1, int(n_streams))
        dn = self.donate if donate is None else bool(donate)
        return self._twin(self.placement_key, ns, dn)

    def with_placement(self, placement: Any) -> "MeshBackend":
        """Twin with the given per-variable placement (memoized: same
        placement → same instance)."""
        key = canonical_placement(placement)
        if key == self.placement_key:
            return self
        return self._twin(key, self.n_streams, self.donate)

    # -- CUDA ordering on the local shards -----------------------------------
    def _ready(self, tensors, stream):
        ev = super()._ready([local_shard(t) for t in tensors], stream)
        for t in tensors:
            t._ready_event, t._ready_stream = ev, stream
        return ev

    def _consume(self, tensors, stream) -> None:
        for t in tensors:
            src = getattr(t, "_ready_stream", None)
            if src is not None and src != stream:
                stream.wait_event(t._ready_event)
                local_shard(t).record_stream(stream)

    # -- compute -----------------------------------------------------------
    def launch(self, fn, names, writes, args, *, stream: int = 0):
        """A block on the DTensors: partial sums its outputs hold are
        reduced before it ends, so a block's collectives are its own."""
        return super().launch(lambda xp, **kw: _reduced_outputs(fn(xp, **kw)),
                              names, writes, args, stream=stream)

    # -- transfers ---------------------------------------------------------
    def _placements_for(self, name: Optional[str]):
        return placements(self.mesh, self.placement.get(name, ()))

    def alloc(self, shape, dtype):
        return from_global(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                                       device=self.device), self.mesh,
                           self._placements_for(None))

    def upload(self, host, *, stream: int = 0, name=None):
        """This rank's shard of ``host`` to the device, as a DTensor at
        the variable's placement (only the shard's bytes move)."""
        host = np.asarray(host)
        plc = self._placements_for(name)
        local = host_shard(host, self.mesh, plc)
        handle = super().upload(np.ascontiguousarray(local), stream=stream)
        out = wrap_shard(handle, self.mesh, plc, host.shape)
        for attr in ("_ready_event", "_ready_stream"):
            if hasattr(handle, attr):
                setattr(out, attr, getattr(handle, attr))
        return out

    def download(self, handle, *, stream: int = 0):
        """The whole value on every rank (a gather of the shards)."""
        if is_dtensor(handle):
            if self.on_cuda:
                self._consume([handle], self._compute)
                with torch.cuda.stream(self._compute):
                    full = handle.full_tensor()
                TorchDeviceBackend._ready(self, [full], self._compute)
            else:
                full = handle.full_tensor()
            handle = full
        return super().download(handle, stream=stream)


def _reduced_outputs(out: Dict[str, Any]) -> Dict[str, Any]:
    return {k: reduced(v) for k, v in out.items()}


register_backend("mesh", MeshBackend)


# ---------------------------------------------------------------------------
# Placement policies and pricing (tuner-facing, no backend state)
# ---------------------------------------------------------------------------

def placement_specs(shapes: Dict[str, Any], mesh, policy: str
                    ) -> Tuple[Dict[str, tuple], List[tuple]]:
    """Per-variable spec entries for one placement policy.

    ``shapes`` maps var → anything with ``.shape`` (the planner's
    abstract values); ``mesh`` is a ``DeviceMesh`` or an
    ``AbstractMesh``.  Returns ``(specs, dropped)``: specs as plain entry
    tuples, dropped as the divisibility guard's records."""
    rules = make_rules(mesh, "train")
    specs: Dict[str, tuple] = {}
    for var in sorted(shapes):
        shape = tuple(shapes[var].shape if hasattr(shapes[var], "shape")
                      else np.shape(shapes[var]))
        nd = len(shape)
        if policy == "replicate" or nd == 0:
            specs[var] = ()
            continue
        if policy == "fsdp":
            axes = ("embed",) + (None,) * (nd - 1)
        elif policy == "tp":
            axes = (None,) * (nd - 1) + ("ffn",)
        else:
            raise ValueError(f"unknown placement policy {policy!r}; have "
                             f"{DEFAULT_PLACEMENTS}")
        specs[var] = spec_for_axes(rules, shape, axes, context=var)
    return specs, list(rules.dropped)


def _shard_factor(mesh_shape_: Dict[str, int], entries) -> int:
    """Number of distinct shards an entry tuple splits an array into."""
    s = 1
    for e in entries or ():
        if e is None:
            continue
        for a in (e if isinstance(e, (list, tuple)) else (e,)):
            s *= mesh_shape_[a]
    return s


def mesh_cost_terms(program, shapes: Dict[str, Any], backend: MeshBackend,
                    specs: Dict[str, tuple]) -> Dict[str, Any]:
    """Price one placement for the tuner's cost model, without running it
    (see the module docstring): ``flops_by_block`` (per-device FLOPs of
    the non-kernel blocks), ``coll_by_block`` (ring-volume wire bytes of
    each block's collectives) and ``h2d_factor`` per variable."""
    from torch.distributed.tensor import Replicate

    from ..roofline.analysis import collective_bytes, trace_step
    mesh = backend.mesh
    n_dev = backend.n_devices
    rep = (Replicate(),) * mesh.ndim

    def meta(v):
        t = torch.empty(tuple(shapes[v].shape),
                        dtype=torch_dtype(shapes[v].dtype), device="meta")
        return from_global(t, mesh, placements(mesh, specs.get(v, ())))

    flops_by_block: Dict[int, float] = {}
    coll_by_block: Dict[int, float] = {}
    for blk in program.offload_blocks():
        args = {v: meta(v) for v in blk.reads}
        if blk.kernel:
            rec = trace_step(lambda: [a.redistribute(placements=rep)
                                      for a in args.values()])
        else:
            rec = trace_step(lambda: _reduced_outputs(blk.fn(torch, **args)))
            flops_by_block[blk.idx] = rec["flops"]
        coll_by_block[blk.idx] = sum(
            v["bytes"] for v in collective_bytes(
                rec["collectives"]).values())
    ms = mesh_shape(mesh)
    h2d_factor = {v: n_dev / _shard_factor(ms, e) for v, e in specs.items()}
    return {
        "specs": specs,
        "flops_by_block": flops_by_block,
        "coll_by_block": coll_by_block,
        "h2d_factor": h2d_factor,
        "n_devices": n_dev,
    }
