"""Logical-axis → mesh-axis sharding rules, mapped onto DTensor placements.

The port of ``src/repro/distributed/sharding.py``.  Model code tags every
param dim with a logical axis name (``models/layers.py::P``); here those
names map to mesh axes per *shape kind* (train / prefill / decode).  A
**divisibility guard** drops any mesh axis that does not evenly divide the
dim (qwen2.5's 40 q-heads or Arctic's 56 on a 16-way "model" axis stay
unsharded and the drop is recorded), so every spec shards evenly.

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names (the reference's ``PartitionSpec``, which
the tuner writes to JSON).  The rules need only a mesh's shape and axis
names, so they run on an ``AbstractMesh`` with no process group as well
as on a ``torch.distributed.device_mesh.DeviceMesh``.  ``placements``
turns a spec into DTensor placements (one per MESH dim) and
``distribute`` places a tensor by its spec.

Parallelism layout (single pod 16×16, multi-pod 2×16×16):
  * batch        → ("pod", "data")      — DP across pods and data axis
  * embed        → "data"               — FSDP: params sharded over data,
                                          gathered per layer at use
  * ffn/heads/vocab/experts/rnn → "model" — TP / EP
  * decode KV cache seq dim → "model"   — sequence-parallel decode
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..tree import flatten_with_paths, leaves, unflatten

__all__ = ["AbstractMesh", "abstract_mesh", "mesh_shape", "NamedSharding",
           "mesh_device_type", "place", "place_leaf", "host_shard",
           "PinnedShard", "local_shard", "spec_of", "wrap_shard",
           "ShardingRules", "PARAM_RULES", "make_rules", "spec_for_axes",
           "tree_shardings", "MeshPolicy", "batch_axes", "batch_specs",
           "cache_shardings", "placements", "distribute", "from_global",
           "like", "replicate", "at_use", "whole", "placed_as", "psum",
           "pmax", "moved", "reduced", "split_dim", "merge_dims",
           "is_dtensor", "assign",
           "local_apply"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices and no group."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def abstract_mesh(shape=(16, 16), axes=("data", "model")) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's axis order, for an
    ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# logical axis -> mesh axis (or tuple), per shape kind
PARAM_RULES: Dict[str, Dict[str, Any]] = {
    "train": {
        "embed": "data",        # FSDP
        "embed_out": None,
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "experts": "model",
        "rnn": "model",
        "layers": None,
    },
    # inference: no FSDP; TP on model, the small rest replicated
    "serve": {
        "embed": None,
        "embed_out": None,
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "experts": "model",
        "rnn": "model",
        "layers": None,
    },
}


def _flat(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dim) for a per-tensor-dim spec.
    An entry naming several mesh axes (``("pod", "data")`` on the batch
    dim) shards that tensor dim over each of them, major to minor, which
    must be the mesh's own axis order.  A mesh axis of size 1 holds the
    whole tensor on its one rank: it is ``Replicate()`` whatever the spec
    says (a shard of one is the whole, and DTensor's view rules refuse
    some reshapes of a dim sharded even one way)."""
    from torch.distributed.tensor import Replicate, Shard
    shape = mesh_shape(mesh)
    names = list(shape)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec or ()):
        axes = _flat(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if shape[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local_shard(t):
    """This rank's values of ``t``: a DTensor's local shard, any other
    tensor (a ``PinnedShard`` is its own shard) as it is."""
    return t.to_local() if is_dtensor(t) else t


def distribute(t, mesh, spec):
    """``t`` placed on ``mesh`` by ``spec``: a DTensor whose local shard
    this rank holds (``t`` is the global value, equal on every rank)."""
    return from_global(t, mesh, placements(mesh, spec))


def host_shard(host, mesh, plc):
    """This rank's shard of the numpy array ``host`` at placements
    ``plc`` (a view; ``from_global``'s chunks, on the host)."""
    import numpy as np
    from torch.distributed.tensor import Shard
    local = host
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            local = np.array_split(local, mesh.size(i), axis=p.dim)[
                mesh.get_local_rank(i)]
    return local


def wrap_shard(local, mesh, plc, shape):
    """A DTensor of global ``shape`` from this rank's shard ``local``
    (no collective)."""
    glob = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(local, mesh, tuple(plc), run_check=False,
                              shape=glob.shape, stride=glob.stride())


def _chunk(t, mesh, plc):
    """This rank's chunk of ``t`` at placements ``plc`` (a view)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(plc):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t


def from_global(t, mesh, plc):
    """A DTensor at placements ``plc`` from the global value ``t`` that
    every rank holds: each rank keeps a copy of its own chunk (never
    ``t``'s storage, which in-place updates would write through), with no
    collective (``distribute_tensor`` would broadcast rank 0's value)."""
    local = _chunk(t, mesh, plc)
    return wrap_shard(local.clone(memory_format=torch.contiguous_format),
                      mesh, plc, t.shape)


def spec_of(t) -> tuple:
    """The spec of a DTensor: each tensor dim's mesh axes, from its
    placements (a mesh axis of size 1 replicates, so it names none)."""
    from torch.distributed.tensor import Shard
    entries: List[List[str]] = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return _spec(*entries)


def like(t, x):
    """``t`` on ``x``'s mesh, sharded where ``x`` is sharded on a leading
    dim of the same size, replicated elsewhere: a plain ``t`` (the same
    value on every rank) is placed so, a DTensor ``t`` redistributed so;
    ``t`` itself if ``x`` is plain."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate, Shard
    plc = tuple(p if isinstance(p, Shard) and p.dim < t.ndim
                and t.shape[p.dim] == x.shape[p.dim] else Replicate()
                for p in x.placements)
    if is_dtensor(t):
        return t if tuple(t.placements) == plc else t.redistribute(
            placements=plc)
    return from_global(t, x.device_mesh, plc)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``.
    ``memory_kind`` ``"pinned_host"`` keeps the local shards in pinned
    host memory (``optim.offload_shardings``)."""
    mesh: Any
    spec: tuple
    memory_kind: Optional[str] = None

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def mesh_device_type(mesh) -> str:
    """``"cuda"`` / ``"cpu"`` of a ``DeviceMesh``; ``"meta"`` for an
    ``AbstractMesh``."""
    return "meta" if isinstance(mesh, AbstractMesh) else mesh.device_type


def place(tree, shardings):
    """Every leaf of ``tree`` (the global values, equal on every rank)
    placed by the ``NamedSharding`` at the same path of ``shardings``
    (see ``place_leaf`` for a ``pinned_host`` one)."""
    flat = leaves(tree)
    sh = leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(flat) != len(sh):
        raise ValueError(f"{len(flat)} leaves against {len(sh)} shardings")
    return unflatten(tree, [place_leaf(t, s) for t, s in zip(flat, sh)])


def place_leaf(t, s: NamedSharding):
    """One global value placed by ``s`` (see ``place``).  A DTensor
    keeps its local shard on its mesh's device, so under a
    ``pinned_host`` sharding an array becomes this rank's own shard in
    host memory, a ``PinnedShard`` (pinned where the mesh is on a card);
    a 0-d leaf (the step) stays on the device, and a ``meta`` value stays
    an abstract DTensor."""
    if s.memory_kind == "pinned_host" and t.ndim and not t.is_meta:
        # only this rank's chunk leaves the card, copied once
        local = _chunk(t, s.mesh, s.placements)
        return PinnedShard(_host_buffer(local.shape, t.dtype, s)
                           .copy_(local), s, t.shape)
    return distribute(t, s.mesh, s.spec)


def _host_buffer(shape, dtype, s: NamedSharding) -> torch.Tensor:
    """An empty host tensor for a shard under ``s``: pinned where the
    mesh is on a card."""
    return torch.empty(tuple(shape), dtype=dtype,
                       pin_memory=mesh_device_type(s.mesh) == "cuda")


_KEEPS_SHARD = {torch.Tensor.clone, torch.Tensor.detach}


class PinnedShard(torch.Tensor):
    """This rank's shard of a global array held in host memory: what the
    reference's global array under ``memory_kind="pinned_host"`` is on
    each rank.  A plain tensor of the local shape (pinned where the mesh
    is on a card) that also carries the array's ``global_shape`` and its
    ``sharding`` (``NamedSharding``: mesh and spec).  Arithmetic on it
    gives plain tensors; ``clone`` and ``detach`` keep the two fields, so
    a tree map that copies a state tree keeps them.
    ``full()`` gathers the array (every rank of the mesh calls it), as a
    checkpoint's save does."""

    @staticmethod
    def __new__(cls, local, sharding: NamedSharding, global_shape):
        out = torch.Tensor._make_subclass(cls, local)
        out.sharding = sharding
        out.global_shape = torch.Size(global_shape)
        return out

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        src = args[0] if args else None
        if func in _KEEPS_SHARD and isinstance(src, PinnedShard) \
                and type(out) is torch.Tensor:
            return PinnedShard(out, src.sharding, src.global_shape)
        return out

    @classmethod
    def zeros(cls, sharding: NamedSharding, global_shape, dtype
              ) -> "PinnedShard":
        """This rank's zero shard of an array of ``global_shape`` placed
        by ``sharding`` (only the shard is allocated)."""
        local = _chunk(torch.empty(tuple(global_shape), device="meta"),
                       sharding.mesh, sharding.placements)
        return cls(_host_buffer(local.shape, dtype, sharding).zero_(),
                   sharding, global_shape)

    @property
    def placements(self) -> tuple:
        return self.sharding.placements

    def local(self) -> torch.Tensor:
        """The shard as a plain tensor (the same storage)."""
        with torch._C.DisableTorchFunctionSubclass():
            return self.view(self.shape)

    def full(self) -> torch.Tensor:
        """The global array, gathered over the mesh (on its device)."""
        mesh = self.sharding.mesh
        return wrap_shard(self.local().to(mesh.device_type), mesh,
                          self.placements, self.global_shape).full_tensor()


@dataclasses.dataclass
class ShardingRules:
    mesh: Any                       # AbstractMesh or DeviceMesh
    kind: str                       # train | prefill | decode
    rules: Dict[str, Any]
    dropped: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)       # (context, axis, dim) divisibility drops

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.shape)

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        n = 1
        for a in _flat(name):
            n *= self.shape[a]
        return n


def make_rules(mesh, kind: str, *, fsdp_layers: bool = False
               ) -> ShardingRules:
    """``fsdp_layers``: shard stacked params on their LAYER dim over "data"
    instead of the embed dim (the layers axis precedes embed in every
    stacked spec, so the guard's used-set drops the embed rule there
    while unstacked params keep plain embed-FSDP)."""
    table = dict(PARAM_RULES["train" if kind == "train" else "serve"])
    if fsdp_layers:
        table["layers"] = "data"
    return ShardingRules(mesh=mesh, kind=kind, rules=table)


def spec_for_axes(rules: ShardingRules, shape: Tuple[int, ...],
                  axes: Tuple[Optional[str], ...],
                  context: str = "") -> tuple:
    """A valid spec, dropping non-dividing or already-used mesh axes."""
    used: set = set()
    entries: List[Any] = []
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.rules.get(logical) if logical else None
        if mesh_axis is None:
            entries.append(None)
            continue
        size = rules.axis_size(mesh_axis)
        flat = _flat(mesh_axis)
        if dim % size != 0 or any(a in used for a in flat):
            if dim % size != 0:
                rules.dropped.append((context, str(logical), dim))
            entries.append(None)
            continue
        used.update(flat)
        entries.append(mesh_axis)
    return tuple(entries)


def tree_shardings(rules: ShardingRules, shapes_tree, axes_tree_,
                   context: str = "params"):
    """A ``NamedSharding`` tree parallel to a tree of tensors (or anything
    with ``.shape``) and its tree of logical-axis tuples."""
    flat = flatten_with_paths(shapes_tree)
    axes = dict(flatten_with_paths(axes_tree_,
                                   is_leaf=lambda x: isinstance(x, tuple)))
    out = [NamedSharding(rules.mesh, spec_for_axes(
        rules, tuple(leaf.shape), tuple(axes[path]), context))
        for path, leaf in flat]
    return unflatten(shapes_tree, out)


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh)) or None


def _entry(e):
    """A spec entry as ``PartitionSpec`` normalizes it: a one-name tuple
    is the name itself."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else (tuple(e) or None)
    return e


def _spec(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


def batch_specs(rules: ShardingRules, cfg, shape_kind: str,
                batch_shapes: Dict[str, Any]) -> Dict[str, NamedSharding]:
    """Shardings for the input batch: batch dim over (pod, data)."""
    b = batch_axes(rules.mesh)
    out = {}
    for name, t in batch_shapes.items():
        shp = tuple(t.shape)
        nd = len(shp)
        if shp and shp[0] % rules.axis_size(b) == 0:
            spec = _spec(b, *([None] * (nd - 1)))
        else:
            spec = (None,) * nd
        out[name] = NamedSharding(rules.mesh, spec)
    return out


# per cache key: (offset from END of shape -> mesh axis), "b" = batch axes
_CACHE_KEY_RULES = {
    "k":    ((4, "b"), (3, "model")),
    "v":    ((4, "b"), (3, "model")),
    "pos":  ((2, "b"), (1, "model")),
    "h":    ((2, "b"), (1, "model")),
    "conv": ((3, "b"), (1, "model")),
    "state": ((4, "b"), (3, "model")),
    "tm_x": ((2, "b"), (1, "model")),
    "cm_x": ((2, "b"), (1, "model")),
    "k_scale": ((3, "b"), (2, "model")),
    "v_scale": ((3, "b"), (2, "model")),
}


def cache_shardings(rules: ShardingRules, cache_tree):
    """Decode-cache shardings, chosen by the cache dict keys:

      k/v  (…, B, T, K, D) : batch→(pod,data), seq→model (sequence-
                              parallel decode)
      pos  (…, B, T)       : matches k/v
      h    (…, B, D)       : batch→(pod,data), channel→model
      conv (…, B, w-1, D)  : batch→(pod,data), channel→model
      state(…, B, H, s, s) : batch→(pod,data), heads→model
      tm_x/cm_x (…, B, D)  : batch→(pod,data), channel→model

    All through the divisibility guard, so B=1 or H=40 stay replicated."""
    b = batch_axes(rules.mesh)
    out = []
    for path, leaf in flatten_with_paths(cache_tree):
        key = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries: List[Any] = [None] * nd
        used: set = set()
        for off, ax in _CACHE_KEY_RULES.get(key, ()):
            ax = b if ax == "b" else ax
            i = nd - off
            if i < 0 or ax is None:
                continue
            size = rules.axis_size(ax)
            flat = set(_flat(ax))
            if shape[i] % size == 0 and not (flat & used):
                entries[i] = ax
                used |= flat
            else:
                rules.dropped.append((f"cache/{key}", str(ax), shape[i]))
        out.append(NamedSharding(rules.mesh, _spec(*entries)))
    return unflatten(cache_tree, out)


# ---------------------------------------------------------------------------
# Activation policy: redistribution hints inside the model
# ---------------------------------------------------------------------------

class MeshPolicy:
    """Maps the model's activation tags to specs; ``acts`` redistributes a
    DTensor to its tag's spec (the reference's
    ``with_sharding_constraint``) and passes a plain tensor through, as
    ``policy=None`` does.

    ``seq_shard``: shard the residual stream on the SEQUENCE dim over
    "model" (Megatron-SP style) instead of the embed dim."""

    def __init__(self, rules: ShardingRules, cfg, *, seq_shard: bool = False):
        self.rules = rules
        self.mesh = rules.mesh
        b = batch_axes(rules.mesh)
        m = "model"

        def div(n):
            return m if n % rules.axis_size(m) == 0 else None
        if seq_shard:
            emb_spec = (b, m, None)
        else:
            emb_spec = (b, None, div(cfg.d_model))
        nh = getattr(cfg, "n_heads", 0) or 1
        nkv = getattr(cfg, "n_kv_heads", 0) or 1
        ne = getattr(cfg, "n_experts", 0) or 1
        self.table: Dict[str, tuple] = {
            # FSDP weight-gather hints: layer weights at their TP-only
            # sharding where they are used (the gather over "data")
            "block_in": (b, None, None),
            "w_ffn_in": (None, div(cfg.d_ff)),
            "w_ffn_out": (div(cfg.d_ff), None),
            "w_attn_q": (None, div(nh), None),
            "w_attn_kv": (None, div(nkv), None),
            "w_attn_out": (div(nh), None, None),
            "embeds": emb_spec,
            "embeds_dec": (b, None, div(cfg.d_model)),
            "ffn_hidden": (b, None, div(cfg.d_ff)),
            "rnn_hidden": (b, None, div(cfg.d_model)),
            "q5": (b, None, div(nkv), None, None),
            "kv4": (b, None, None, None),
            "kvcache": (b, m, None, None),
            "moe_buf": (div(ne), None, None),
            "moe_hidden": (div(ne), None, None),
        }
        self.table = {k: _spec(*v) for k, v in self.table.items()}

    def spec(self, kind: str, ndim: int) -> Optional[tuple]:
        spec = self.table.get(kind)
        return None if spec is None else tuple(spec[:ndim])

    def acts(self, x, kind: str):
        spec = self.spec(kind, x.ndim)
        if spec is None or not is_dtensor(x):
            return x
        want = placements(x.device_mesh, spec)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


def replicate(t, x):
    """The plain tensor ``t`` replicated on ``x``'s mesh (a constant that
    broadcasts against ``x``); ``t`` itself if ``x`` is plain."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate
    return from_global(t, x.device_mesh,
                       (Replicate(),) * x.device_mesh.ndim)


def at_use(t, x, dims):
    """``t`` (a param, or a plain constant) placed where it meets the
    activation ``x``, so that the op between them runs on each rank's
    shards: on each mesh axis over which ``x`` splits a dim that ``dims``
    pairs with a dim of ``t`` (``{x dim: t dim}``), ``t`` is split the
    same way (a slice of what the rank holds: no collective); on an axis
    over which ``x`` is whole, ``t`` keeps its own split of a dim that
    ``dims`` pairs with none (a weight's output dim: ``x @ t`` comes out
    split there); on every other axis ``t`` is whole (the FSDP gather
    over "data", of the weight and not of the activation).  A
    contraction whose dim ``x`` splits then leaves partial sums of the
    (small) result, reduced where it is next used.  A plain ``t`` (the
    same value on every rank) is placed so; ``t`` itself if ``x`` is
    plain."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate, Shard
    own = t.placements if is_dtensor(t) else (Replicate(),) * len(
        x.placements)
    paired = set(dims.values())
    want = []
    for p, q in zip(x.placements, own):
        if isinstance(p, Shard) and p.dim in dims:
            want.append(Shard(dims[p.dim]))
        elif isinstance(p, Replicate) and isinstance(q, Shard) \
                and q.dim not in paired:
            want.append(q)
        else:
            want.append(Replicate())
    want = tuple(want)
    if not is_dtensor(t):
        return from_global(t, x.device_mesh, want)
    return t if tuple(t.placements) == want else t.redistribute(
        placements=want)


def whole(x, dim: int):
    """``x`` with dim ``dim`` gathered over every mesh axis that splits
    it (its other splits kept): the activation a projection contracts,
    gathered once for every weight that reads it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.ndim
    want = tuple(Replicate() if p == Shard(dim) else p
                 for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(
        placements=want)


def placed_as(y, x):
    """``y`` redistributed to the placements of ``x`` (of the same
    shape): partial sums reduced straight to ``x``'s split (a
    reduce-scatter); ``y`` itself if either is plain."""
    if not (is_dtensor(y) and is_dtensor(x)) \
            or tuple(y.placements) == tuple(x.placements):
        return y
    return y.redistribute(placements=x.placements)


def _all_reduce(t, groups, op: str = "sum"):
    for g in groups:
        t = torch.ops._c10d_functional.wait_tensor(
            torch.ops._c10d_functional.all_reduce(t.contiguous(), op, g))
    return t


class _Psum(torch.autograd.Function):
    """The sum over process groups.  Its gradient is the same sum of the
    gradients where each rank's copy of the sum feeds that rank's own
    outputs, and the gradient as it is where every rank's outputs are
    the same (replicated) values."""

    @staticmethod
    def forward(ctx, t, groups, replicated):
        ctx.groups, ctx.replicated = groups, replicated
        return _all_reduce(t, groups)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.replicated else _all_reduce(g, ctx.groups),
                None, None)


def _groups(mesh, dims) -> tuple:
    return tuple(mesh.get_group(i).group_name for i in dims)


def psum(t, mesh, dims, *, replicated: bool = False):
    """The sum of the plain local tensor ``t`` over the mesh dims ``dims``
    (inside ``local_apply``: one all-reduce a dim), differentiable.  By
    default each rank's copy of the sum feeds that rank's own shard of
    the outputs, and the backward sums the gradient over the same ranks;
    ``replicated``: the outputs are replicated over ``dims`` (each rank
    holds the same values), and the gradient passes as it is."""
    groups = _groups(mesh, dims)
    return _Psum.apply(t, groups, replicated) if groups else t


def pmax(t, mesh, dims):
    """The maximum of the plain local tensor ``t`` over the mesh dims
    ``dims`` (not differentiable: a stabilizing shift)."""
    return _all_reduce(t.detach(), _groups(mesh, dims), "max")


def moved(plc, mapping):
    """Placements with each ``Shard(d)`` moved to ``Shard(mapping[d])``
    (replicated where ``mapping`` has no entry for ``d``)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(mapping[p.dim]) if isinstance(p, Shard)
                 and p.dim in mapping else
                 (p if not isinstance(p, Shard) else Replicate())
                 for p in plc)


def reduced(x):
    """A DTensor's partial sums reduced (``Partial`` → ``Replicate``);
    anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(placements=tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def split_dim(x, dim: int, sizes: Tuple[int, ...]):
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  On a
    DTensor the split runs on each rank's shard (``local_apply``, so the
    gradient is redistributed as needed): a sharded ``dim`` keeps its
    mesh axes on the first new dim where they divide ``sizes[0]``, and is
    gathered over the others first."""
    dim = dim % x.ndim
    shape = tuple(x.shape)
    new = shape[:dim] + tuple(sizes) + shape[dim + 1:]
    if not is_dtensor(x):
        return x.reshape(new)
    from torch.distributed.tensor import Replicate, Shard
    x = reduced(x)
    mesh = x.device_mesh
    plc, n = [], 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim) and sizes[0] % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            plc.append(p)
        else:
            plc.append(Replicate() if p == Shard(dim) else p)
    x = x.redistribute(placements=tuple(plc))
    k = len(sizes) - 1
    out = moved(x.placements, {d: d if d <= dim else d + k
                               for d in range(x.ndim)})
    return local_apply(lambda t: t.reshape(
        t.shape[:dim] + (t.shape[dim] * sizes[0] // shape[dim],)
        + tuple(sizes[1:]) + t.shape[dim + 1:]), list(out), x)


def merge_dims(x, dim: int, count: int):
    """``x`` with dims ``dim .. dim+count-1`` merged into one (a
    reshape); on a DTensor only the first of them may stay sharded, the
    others are gathered first, and the merge runs on each rank's
    shard."""
    shape = tuple(x.shape)
    merged = 1
    for s in shape[dim:dim + count]:
        merged *= s
    new = shape[:dim] + (merged,) + shape[dim + count:]
    if not is_dtensor(x):
        return x.reshape(new)
    from torch.distributed.tensor import Replicate, Shard
    x = reduced(x)
    x = x.redistribute(placements=tuple(
        Replicate() if isinstance(p, Shard) and dim < p.dim < dim + count
        else p for p in x.placements))
    out = moved(x.placements, {d: d if d <= dim else d - count + 1
                               for d in range(x.ndim)
                               if not dim < d < dim + count})
    return local_apply(lambda t: t.reshape(
        t.shape[:dim] + (-1,) + t.shape[dim + count:]), list(out), x)


def assign(dst, src) -> None:
    """``dst.copy_(src)`` in place, ``src`` first redistributed to
    ``dst``'s placements when both are DTensors."""
    if is_dtensor(dst) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(placements=dst.placements)
    dst.copy_(src)


def local_apply(fn, out_placements, *args):
    """``fn(*args)`` on each rank's own shards (``local_map``): every
    DTensor leaf of ``args`` enters as its local tensor, at its own
    placements, and the outputs leave as DTensors at ``out_placements``
    (one entry per output tensor; ``"like"`` takes the first DTensor
    leaf's).  With no DTensor leaf ``fn`` runs on the plain tensors as
    they are.

    An input that holds partial sums is reduced first (``fn`` sees whole
    values).  An input replicated over a mesh axis along which the
    outputs vary (are sharded) gets a gradient that each rank holds only
    in part: its gradient placement there is ``Partial`` (summed over
    the axis)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    flat, spec = tree_flatten(args)
    if not any(is_dtensor(a) for a in flat):
        return fn(*args)
    flat = [reduced(a) for a in flat]
    args = tree_unflatten(flat, spec)
    first = next(a for a in flat if is_dtensor(a))
    from torch.distributed.tensor.experimental import local_map
    if out_placements == "like":
        # a list: local_map reads a tuple as one entry per output
        out_placements = list(first.placements)
    outs = (out_placements if isinstance(out_placements, tuple)
            else (out_placements,))
    varies = [any(o is not None and not isinstance(o[i], Replicate)
                  for o in outs) for i in range(first.device_mesh.ndim)]
    inp = tuple(a.placements if is_dtensor(a) else None for a in flat)
    grad = tuple(None if p is None else tuple(
        Partial() if v and isinstance(q, Replicate) else q
        for q, v in zip(p, varies)) for p in inp)
    return local_map(fn, out_placements=out_placements, in_placements=inp,
                     in_grad_placements=grad,
                     device_mesh=first.device_mesh)(*args)
