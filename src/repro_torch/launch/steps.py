"""Step builders: abstract input specs and the step functions of every
(arch × shape × mesh) cell.

The port of ``src/repro/launch/steps.py``.  A train cell is the
reference's ``train_step``: value and gradient of ``Transformer.loss``
(``grad_accum`` micro-batches summed in fp32), then the optimizer's
update, in place (the reference donates its params and state).  Prefill
and decode cells are thin wrappers over ``prefill`` and ``decode_step``
with greedy ``argmax``.  The abstract arguments are ``meta`` tensors.

With a ``mesh`` (a ``DeviceMesh``) the params, the optimizer state (with
Adafactor's factored ``vr``/``vc``), the batch and the decode cache are
placed by the sharding rules (``CellArtifacts.in_shardings``; ``place``
puts concrete values there), the step runs with a ``MeshPolicy``, and
the abstract arguments are ``meta`` DTensors.  ``CellArtifacts.lower``
is the port's analogue of lowering: one run of the step on those
arguments under ``roofline.analysis.collective_trace`` (a
``CommDebugMode``), which returns the per-device bytes of params,
optimizer state and cache, the per-device FLOPs and the collectives,
and allocates nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ArchConfig, ShapeSpec
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (MeshPolicy, batch_specs,
                                    cache_shardings, is_dtensor, make_rules,
                                    mesh_shape, place, place_leaf,
                                    placed_as, tree_shardings)
from ..models import Transformer
from ..optim import (default_optimizer, offload_shardings,
                     offloaded_optimizer, opt_state_shardings)
from ..tree import leaves, unflatten

__all__ = ["input_specs", "build_cell", "CellArtifacts", "value_and_grad",
           "train_step"]


def input_specs(cfg: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """``meta``-device stand-ins for every model input of this cell, with
    the reference's shapes and types."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        if cfg.input_embeds:
            out["embeds"] = spec((B, cfg.d_model), dt)
        else:
            out["tokens"] = spec((B,), torch.int32)
        out["pos"] = spec((B,), torch.int32)
        return out
    if cfg.input_embeds:
        out["embeds"] = spec((B, S, cfg.d_model), dt)
    else:
        out["tokens"] = spec((B, S), torch.int32)
    if shape.kind == "train":
        lshape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        out["labels"] = spec(lshape, torch.int32)
    return out


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of ``tree`` (whole plain tensors)."""
    total = 0
    for t in leaves(tree):
        if not torch.is_tensor(t):
            continue
        loc = t.to_local() if is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


class CellArtifacts:
    """One (arch × shape × mesh) cell: its step function, abstract
    arguments, the arguments it updates in place (the reference's donated
    ones), their shardings (``None`` off a mesh) and metadata."""

    def __init__(self, fn, args_abstract: Tuple[Any, ...],
                 donate: Tuple[int, ...], meta: Dict[str, Any],
                 in_shardings=None):
        self.fn = fn
        self.args_abstract = args_abstract
        self.donate = donate
        self.meta = meta
        self.in_shardings = in_shardings

    def place(self, *args):
        """Concrete global arguments (equal on every rank) placed by
        ``in_shardings``; themselves off a mesh."""
        if self.in_shardings is None:
            return args
        return tuple(a if s is None else place(a, s)
                     for a, s in zip(args, self.in_shardings))

    def lower(self) -> Dict[str, Any]:
        """One run of the step on the abstract (``meta``) arguments under
        ``collective_trace``.  Returns the per-device bytes of the params,
        the optimizer state (host-resident under ``offload_opt``), the
        cache and the batch (tokens, labels, positions: with the others,
        the reference's ``argument_bytes``), the per-device FLOPs and the
        collective records."""
        from ..roofline.analysis import trace_step
        args = self.args_abstract
        rec = trace_step(self.fn, *args)
        kind = self.meta["kind"]
        batch = args[1:] if kind == "prefill" else args[2:]
        out = {"param_bytes": _local_bytes(args[0]),
               "opt_bytes": _local_bytes(args[1]) if kind == "train" else 0,
               "cache_bytes": _local_bytes(args[1]) if kind == "decode"
               else 0,
               "batch_bytes": sum(_local_bytes(a) for a in batch),
               "opt_on_host": bool(self.meta.get("offload_opt")),
               **rec}
        return out


def _micro(t, i: int, n: int):
    """Micro-batch i of n along the first axis; a DTensor splits its own
    rows (each micro-batch stays sharded as the batch is)."""
    if is_dtensor(t):
        loc = t.to_local()
        loc = loc.reshape((n, loc.shape[0] // n) + loc.shape[1:])[i]
        return DTensor.from_local(loc, t.device_mesh, t.placements,
                                  run_check=False)
    return t.reshape((n, t.shape[0] // n) + t.shape[1:])[i]


def value_and_grad(model: Transformer, params, batch, grad_accum: int = 1,
                   policy=None):
    """(loss, metrics, grads) of ``model.loss`` at ``params``, each of
    which it marks as requiring grad.  With
    ``grad_accum`` > 1 the batch splits into that many micro-batches along
    its first axis; their gradients are summed in fp32 and divided, as
    are their losses, and the metrics are ``{"ce": loss, "aux": 0.0}``,
    as the reference reports them."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    if grad_accum == 1:
        loss, metrics = model.loss(params, batch, policy)
        grads = torch.autograd.grad(loss, flat)
        return (loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                                for k, v in metrics.items()},
                unflatten(params, grads))
    mbs = [{k: _micro(t, i, grad_accum) for k, t in batch.items()}
           for i in range(grad_accum)]
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
    total = 0.0
    for mb in mbs:
        loss, _ = model.loss(params, mb, policy)
        for a, g in zip(acc, torch.autograd.grad(loss, flat)):
            # each micro-batch's gradient at its param's placement (the
            # models place each param at its point of use, so most
            # arrive there; partial sums over "data" are reduced here,
            # in the gradient's own type), then summed in fp32
            a.add_(placed_as(g, a).float())
        total = total + loss.detach()
    loss = total / grad_accum
    grads = [a.div_(grad_accum) for a in acc]
    return loss, {"ce": loss, "aux": 0.0}, unflatten(params, grads)


def train_step(model: Transformer, opt, params, opt_state, batch,
               grad_accum: int = 1, policy=None):
    """One optimizer step.  Returns (params, opt_state, metrics), the
    first two updated in place; the metrics stay on the device."""
    loss, metrics, grads = value_and_grad(model, params, batch, grad_accum,
                                          policy)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, {"loss": loss, **metrics}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh=None, *,
               use_pallas: bool = False, offload_opt: bool = False,
               remat: bool = True, grad_accum: int = 1,
               moe_ep: bool = False, kv_quant: bool = False,
               fsdp_layers: bool = False,
               seq_shard: bool = False) -> CellArtifacts:
    """The reference's signature.  ``remat`` is taken and not read, as in
    the reference: the loss recomputes each layer in the backward
    either way.  ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_mesh``);
    ``moe_ep``, ``fsdp_layers`` and ``seq_shard`` need one."""
    if mesh is None and (moe_ep or fsdp_layers or seq_shard):
        raise ValueError("moe_ep, fsdp_layers and seq_shard shard a cell: "
                         "they need a mesh")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(launch.mesh.make_mesh), not "
                            f"{type(mesh).__name__}")
    model = Transformer(cfg, use_pallas=use_pallas, moe_ep=moe_ep,
                        kv_quant=kv_quant)
    kind = shape.kind
    aparams = model.abstract_params()
    ispecs = input_specs(cfg, shape)
    meta = {"arch": cfg.name, "shape": shape.name, "kind": kind,
            "kv_quant": kv_quant, "use_pallas": use_pallas,
            "offload_opt": offload_opt, "fsdp_layers": fsdp_layers,
            "moe_ep": moe_ep}
    policy = rules = p_sh = None
    if mesh is not None:
        rules = make_rules(mesh, kind, fsdp_layers=fsdp_layers)
        policy = MeshPolicy(rules, cfg, seq_shard=seq_shard)
        p_sh = tree_shardings(rules, aparams, model.logical_axes())
        meta.update(mesh_shape=mesh_shape(mesh), dropped=rules.dropped)
        aparams = place(aparams, p_sh)

    def sharded(tree, sh):
        return tree if mesh is None else place(tree, sh)

    if kind == "train":
        opt = default_optimizer(cfg)
        aopt = opt.init(model.abstract_params())
        o_sh = None
        if mesh is not None:
            o_sh = opt_state_shardings(mesh, model.abstract_params(), p_sh,
                                        opt.name)
            if offload_opt:
                o_sh = offload_shardings(o_sh)
            aopt = place(aopt, o_sh)
        if offload_opt:
            opt = offloaded_optimizer(opt)
        meta["optimizer"] = opt.name
        b_sh = None if mesh is None else batch_specs(rules, cfg, kind, ispecs)

        def fn(params, opt_state, batch):
            return train_step(model, opt, params, opt_state, batch,
                              grad_accum, policy)
        return CellArtifacts(fn=fn, args_abstract=(aparams, aopt,
                                                   sharded(ispecs, b_sh)),
                             donate=(0, 1), meta=meta,
                             in_shardings=None if mesh is None
                             else (p_sh, o_sh, b_sh))

    max_seq = shape.seq_len
    if kind == "prefill":
        b_sh = None if mesh is None else batch_specs(rules, cfg, kind, ispecs)

        def prefill(params, batch):
            return model.prefill(params, batch, max_seq=max_seq,
                                 policy=policy)
        return CellArtifacts(fn=prefill, args_abstract=(
            aparams, sharded(ispecs, b_sh)), donate=(), meta=meta,
            in_shardings=None if mesh is None else (p_sh, b_sh))

    acache = model.init_cache(shape.global_batch, max_seq, device="meta")
    pos_spec = ispecs.pop("pos")
    c_sh = tok_sh = pos_sh = None
    if mesh is not None:
        c_sh = cache_shardings(rules, acache)
        tok_sh = batch_specs(rules, cfg, kind, ispecs)
        pos_sh = batch_specs(rules, cfg, kind, {"pos": pos_spec})["pos"]

    def serve_step(params, cache, batch, pos):
        logits, cache = model.decode_step(params, cache, batch, pos,
                                          policy=policy)
        # greedy next token: the serving driver feeds it back
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    args = (aparams, acache, ispecs, pos_spec)
    if mesh is not None:
        args = (aparams, place(acache, c_sh), place(ispecs, tok_sh),
                place_leaf(pos_spec, pos_sh))
    return CellArtifacts(fn=serve_step, args_abstract=args, donate=(1,),
                         meta=meta, in_shardings=None if mesh is None
                         else (p_sh, c_sh, tok_sh, pos_sh))
