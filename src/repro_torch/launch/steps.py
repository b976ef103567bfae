"""Step builders: abstract input specs and the step functions of every
(arch × shape) cell on one device.

The port of ``src/repro/launch/steps.py``.  A train cell is the
reference's ``train_step``: value and gradient of ``Transformer.loss``
(``grad_accum`` micro-batches summed in fp32), then the optimizer's
update, in place (the reference donates its params and state).  Prefill
and decode cells are thin wrappers over ``prefill`` and ``decode_step``
with greedy ``argmax``.  The abstract arguments are ``meta`` tensors.
Meshes (``mesh``, ``moe_ep``, ``fsdp_layers``, ``seq_shard``) and
lowering (``CellArtifacts.lower``) come with the mesh slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ArchConfig, ShapeSpec
from ..models import Transformer
from ..optim import default_optimizer, offloaded_optimizer
from ..tree import leaves, unflatten

__all__ = ["input_specs", "build_cell", "CellArtifacts", "value_and_grad",
           "train_step"]

_MESH = "comes with the mesh slice of the port"


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


class CellArtifacts:
    """One (arch × shape) cell: its step function, abstract arguments,
    the arguments it updates in place (the reference's donated ones), and
    metadata."""

    def __init__(self, fn, args_abstract: Tuple[Any, ...],
                 donate: Tuple[int, ...], meta: Dict[str, Any]):
        self.fn = fn
        self.args_abstract = args_abstract
        self.donate = donate
        self.meta = meta

    def lower(self):
        raise NotImplementedError(f"lowering a cell onto a mesh {_MESH}")


def value_and_grad(model: Transformer, params, batch, grad_accum: int = 1):
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
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, flat)
        return (loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                                for k, v in metrics.items()},
                unflatten(params, grads))
    mbs = [{k: t.reshape((grad_accum, t.shape[0] // grad_accum)
                         + t.shape[1:])[i] for k, t in batch.items()}
           for i in range(grad_accum)]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat]
    total = 0.0
    for mb in mbs:
        loss, _ = model.loss(params, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, flat)):
            a.add_(g.float())
        total = total + loss.detach()
    loss = total / grad_accum
    grads = [a.div_(grad_accum) for a in acc]
    return loss, {"ce": loss, "aux": 0.0}, unflatten(params, grads)


def train_step(model: Transformer, opt, params, opt_state, batch,
               grad_accum: int = 1):
    """One optimizer step.  Returns (params, opt_state, metrics), the
    first two updated in place; the metrics stay on the device."""
    loss, metrics, grads = value_and_grad(model, params, batch, grad_accum)
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
    either way."""
    if mesh is not None or moe_ep or fsdp_layers or seq_shard:
        raise NotImplementedError(f"mesh cells (mesh, moe_ep, fsdp_layers, "
                                  f"seq_shard) {_MESH}")
    model = Transformer(cfg, use_pallas=use_pallas, kv_quant=kv_quant)
    kind = shape.kind
    aparams = model.abstract_params()
    ispecs = input_specs(cfg, shape)
    meta = {"arch": cfg.name, "shape": shape.name, "kind": kind,
            "kv_quant": kv_quant, "use_pallas": use_pallas}

    if kind == "train":
        opt = default_optimizer(cfg)
        if offload_opt:
            opt = offloaded_optimizer(opt)
        meta["optimizer"] = opt.name
        aopt = opt.init(aparams)

        def fn(params, opt_state, batch):
            return train_step(model, opt, params, opt_state, batch,
                              grad_accum)
        return CellArtifacts(fn=fn, args_abstract=(aparams, aopt, ispecs),
                             donate=(0, 1), meta=meta)

    max_seq = shape.seq_len
    if kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch, max_seq=max_seq)
        return CellArtifacts(fn=prefill, args_abstract=(aparams, ispecs),
                             donate=(), meta=meta)

    acache = model.init_cache(shape.global_batch, max_seq, device="meta")
    pos_spec = ispecs.pop("pos")

    def serve_step(params, cache, batch, pos):
        logits, cache = model.decode_step(params, cache, batch, pos)
        # greedy next token: the serving driver feeds it back
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return CellArtifacts(fn=serve_step,
                         args_abstract=(aparams, acache, ispecs, pos_spec),
                         donate=(1,), meta=meta)
