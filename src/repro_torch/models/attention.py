"""Attention: GQA with RoPE, the blockwise online-softmax path (no S x S
scores), and sliding-window local attention.

The port of ``src/repro/models/attention.py``.
``attn_apply(use_pallas=True)`` takes the CUDA flash kernel through
``kernels.ops.flash_attention`` (its plain version for CPU tensors);
``use_pallas=False`` takes ``blockwise_attention``, as the reference does.

The decode step (``attn_decode``) writes one token's K/V into the layer's
cache IN PLACE and attends over the whole cache (``decode_attention``),
as the reference does without a kernel.  A row whose slot lies past the
end of a full cache (an idle row of the serving engine keeps stepping)
writes nothing: JAX's ``.at[].set`` drops such an index, and
``drop_rows_set`` reproduces that without a device-side index error.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import Replicate, Shard

from ..distributed.sharding import (from_global, is_dtensor, like,
                                    local_apply, merge_dims, split_dim)
from ..kernels import ops as kops
from .layers import P, acts, apply_rope, rms_norm

__all__ = ["attn_spec", "attn_apply", "attn_decode", "init_kv_cache",
           "quantize_kv_cache", "blockwise_attention", "decode_attention",
           "drop_rows_set"]

NEG_INF = -1e30


def attn_spec(cfg, prefix_shape=(), prefix_names=()) -> Dict[str, P]:
    pa, pn = tuple(prefix_shape), tuple(prefix_names)
    d = cfg.d_model
    spec = {
        "w_q": P(pa + (d, cfg.n_heads, cfg.d_head),
                 pn + ("embed", "heads", "head_dim")),
        "w_k": P(pa + (d, cfg.n_kv_heads, cfg.d_head),
                 pn + ("embed", "kv_heads", "head_dim")),
        "w_v": P(pa + (d, cfg.n_kv_heads, cfg.d_head),
                 pn + ("embed", "kv_heads", "head_dim")),
        "w_o": P(pa + (cfg.n_heads, cfg.d_head, d),
                 pn + ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["b_q"] = P(pa + (cfg.n_heads, cfg.d_head),
                        pn + ("heads", "head_dim"), init="zeros")
        spec["b_k"] = P(pa + (cfg.n_kv_heads, cfg.d_head),
                        pn + ("kv_heads", "head_dim"), init="zeros")
        spec["b_v"] = P(pa + (cfg.n_kv_heads, cfg.d_head),
                        pn + ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        spec["qnorm"] = P(pa + (cfg.d_head,), pn + ("head_dim",),
                          init="ones")
        spec["knorm"] = P(pa + (cfg.d_head,), pn + ("head_dim",),
                          init="ones")
    return spec


def _project_qkv(params, x, cfg, positions, policy=None):
    q = torch.einsum("bsd,dhk->bshk", x,
                     acts(policy, params["w_q"], "w_attn_q"))
    k = torch.einsum("bsd,dhk->bshk", x,
                     acts(policy, params["w_k"], "w_attn_kv"))
    v = torch.einsum("bsd,dhk->bshk", x,
                     acts(policy, params["w_v"], "w_attn_kv"))
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    if "qnorm" in params:
        q = rms_norm(q, params["qnorm"])
        k = rms_norm(k, params["knorm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Flash-style attention without S x S scores.

    q: (B, S, K, G, D) — G query heads per KV head; k, v: (B, T, K, D).
    Online softmax over KV chunks, one Q chunk at a time."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"chunks do not divide: S={S} q_chunk={q_chunk}, "
                         f"T={T} kv_chunk={kv_chunk}")
    scale = 1.0 / (D ** 0.5)
    qf = q * scale
    dev = q.device
    outs = []
    for q0 in range(0, S, q_chunk):
        qblk = qf[:, q0:q0 + q_chunk].float()          # (B, qc, K, G, D)
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        o = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                        device=dev)
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((B, K, G, q_chunk), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, T, kv_chunk):
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                             k[:, k0:k0 + kv_chunk].float())
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p,
                              v[:, k0:k0 + kv_chunk].float())
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(lse[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))          # (B, qc, K, G, D)
    return torch.cat(outs, dim=1).to(q.dtype)


def _fold_heads(q, K: int, G: int):
    """(B, S, H, D) → (B, S, K, G, D).  On a mesh, heads split over an
    axis that does not divide K are gathered first (``split_dim``)."""
    return split_dim(q, 2, (K, G))


def _head_axis(q, cfg):
    """The mesh dim of "model" when q (B, S, K, G, D) is whole over it
    although its heads could split: K does not divide the axis (the
    ``q5`` spec replicates it) but the H = K*G query heads do.  The
    reference's GSPMD then splits the attention by query heads, the
    placement the output projection's heads propagate back; ``None``
    elsewhere."""
    if not is_dtensor(q) or "model" not in q.device_mesh.mesh_dim_names:
        return None
    i = q.device_mesh.mesh_dim_names.index("model")
    n = q.device_mesh.size(i)
    if n == 1 or q.placements[i] != Replicate() \
            or cfg.n_heads % n or cfg.n_kv_heads % n == 0:
        return None
    return i


def _attention_by_heads(core, q, k, v, axis: int):
    """``core`` on this rank's H/n query heads (n ranks on mesh dim
    ``axis``, over which q, k and v are whole and placed alike): each
    head attends with its own KV head (a fold of G = 1), and the output
    (B, S, H, D) is split by heads over ``axis``."""
    B, S, K, G, D = q.shape
    H = K * G
    nh = H // q.device_mesh.size(axis)
    j = q.device_mesh.get_local_rank(axis)
    out = tuple(Shard(2) if d == axis else p
                for d, p in enumerate(q.placements))

    def body(ql, kl, vl):
        Bl, Sl = ql.shape[:2]
        heads = torch.arange(j * nh, (j + 1) * nh, device=ql.device)
        qh = ql.reshape(Bl, Sl, H, D)[:, :, j * nh:(j + 1) * nh, None]
        o = core(qh.contiguous(), kl[:, :, heads // G],
                 vl[:, :, heads // G])
        return o.reshape(Bl, Sl, nh, D)
    return local_apply(body, list(out), q, k, v)


def attn_apply(params, x, cfg, positions, *, policy=None, window: int = 0,
               use_pallas: bool = False):
    """Training / prefill self-attention.  x: (B, S, d_model).  Returns
    (out, (k, v)): the roped keys and values, which a prefill packs into
    its cache."""
    B, S, _ = x.shape
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(params, x, cfg, positions, policy)
    q = acts(policy, _fold_heads(q, K, G), "q5")
    k = acts(policy, k, "kv4")
    v = acts(policy, v, "kv4")
    if is_dtensor(q):
        # the kernel runs on this rank's rows and KV heads (with their
        # query groups): k and v take q's sharding of (B, S, K)
        k = k.redistribute(placements=q.placements)
        v = v.redistribute(placements=q.placements)
    if use_pallas:
        def core(q, k, v):
            return kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        def core(q, k, v):
            return blockwise_attention(q, k, v, causal=True, window=window)
    axis = _head_axis(q, cfg) if policy is not None else None
    o = (_attention_by_heads(core, q, k, v, axis) if axis is not None
         else merge_dims(local_apply(core, "like", q, k, v), 2, 2))
    w_o = acts(policy, params["w_o"], "w_attn_out")
    return torch.einsum("bshk,hkd->bsd", o, w_o), (k, v)


# ---------------------------------------------------------------------------
# Decode path: single-token step against a KV cache.
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_seq: int, n_attn_layers: int,
                  dtype=torch.bfloat16, window: int = 0,
                  quant: bool = False, device=None):
    """Full cache (layers, B, T, K, D) — or a ring buffer of ``window``.

    ``quant``: int8 storage with per-(token, head) fp32 scales; the
    dequantization happens inside the fp32 attention einsum."""
    T = min(max_seq, window) if window else max_seq
    shape = (n_attn_layers, batch, T, cfg.n_kv_heads, cfg.d_head)
    pos = torch.full((n_attn_layers, batch, T), -1, dtype=torch.int32,
                     device=device)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def _quantize_kv(x):
    """x: (..., K, D) → (int8, scale (..., K)).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_cache(cache):
    """A float KV cache (k, v, pos; a prefill's) in the int8 layout of
    ``init_kv_cache(quant=True)``, each (token, head) quantized as
    ``attn_decode`` quantizes the token it writes."""
    kq, ks = _quantize_kv(cache["k"])
    vq, vs = _quantize_kv(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
            "pos": cache["pos"]}


def drop_rows_set(buf, rows, cols, values, n_cols: int) -> None:
    """``buf[rows, cols] = values`` in place, except that a row whose
    column is ``>= n_cols`` writes nothing — what JAX's ``.at[].set``
    does with an out-of-bounds index.  Such a row writes back the value
    already stored at an in-range column instead of indexing past the end
    (a device-side assert on CUDA), so it changes no element; the check
    stays on the device (no host sync)."""
    live = cols < n_cols
    safe = torch.where(live, cols, torch.zeros_like(cols))
    keep = live.reshape(live.shape + (1,) * (values.dim() - 1))
    buf[rows, safe] = torch.where(keep, values.to(buf.dtype),
                                  buf[rows, safe])


def decode_attention(q, k_cache, v_cache, cache_pos, pos, *, window: int = 0):
    """q: (B, 1, K, G, D); caches: (B, T, K, D); cache_pos: (B, T) absolute
    positions stored in each cache slot (-1 = empty); pos: (B,) current
    position.  Full-length masked attention: the validity mask handles
    both causal order and (for ring buffers) the window."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqkgd,btkd->bkgqt", (q * scale).float(),
                     k_cache.float())                        # (B,K,G,1,T)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window:
        valid = valid & (cache_pos > (pos[:, None] - window))
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v_cache.float())
    return o.to(q.dtype)


def attn_decode(params, x, cfg, cache, pos, *, policy=None, window: int = 0):
    """One decode step.  x: (B, 1, d_model); pos: (B,) int32 current index.
    cache: dict(k, v[, k_scale, v_scale], pos) for THIS layer, written in
    place.  Returns (out (B, 1, d), cache).

    On a mesh (DTensor cache) each rank writes and attends over its own
    cache shard: the sequence dim sharded over "model" is
    sequence-parallel decode, whose softmax statistics and outputs are
    all-reduced over "model" (``_decode_core``)."""
    B = x.shape[0]
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(params, x, cfg, like(pos[:, None], x), policy)
    q = _fold_heads(q, K, G)
    T = cache["k"].shape[1]
    names = [n for n in ("k", "v", "k_scale", "v_scale", "pos")
             if n in cache]
    group = None
    if is_dtensor(cache["k"]):
        # q, the new k/v and pos take the cache's batch sharding and are
        # whole over "model"; the cache's T shard is this rank's slots
        mesh = cache["k"].device_mesh
        plc = cache["pos"].placements
        rows = tuple(p if isinstance(p, Shard) and p.dim == 0
                     else Replicate() for p in plc)
        q, k, v = (t.redistribute(placements=rows) for t in (q, k, v))
        pos = like(pos, cache["pos"])
        base = from_global(torch.arange(T, device=pos.device)[None], mesh,
                           tuple(Shard(1) if p == Shard(1) else Replicate()
                                 for p in plc))
        if Shard(1) in plc:
            group = mesh.get_group(mesh.mesh_dim_names[plc.index(Shard(1))])
    else:
        base = None

    def core(q, k, v, pos, base, *bufs):
        c = dict(zip(names, bufs))
        return _decode_core(q, k, v, pos, None if base is None else base[0],
                            c, T, window, group)
    o = local_apply(core, "like", q, k, v, pos, base,
                    *(cache[n] for n in names))
    o = merge_dims(o, 2, 2)
    w_o = acts(policy, params["w_o"], "w_attn_out")
    return torch.einsum("bshk,hkd->bsd", o, w_o), cache


def _decode_core(q, k, v, pos, slots, cache, T: int, window: int, group):
    """Write one token's k/v into ``cache`` (in place) and attend.  On a
    mesh the cache holds the global slots ``slots`` of a T-slot cache
    (``None``: all of them) and a row whose slot lies elsewhere writes
    nothing here.  With ``group`` (the cache's T dim sharded over it) the
    softmax is combined across the group's ranks: max, sum and outputs
    all-reduced."""
    B = q.shape[0]
    slot = (pos % T) if window else pos              # ring buffer for local
    if slots is None:
        col, n = slot, T
    else:
        n = slots.shape[0]
        col = slot - slots[0]
        col = torch.where(col < 0, torch.full_like(col, n), col)
    b_idx = torch.arange(B, device=q.device)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k[:, 0])
        vq, vs = _quantize_kv(v[:, 0])
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            drop_rows_set(cache[name], b_idx, col, val, n)
        att_k = cache["k"].float() * cache["k_scale"][..., None]
        att_v = cache["v"].float() * cache["v_scale"][..., None]
    else:
        drop_rows_set(cache["k"], b_idx, col, k[:, 0], n)
        drop_rows_set(cache["v"], b_idx, col, v[:, 0], n)
        att_k, att_v = cache["k"], cache["v"]
    drop_rows_set(cache["pos"], b_idx, col, pos, n)
    if group is None:
        return decode_attention(q, att_k, att_v, cache["pos"], pos,
                                window=window)
    return _decode_attention_split(q, att_k, att_v, cache["pos"], pos,
                                   window, group)


def _decode_attention_split(q, k_cache, v_cache, cache_pos, pos, window,
                            group):
    """``decode_attention`` over a cache whose slots are split across
    ``group``: each rank's partial softmax, then the max, the sum and
    the weighted values all-reduced (Flash-Decoding's combine)."""
    from torch.distributed import _functional_collectives as funcol
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqkgd,btkd->bkgqt", (q * scale).float(),
                     k_cache.float())                        # (B,K,G,1,T)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window:
        valid = valid & (cache_pos > (pos[:, None] - window))
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(s - m)
    den = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    o = funcol.all_reduce(torch.einsum("bkgqt,btkd->bqkgd", p,
                                       v_cache.float()), "sum", group)
    return (o / den.permute(0, 3, 1, 2, 4)).to(q.dtype)
