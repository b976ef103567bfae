"""The model forward of the port against the reference, on ``reduced()``
configs with the same weights (the reference's init, carried across by
``params_from_numpy``).

The reference runs ``use_pallas=True`` through its Pallas kernels in
interpret mode (its default on the CPU); the port's ``use_pallas=True``
runs its kernel wrappers, which take their plain versions for CPU
tensors.  Leaves the reference initialises to a constant (conv weights,
lerp mixes, decays, biases, norm gains) are perturbed, so that every path
carries a signal; decay perturbations stay small, because the reference's
chunked wkv6 kernel divides by a cumulative decay product that underflows
fp32 for strong decays (why its registry leaves out block_t=128).

The slice as a whole (loss, hidden states, specs, the carry-across) runs
every arch of ``ALL_ARCHS``: dense, MoE (qwen3-moe-30b-a3b, arctic-480b;
``tests/test_torch_moe.py`` holds the layer itself) and musicgen-large's
embedding inputs with its four codebook heads.

Tolerances: modules 1e-4 (atol and rtol), the loss rtol 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attention
import repro.models.layers as ref_layers
import repro.models.rglru as ref_rglru
import repro.models.rwkv6 as ref_rwkv6
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Transformer as RefTransformer
from repro.models.transformer import model_spec as ref_model_spec
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import Transformer, model_spec, params_from_numpy
from repro_torch.models import attention, layers, rglru, rwkv6

ARCHS = tuple(cfg.name for cfg in ALL_ARCHS)
MODULE_TOL = 1e-4
LOSS_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _numpy_params(name: str):
    """The reference's init of reduced(name) as numpy, constants
    perturbed (see the module docstring)."""
    cfg = ref_reduced(ref_get_config(name))
    params = RefTransformer(cfg).init(jax.random.key(0))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        a = np.asarray(a)
        if not np.all(a == a.flat[0]):
            return a
        key = jax.tree_util.keystr(path)
        scale = 0.02 if ("w0" in key or "lora_b_w" in key) else 0.1
        return a + (scale * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(perturb, params)


def _both(name):
    """(reference cfg, port cfg, reference params, port params)."""
    tree = _numpy_params(name)
    return (ref_reduced(ref_get_config(name)), reduced(get_config(name)),
            jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu"))


def _layer(tree, *idx):
    for i in idx:
        tree = jax.tree.map(lambda t: t[i], tree)
    return tree


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close(got, want, tol=MODULE_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# --- modules ---------------------------------------------------------------

@pytest.mark.parametrize("branch", ["pallas", "plain", "state"])
def test_rwkv6_time_mix_matches_reference(branch):
    jcfg, cfg, jp, tp = _both("rwkv6-3b")
    jlp = _layer(jp["layers"]["rwkv"]["tm"], 0)
    tlp = jax.tree.map(lambda t: t[0], tp["layers"]["rwkv"]["tm"])
    x = _x((2, 64, cfg.d_model), seed=1)
    kw = {"use_pallas": branch == "pallas"}
    if branch == "state":
        H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        s0 = 0.1 * _x((2, H, hs, hs), seed=2)
        xp = _x((2, cfg.d_model), seed=3)
        want, (want_x, want_s) = ref_rwkv6.rwkv6_time_mix(
            jlp, jnp.asarray(x), jcfg, x_prev=jnp.asarray(xp),
            state=jnp.asarray(s0), use_pallas=True)
        got, (got_x, got_s) = rwkv6.rwkv6_time_mix(
            tlp, torch.from_numpy(x), cfg, x_prev=torch.from_numpy(xp),
            state=torch.from_numpy(s0), use_pallas=True)
    else:
        want, (want_x, want_s) = ref_rwkv6.rwkv6_time_mix(
            jlp, jnp.asarray(x), jcfg, **kw)
        got, (got_x, got_s) = rwkv6.rwkv6_time_mix(
            tlp, torch.from_numpy(x), cfg, **kw)
    _close(got, want)
    _close(got_x, want_x)
    _close(got_s, want_s)


def test_rwkv6_channel_mix_matches_reference():
    jcfg, cfg, jp, tp = _both("rwkv6-3b")
    x = _x((2, 32, cfg.d_model), seed=4)
    want, want_x = ref_rwkv6.rwkv6_channel_mix(
        _layer(jp["layers"]["rwkv"]["cm"], 1), jnp.asarray(x), jcfg)
    got, got_x = rwkv6.rwkv6_channel_mix(
        jax.tree.map(lambda t: t[1], tp["layers"]["rwkv"]["cm"]),
        torch.from_numpy(x), cfg)
    _close(got, want)
    _close(got_x, want_x)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_rglru_apply_matches_reference(use_pallas):
    jcfg, cfg, jp, tp = _both("recurrentgemma-2b")
    x = _x((2, 64, cfg.d_model), seed=5)
    want = ref_rglru.rglru_apply(_layer(jp["periods"]["rec"]["rglru"], 0, 1),
                                 jnp.asarray(x), jcfg, use_pallas=use_pallas)
    got, _ = rglru.rglru_apply(
        jax.tree.map(lambda t: t[0][1], tp["periods"]["rec"]["rglru"]),
        torch.from_numpy(x), cfg, use_pallas=use_pallas)
    _close(got, want)


@pytest.mark.parametrize("name,use_pallas", [
    ("recurrentgemma-2b", True), ("recurrentgemma-2b", False),
    ("qwen2.5-14b", True), ("qwen2.5-14b", False),
])
def test_attn_apply_matches_reference(name, use_pallas):
    jcfg, cfg, jp, tp = _both(name)
    stack = "periods" if cfg.layer_pattern == "griffin" else "layers"
    x = _x((2, 64, cfg.d_model), seed=6)
    pos = np.broadcast_to(np.arange(64), (2, 64))
    want = ref_attention.attn_apply(
        _layer(jp[stack]["attn"]["attn"] if stack == "periods"
               else jp[stack]["attn"], 0),
        jnp.asarray(x), jcfg, jnp.asarray(pos), window=cfg.local_window,
        use_pallas=use_pallas)
    tl = tp[stack]["attn"]["attn"] if stack == "periods" \
        else tp[stack]["attn"]
    got, _ = attention.attn_apply(
        jax.tree.map(lambda t: t[0], tl), torch.from_numpy(x), cfg,
        torch.from_numpy(np.ascontiguousarray(pos)),
        window=cfg.local_window, use_pallas=use_pallas)
    assert cfg.local_window > 0 or name == "qwen2.5-14b"
    _close(got, want)


@pytest.mark.parametrize("window", [0, 24])
def test_blockwise_attention_matches_reference(window):
    q = _x((2, 64, 2, 3, 16), seed=7)
    k, v = _x((2, 64, 2, 16), seed=8), _x((2, 64, 2, 16), seed=9)
    want = ref_attention.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), window=window, q_chunk=16, kv_chunk=32)
    got = attention.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), window=window, q_chunk=16,
        kv_chunk=32)
    _close(got, want, 2e-5)


# --- layers ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x, w = _x((3, 5, 48), seed=10), _x((48,), seed=11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_layers.rms_norm(jnp.asarray(x).astype(jdt),
                               jnp.asarray(w).astype(jdt))
    got = layers.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


def test_apply_rope_matches_reference():
    x = _x((2, 40, 3, 16), seed=12)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(np.ascontiguousarray(pos)), 1e4)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "sq_relu"])
def test_ffn_apply_matches_reference(activation):
    rng = np.random.default_rng(13)
    spec = layers.ffn_spec(32, 48, activation)
    params = {k: (rng.standard_normal(p.shape) / 6).astype(np.float32)
              for k, p in spec.items()}
    x = _x((2, 7, 32), seed=14)
    want = ref_layers.ffn_apply({k: jnp.asarray(v) for k, v in
                                 params.items()}, jnp.asarray(x), activation)
    got = layers.ffn_apply(params_from_numpy(params, "cpu"),
                           torch.from_numpy(x), activation)
    _close(got, want, 1e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((2, 9, 31)).astype(np.float32) * 3
    labels = rng.integers(0, 31, (2, 9)).astype(np.int32)
    labels[0, :4] = -1
    want = ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels).long())
    _close(got, want, 1e-6)


# --- the slice as a whole --------------------------------------------------

def _batch(cfg, seed, B=2, S=128):
    """Tokens (B, S), or embeds (B, S, d_model) for ``input_embeds`` archs,
    and labels (B, S[, n_codebooks])."""
    rng = np.random.default_rng(seed)
    if cfg.input_embeds:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S, cfg.n_codebooks))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _torch_batch(batch):
    """The port's batch: integer arrays as int64, floats as they are."""
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas", "plain"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_reference(name, use_pallas):
    jcfg, cfg, jp, tp = _both(name)
    batch = _batch(cfg, seed=16)
    want, want_m = RefTransformer(jcfg, use_pallas=use_pallas).loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_m = Transformer(cfg, use_pallas=use_pallas).loss(
        tp, _torch_batch(batch))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               rtol=LOSS_RTOL)
    # the router's aux loss, summed over the layers (0 without MoE)
    assert abs(float(got_m["aux"]) - float(want_m["aux"])) <= 1e-6
    assert (float(got_m["aux"]) > 0) == cfg.is_moe


@pytest.mark.parametrize("name", ARCHS)
def test_hidden_matches_reference_backbone(name):
    """``Transformer.hidden`` is the reference's backbone plus final norm:
    what the loss feeds the head.  On the plain paths: the reference's
    chunked wkv6 kernel rounds apart from the sequential recurrence by
    up to its own tolerance (2e-4), which the loss tests cover.

    The archs of this slice are held to 1e-4 of the states' scale (their
    largest magnitude) instead of 1e-4 absolute: their residual streams
    grow to 60-80 before the final norm at this width (nemotron-4-15b's
    squared ReLU most), where the port's and the reference's fp32 states
    lie 1.55e-3 and 1.41e-3 from a float64 run of the port, so about 1e-4
    apart after the norm, on elements near 0 too."""
    jcfg, cfg, jp, tp = _both(name)
    batch = _batch(cfg, seed=20)
    batch.pop("labels")
    ref = RefTransformer(jcfg)
    x = ref._embed(jp, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    pos = jnp.broadcast_to(jnp.arange(128), (2, 128))
    h, _, _ = ref._backbone(jp, x, pos, None)
    want = ref_layers.rms_norm(h, jp["final_norm"], jcfg.norm_eps)
    got = Transformer(cfg).hidden(tp, _torch_batch(batch))
    if name in NEW_ARCHS:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL,
                                   atol=MODULE_TOL * np.abs(want).max())
    else:
        _close(got, want)


def test_loss_chunks_long_sequences():
    """S = 1024 is two loss chunks of 512: the chunked CE equals the mean
    of the per-chunk CEs, as the reference's scan computes it."""
    jcfg, cfg, jp, tp = _both("qwen2.5-14b")
    rng = np.random.default_rng(17)
    batch = {k: rng.integers(0, cfg.vocab, (1, 1024)).astype(np.int32)
             for k in ("tokens", "labels")}
    want, _ = RefTransformer(jcfg).loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = Transformer(cfg).loss(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_kernel_path_goes_through_the_wrappers(monkeypatch):
    """With use_pallas the forward calls each kernel wrapper once per layer
    of its kind; without, none."""
    calls = {"wkv6": 0, "rglru_scan": 0, "flash": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(wk, "wkv6_folded",
                        counting("wkv6", wk.wkv6_folded))
    monkeypatch.setattr(rg, "rglru_scan",
                        counting("rglru_scan", rg.rglru_scan))
    monkeypatch.setattr(fa, "flash_attention_folded",
                        counting("flash", fa.flash_attention_folded))
    for name in ("rwkv6-3b", "recurrentgemma-2b"):
        _, cfg, _, tp = _both(name)
        batch = {k: torch.from_numpy(v).long()
                 for k, v in _batch(cfg, seed=18).items()}
        for use_pallas in (False, True):
            Transformer(cfg, use_pallas=use_pallas).loss(tp, batch)
    kinds = reduced(get_config("recurrentgemma-2b")).layer_kinds()
    assert calls == {"wkv6": reduced(get_config("rwkv6-3b")).n_layers,
                     "rglru_scan": kinds.count("rglru"),
                     "flash": kinds.count("attn")}


# --- specs, init, carry-across ---------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


@pytest.mark.parametrize("name", ARCHS + tuple(
    f"{n}-full" for n in ("recurrentgemma-2b", "qwen3-moe-30b-a3b",
                          "arctic-480b", "musicgen-large")))
def test_model_spec_matches_reference(name):
    full = name.endswith("-full")
    base = name[:-len("-full")] if full else name
    jcfg, cfg = ref_get_config(base), get_config(base)
    if not full:
        jcfg, cfg = ref_reduced(jcfg), reduced(cfg)
    want = _flat(ref_model_spec(jcfg))
    got = _flat(model_spec(cfg))
    assert got.keys() == want.keys()
    for k in want:
        assert dataclasses.astuple(got[k]) == dataclasses.astuple(want[k]), k


def test_configs_are_the_references():
    for cfg in ALL_ARCHS:
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(ref_get_config(cfg.name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_draws_the_specs_distributions(dtype):
    cfg = reduced(get_config("recurrentgemma-2b"))
    m = Transformer(cfg)
    params = _flat(m.init(torch.Generator().manual_seed(3), device="cpu",
                          dtype=dtype))
    spec = _flat(m.spec())
    assert params.keys() == spec.keys()
    for k, p in spec.items():
        t = params[k]
        assert tuple(t.shape) == p.shape and t.dtype == dtype, k
        if p.init in ("zeros", "ones"):
            assert bool((t == (p.init == "ones")).all()), k
    emb = params["embed"].float()
    assert abs(emb.std().item() * cfg.vocab ** 0.5 - 1.0) < 0.05
    again = _flat(m.init(torch.Generator().manual_seed(3), device="cpu",
                         dtype=dtype))
    assert all(torch.equal(params[k], again[k]) for k in params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_keeps_every_key_shape_and_value(dtype):
    cfg = ref_reduced(ref_get_config("recurrentgemma-2b"))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tree = jax.tree.map(np.asarray,
                        RefTransformer(cfg).init(jax.random.key(1), jdt))
    want = _flat(tree)
    if dtype == "bfloat16":
        assert all(a.dtype == ml_dtypes.bfloat16 for a in want.values())
    got = _flat(params_from_numpy(tree, "cpu"))
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert got[k].dtype == getattr(torch, dtype), k
        assert tuple(got[k].shape) == a.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      a.astype(np.float32), err_msg=k)
    cast = _flat(params_from_numpy(tree, "cpu", torch.float32))
    assert all(t.dtype == torch.float32 for t in cast.values())


NEW_ARCHS = ("internlm2-20b", "command-r-35b", "nemotron-4-15b",
             "chameleon-34b", "qwen3-moe-30b-a3b", "arctic-480b",
             "musicgen-large")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_params_from_numpy_carries_every_arch(name):
    """The new trees cross unchanged, in bf16 and cast to fp32: the MoE
    router, stacked experts and arctic's dense branch, musicgen's
    ``in_proj`` and its codebook-wide head, qk_norm gains, sq_relu's two
    matrices."""
    cfg = ref_reduced(ref_get_config(name))
    tree = jax.tree.map(np.asarray, RefTransformer(cfg).init(
        jax.random.key(2), jnp.bfloat16))
    want = _flat(tree)
    got = _flat(params_from_numpy(tree, "cpu"))
    assert got.keys() == want.keys() == _flat(model_spec(reduced(
        get_config(name)))).keys()
    for k, a in want.items():
        assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == \
            a.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      a.astype(np.float32), err_msg=k)
    keys = "/".join(want)
    assert ("moe/router" in keys) == cfg.is_moe
    assert ("moe/dense" in keys) == cfg.moe_dense_residual
    assert ("in_proj" in want) == cfg.input_embeds
    assert want["head"].shape[-1] == max(cfg.n_codebooks, 1) * cfg.vocab


def test_init_without_device_needs_a_card():
    m = Transformer(reduced(get_config("rwkv6-3b")))
    if torch.cuda.is_available():
        pytest.skip("a card is present: init runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(torch.Generator())


def _policy_runs(kind, name, moe_ep=False):
    """(with a MeshPolicy, without any) outputs of one entry point on
    plain CPU tensors."""
    from repro_torch.distributed.sharding import (MeshPolicy, abstract_mesh,
                                                  make_rules)
    cfg = reduced(get_config(name))
    model = Transformer(cfg, moe_ep=moe_ep)
    plain = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pol = MeshPolicy(make_rules(abstract_mesh((2, 4)), "train"), cfg)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=g,
                        dtype=torch.int32)
    if kind == "prefill":
        return (model.prefill(params, {"tokens": tok}, 16, policy=pol)[0],
                plain.prefill(params, {"tokens": tok}, 16)[0])
    if kind == "decode_step":
        pos = torch.zeros(2, dtype=torch.int32)
        return tuple(m.decode_step(params, m.init_cache(2, 16,
                                                        device="cpu"),
                                   {"tokens": tok[:, 0]}, pos,
                                   **kw)[0]
                     for m, kw in ((model, {"policy": pol}), (plain, {})))
    batch = {"tokens": tok, "labels": tok}
    return (model.loss(params, batch, policy=pol)[0],
            plain.loss(params, batch)[0])


@pytest.mark.parametrize("call", [
    lambda: _policy_runs("prefill", "qwen2.5-14b"),
    lambda: _policy_runs("decode_step", "qwen2.5-14b"),
    lambda: _policy_runs("loss", "qwen2.5-14b"),
    lambda: _policy_runs("loss", "qwen2.5-14b", moe_ep=True),
    lambda: _policy_runs("loss", "qwen3-moe-30b-a3b", moe_ep=True),
], ids=["prefill", "decode_step", "policy", "moe_ep", "moe"])
def test_later_slices_raise(call):
    """The mesh options on plain tensors: a sharding policy
    redistributes only DTensors, so prefill, decode_step and loss give
    the unsharded results bit for bit; ``moe_ep`` without a mesh, dense
    or MoE, is the plain model (sharded runs: test_torch_mesh.py)."""
    got, want = call()
    assert torch.equal(got, want)


@pytest.mark.parametrize("change", [
    {"n_codebooks": 4}, {"input_embeds": True, "kv_quant": True},
    {"n_experts": 4, "top_k": 2}], ids=["init_cache", "kv_quant", "moe"])
def test_features_of_this_slice_build(change):
    """A codebook head's cache, an int8 KV cache behind embedding inputs
    and MoE layers, which earlier slices refused, now build: the cache
    on the meta device has the reference's layout, and the params the
    reference's spec."""
    change = dict(change)
    kv_quant = change.pop("kv_quant", False)
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-14b")), **change)
    jcfg = dataclasses.replace(ref_reduced(ref_get_config("qwen2.5-14b")),
                               **change)
    m = Transformer(cfg, kv_quant=kv_quant)
    want = RefTransformer(jcfg, kv_quant=kv_quant)
    cache = _flat(m.init_cache(2, 8, device="meta"))
    want_cache = _flat(jax.eval_shape(lambda: want.init_cache(2, 8)))
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in cache.items()} == \
        {k: (t.shape, str(t.dtype)) for k, t in want_cache.items()}
    params = _flat(m.init(torch.Generator().manual_seed(0), device="cpu"))
    assert {k: tuple(t.shape) for k, t in params.items()} == \
        {k: p.shape for k, p in _flat(ref_model_spec(jcfg)).items()}
