"""The port's serving half of the model against the reference: ``prefill``
(with and without ``last_pos``), ``init_cache``, ``decode_step`` and the
int8 KV cache (``kv_quant``), on ``reduced()`` configs with the same
weights (the reference's init, constants perturbed, carried across by
``params_from_numpy``).  The reference's prefill and decode run no Pallas
kernel, and neither do the port's.

Tolerances: rtol 1e-5, and atol 1e-5 of the tensor's scale (its largest
magnitude, at least 1), on logits and float cache leaves; integer leaves
(positions, int8 K/V) and tokens equal.  The scale is there because K, V
and logits reach 16 in magnitude, where the two frameworks' fp32 einsums,
summed in another order, differ by up to 5e-5 (3e-6 of the scale).  One
exception, stated here before it is used: the logits of a decode step are
held to 5e-5 of their scale.  Griffin's local attention is ill-conditioned
at this width: on its fifth step from S = 40, the reference's and the
port's fp32 logits lie 6.9e-5 and 3.9e-5 from a float64 run of the port
(1.8e-5 and 1.0e-5 of the scale, 3.9), so 2.8e-5 of the scale apart,
while their caches stay within 1e-5.  Decode after
``prefill(S)`` against the last logits of ``prefill(S + 1)`` (the port
against itself) within 1e-4 of the logits' scale; int8 decode against the
float decode within 0.25, as the reference's
``test_kv_quant_decode_close_to_fp`` holds them.

Every arch of ``ALL_ARCHS`` runs: musicgen-large takes (B, S, d) embeds
(and an embed a decode step) and returns (B, 4, vocab) codebook logits;
the MoE archs route their prefill's B*S tokens under the published
capacity factor, both packages dropping the same ones, and a decode
step's B rows.  Decode after ``prefill(S)`` equals ``prefill(S + 1)``
only where capacity drops nothing, so that test lifts the MoE capacity
factor to n_experts / top_k (C >= T), as the reference's
``test_moe_decode_matches_prefill_no_dropping`` does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Transformer as RefTransformer
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.models import Transformer, params_from_numpy
from repro_torch.serve.kvpool import tree_flatten

ARCHS = tuple(cfg.name for cfg in ALL_ARCHS)
TOL = 1e-5
DECODE_LOGITS_TOL = 5e-5
MAX_SEQ = 48


@functools.lru_cache(maxsize=None)
def numpy_params(name: str):
    """The reference's init of reduced(name) as numpy; leaves it sets to a
    constant get seeded noise, so every path carries a signal (decays
    only 0.02: see tests/test_torch_models.py)."""
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


def models(name, kv_quant=False):
    """(reference model, reference params, port model, port params)."""
    tree = numpy_params(name)
    return (RefTransformer(ref_reduced(ref_get_config(name)),
                           kv_quant=kv_quant),
            jax.tree.map(jnp.asarray, tree),
            Transformer(reduced(get_config(name)), kv_quant=kv_quant),
            params_from_numpy(tree, "cpu"))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 257, shape) \
        .astype(np.int32)


def _inputs(cfg, shape, seed):
    """A batch of ``shape`` (B, S) or (B,) positions: tokens, or embeds
    (..., d_model) for ``input_embeds`` archs."""
    if cfg.input_embeds:
        return {"embeds": np.random.default_rng(seed).standard_normal(
            shape + (cfg.d_model,)).astype(np.float32)}
    return {"tokens": _tokens(shape, seed)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_tree_close(got, want, tol=TOL):
    """Every leaf: same path, shape and dtype; floats within ``tol``,
    integers equal."""
    paths, leaves = tree_flatten(got)
    want_paths, want_leaves = tree_flatten(jax.tree.map(np.asarray, want))
    assert paths == want_paths
    for path, g, w in zip(paths, leaves, want_leaves):
        assert_leaf_close(g.numpy(), w, path, tol)


def assert_leaf_close(g, w, path, tol=TOL):
    """One leaf: same shape and dtype; floats within ``tol`` (atol of the
    leaf's scale), integers equal."""
    assert g.shape == w.shape and g.dtype == w.dtype, \
        (path, g.shape, w.shape, g.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=tol, atol=_atol(w, tol),
                                   err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


def _atol(want, tol):
    return tol * max(1.0, float(np.abs(want).max(initial=0.0)))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=_atol(want, tol))


@pytest.mark.parametrize("last_pos", [False, True], ids=["last", "last_pos"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name, last_pos):
    """Logits and every cache leaf; S = 40 puts griffin's ring (window 32)
    on its wrapped layout (slot = pos % window)."""
    jm, jp, tm, tp = models(name)
    batch = _inputs(tm.cfg, (2, 40), seed=1)
    lp = np.array([17, 39], np.int32) if last_pos else None
    want, want_cache = jm.prefill(
        jp, _j(batch), max_seq=MAX_SEQ,
        last_pos=None if lp is None else jnp.asarray(lp))
    got, got_cache = tm.prefill(
        tp, _t(batch), max_seq=MAX_SEQ,
        last_pos=None if lp is None else torch.from_numpy(lp))
    assert got.shape == (2, tm.cfg.n_codebooks, 257) if tm.cfg.n_codebooks \
        else got.shape == (2, 257)
    _close(got, want)
    assert_tree_close(got_cache, want_cache)


@pytest.mark.parametrize("name,S", [(n, 40) for n in ARCHS]
                         + [("recurrentgemma-2b", 29)],
                         ids=[*ARCHS, "recurrentgemma-2b-ring-wraps"])
def test_decode_steps_match_reference(name, S):
    """Five greedy steps after the prefill: logits and caches each step.
    Griffin from S = 29 writes positions 29..33 into its ring of 32, so
    the decode side wraps (slot = pos % 32).  An embeds arch steps on a
    fresh seeded embed each step."""
    jm, jp, tm, tp = models(name)
    want, jc = jm.prefill(jp, _j(_inputs(tm.cfg, (2, S), seed=2)),
                          max_seq=MAX_SEQ)
    got, tc = tm.prefill(tp, _t(_inputs(tm.cfg, (2, S), seed=2)),
                         max_seq=MAX_SEQ)
    for i in range(5):
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), tok)
        pos = np.full((2,), S + i, np.int32)
        step = (_inputs(tm.cfg, (2,), seed=10 + i) if tm.cfg.input_embeds
                else {"tokens": tok})
        want, jc = jm.decode_step(jp, jc, _j(step), jnp.asarray(pos))
        got, tc = tm.decode_step(tp, tc, _t(step), torch.from_numpy(pos))
        _close(got, want, DECODE_LOGITS_TOL)
        assert_tree_close(tc, jc)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_prefill(name):
    """decode_step after prefill(S) == last logits of prefill(S + 1)
    (MoE: with the capacity factor that drops nothing)."""
    _, _, m, params = models(name)
    if m.cfg.is_moe:
        m = Transformer(dataclasses.replace(
            m.cfg, capacity_factor=m.cfg.n_experts / m.cfg.top_k))
    B, S = 2, 24
    full = _t(_inputs(m.cfg, (B, S + 1), seed=3))
    _, cache = m.prefill(params, {k: v[:, :S] for k, v in full.items()},
                         max_seq=S + 8)
    ld, _ = m.decode_step(params, cache, {k: v[:, S] for k, v in
                                          full.items()},
                          torch.full((B,), S, dtype=torch.int32))
    lf, _ = m.prefill(params, full, max_seq=S + 9)
    scale = lf.abs().max().item()
    np.testing.assert_allclose(ld.numpy(), lf.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-2b"])
def test_kv_quant_init_cache_layout(name):
    """int8 K/V with per-(token, head) fp32 scales: the reference's leaves,
    shapes and dtypes; the K/V bytes shrink by the fp32 itemsize."""
    jm, _, tm, _ = models(name, kv_quant=True)
    want = jm.init_cache(3, MAX_SEQ)
    got = tm.init_cache(3, MAX_SEQ, device="cpu")
    assert_tree_close(got, want)
    kv = got["attn"] if "attn" in got else got
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == \
        torch.float32
    plain = Transformer(tm.cfg).init_cache(3, MAX_SEQ, device="cpu")
    plain = plain["attn"] if "attn" in plain else plain
    assert plain["k"].numel() * plain["k"].element_size() == \
        4 * kv["k"].numel() * kv["k"].element_size()


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-2b"])
def test_kv_quant_decode_matches_reference(name):
    """Eight steps from the empty int8 cache: int8 leaves and positions
    equal, scales and logits within the tolerance; and the int8 logits
    within 0.25 of the float cache's (the reference's own bound)."""
    jm, jp, tm, tp = models(name, kv_quant=True)
    fp = Transformer(tm.cfg)
    B = 2
    toks = _tokens((B, 8), seed=4)
    jc = jm.init_cache(B, 16)
    tc = tm.init_cache(B, 16, device="cpu")
    fc = fp.init_cache(B, 16, device="cpu")
    err = 0.0
    for t in range(8):
        tok, pos = toks[:, t], np.full((B,), t, np.int32)
        want, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)},
                                  jnp.asarray(pos))
        got, tc = tm.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                                 torch.from_numpy(pos))
        ref, fc = fp.decode_step(tp, fc, {"tokens": torch.from_numpy(tok)},
                                 torch.from_numpy(pos))
        _close(got, want)
        assert_tree_close(tc, jc)
        err = max(err, (got - ref).abs().max().item())
    assert err < 0.25, err


def test_quantize_cache_is_decodes_layout():
    """A prefill's float KV, quantized for an int8 pool, has the tree and
    dtypes ``init_cache(kv_quant)`` gives, and each token's int8 row is
    what ``decode_step`` writes for that token."""
    _, _, tm, tp = models("qwen2.5-14b", kv_quant=True)
    toks = torch.from_numpy(_tokens((1, 9), seed=5))
    _, cache = tm.prefill(tp, {"tokens": toks[:, :8]}, max_seq=16)
    q = tm.quantize_cache(cache)
    paths, leaves = tree_flatten(q)
    want_paths, want = tree_flatten(tm.init_cache(1, 16, device="cpu"))
    assert paths == want_paths
    assert [x.dtype for x in leaves] == [x.dtype for x in want]
    # decode token 8 from an empty int8 cache holding the same prefix
    _, full = tm.prefill(tp, {"tokens": toks}, max_seq=16)
    fq = tm.quantize_cache(full)
    torch.testing.assert_close(fq["k"][:, :, :8], q["k"][:, :, :8])
    torch.testing.assert_close(fq["k_scale"][:, :, :8],
                               q["k_scale"][:, :, :8])
    tm.decode_step(tp, q, {"tokens": toks[:, 8]},
                   torch.tensor([8], dtype=torch.int32))
    # layer 0's K of token 8 (deeper layers read the int8 attention's
    # output, the float prefill does not): at most one rounding step apart
    assert (q["k"][0, :, 8].int() - fq["k"][0, :, 8].int()).abs().max() <= 1
    np.testing.assert_allclose(q["k_scale"][0, :, 8].numpy(),
                               fq["k_scale"][0, :, 8].numpy(), rtol=1e-5)


def test_codebook_logits_at_the_published_vocab():
    """musicgen-large's four 2048-way heads at the reduced width: prefill
    and decode logits are (B, 4, 2048) and the reference's."""
    name = "musicgen-large"
    jcfg = dataclasses.replace(ref_reduced(ref_get_config(name)),
                               vocab=2048)
    cfg = dataclasses.replace(reduced(get_config(name)), vocab=2048)
    tree = jax.tree.map(np.asarray, RefTransformer(jcfg).init(
        jax.random.key(4)))
    jm, tm = RefTransformer(jcfg), Transformer(cfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    assert tp["head"].shape == (cfg.d_model, 4 * 2048)
    batch = _inputs(cfg, (2, 12), seed=5)
    want, jc = jm.prefill(jp, _j(batch), max_seq=16)
    got, tc = tm.prefill(tp, _t(batch), max_seq=16)
    assert got.shape == (2, 4, 2048)
    _close(got, want)
    step = _inputs(cfg, (2,), seed=6)
    pos = np.full((2,), 12, np.int32)
    want, _ = jm.decode_step(jp, jc, _j(step), jnp.asarray(pos))
    got, _ = tm.decode_step(tp, tc, _t(step), torch.from_numpy(pos))
    assert got.shape == (2, 4, 2048)
    _close(got, want, DECODE_LOGITS_TOL)


def test_init_cache_without_device_needs_a_card():
    m = Transformer(reduced(get_config("qwen2.5-14b")))
    if torch.cuda.is_available():
        pytest.skip("a card is present: init_cache runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 8)
