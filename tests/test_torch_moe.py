"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``src/repro/models/moe.py``, on ``reduced()`` qwen3-moe-30b-a3b
(8 experts, top 2) and arctic-480b (top 2 plus the dense residual branch),
with the reference's init carried across by ``params_from_numpy``.

Tolerances: outputs 1e-5 (atol and rtol) in fp32 and 2e-2 in bf16 (the
reference kernel sweep's bf16 bound); the router aux loss 1e-6 absolute.
``bincount / (T*k)`` is exact where T*k is a power of two (S = 64 here)
and within about n**2 * 2**-25 / (T*k) of the reference's n repeated fp32
adds otherwise (S = 40: T*k = 160, n <= 160, under 1.6e-5 of an expert's
fraction in the worst case, about 1e-7 on these draws); the mean of the
router probabilities, reduced in another order, adds a few 1e-8.  The
tokens each expert keeps under capacity, and so the dropped set, must be
identical: at capacity factor 0.25 most experts drop tokens.
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
from repro.models.layers import init_tree as ref_init_tree
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_spec as ref_moe_spec
from repro_torch.configs import get_config, reduced
from repro_torch.models import Transformer, params_from_numpy
from repro_torch.models import moe

ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
FP32_TOL = 1e-5
BF16_TOL = 2e-2
AUX_TOL = 1e-6


def _cfgs(name, **changes):
    """(reference cfg, port cfg) of reduced(name), with ``changes``."""
    return (dataclasses.replace(ref_reduced(ref_get_config(name)), **changes),
            dataclasses.replace(reduced(get_config(name)), **changes))


@functools.lru_cache(maxsize=None)
def _numpy_params(name, activation=None, seed=0):
    """The reference's init of one reduced MoE layer, as numpy (fp32)."""
    jcfg, _ = _cfgs(name, **({"activation": activation} if activation
                             else {}))
    tree = ref_init_tree(ref_moe_spec(jcfg), jax.random.key(seed),
                         jnp.float32)
    return jax.tree.map(np.asarray, tree)


def _x(cfg, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


def _run(name, S=64, dtype="float32", tree=None, **changes):
    """Both layers on the same params and inputs: ((want, want_aux),
    (got, got_aux), port cfg, port params, x)."""
    jcfg, cfg = _cfgs(name, **changes)
    tree = _numpy_params(name, changes.get("activation")) if tree is None \
        else tree
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _x(cfg, S)
    want = ref_moe_apply(jax.tree.map(lambda a: jnp.asarray(a, jdt), tree),
                         jnp.asarray(x, jdt), jcfg)
    tp = params_from_numpy(tree, "cpu", tdt)
    got = moe.moe_apply(tp, torch.from_numpy(x).to(tdt), cfg)
    return want, got, cfg, tp, torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ref_dropped(tree, x, jcfg):
    """The reference's own dispatch, step by step as ``moe_apply`` takes
    it (src/repro/models/moe.py:54-79): the set of dropped (token,
    expert) assignments, and how many assignments there are."""
    E, k = jcfg.n_experts, jcfg.top_k
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    T = xf.shape[0]
    C = moe._capacity(T, E, k, jcfg.capacity_factor)
    probs = jax.nn.softmax(xf @ jnp.asarray(tree["router"]), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e)
    se, st = flat_e[order], flat_t[order]
    counts = jnp.zeros((E,), jnp.int32).at[se].add(1)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(T * k) - offsets[se]
    drop = np.asarray(rank >= C)
    return set(zip(np.asarray(st)[drop].tolist(),
                   np.asarray(se)[drop].tolist())), T * k


def _port_dropped(tp, x, cfg):
    xf = x.reshape(-1, cfg.d_model)
    T = xf.shape[0]
    C = moe._capacity(T, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    _, _, expert = moe._route(tp["router"], xf, cfg.top_k)
    flat_e = expert.reshape(-1)
    order, keep, slot = moe._dispatch(
        flat_e, torch.bincount(flat_e, minlength=cfg.n_experts), C)
    assert bool((slot[~keep] == cfg.n_experts * C).all())
    assert len(set(slot[keep].tolist())) == int(keep.sum())
    drop = order[~keep]
    return set(zip((drop // cfg.top_k).tolist(), flat_e[drop].tolist()))


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["published", "dropping"])
@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_reference_fp32(name, S, cf):
    (want, want_aux), (got, got_aux), cfg, tp, x = _run(
        name, S, capacity_factor=cf)
    _close(got, want, FP32_TOL)
    assert got_aux.dtype == torch.float32
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
    jcfg, _ = _cfgs(name, capacity_factor=cf)
    want_drop, n = _ref_dropped(_numpy_params(name), x.numpy(), jcfg)
    got_drop = _port_dropped(tp, x, cfg)
    assert got_drop == want_drop
    if cf < 1:
        assert 0 < len(got_drop) < n


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["published", "dropping"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_reference_bf16(name, cf):
    (want, want_aux), (got, got_aux), *_ = _run(
        name, dtype="bfloat16", capacity_factor=cf)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("activation", ["geglu", "sq_relu"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_other_expert_activations(name, activation):
    """geglu experts (gelu gate) and sq_relu experts (two matrices)."""
    (want, want_aux), (got, got_aux), _, tp, _ = _run(
        name, activation=activation)
    assert ("w_gate" in tp["experts"]) == (activation == "geglu")
    _close(got, want, FP32_TOL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("name", ARCHS)
def test_tied_router_columns_pick_the_lower_expert(name):
    """Experts 0 and 1 get identical router columns, so every token's
    probabilities for them tie exactly.  ``lax.top_k`` takes the lower
    index first; the port's stable descending sort does too, so the
    routing, the dropped set and the outputs are the reference's."""
    tree = dict(_numpy_params(name))
    router = tree["router"].copy()
    router[:, 1] = router[:, 0]
    router[:, 0] *= 4.0          # ...and large, so the tie lands in the top k
    router[:, 1] = router[:, 0]
    tree["router"] = router
    for cf in (1.25, 0.25):
        (want, want_aux), (got, got_aux), cfg, tp, x = _run(
            name, tree=tree, capacity_factor=cf)
        probs, _, expert = moe._route(tp["router"], x.reshape(-1, 64), 2)
        assert torch.equal(probs[:, 0], probs[:, 1])
        tied = (expert == 0).any(1) | (expert == 1).any(1)
        assert bool(tied.any())
        # where both tied experts are chosen, 0 comes first
        both = (expert == 0).any(1) & (expert == 1).any(1)
        assert bool((expert[both, 0] == 0).all())
        _close(got, want, FP32_TOL)
        assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
        jcfg, _ = _cfgs(name, capacity_factor=cf)
        assert _port_dropped(tp, x, cfg) == \
            _ref_dropped(tree, x.numpy(), jcfg)[0]


def test_dropped_token_passes_only_the_dense_branch():
    """With every expert's capacity filled, a dropped token's MoE output
    is 0 (qwen3-moe) or the dense branch alone (arctic), never a clamped
    slot's expert output."""
    for name in ARCHS:
        _, (got, _), cfg, tp, x = _run(name, capacity_factor=0.25)
        xf = x.reshape(-1, cfg.d_model)
        C = moe._capacity(xf.shape[0], cfg.n_experts, cfg.top_k, 0.25)
        _, _, expert = moe._route(tp["router"], xf, cfg.top_k)
        flat_e = expert.reshape(-1)
        order, keep, _ = moe._dispatch(
            flat_e, torch.bincount(flat_e, minlength=cfg.n_experts), C)
        kept = torch.zeros(flat_e.shape[0], dtype=torch.bool)
        kept[order] = keep
        gone = ~kept.reshape(-1, cfg.top_k).any(1)
        assert bool(gone.any())
        want = torch.zeros_like(xf[gone])
        if cfg.moe_dense_residual:
            from repro_torch.models.layers import ffn_apply
            want = ffn_apply(tp["dense"], xf[gone], cfg.activation)
        torch.testing.assert_close(got.reshape(-1, cfg.d_model)[gone], want,
                                   rtol=0, atol=0)


def test_repeated_calls_give_the_same_bits():
    _, (a, aux_a), cfg, tp, x = _run("qwen3-moe-30b-a3b")
    b, aux_b = moe.moe_apply(tp, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_moe_ep_waits_for_the_mesh_slice(tmp_path):
    """``moe_apply_ep`` on a one-rank gloo mesh (one "model" rank owns
    every expert) equals ``moe_apply`` with no drops; the 8-rank runs are
    in test_torch_mesh.py."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import init_process_group, make_mesh
    _, cfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=1000.0)
    _, (want, want_aux), _, tp, x = _run("qwen3-moe-30b-a3b",
                                         capacity_factor=1000.0)
    init_process_group("cpu", 0, 1, str(tmp_path))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        dp = {"router": distribute(tp["router"], mesh, ()),
              "experts": {k: distribute(v, mesh, ())
                          for k, v in tp["experts"].items()}}
        out, aux = moe.moe_apply_ep(dp, distribute(x, mesh, ()), cfg, mesh)
        torch.testing.assert_close(out.full_tensor(), want, rtol=FP32_TOL,
                                   atol=FP32_TOL)
        assert abs(float(aux.full_tensor()) - float(want_aux)) <= AUX_TOL
    finally:
        dist.destroy_process_group()
    assert Transformer(cfg, moe_ep=True).moe_ep


def test_moe_spec_matches_reference():
    for name in ARCHS:
        jcfg, cfg = _cfgs(name)
        want = jax.tree.leaves(ref_moe_spec(jcfg),
                               is_leaf=lambda p: hasattr(p, "axes"))
        got = jax.tree.leaves(moe.moe_spec(cfg),
                              is_leaf=lambda p: hasattr(p, "axes"))
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want]
        assert ("dense" in moe.moe_spec(cfg)) == cfg.moe_dense_residual


@pytest.mark.parametrize("name", ARCHS)
def test_no_drop_moe_equals_a_per_token_expert_loop(name):
    """With capacity to spare (C >= T) the layer is, token by token, the
    gate-weighted sum of its top-k experts' FFNs (plus the dense branch),
    as the reference's ``test_moe_vs_dense_oracle`` holds its own."""
    from repro_torch.models.layers import ffn_apply
    _, cfg = _cfgs(name, capacity_factor=1000.0)
    tp = params_from_numpy(_numpy_params(name), "cpu")
    x = torch.from_numpy(_x(cfg, 8)).reshape(-1, cfg.d_model)
    got, _ = moe.moe_apply(tp, x.reshape(2, 8, -1), cfg)
    _, gate, expert = moe._route(tp["router"], x, cfg.top_k)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(expert[t, j])
            ew = {k: v[e] for k, v in tp["experts"].items()}
            want[t] += gate[t, j] * ffn_apply(ew, x[t], cfg.activation)
    if cfg.moe_dense_residual:
        want = want + ffn_apply(tp["dense"], x, cfg.activation)
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want,
                               rtol=FP32_TOL, atol=FP32_TOL)
