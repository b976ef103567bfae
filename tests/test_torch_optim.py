"""The port's optimizers against the reference's (``src/repro/optim``):
AdamW and Adafactor ``update`` over five steps on the same params and
grads, ``default_optimizer``'s choice, and the offload wrapper, which is
the identity on the CPU.

Tolerances: fp32 params within 1e-6 of their scale (the two packages
round ``pow`` and the reductions apart); bf16 params within one bf16 ulp
of the reference's (the fp32 update may round to the neighbouring bf16
value).
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import default_optimizer as ref_default_optimizer
from repro_torch.configs import ALL_ARCHS
from repro_torch.models import params_from_numpy
from repro_torch.optim import (adafactor, adamw, default_optimizer,
                               host_memory_kind, offload, offload_shardings,
                               offloaded_optimizer, offloaded_state,
                               supports_pinned_host)
from repro_torch.tree import leaves

# the module, not the function the package exports under its name
adamw_mod = importlib.import_module("repro_torch.optim.adamw")

FP32_RTOL = 1e-6
OPTS = {"adamw": (adamw, ref_adamw), "adafactor": (adafactor, ref_adafactor)}


def _tree(seed):
    """Leaves of every rank the optimizers branch on: stacked (3-d), 2-d
    and 1-d, in nested dicts whose keys are not in sorted order."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 6, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "layers": {"z": rng.standard_normal((4, 9)).astype(np.float32),
                       "a": rng.standard_normal((2, 3)).astype(np.float32)}}


def _grads(n=5):
    rng = np.random.default_rng(1)
    return [jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape))
                         .astype(np.float32), _tree(0)) for _ in range(n)]


def _run_both(name, dtype, kw=None):
    make, ref_make = OPTS[name]
    kw = kw or {}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref, port = ref_make(**kw), make(**kw)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(0))
    rs = ref.init(rp)
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ts = port.init(tp)
    for g in _grads():
        rp, rs = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts = port.update(params_from_numpy(g, "cpu"), ts, tp)
    return rp, rs, tp, ts


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("adamw", {"grad_clip": 0.0}), ("adafactor", {}),
    ("adafactor", {"decay": 0.5, "clip_threshold": 0.1})],
    ids=["adamw", "adamw-weight_decay", "adamw-no_clip", "adafactor",
         "adafactor-decay-clip"])
def test_update_fp32_matches_reference(name, kw):
    rp, rs, tp, ts = _run_both(name, "float32", kw)
    for want, got in zip(jax.tree.leaves(rp), leaves(tp)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FP32_RTOL * np.abs(want).max())
    for want, got in zip(jax.tree.leaves(rs), leaves(ts)):
        want = np.asarray(want)
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=FP32_RTOL,
                                   atol=FP32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_bf16_within_one_ulp(name):
    rp, _, tp, ts = _run_both(name, "bfloat16")
    for want, got in zip(jax.tree.leaves(rp), leaves(tp)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want).astype(np.float32)
        got = got.float().numpy()
        # one ulp of bf16 at |want|: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    assert int(ts["step"]) == 5


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_tree_matches_reference_layout(name):
    """The same keys, shapes and types, leaf for leaf (what a checkpoint
    cross-load relies on)."""
    make, ref_make = OPTS[name]
    ref = ref_make().init(jax.tree.map(jnp.asarray, _tree(0)))
    port = make().init(params_from_numpy(_tree(0), "cpu"))
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got = leaves(port)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_is_in_place_and_returns_the_trees(name):
    make, _ = OPTS[name]
    opt = make()
    params = params_from_numpy(_tree(0), "cpu")
    state = opt.init(params)
    before = {id(t) for t in leaves(params) + leaves(state)}
    w = params["w"].clone()
    new_p, new_s = opt.update(params_from_numpy(_grads(1)[0], "cpu"),
                              state, params)
    assert new_p is params and new_s is state
    assert {id(t) for t in leaves(new_p) + leaves(new_s)} == before
    assert not torch.equal(params["w"], w)


def test_adamw_slices_change_no_value(monkeypatch):
    """The update walks each leaf in ``CHUNK``-element slices; with slices
    of 7 elements the params and state are bitwise those of one slice a
    leaf."""
    def run():
        opt = adamw(weight_decay=0.1)
        params = params_from_numpy(_tree(0), "cpu")
        state = opt.init(params)
        for g in _grads(3):
            opt.update(params_from_numpy(g, "cpu"), state, params)
        return leaves(params) + leaves(state)
    whole = run()
    monkeypatch.setattr(adamw_mod, "CHUNK", 7)
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_adamw_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """CPU tensors take ``kernels.adamw``'s plain slice loop and slice
    sum: the kernel library is never built (this machine needs no
    ``nvcc`` to import or run the module) and neither launch counter
    moves; so do the dry-run's ``meta`` tensors."""
    kadamw = importlib.import_module("repro_torch.kernels.adamw")
    from repro_torch.kernels import _build

    def no_nvcc(*args, **kw):
        raise AssertionError("the CPU path asked for the kernel library")
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(kadamw, "launches_leaf", 0)
    monkeypatch.setattr(kadamw, "launches_square_sum", 0)
    opt = adamw(weight_decay=0.1)
    params = params_from_numpy(_tree(0), "cpu")
    state = opt.init(params)
    for g in _grads(2):
        opt.update(params_from_numpy(g, "cpu"), state, params)
    assert (kadamw.launches_leaf, kadamw.launches_square_sum) == (0, 0)
    meta = torch.empty(8, device="meta")
    assert kadamw.square_sum(meta, chunk=4).device.type == "meta"
    kadamw.adamw_leaf(meta, meta.float(), meta.float(), meta,
                      *(torch.ones((), device="meta") for _ in range(3)),
                      b1=0.9, b2=0.95, eps=1e-8, lr=1e-4, weight_decay=0.0,
                      chunk=4)
    assert (kadamw.launches_leaf, kadamw.launches_square_sum) == (0, 0)
    # the card's operators exist, for CUDA tensors alone
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.square_sum(torch.ones(8))


def test_grads_are_not_modified():
    opt = adamw()
    params = params_from_numpy(_tree(0), "cpu")
    grads = params_from_numpy(_grads(1)[0], "cpu")
    copy = [g.clone() for g in leaves(grads)]
    opt.update(grads, opt.init(params), params)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads), copy))


@pytest.mark.parametrize("i", range(len(ALL_ARCHS)),
                         ids=[c.name for c in ALL_ARCHS])
def test_default_optimizer_matches_reference(i):
    assert default_optimizer(ALL_ARCHS[i]).name == \
        ref_default_optimizer(REF_ARCHS[i]).name
    assert (default_optimizer(ALL_ARCHS[i]).name == "adafactor") == \
        (ALL_ARCHS[i].name == "arctic-480b")


# --- offload ---------------------------------------------------------------

def test_host_memory_kind():
    assert host_memory_kind("cpu") is None
    assert not supports_pinned_host("cpu")
    assert host_memory_kind("cuda") == "pinned_host"
    assert host_memory_kind(torch.device("cuda", 0)) == "pinned_host"
    assert supports_pinned_host() == torch.cuda.is_available()


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_offload_is_the_identity_on_cpu(name):
    make, _ = OPTS[name]
    base = make()
    off = offloaded_optimizer(base)
    assert off.name == base.name + "+offload"
    p1, p2 = (params_from_numpy(_tree(0), "cpu") for _ in range(2))
    s1, s2 = base.init(p1), off.init(p2)
    assert not any(t.is_pinned() for t in leaves(s2))
    for g in _grads(3):
        base.update(params_from_numpy(g, "cpu"), s1, p1)
        off.update(params_from_numpy(g, "cpu"), s2, p2)
    for a, b in zip(leaves(p1) + leaves(s1), leaves(p2) + leaves(s2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_offload_pieces_give_the_whole_update(name, monkeypatch):
    """The units the offloaded update streams (slices of ``CHUNK``
    elements for AdamW, whole leaves for Adafactor), each run through the
    rule on its own, give bitwise the plain update."""
    monkeypatch.setattr(offload, "CHUNK", 11)
    make, _ = OPTS[name]
    opt = make()
    p1, p2 = (params_from_numpy(_tree(0), "cpu") for _ in range(2))
    s1, s2 = opt.init(p1), opt.init(p2)
    for g in _grads(3):
        opt.update(params_from_numpy(g, "cpu"), s1, p1)
        grads = params_from_numpy(g, "cpu")
        ctx = opt.rule.begin(leaves(grads), s2)
        units = list(offload._pieces(opt.rule, leaves(grads),
                                     opt.rule.slots(s2), leaves(p2)))
        sizes = [p.numel() for p in leaves(p2)]
        assert len(units) == (sum(-(-n // 11) for n in sizes)
                              if name == "adamw" else len(sizes))
        for gu, slot, pu in units:
            opt.rule.leaf(ctx, gu, slot, pu)
    for a, b in zip(leaves(p1) + leaves(s1), leaves(p2) + leaves(s2)):
        assert torch.equal(a, b)


def test_offloaded_state_needs_a_card():
    shapes = adamw().init(params_from_numpy(_tree(0), "meta"))
    with pytest.raises(ValueError):
        offloaded_state(shapes, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            offloaded_state(shapes)


def test_offload_shardings_waits_for_the_mesh():
    """Shardings on a card's mesh move their local shards to pinned host
    memory, with the same placements; a CPU or abstract mesh has no host
    memory kind apart, so its shardings stay as they are."""
    import types
    from repro_torch.distributed.sharding import NamedSharding, abstract_mesh
    card = types.SimpleNamespace(device_type="cuda")
    tree = {"m": {"w": NamedSharding(card, ("data", None))},
            "step": NamedSharding(card, ())}
    moved = offload_shardings(tree)
    assert moved["m"]["w"].spec == ("data", None)
    assert moved["m"]["w"].memory_kind == "pinned_host"
    assert moved["step"].memory_kind == "pinned_host"
    flat = {"w": NamedSharding(abstract_mesh((2, 4)), ("data",))}
    assert offload_shardings(flat) == flat


def test_bf16_reference_params_carry_across():
    """The bf16 trees the tests start from are the reference's values."""
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    for a, b in zip(jax.tree.leaves(rp), leaves(tp)):
        np.testing.assert_array_equal(
            np.asarray(a).view(np.int16),
            b.view(torch.int16).numpy())
        assert np.asarray(a).dtype == ml_dtypes.bfloat16
