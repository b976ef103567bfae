"""wkv6, rglru_scan and rmsnorm: the port's wrappers against the
reference's Pallas kernels (interpret mode, as the reference's own tests
run them on the CPU).  The CUDA kernels against their plain versions are
in ``test_torch_cuda.py``.

On the CPU each wrapper runs its plain PyTorch version.  The sweeps are
``tests/test_kernels.py``'s, every registry tile is covered at that file's
``_WKV6_SHAPES``/``_RGLRU_SHAPES``/``_RMSNORM_SHAPES`` sizes, and the
tolerances are that file's: wkv6 2e-4, rglru_scan 1e-5, rmsnorm fp32 1e-5
and bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
import repro.kernels.ref as ref_ref
import repro.kernels.variants as ref_variants
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import variants
from repro_torch.kernels import wkv6 as wk

WKV6_TOL = 2e-4
RGLRU_TOL = 1e-5
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

_WKV6_SHAPES = ((1, 128, 2, 8),) * 4 + ((2, 8),)
_RGLRU_SHAPES = ((1, 256, 8),) * 2
_RMSNORM_SHAPES = ((128, 32), (32,))


def _wkv6_inputs(B, T, H, hs, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (B, T, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    return r, k, v, w, u


def _rglru_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.4, 0.999, shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rmsnorm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1:]).astype(np.float32))


def _check_wkv6(inputs, tile):
    want_o, want_s = ref_ops.wkv6(*map(jnp.asarray, inputs), interpret=True,
                                  **tile)
    got_o, got_s = ops.wkv6(*map(torch.from_numpy, inputs), **tile)
    assert got_o.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=WKV6_TOL, atol=WKV6_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=WKV6_TOL, atol=WKV6_TOL)


def _check_rglru(a, b, tile):
    want = ref_ops.rglru_scan(jnp.asarray(a), jnp.asarray(b), interpret=True,
                              **tile)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), **tile)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RGLRU_TOL, atol=RGLRU_TOL)


def _check_rmsnorm(x, w, dtype, tile):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_ops.rmsnorm(jnp.asarray(x).astype(jdt),
                           jnp.asarray(w).astype(jdt), interpret=True, **tile)
    tdt = getattr(torch, dtype)
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      **tile)
    assert got.dtype == tdt
    tol = RMSNORM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# --- the reference's sweeps ------------------------------------------------

@pytest.mark.parametrize("B,T,D,block", [
    (1, 32, 8, 8), (2, 128, 24, 32), (3, 64, 16, 64),
])
def test_rglru_scan_sweep(B, T, D, block):
    _check_rglru(*_rglru_inputs((B, T, D), seed=T + D), {"block_t": block})


@pytest.mark.parametrize("B,T,H,hs,block", [
    (1, 32, 1, 8, 8), (2, 64, 3, 8, 16), (1, 128, 2, 16, 32),
])
def test_wkv6_sweep(B, T, H, hs, block):
    _check_wkv6(_wkv6_inputs(B, T, H, hs, seed=T + H), {"block_t": block})


@pytest.mark.parametrize("shape", [(8, 32), (4, 16, 48), (128, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_sweep(shape, dtype):
    _check_rmsnorm(*_rmsnorm_inputs(shape, seed=len(shape)), dtype, {})


# --- every registry tile ---------------------------------------------------

def _tile_cases():
    cases = []
    for kernel, shapes in (("wkv6", _WKV6_SHAPES),
                           ("rglru_scan", _RGLRU_SHAPES),
                           ("rmsnorm", _RMSNORM_SHAPES)):
        for v in ref_variants.variants_for(kernel, shapes):
            dtypes = ("float32", "bfloat16") if kernel == "rmsnorm" \
                else ("float32",)
            for dtype in dtypes:
                cases.append(pytest.param(kernel, v.kwargs(), dtype,
                                          id=f"{v.label}-{dtype}"))
    return cases


@pytest.mark.parametrize("kernel,tile,dtype", _tile_cases())
def test_every_registry_tile_matches_reference_kernel(kernel, tile, dtype):
    if kernel == "wkv6":
        _check_wkv6(_wkv6_inputs(*_WKV6_SHAPES[0], seed=11), tile)
    elif kernel == "rglru_scan":
        _check_rglru(*_rglru_inputs(_RGLRU_SHAPES[0], seed=12), tile)
    else:
        _check_rmsnorm(*_rmsnorm_inputs(_RMSNORM_SHAPES[0], seed=13), dtype,
                       tile)


@pytest.mark.parametrize("kernel,shapes", [
    ("wkv6", _WKV6_SHAPES), ("rglru_scan", _RGLRU_SHAPES),
    ("rmsnorm", _RMSNORM_SHAPES),
    ("wkv6", ((1, 4096, 40, 64),) * 4 + ((40, 64),)),
    ("rglru_scan", ((1, 4096, 2560),) * 2),
    ("rmsnorm", ((4096, 2560), (2560,))),
])
def test_registry_matches_reference(kernel, shapes):
    """The port refuses no tile the reference admits."""
    want = {v.label for v in ref_variants.variants_for(kernel, shapes)}
    got = {v.label for v in variants.variants_for(kernel, shapes)}
    assert got == want and len(got) >= 1
    assert variants.KERNELS[kernel]["grid"] == \
        ref_variants.KERNELS[kernel]["grid"]


# --- oracles, counters, refusals -------------------------------------------

def test_oracles_match_reference_oracles():
    r, k, v, w, u = _wkv6_inputs(2, 48, 3, 8, seed=5)
    def fold(t):
        return t.transpose(0, 2, 1, 3).reshape(6, 48, 8)
    uu = np.broadcast_to(u[None], (2, 3, 8)).reshape(6, 8)
    folded = [fold(t) for t in (r, k, v, w)] + [np.ascontiguousarray(uu)]
    got = ref.wkv6_ref(*map(torch.from_numpy, folded))
    want = ref_ref.wkv6_ref(*map(jnp.asarray, folded))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                   rtol=WKV6_TOL, atol=WKV6_TOL)
    a, b = _rglru_inputs((2, 40, 6), seed=6)
    np.testing.assert_allclose(
        ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=RGLRU_TOL, atol=RGLRU_TOL)
    x, g = _rmsnorm_inputs((4, 7, 24), seed=7)
    np.testing.assert_allclose(
        ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(ref_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)


def test_plain_paths_launch_nothing():
    before = (wk.launches, rg.launches, rn.launches)
    ops.wkv6(*map(torch.from_numpy, _wkv6_inputs(1, 16, 2, 8, seed=1)))
    ops.rglru_scan(*map(torch.from_numpy, _rglru_inputs((1, 16, 8), 2)))
    ops.rmsnorm(*map(torch.from_numpy, _rmsnorm_inputs((16, 8), 3)))
    assert (wk.launches, rg.launches, rn.launches) == before


@pytest.mark.parametrize("call", [
    lambda: wk.wkv6_folded(*(torch.zeros(2, 96, 8),) * 4,
                           torch.zeros(2, 8), block_t=64),
    lambda: wk.wkv6_folded(*(torch.zeros(2, 96, 8),) * 4,
                           torch.zeros(3, 8)),
    lambda: wk.wkv6_folded(*(torch.zeros(2, 96, 8),) * 3,
                           torch.zeros(2, 96, 4), torch.zeros(2, 8)),
    lambda: rg.rglru_scan(torch.zeros(1, 96, 8), torch.zeros(1, 96, 8),
                          block_t=64),
    lambda: rg.rglru_scan(torch.zeros(1, 96, 8), torch.zeros(1, 64, 8)),
    lambda: rn.rmsnorm(torch.zeros(96, 8), torch.zeros(8), block_rows=64),
    lambda: rn.rmsnorm(torch.zeros(96, 8), torch.zeros(6)),
    lambda: wk.wkv6_folded(*(torch.zeros(2, 16, 8, device="meta"),) * 4,
                           torch.zeros(2, 8, device="meta")),
], ids=["wkv6-tile", "wkv6-u", "wkv6-w", "rglru-tile", "rglru-shape",
        "rmsnorm-tile", "rmsnorm-w", "wkv6-meta"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
