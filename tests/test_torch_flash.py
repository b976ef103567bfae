"""Flash attention: the port's wrapper against the reference's Pallas
kernel (interpret mode, as the reference's own tests run it on the CPU).
The CUDA kernel against its plain version is in ``test_torch_cuda.py``.

On the CPU the wrapper runs its plain PyTorch version; every registry
tile is covered at ``tests/test_kernels.py``'s ``_FLASH_SHAPES`` sizes,
with G = 1 and G = 5 (qwen2.5-14b's group, not a power of two), causal
and sliding windows.  Tolerances are the reference's kernel sweep's:
fp32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
import repro.kernels.ref as ref_ref
import repro.kernels.variants as ref_variants
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, variants

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# Registry tiles the port refuses though the reference admits them, with
# the reason.  None: neither CUDA kernel's tiling depends on
# block_q/block_k, so every tile the reference admits launches.
REFUSED_TILES = {}


def _shapes(G):
    return ((1, 128, 1, G, 8), (1, 128, 1, 8), (1, 128, 1, 8))


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _cases():
    cases = []
    for G in (1, 5):
        for v in ref_variants.variants_for("flash_attention", _shapes(G)):
            for window in (0, 8, 32):
                cases.append(pytest.param(G, v.kwargs(), window, "float32",
                                          id=f"G{G}-{v.label}-w{window}-f32"))
            cases.append(pytest.param(G, v.kwargs(), 0, "bfloat16",
                                      id=f"G{G}-{v.label}-w0-bf16"))
    return cases


@pytest.mark.parametrize("G,tile,window,dtype", _cases())
def test_wrapper_matches_reference_kernel(G, tile, window, dtype):
    q, k, v = _inputs(_shapes(G), seed=G * 100 + window)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_ops.flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), causal=True,
        window=window, interpret=True, **tile)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=True, window=window, **tile)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_registry_matches_reference_but_for_refusals():
    for G in (1, 5):
        for shapes in (_shapes(G), ((1, 96, 1, G, 8), (1, 96, 1, 8),
                                    (1, 96, 1, 8)),
                       ((1, 4096, 8, G, 128), (1, 4096, 8, 128),
                        (1, 4096, 8, 128))):
            want = {v.label for v in
                    ref_variants.variants_for("flash_attention", shapes)}
            got = {v.label for v in
                   variants.variants_for("flash_attention", shapes)}
            assert got == want - set(REFUSED_TILES)
    assert variants.KERNELS["flash_attention"]["grid"] == \
        ref_variants.KERNELS["flash_attention"]["grid"]


def test_numpy_in_numpy_out():
    """Host blocks and the numpy backend hand the wrapper numpy arrays."""
    q, k, v = _inputs(_shapes(5), seed=7)
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    want = ref_ref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_oracle_matches_reference_oracle(window):
    q, k, v = _inputs(((2, 64, 2, 5, 16), (2, 64, 2, 16), (2, 64, 2, 16)),
                      seed=3)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  window=window)
    want = ref_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                       window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _counts():
    return fa.launches, fa.launches_sm90, fa.launches_simt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 64, 128, 256])
def test_plain_path_launches_nothing(dtype, D):
    """CPU tensors take the plain version on either route's dtype and
    head dim: no counter moves."""
    shapes = ((1, 64, 1, 2, D), (1, 64, 1, D), (1, 64, 1, D))
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _inputs(shapes, seed=1))
    before = _counts()
    ops.flash_attention(q, k, v)
    assert _counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [1, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512])
def test_route_by_dtype_and_head_dim(dtype, D):
    """bf16 with D in {64, 128, 256} takes the tensor-core kernel; every
    other case the SIMT one (which refuses what it is not built for)."""
    want = "sm90" if dtype == torch.bfloat16 and D in (64, 128, 256) \
        else "simt"
    assert fa.route(dtype, D) == want
    assert fa.SM90_HEAD_DIMS == (64, 128, 256)
    assert set(fa.SM90_HEAD_DIMS) <= set(fa.HEAD_DIMS)


@pytest.mark.parametrize("bad", [
    dict(block_q=96),                               # does not divide S
    dict(block_k=48),                               # does not divide T
    dict(window=-1),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(_shapes(1), seed=2))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **bad)


def test_wrapper_rejects_mismatched_operands():
    qf = torch.zeros(2, 64, 5, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_folded(qf, torch.zeros(2, 64, 8),
                                  torch.zeros(2, 64, 8))
    with pytest.raises(TypeError):
        fa.flash_attention_folded(qf, torch.zeros(2, 64, 16),
                                  torch.zeros(2, 64, 16,
                                              dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        fa.flash_attention_folded(qf.to("meta"), torch.zeros(2, 64, 16,
                                                             device="meta"),
                                  torch.zeros(2, 64, 16, device="meta"))


# -- the gradient ------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16])
def test_flash_gradient_matches_reference_vjp(window):
    """The port's ops.flash_attention differentiates like the reference's
    custom_vjp (Pallas forward in interpret mode, blockwise backward):
    q, k and v gradients within 1e-5 of the reference's scale, fp32.
    The CPU tensors take the same autograd Function the card's do."""
    import jax
    B, S, K, G, D = 1, 64, 2, 2, 16
    q, k, v, g = _inputs(((B, S, K, G, D), (B, S, K, D), (B, S, K, D),
                          (B, S, K, G, D)), seed=window + 3)

    def f(q, k, v):
        return ref_ops.flash_attention(q, k, v, causal=True, window=window)
    want_o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))

    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*xs, causal=True, window=window)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, xs, torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               rtol=0, atol=TOL["float32"])
    for a, b in zip(got, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), err


def test_flash_numpy_entry_and_no_grad_inputs():
    """numpy in, numpy out; tensors that need no gradient give an output
    without one."""
    q, k, v = _inputs(_shapes(1), seed=9)
    out = ops.flash_attention(q, k, v)
    assert isinstance(out, np.ndarray) and out.shape == q.shape
    t = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert not t.requires_grad
    np.testing.assert_array_equal(t.numpy(), out)
