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


# -- the sm90 backward's arithmetic, in plain PyTorch ------------------------

@pytest.mark.parametrize("G", [1, 5, 6])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_bwd_plain_matches_blockwise_and_reference_vjp(G, window):
    """``flash_attention_bwd_plain``, fed the plain forward's o and lse,
    gives the gradients of autograd through ``blockwise_attention`` and of
    the reference's custom_vjp (Pallas forward in interpret mode, blockwise
    backward), fp32 within 1e-5 of each gradient's scale.  S = 72 is no
    multiple of the kernels' 64-row tiles or of 128; S * G rows straddle
    query positions when G = 5, 6."""
    import jax

    from repro_torch.models.attention import blockwise_attention
    B, S, K, D = 1, 72, 2, 16
    q, k, v, g = _inputs(((B, S, K, G, D), (B, S, K, D), (B, S, K, D),
                          (B, S, K, G, D)), seed=10 * G + window)

    def f(q, k, v):
        return ref_ops.flash_attention(q, k, v, causal=True, window=window,
                                       block_q=S, block_k=S)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want_ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = blockwise_attention(*xs, causal=True, window=window)
    want = [x.numpy() for x in torch.autograd.grad(o, xs, torch.from_numpy(g))]

    qf, kf, vf = ops.fold_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    of, lse = fa.flash_attention_plain(qf, kf, vf, causal=True,
                                       window=window, return_lse=True)
    assert lse.shape == (B * K, S, G) and lse.dtype == torch.float32
    gf = torch.from_numpy(g).permute(0, 2, 1, 3, 4).reshape(B * K, S, G, D)
    dqf, dkf, dvf = fa.flash_attention_bwd_plain(qf, kf, vf, of, gf, lse,
                                                 causal=True, window=window)
    got = [(dqf / D ** 0.5).reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4),
           dkf.reshape(B, K, S, D).permute(0, 2, 1, 3),
           dvf.reshape(B, K, S, D).permute(0, 2, 1, 3)]
    for a, b, r in zip(got, want, want_ref):
        a = a.numpy()
        for ref_grad in (b, r):
            err = float(np.abs(a - ref_grad).max())
            assert err <= 1e-5 * float(np.abs(ref_grad).max()), err


@pytest.mark.parametrize("window", [0, 16])
def test_plain_lse_is_the_rows_logsumexp(window):
    """The plain forward's lse is each row's logsumexp over its visible
    scores, and exp(s - lse) over them sums to 1."""
    BK, S, G, D = 2, 40, 3, 8
    q, k, v = (torch.from_numpy(x) for x in _inputs(
        ((BK, S, G, D), (BK, S, D), (BK, S, D)), seed=window))
    o, lse = fa.flash_attention_plain(q, k, v, window=window, return_lse=True)
    torch.testing.assert_close(o, fa.flash_attention_plain(q, k, v,
                                                           window=window))
    s = torch.einsum("bsgd,btd->bsgt", q, k)
    i = torch.arange(S)
    visible = (i[:, None] >= i[None, :]) & \
        ((i[:, None] - i[None, :] < window) if window else True)
    s = s.masked_fill(~visible[None, :, None, :], -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1))
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1),
                               torch.ones(BK, S, G))


@pytest.mark.parametrize("dtype,D,S,T,window,want", [
    (torch.bfloat16, 128, 4096, 4096, 0, "sm90"),        # train-4k
    (torch.bfloat16, 64, 100, 100, 16, "sm90"),
    (torch.bfloat16, 128, 64, 96, 0, "sm90"),            # T > S
    (torch.bfloat16, 128, 96, 64, 0, "sm90"),            # causal, S > T
    (torch.bfloat16, 128, 96, 64, 40, "sm90"),           # S - T < window
    (torch.bfloat16, 128, 96, 64, 32, "blockwise"),      # rows see no key
    (torch.bfloat16, 128, 64, 0, 0, "blockwise"),        # no keys
    (torch.bfloat16, 256, 256, 256, 2048, "blockwise"),  # recurrentgemma
    (torch.bfloat16, 32, 64, 64, 0, "blockwise"),        # the SIMT route
    (torch.float32, 128, 64, 64, 0, "blockwise"),
    (torch.float16, 128, 64, 64, 0, "blockwise"),
])
def test_bwd_route_by_shape(dtype, D, S, T, window, want):
    """The sm90 backward takes bf16 at D = 64, 128 where every row sees a
    key; D = 256, the SIMT route and rows that see no key recompute
    through ``blockwise_attention``."""
    assert fa.bwd_route(dtype, D, S, T, window) == want
    assert fa.SM90_BWD_HEAD_DIMS == (64, 128)
    assert set(fa.SM90_BWD_HEAD_DIMS) <= set(fa.SM90_HEAD_DIMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cpu_backward_goes_through_blockwise(dtype, D, monkeypatch):
    """CPU tensors launch nothing forward or backward, whatever their
    dtype and head dim: the gradient is recomputed through
    ``blockwise_attention`` and no counter moves."""
    from repro_torch.models import attention
    calls = []
    real = attention.blockwise_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(attention, "blockwise_attention", counted)
    shapes = ((1, 64, 2, 3, D), (1, 64, 2, D), (1, 64, 2, D))
    xs = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
          for x in _inputs(shapes, seed=D)]
    before = _counts() + (fa.launches_bwd_sm90,)
    o = ops.flash_attention(*xs, window=16)
    grads = torch.autograd.grad(o, xs, torch.ones_like(o))
    assert len(calls) == 1
    assert all(g.shape == x.shape and g.dtype == x.dtype
               for g, x in zip(grads, xs))
    assert _counts() + (fa.launches_bwd_sm90,) == before


def test_bwd_folded_refuses_cpu_tensors_and_mismatched_operands():
    """``flash_attention_bwd_folded`` is the sm90 backward alone: CPU
    tensors raise (their gradient goes through ``blockwise_attention``,
    ``flash_attention_bwd_plain`` is the tests' reference), as do operands
    that do not match; no counter moves."""
    BK, S, G, D = 2, 48, 2, 16
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(
        ((BK, S, G, D), (BK, S, D), (BK, S, D), (BK, S, G, D)), seed=4))
    o, lse = fa.flash_attention_plain(q, k, v, window=8, return_lse=True)
    before = fa.launches_bwd_sm90
    with pytest.raises(ValueError, match="on a card"):
        fa.flash_attention_bwd_folded(q, k, v, o, g, lse, window=8)
    with pytest.raises(ValueError, match="want q, o, do"):
        fa.flash_attention_bwd_folded(q, k, v, o, g, lse[:, :-1], window=8)
    assert fa.launches_bwd_sm90 == before
