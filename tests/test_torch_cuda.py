"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the model forward with kernels against its plain
path.  Every test needs a card and skips without one (the kernels have no
CPU mode).  The file imports neither JAX nor the reference, so it runs on
a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel sweeps' (flash fp32 2e-5, bf16
2e-2; wkv6 2e-4; rglru_scan 1e-5; rmsnorm fp32 1e-5, bf16 2e-2) and 1e-4
relative on the fp32 loss.  The bf16 model forward through the tensor-core
flash kernel is held to 1e-2 relative on the loss and 5e-2 of their scale
on the final hidden states: both paths round every activation to bf16
(2^-8 relative), and the kernel rounds its softmax weights to bf16 too, so
single roundings differ by an ulp here and there and the norms carry that
through the layers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import Transformer

pytestmark = pytest.mark.cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WKV6_TOL = 2e-4
RGLRU_TOL = 1e-5
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _normal(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_cuda_kernel_matches_plain(cuda, D, dtype, window):
    rng = np.random.default_rng(D)
    BK, S, G = 2, 96, 5
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, S, D), rng), _normal((BK, S, D), rng)
    q, k, v = (torch.from_numpy(x).to(cuda, getattr(torch, dtype))
               for x in (q, k, v))
    before = fa.launches
    got = fa.flash_attention_folded(q, k, v, causal=True, window=window,
                                    block_q=96, block_k=96)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


_SIMT_CASES = [("float32", D) for D in fa.HEAD_DIMS] + \
    [("bfloat16", D) for D in fa.HEAD_DIMS if D < 64]


@pytest.mark.parametrize("dtype,D", _SIMT_CASES)
@pytest.mark.parametrize("G", [1, 5, 10])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("window", [0, 8, 64])
def test_cuda_simt_tile_edges(cuda, dtype, D, G, S, window):
    """The SIMT route around its tile edges: 64 rows of (S, G) a block, 64
    keys a chunk, so S = 63, 64, 65 end just before, on and after a key
    chunk, and S * G ragged row tiles; windows that end inside a chunk."""
    rng = np.random.default_rng(D * 1000 + G * 10 + S + window)
    BK = 2
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, S, D), rng), _normal((BK, S, D), rng)
    q, k, v = (torch.from_numpy(x).to(cuda, getattr(torch, dtype))
               for x in (q, k, v))
    assert fa.route(q.dtype, D) == "simt"
    before = (fa.launches_sm90, fa.launches_simt)
    got = fa.flash_attention_folded(q, k, v, causal=True, window=window,
                                    block_q=S, block_k=S)
    torch.cuda.synchronize()
    assert (fa.launches_sm90, fa.launches_simt) == (before[0],
                                                    before[1] + 1)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("D", fa.SM90_HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 5, 10])
@pytest.mark.parametrize("S", [96, 100, 256])
@pytest.mark.parametrize("window", [0, 8, 64])
def test_cuda_sm90_matches_plain(cuda, D, G, S, window):
    """The tensor-core route on ragged row tails (S·G = 480 rows is 3.75
    tiles of 128), windows that end inside a chunk, and every head dim it
    is built for."""
    rng = np.random.default_rng(D * 1000 + G * 10 + S)
    BK = 2
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, S, D), rng), _normal((BK, S, D), rng)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (q, k, v))
    assert fa.route(q.dtype, D) == "sm90"
    before = (fa.launches_sm90, fa.launches_simt)
    got = fa.flash_attention_folded(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (fa.launches_sm90, fa.launches_simt) == (before[0] + 1,
                                                    before[1])
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("hs", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_matches_plain(cuda, hs, dtype):
    rng = np.random.default_rng(hs)
    B, T, H = 2, 100, 3
    r, k, v = (_normal((B, T, H, hs), rng) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (B, T, H, hs)).astype(np.float32)
    u = _normal((H, hs), rng)
    tdt = getattr(torch, dtype)
    r, k, v, u = (torch.from_numpy(x).to(cuda, tdt) for x in (r, k, v, u))
    w = torch.from_numpy(w).to(cuda)
    before = wk.launches
    o, s = ops.wkv6(r, k, v, w, u, block_t=100)
    torch.cuda.synchronize()
    assert wk.launches == before + 1

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, T, hs).contiguous()
    uu = u[None].expand(B, H, hs).reshape(B * H, hs).contiguous()
    want_o, want_s = wk.wkv6_plain(fold(r), fold(k), fold(v), fold(w), uu)
    np.testing.assert_allclose(fold(o).cpu().numpy(), want_o.cpu().numpy(),
                               rtol=WKV6_TOL, atol=WKV6_TOL)
    np.testing.assert_allclose(s.reshape(B * H, hs, hs).cpu().numpy(),
                               want_s.cpu().numpy(), rtol=WKV6_TOL,
                               atol=WKV6_TOL)


@pytest.mark.parametrize("hs", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 15, 65, 100, 129])
def test_cuda_wkv6_extreme_decays_ragged(cuda, hs, dtype, T):
    """Decays of exactly 0, 1e-30 and 1.0 among moderate ones, on T that
    end inside a chunk (64) and a sub-chunk (16) of the kernel."""
    rng = np.random.default_rng(T * 1000 + hs)
    BH = 3
    r, k, v = (_normal((BH, T, hs), rng) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (BH, T, hs)).astype(np.float32)
    pick = rng.uniform(size=w.shape)
    w[pick < 0.1] = 0.0
    w[(pick >= 0.1) & (pick < 0.2)] = 1e-30
    w[(pick >= 0.2) & (pick < 0.4)] = 1.0
    u = _normal((BH, hs), rng)
    tdt = getattr(torch, dtype)
    r, k, v, u = (torch.from_numpy(x).to(cuda, tdt) for x in (r, k, v, u))
    w = torch.from_numpy(w).to(cuda)
    before = wk.launches
    o, s = wk.wkv6_folded(r, k, v, w, u, block_t=T)
    torch.cuda.synchronize()
    assert wk.launches == before + 1
    want_o, want_s = wk.wkv6_plain(r, k, v, w, u)
    for got, want in ((o, want_o), (s, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=WKV6_TOL, atol=WKV6_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_misaligned_views(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary: wkv6 and flash's
    SIMT route stage 16-byte pieces, so their wrappers copy such inputs
    into aligned storage first."""
    rng = np.random.default_rng(7)
    tdt = getattr(torch, dtype)

    def view(x, dt):
        """x as a contiguous CUDA view one element past its storage's start"""
        flat = np.concatenate([[0.0], x.ravel()]).astype(np.float32)
        out = torch.from_numpy(flat).to(cuda, dt)[1:].view(x.shape)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    BH, T, hs = 3, 70, 16
    r, k, v = (view(_normal((BH, T, hs), rng), tdt) for _ in range(3))
    w = view(rng.uniform(0.2, 0.99, (BH, T, hs)), torch.float32)
    u = view(_normal((BH, hs), rng), tdt)
    o, s = wk.wkv6_folded(r, k, v, w, u, block_t=T)
    want_o, want_s = wk.wkv6_plain(r, k, v, w, u)
    for got, want in ((o, want_o), (s, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=WKV6_TOL, atol=WKV6_TOL)
    D = 32
    q = view(_normal((2, 40, 5, D), rng) / D ** 0.5, tdt)
    kk, vv = (view(_normal((2, 40, D), rng), tdt) for _ in range(2))
    got = fa.flash_attention_folded(q, kk, vv, causal=True, window=8,
                                    block_q=40, block_k=40)
    want = fa.flash_attention_plain(q, kk, vv, causal=True, window=8)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(1, 37, 5), (2, 256, 2560), (3, 17, 33)])
def test_cuda_rglru_scan_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    a = torch.from_numpy(rng.uniform(0.4, 0.999, shape).astype(np.float32))
    b = torch.from_numpy(_normal(shape, rng))
    a, b = a.to(cuda), b.to(cuda)
    before = rg.launches
    got = rg.rglru_scan(a, b, block_t=shape[1])
    torch.cuda.synchronize()
    assert rg.launches == before + 1
    want = rg.rglru_scan_plain(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RGLRU_TOL, atol=RGLRU_TOL)


def _rglru_inputs(shape, seed, device, mix="uniform"):
    """a uniform(0.4, 0.999), or the extreme mix: 10% exact 0.0, 10% 1e-30,
    20% exact 1.0 among them; b standard normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, shape).astype(np.float32)
    if mix == "extreme":
        pick = rng.uniform(size=shape)
        a[pick < 0.1] = 0.0
        a[(pick >= 0.1) & (pick < 0.2)] = 1e-30
        a[(pick >= 0.2) & (pick < 0.4)] = 1.0
    return (torch.from_numpy(a).to(device),
            torch.from_numpy(_normal(shape, rng)).to(device))


def _check_rglru(got, a, b):
    want = rg.rglru_scan_plain(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RGLRU_TOL, atol=RGLRU_TOL)


@pytest.mark.parametrize("shape,mix", [
    ((1, 4096, 2560), "extreme"),   # recurrentgemma-2b width
    ((2, 16384, 512), "uniform"),   # 16384 / CHUNK chunks a row: deep
                                    # look-back
    ((1, 4099, 2560), "uniform"),   # a ragged last chunk
    ((1, 300, 2562), "extreme"),    # D % 4 != 0: the scalar path
])
def test_cuda_rglru_scan_at_width(cuda, shape, mix):
    a, b = _rglru_inputs(shape, seed=shape[1], device=cuda, mix=mix)
    before = rg.launches
    got = rg.rglru_scan(a, b, block_t=shape[1])
    torch.cuda.synchronize()
    assert rg.launches == before + 1
    _check_rglru(got, a, b)


@pytest.mark.parametrize("shape", [(2, 301, 1032), (3, 77, 1030),
                                   (1, 5, 8)])
def test_cuda_rglru_scan_ragged(cuda, shape):
    """Ragged in T and in D at the extreme mix: D = 1032 leaves a short
    last channel tile on the vector path, D = 1030 takes the scalar path,
    and (1, 5, 8) is one tile for many blocks."""
    a, b = _rglru_inputs(shape, seed=sum(shape), device=cuda, mix="extreme")
    before = rg.launches
    got = rg.rglru_scan(a, b, block_t=shape[1])
    torch.cuda.synchronize()
    assert rg.launches == before + 1
    _check_rglru(got, a, b)


def test_cuda_rglru_scan_misaligned(cuda):
    """Contiguous views that start off a 16-byte boundary take the scalar
    path."""
    B, T, D = 1, 200, 2560
    a, b = _rglru_inputs((B * T * D + 1,), seed=3, device=cuda)
    a, b = a[1:].view(B, T, D), b[1:].view(B, T, D)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _check_rglru(rg.rglru_scan(a, b, block_t=T), a, b)


def test_cuda_rglru_scan_back_to_back(cuda):
    """Three calls on one stream with no sync between: each call has its
    own flags and ticket, so none sees another's."""
    shape = (1, 4096, 2560)
    inputs = [_rglru_inputs(shape, seed=s, device=cuda,
                            mix="extreme" if s % 2 else "uniform")
              for s in range(3)]
    before = rg.launches
    outs = [rg.rglru_scan(a, b) for a, b in inputs]
    torch.cuda.synchronize()
    assert rg.launches == before + 3
    for got, (a, b) in zip(outs, inputs):
        _check_rglru(got, a, b)


def test_cuda_rglru_scan_two_streams(cuda):
    """Two calls on two streams at once."""
    shape = (2, 4096, 2560)
    inputs = [_rglru_inputs(shape, seed=10 + s, device=cuda)
              for s in range(2)]
    streams = [torch.cuda.Stream() for _ in inputs]
    main = torch.cuda.current_stream()
    before = rg.launches
    outs = []
    for st, (a, b) in zip(streams, inputs):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            outs.append(rg.rglru_scan(a, b))
    for st in streams:
        main.wait_stream(st)
    torch.cuda.synchronize()
    assert rg.launches == before + 2
    for got, (a, b) in zip(outs, inputs):
        _check_rglru(got, a, b)


@pytest.mark.parametrize("shape", [(8, 32), (64, 2560), (5, 7000),
                                   (4096, 2560), (5, 7001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(shape[1])
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(_normal(shape, rng)).to(cuda, tdt)
    w = torch.from_numpy(_normal(shape[-1:], rng)).to(cuda, tdt)
    before = rn.launches
    got = rn.rmsnorm(x, w, block_rows=shape[0])
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    want = rn.rmsnorm_plain(x, w)
    tol = RMSNORM_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_misaligned_rows(cuda, dtype):
    """Rows whose base is not 16-byte aligned take the scalar path."""
    rng = np.random.default_rng(11)
    tdt = getattr(torch, dtype)
    N, D = 6, 2560
    buf = torch.from_numpy(_normal((N * D + 1,), rng)).to(cuda, tdt)
    x = buf[1:].view(N, D)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = torch.from_numpy(_normal((D,), rng)).to(cuda, tdt)
    got = rn.rmsnorm(x, w, block_rows=N)
    torch.cuda.synchronize()
    want = rn.rmsnorm_plain(x, w)
    tol = RMSNORM_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def _perturb_constants(params, generator):
    """Seeded noise on every constant-initialised leaf, so every branch of
    the forward carries a signal."""
    for v in params.values():
        if isinstance(v, dict):
            _perturb_constants(v, generator)
        elif bool((v == v.reshape(-1)[0]).all()):
            v.add_(0.1 * torch.randn(v.shape, generator=generator,
                                     device=v.device))


@pytest.mark.parametrize("name", ["rwkv6-3b", "recurrentgemma-2b",
                                  "qwen2.5-14b"])
def test_cuda_kernel_loss_matches_plain_loss(cuda, name):
    cfg = reduced(get_config(name))
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen)
    _perturb_constants(params, gen)
    batch = {k: torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    before = (wk.launches, rg.launches, fa.launches)
    got, _ = Transformer(cfg, use_pallas=True).loss(params, batch)
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    assert (wk.launches - before[0], rg.launches - before[1],
            fa.launches - before[2]) == (kinds.count("rwkv"),
                                         kinds.count("rglru"),
                                         kinds.count("attn"))
    want, _ = Transformer(cfg).loss(params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_cuda_bf16_forward_through_sm90_matches_plain(cuda):
    """recurrentgemma-2b cut to a few narrow layers but with d_head = 128,
    so its attention layers take the tensor-core route, in bf16."""
    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-2b")),
                              d_head=128)
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    _perturb_constants(params, gen)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    kernels, plain = (Transformer(cfg, use_pallas=p) for p in (True, False))
    before = (fa.launches_sm90, fa.launches_simt)
    got, _ = kernels.loss(params, batch)
    torch.cuda.synchronize()
    assert (fa.launches_sm90 - before[0], fa.launches_simt - before[1]) == \
        (cfg.layer_kinds().count("attn"), 0)
    want, _ = plain.loss(params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)
    h_k, h_p = kernels.hidden(params, batch), plain.hidden(params, batch)
    err = ((h_k.float() - h_p.float()).abs().max()
           / h_p.float().abs().max()).item()
    assert err <= 5e-2, err


# -- flash attention's gradient, the device kernel time, TF32's scope -------

def _grad_pair(q, k, v, g, window):
    """(q, k, v) gradients through ops.flash_attention (the kernel's
    forward, the blockwise backward) and through the plain version."""
    outs = []
    for fwd in ("kernel", "plain"):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        if fwd == "kernel":
            o = ops.flash_attention(*xs, causal=True, window=window)
        else:
            B, S, K, G, D = q.shape
            o = fa.flash_attention_plain(*ops.fold_attention(*xs),
                                         causal=True, window=window)
            o = o.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)
        assert o.requires_grad and o.grad_fn is not None
        outs.append(torch.autograd.grad(o, xs, g))
    return outs


@pytest.mark.parametrize("dtype,D,tol", [("float32", 64, 1e-4),
                                         ("bfloat16", 128, 2e-2)])
@pytest.mark.parametrize("window", [0, 16])
def test_cuda_flash_gradient_matches_plain(cuda, dtype, D, tol, window):
    """fp32 (the SIMT route) to 1e-4 of the gradient's scale; bf16 at
    D = 128 (the sm90 route) to 2e-2 normwise."""
    rng = np.random.default_rng(D + window)
    B, S, K, G = 1, 128, 2, 5
    q, k, v, g = (torch.from_numpy(_normal(s, rng)).to(cuda,
                                                       getattr(torch, dtype))
                  for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D),
                            (B, S, K, G, D)))
    before = (fa.launches_sm90, fa.launches_simt)
    got, want = _grad_pair(q, k, v, g, window)
    route = fa.route(q.dtype, D)
    assert (fa.launches_sm90 - before[0], fa.launches_simt - before[1]) \
        == ((1, 0) if route == "sm90" else (0, 1))
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if dtype == "float32":
            err = ((a - b).abs().max() / b.abs().max()).item()
        else:
            err = ((a - b).norm() / b.norm()).item()
        assert err <= tol, (route, err)


def test_cuda_kernel_time_is_device_time(cuda):
    """A compiled attn_step execute on the card reads its kernel time
    from CUDA events: positive and inside the wall time.  An execute
    that raises stops the timing too."""
    from repro_torch.core import Program, TorchDeviceBackend, execute, plan
    from repro_torch.optim import attention_step_program
    pl = plan(attention_step_program(2, shapes=(1, 512, 512, 2, 5, 64)))
    be = TorchDeviceBackend("cuda")
    for mode in ("compiled", "interpreted", "compiled"):
        _, s = execute(pl, mode=mode, backend=be)
        assert 0 < s.kernel_time <= s.wall_time, (mode, s)
    assert be._kernel_events is None

    def boom(xp, x):
        raise RuntimeError("boom")
    bad = Program("raises")
    bad.bind("x", np.ones(4, np.float32))
    bad.offload(boom, reads=("x",), writes=("y",), name="boom")
    bad.set_outputs("y")
    with pytest.raises(RuntimeError, match="boom"):
        execute(plan(bad), backend=be)
    assert be._kernel_events is None


def test_cuda_backend_leaves_tf32_flags_alone(cuda):
    """Building a backend changes no TF32 flag; its launches run with
    TF32 off and the caller's flags come back after each."""
    import repro_torch.core as core
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, True), (True, False)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
            be = core.TorchDeviceBackend("cuda").variant(n_streams=3)
            p = core.Program("tf32_probe")
            p.bind("A", np.ones((4, 4), np.float32))
            p.offload(lambda xp, A: {"B": A * 0 + float(
                torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)},
                reads=("A",), writes=("B",), name="probe")
            p.set_outputs("B")
            for mode in ("interpreted", "compiled"):
                out, _ = core.execute(core.plan(p), mode=mode, backend=be)
                assert (out["B"] == 0).all(), mode
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
