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
from repro_torch.kernels import adamw as ka
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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 6, 7, 8])
@pytest.mark.parametrize("S", [100, 300, 515])
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_sm90_group_sizes_of_the_zoo(cuda, D, G, S, window):
    """The tensor-core route at the GQA group sizes of the model zoo:
    musicgen-large (G = 1, D = 64), internlm2-20b / nemotron-4-15b (6),
    arctic-480b (7) and the G = 8 archs.  Row r of a bk's (S*G) rows sits
    at query position r / G, so with G = 6 or 7 a 128-row block straddles
    a query position: its mask and the bounds of the key chunks it skips
    must follow the block's first and last rows, not a multiple of G.
    Ragged S ends inside a 128-key chunk and inside a row tile (the
    tile arguments, which the kernel only validates, are S itself)."""
    rng = np.random.default_rng(D * 1000 + G * 100 + S + window)
    BK = 2
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, S, D), rng), _normal((BK, S, D), rng)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (q, k, v))
    assert fa.route(q.dtype, D) == "sm90"
    before = (fa.launches_sm90, fa.launches_simt)
    got = fa.flash_attention_folded(q, k, v, causal=True, window=window,
                                    block_q=S, block_k=S)
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


def _batch(cfg, gen, device, B=2, S=128):
    """Seeded tokens and labels, or embeds and (B, S, n_codebooks) labels
    for an ``input_embeds`` arch."""
    if cfg.input_embeds:
        return {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                      device=device),
                "labels": torch.randint(0, cfg.vocab,
                                        (B, S, cfg.n_codebooks),
                                        generator=gen, device=device)}
    return {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                             device=device) for k in ("tokens", "labels")}


@pytest.mark.parametrize("name", [
    "rwkv6-3b", "recurrentgemma-2b", "qwen2.5-14b", "internlm2-20b",
    "command-r-35b", "nemotron-4-15b", "chameleon-34b", "qwen3-moe-30b-a3b",
    "arctic-480b", "musicgen-large"])
def test_cuda_kernel_loss_matches_plain_loss(cuda, name):
    cfg = reduced(get_config(name))
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen)
    _perturb_constants(params, gen)
    batch = _batch(cfg, gen, cuda)
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
    forward, the backward ``fa.bwd_route`` names) and through the plain
    version in fp32 on the same (upcast) inputs."""
    outs = []
    for fwd in ("kernel", "plain"):
        xs = [(x if fwd == "kernel" else x.float()).detach().clone()
              .requires_grad_() for x in (q, k, v)]
        if fwd == "kernel":
            o = ops.flash_attention(*xs, causal=True, window=window)
        else:
            B, S, K, G, D = q.shape
            o = fa.flash_attention_plain(*ops.fold_attention(*xs),
                                         causal=True, window=window)
            o = o.reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4)
        assert o.requires_grad and o.grad_fn is not None
        outs.append(torch.autograd.grad(o, xs, g.to(o.dtype)))
    return outs


def _flash_counts():
    return fa.launches_sm90, fa.launches_simt, fa.launches_bwd_sm90


@pytest.mark.parametrize("dtype,D,tol", [("float32", 64, 1e-4),
                                         ("bfloat16", 64, 2e-2),
                                         ("bfloat16", 128, 2e-2),
                                         ("bfloat16", 256, 2e-2)])
@pytest.mark.parametrize("G,S", [(5, 128), (6, 100)])
@pytest.mark.parametrize("window", [0, 16])
def test_cuda_flash_gradient_matches_plain(cuda, dtype, D, tol, window, G,
                                           S):
    """Gradients through ops.flash_attention against the plain version's
    in fp32.  fp32 (the SIMT route, the blockwise backward) to 1e-4 of the
    gradient's scale.  bf16 on the sm90 route to 2e-2 normwise, the
    reference's bf16 kernel tolerance: at D = 64 and 128 the sm90 backward
    (launched once a call, counted by ``launches_bwd_sm90``) rounds P and
    dS to bf16 before their products and dq, dk, dv at the end (2^-9
    relative each, about 1e-2 normwise at most after the sums); at
    D = 256 the blockwise recompute rounds only the result.  S = 100 ends
    inside a 64-row tile and a 64-key chunk."""
    rng = np.random.default_rng(D + window + G)
    B, K = 1, 2
    q, k, v, g = (torch.from_numpy(_normal(s, rng)).to(cuda,
                                                       getattr(torch, dtype))
                  for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D),
                            (B, S, K, G, D)))
    before = _flash_counts()
    got, want = _grad_pair(q, k, v, g, window)
    torch.cuda.synchronize()
    route = fa.route(q.dtype, D)
    bwd = fa.bwd_route(q.dtype, D, S, S, window)
    assert bwd == ("sm90" if dtype == "bfloat16" and D < 256
                   else "blockwise")
    assert tuple(a - b for a, b in zip(_flash_counts(), before)) == (
        int(route == "sm90"), int(route == "simt"), int(bwd == "sm90"))
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        if dtype == "float32":
            err = ((a - b).abs().max() / b.abs().max()).item()
        else:
            err = ((a - b).norm() / b.norm()).item()
        assert err <= tol, (route, bwd, err)


@pytest.mark.parametrize("D", fa.SM90_HEAD_DIMS)
@pytest.mark.parametrize("G,S", [(1, 100), (6, 300), (5, 515)])
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_sm90_lse_matches_plain(cuda, D, G, S, window):
    """The forward's lse (``return_lse``) is the plain version's
    logsumexp: within 1e-4 absolute and relative (fp32 sums in another
    order, exp2 on the MUFU unit at 2^-22 relative), the output the same
    bits as a forward-only call, which writes no lse."""
    rng = np.random.default_rng(D + G + S + window)
    BK = 2
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, S, D), rng), _normal((BK, S, D), rng)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in (q, k, v))
    tiles = dict(block_q=S, block_k=S)
    o, lse = fa.flash_attention_folded(q, k, v, window=window,
                                       return_lse=True, **tiles)
    assert lse.shape == (BK, S, G) and lse.dtype == torch.float32
    assert torch.equal(o, fa.flash_attention_folded(q, k, v, window=window,
                                                    **tiles))
    _, want = fa.flash_attention_plain(q, k, v, window=window,
                                       return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", fa.SM90_BWD_HEAD_DIMS)
@pytest.mark.parametrize("G,S,T,window", [
    (G, S, T, w) for G, S, T in ((1, 100, 100), (6, 300, 300), (5, 515, 515),
                                 (6, 64, 200), (6, 200, 72))
    for w in (0, 64) if not (w and S - T >= w)])   # rows see no key
def test_cuda_sm90_bwd_matches_plain(cuda, D, G, S, T, window):
    """The sm90 backward on the folded layout against the plain backward
    in fp32 fed the plain forward's o and lse: dq, dk, dv within 2e-2
    normwise (the gradient test's reason), with ragged row tiles and key
    tiles, more keys than queries and fewer (rows past the last key see
    them all), every group size's straddling rows.  One launch a call."""
    rng = np.random.default_rng(D + G + S + T + window)
    BK = 2
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v = _normal((BK, T, D), rng), _normal((BK, T, D), rng)
    g = _normal((BK, S, G, D), rng)
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                  for x in (q, k, v, g))
    o, lse = fa.flash_attention_folded(q, k, v, window=window,
                                       return_lse=True, block_q=S, block_k=T)
    before = fa.launches_bwd_sm90
    got = fa.flash_attention_bwd_folded(q, k, v, o, g, lse, window=window)
    torch.cuda.synchronize()
    assert fa.launches_bwd_sm90 == before + 1
    f32 = [x.float() for x in (q, k, v)]
    of, lsef = fa.flash_attention_plain(*f32, window=window, return_lse=True)
    want = fa.flash_attention_bwd_plain(*f32, of, g.float(), lsef,
                                        window=window)
    for name, a, b in zip("qkv", got, want):
        err = ((a.float() - b).norm() / b.norm()).item()
        assert err <= 2e-2, (name, err)


def test_cuda_sm90_bwd_at_the_train_cell_shape(cuda):
    """internlm2-20b's train-4k call: BK 8, S = T = 4096, G 6, D 128,
    causal, through ops.flash_attention's forward and backward: dq, dk, dv
    within 2e-2 normwise of the plain fp32 backward (computed a bk at a
    time to bound its memory), one sm90 backward launch."""
    rng = np.random.default_rng(4096)
    B, S, K, G, D = 1, 4096, 8, 6, 128
    q, k, v, g = (torch.from_numpy(_normal(s, rng)).to(cuda, torch.bfloat16)
                  for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D),
                            (B, S, K, G, D)))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _flash_counts()
    o = ops.flash_attention(*xs, causal=True)
    got = torch.autograd.grad(o, xs, g)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_flash_counts(), before)) == (1, 0, 1)
    qf, kf, vf = (x.float() for x in ops.fold_attention(q, k, v))
    gf = g.float().permute(0, 2, 1, 3, 4).reshape(B * K, S, G, D)
    parts = []
    for i in range(B * K):
        sl = slice(i, i + 1)
        of, lse = fa.flash_attention_plain(qf[sl], kf[sl], vf[sl],
                                           return_lse=True)
        parts.append(fa.flash_attention_bwd_plain(qf[sl], kf[sl], vf[sl], of,
                                                  gf[sl], lse))
    dqf, dkf, dvf = (torch.cat(x) for x in zip(*parts))
    want = [(dqf / D ** 0.5).reshape(B, K, S, G, D).permute(0, 2, 1, 3, 4),
            dkf.reshape(B, K, S, D).permute(0, 2, 1, 3),
            dvf.reshape(B, K, S, D).permute(0, 2, 1, 3)]
    for name, a, b in zip("qkv", got, want):
        err = ((a.float() - b).norm() / b.norm()).item()
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("mode,want", [("grad", True), ("no_grad", False),
                                       ("detached", False)])
def test_cuda_forward_asks_for_the_lse_only_under_grad(cuda, monkeypatch,
                                                       mode, want):
    """ops.flash_attention on the sm90 backward's route asks the forward
    for the lse only where the call records a gradient: not under no_grad
    (serving, a recompute's first pass), not for inputs that need none."""
    asked = []
    real = fa.flash_attention_folded

    def spy(*a, **kw):
        asked.append(kw.get("return_lse", False))
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_folded", spy)
    rng = np.random.default_rng(7)
    B, S, K, G, D = 1, 128, 2, 6, 128
    q, k, v = (torch.from_numpy(_normal(s, rng)).to(cuda, torch.bfloat16)
               .requires_grad_(mode != "detached")
               for s in ((B, S, K, G, D), (B, S, K, D), (B, S, K, D)))
    before = fa.launches_bwd_sm90
    if mode == "no_grad":
        with torch.no_grad():
            o = ops.flash_attention(q, k, v)
    else:
        o = ops.flash_attention(q, k, v)
    assert asked == [want] and o.requires_grad == want
    if want:
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        assert fa.launches_bwd_sm90 == before + 1


def test_cuda_sm90_lse_layout_at_one_bk(cuda):
    """The forward's lse is a view of zeroed rows padded to LSE_ROWS, with
    that stride at BK = 1 too, where a view would drop it; the backward
    takes it as it is and refuses an lse in another layout."""
    rng = np.random.default_rng(11)
    BK, S, G, D = 1, 100, 5, 128
    q = _normal((BK, S, G, D), rng) / D ** 0.5
    k, v, g = (_normal(s, rng) for s in ((BK, S, D), (BK, S, D),
                                         (BK, S, G, D)))
    q, k, v, g = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                  for x in (q, k, v, g))
    o, lse = fa.flash_attention_folded(q, k, v, return_lse=True,
                                       block_q=S, block_k=S)
    assert lse.stride() == (512, G, 1)
    got = fa.flash_attention_bwd_folded(q, k, v, o, g, lse)
    f32 = [x.float() for x in (q, k, v)]
    of, lsef = fa.flash_attention_plain(*f32, return_lse=True)
    torch.testing.assert_close(lse, lsef, rtol=1e-4, atol=1e-4)
    want = fa.flash_attention_bwd_plain(*f32, of, g.float(), lsef)
    for name, a, b in zip("qkv", got, want):
        err = ((a.float() - b).norm() / b.norm()).item()
        assert err <= 2e-2, (name, err)
    unpadded = torch.empty(lse.shape, dtype=lse.dtype, device=lse.device)
    assert unpadded.stride() == (S * G, G, 1)
    with pytest.raises(ValueError, match="padded rows"):
        fa.flash_attention_bwd_folded(q, k, v, o, g, unpadded.copy_(lse))


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


# -- serving: decode, the pool, two streams, idle rows ----------------------

SERVE_ARCHS = ("qwen2.5-14b", "rwkv6-3b", "recurrentgemma-2b")
ZOO_ARCHS = ("qwen3-moe-30b-a3b", "musicgen-large")


@pytest.fixture
def no_tf32(cuda):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _host_params(name):
    """Seeded reduced fp32 params on the host, constants perturbed."""
    cfg = reduced(get_config(name))
    gen = torch.Generator().manual_seed(0)
    params = Transformer(cfg).init(gen, device="cpu")
    _perturb_constants(params, gen)
    return cfg, params


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _serve_runtime(name, device, max_seq=48):
    from repro_torch.core import TorchDeviceBackend
    from repro_torch.serve import ServeRuntime
    cfg, params = _host_params(name)
    rt = ServeRuntime(cfg, max_seq=max_seq, params=params,
                      backend=TorchDeviceBackend(device))
    rt.tune = None
    return rt


def _assert_trees_close(got, want, tol=1e-5):
    from repro_torch.serve.kvpool import tree_flatten
    paths, g = tree_flatten(got)
    assert paths == tree_flatten(want)[0]
    for path, a, b in zip(paths, g, tree_flatten(want)[1]):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.is_floating_point():
            scale = max(1.0, b.abs().max().item())
            torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale,
                                       msg=path)
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("name", SERVE_ARCHS + ZOO_ARCHS)
def test_cuda_decode_step_matches_cpu(no_tf32, name):
    """fp32 prefill + five decode steps (the same seeded tokens, or embeds
    for musicgen-large) on the card against the same on the CPU: logits
    and caches within 1e-5 of their scale, TF32 off.  musicgen-large's
    logits are held to 5e-5 of their scale, the decode tolerance
    tests/test_torch_decode.py states for an ill-conditioned attention:
    its near-argmax attention (fan-in n_heads for w_q and w_k at this
    width) moves the fifth step's logits 1.5e-5 of their scale between
    the two devices' fp32 sums, while its caches stay within 6.6e-6."""
    cfg, params = _host_params(name)
    m = Transformer(cfg)
    rng = np.random.default_rng(1)
    if cfg.input_embeds:
        key, seq = "embeds", torch.from_numpy(rng.standard_normal(
            (2, 45, cfg.d_model)).astype(np.float32))
    else:
        key, seq = "tokens", torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, 45)).astype(np.int32))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, cache = m.prefill(p, {key: seq[:, :40].to(dev)},
                                  max_seq=48)
        outs = [logits.cpu()]
        for i in range(40, 45):
            pos = torch.full((2,), i, dtype=torch.int32, device=dev)
            logits, cache = m.decode_step(p, cache, {key: seq[:, i].to(dev)},
                                          pos)
            outs.append(logits.cpu())
        runs[dev] = (outs, cache)
    tol = 5e-5 if cfg.input_embeds else 1e-5
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * scale)
    _assert_trees_close(runs["cuda"][1], runs["cpu"][1])


def test_cuda_pool_insert_keeps_storage(cuda):
    from repro_torch.serve import KVSlotPool, Request
    from repro_torch.serve.kvpool import tree_flatten
    rt = _serve_runtime("recurrentgemma-2b", "cuda")
    pool = KVSlotPool(rt.model, capacity=3, max_seq=rt.max_seq, device=cuda)
    before = [t.data_ptr() for t in tree_flatten(pool.cache)[1]]
    for rid in range(6):
        slot = pool.alloc()
        req = Request(rid=rid, prompt=np.arange(5 + rid, dtype=np.int32),
                      max_new_tokens=2)
        _, cache = rt.prefill_request(req)
        with rt.on_stream(0):
            pool.insert(cache, 0, slot)
        pool.free(slot)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in tree_flatten(pool.cache)[1]] == before


@pytest.mark.parametrize("pressure", [False, True],
                         ids=["ordered", "allocator_pressure"])
def test_cuda_prefill_stream1_insert_stream0(cuda, pressure):
    """A prefill on stream 1 that finishes late, then at once an insert on
    stream 0: the pool row equals the synchronous result.  Under
    pressure, stream 0 is held back too, and while its insert waits the
    prefill's tensors are dropped and their sizes (and a large tensor)
    allocated, filled with NaN and freed on stream 1: without
    ``record_stream`` the allocator would hand the insert's source to
    them."""
    from repro_torch.serve import KVSlotPool, Request
    from repro_torch.serve.kvpool import tree_flatten
    rt = _serve_runtime("qwen2.5-14b", "cuda")
    req = Request(rid=0, prompt=np.arange(3, 40, dtype=np.int32),
                  max_new_tokens=2)
    s0, s1 = rt.be.torch_stream(0), rt.be.torch_stream(1)
    assert s0 != s1

    want = KVSlotPool(rt.model, capacity=2, max_seq=rt.max_seq, device=cuda)
    slot = want.alloc()
    _, cache = rt.prefill_request(req)
    torch.cuda.synchronize()
    want.insert(cache, 0, slot)
    torch.cuda.synchronize()
    sizes = [t.shape for t in tree_flatten(cache)[1]]
    del cache

    got = KVSlotPool(rt.model, capacity=2, max_seq=rt.max_seq, device=cuda)
    slot = got.alloc()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        torch.cuda._sleep(50_000_000)            # the prefill lands late
    _, cache = rt.prefill_request(req)
    with rt.on_stream(0):
        if pressure:
            torch.cuda._sleep(100_000_000)       # ... and the insert later
        got.insert(cache, 0, slot)
    if pressure:
        del cache
        with torch.cuda.stream(s1):
            junk = [torch.full(s, float("nan"), device=cuda)
                    for s in sizes for _ in range(4)]
            junk.append(torch.full((1 << 26,), float("nan"), device=cuda))
            del junk
    torch.cuda.synchronize()
    _assert_trees_close(got.cache, want.cache, tol=0.0)


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_cuda_idle_row_past_max_seq(no_tf32, name):
    """An idle row runs 76 decode steps, past max_seq = 48: on the card
    its writes past a full cache's end are dropped without a device-side
    assert, and the engine's tokens and the live row of its pool equal
    the CPU's (1e-4 of the scale after 76 steps)."""
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.kvpool import tree_flatten
    out = {}
    for dev in ("cpu", "cuda"):
        rt = _serve_runtime(name, dev)
        eng = Engine(rt, capacity=2, max_batch_tokens=28)
        rep = eng.run([Request(rid=r, prompt=np.arange(r, r + 8,
                                                       dtype=np.int32),
                               max_new_tokens=20) for r in range(4)],
                      respect_arrivals=False)
        torch.cuda.synchronize()
        assert rep["steps"] == 76 and rep["pool"]["peak_in_use"] == 1
        live = {k: v.select(ax, 0) for (k, v), ax in zip(
            zip(*tree_flatten(eng.pool.cache)), eng.pool.batch_axes)}
        out[dev] = ({r.rid: r.tokens for r in eng.completed}, live)
        if name == "qwen2.5-14b":   # the idle row's positions 48..75 dropped
            idle = eng.pool.cache["pos"][:, 1].cpu()
            assert torch.equal(idle, torch.arange(48, dtype=torch.int32)
                               .expand_as(idle))
    for rid, toks in out["cpu"][0].items():
        np.testing.assert_array_equal(out["cuda"][0][rid], toks)
    _assert_trees_close(out["cuda"][1], out["cpu"][1], tol=1e-4)


# -- MoE on the card ---------------------------------------------------------

def _moe_layer(name, device, seed=0, **changes):
    """One reduced MoE layer's seeded fp32 params on ``device``, and its
    config with ``changes``."""
    from repro_torch.models.layers import init_tree
    from repro_torch.models.moe import moe_spec
    cfg = dataclasses.replace(reduced(get_config(name)), **changes)
    gen = torch.Generator().manual_seed(seed)
    return cfg, _to(init_tree(moe_spec(cfg), gen, "cpu", torch.float32),
                    device)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["published", "dropping"])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_cuda_moe_apply_matches_cpu(no_tf32, name, cf):
    """moe_apply in fp32 on the card against the CPU, at the published
    capacity factor and at 0.25 (most experts drop tokens): outputs
    within 1e-5, aux within 1e-6."""
    from repro_torch.models.moe import moe_apply
    cfg, params = _moe_layer(name, "cpu", capacity_factor=cf)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32))
    want, want_aux = moe_apply(params, x, cfg)
    got, got_aux = moe_apply(_to(params, "cuda"), x.cuda(), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_cuda_moe_combine_is_deterministic(cuda):
    """The combine sums each token's k expert outputs in a fixed order (no
    atomics): repeated calls on the card give the same bits, at 128
    experts, top 8 and 4096 tokens, in fp32 and bf16."""
    from repro_torch.models.moe import moe_apply
    cfg, params = _moe_layer("qwen3-moe-30b-a3b", "cuda", n_experts=128,
                             top_k=8, d_model=256, d_ff=64)
    x = torch.randn((2, 2048, cfg.d_model),
                    generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        p = {k: {n: t.to(dtype) for n, t in v.items()} if isinstance(v, dict)
             else v.to(dtype) for k, v in params.items()}
        first, aux = moe_apply(p, x.to(dtype), cfg)
        for _ in range(3):
            again, aux_again = moe_apply(p, x.to(dtype), cfg)
            assert torch.equal(again, first) and torch.equal(aux_again, aux)


# -- training on the card ----------------------------------------------------

def _tree_leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _train_batches(cfg, n, B=2, S=64, seed=1):
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(cfg, B, S, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
            for i in range(n)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("name", ["qwen2.5-14b", "internlm2-20b"])
def test_cuda_train_step_matches_cpu(no_tf32, name, use_pallas):
    """Three fp32 AdamW steps of a reduced dense arch on the card (flash's
    SIMT route with use_pallas) against the plain steps on the CPU from
    the same weights: losses within 1e-4 relative, params within 1e-4
    normwise; flash launches twice per layer a step (the forward and the
    per-layer recompute)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw
    cfg, host = _host_params(name)
    dev = _to(host, "cuda")
    out = {}
    for device, params, pallas in (("cpu", host, False),
                                   ("cuda", dev, use_pallas)):
        opt = adamw()
        step = make_train_step(Transformer(cfg, use_pallas=pallas), opt)
        state = opt.init(params)
        losses = []
        before = fa.launches_simt
        for b in _train_batches(cfg, 3):
            params, state, m = step(params, state, _to(b, device))
            losses.append(float(m["loss"]))
        launched = fa.launches_simt - before
        out[device] = (losses, params, launched)
    n_attn = cfg.layer_kinds().count("attn")
    assert out["cuda"][2] == (3 * 2 * n_attn if use_pallas else 0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    num = sum(float(((a.cpu() - b) ** 2).sum()) for a, b in
              zip(_tree_leaves(out["cuda"][1]), _tree_leaves(out["cpu"][1])))
    den = sum(float((b ** 2).sum()) for b in _tree_leaves(out["cpu"][1]))
    assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_cuda_offloaded_optimizer_is_bitwise_the_plain_one(cuda, name,
                                                          monkeypatch):
    """The offloaded optimizer's state sits in pinned host memory (the
    step on the card), and three updates give bitwise the params and
    state of the plain optimizer on the card.  Pieces of 1000 elements,
    so AdamW's leaves stream in many slices."""
    from repro_torch.optim import adafactor, adamw, offload
    from repro_torch.optim import offloaded_optimizer
    monkeypatch.setattr(offload, "CHUNK", 1000)
    make = {"adamw": adamw, "adafactor": adafactor}[name]
    cfg = reduced(get_config("qwen2.5-14b"))
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    grads = [[torch.randn(p.shape, generator=gen, device=cuda)
              .to(p.dtype) for p in _tree_leaves(params)] for _ in range(3)]
    from repro_torch.tree import unflatten
    runs = []
    for opt in (make(), offloaded_optimizer(make())):
        p = unflatten(params, [t.clone() for t in _tree_leaves(params)])
        state = opt.init(p)
        for g in grads:
            p, state = opt.update(unflatten(params, g), state, p)
        torch.cuda.synchronize()
        runs.append((p, state))
    (p1, s1), (p2, s2) = runs
    assert s2["step"].device.type == "cuda" and int(s2["step"]) == 3
    arrays = [t for t in _tree_leaves(s2) if t.ndim]
    assert arrays and all(t.device.type == "cpu" and t.is_pinned()
                          for t in arrays)
    for a, b in zip(_tree_leaves(p1) + _tree_leaves(s1),
                    _tree_leaves(p2) + _tree_leaves(s2)):
        assert torch.equal(a.cpu(), b.cpu())


# AdamW's update and the clip norm (kernels/adamw.py): the kernels against
# the plain slice loop on the card, bitwise, and the square sum against an
# fp64 sum (1e-6 relative: fp64 accumulation of fp32 vector sums)
ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, lr=1e-2)   # lr: p moves in bf16


def _adamw_leaf_inputs(cuda, n, dtype, seed):
    """g, m, v, p of a leaf mid-training, and (scale, bc1, bc2) as
    ``adamw``'s ``begin`` makes them at step 3."""
    gen = torch.Generator(cuda).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=cuda).to(dtype)
    p = torch.randn(n, generator=gen, device=cuda).to(dtype)
    m = 0.01 * torch.randn(n, generator=gen, device=cuda)
    v = 1e-4 * torch.rand(n, generator=gen, device=cuda)
    step = torch.full((), 3.0, device=cuda)
    ctx = (torch.full((), 0.37, device=cuda), 1 - torch.pow(0.9, step),
           1 - torch.pow(0.95, step))
    return (g, m, v, p), ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("n", [1, 7, 4096, 4099, 100_003])
def test_cuda_adamw_leaf_is_bitwise_the_slice_loop(cuda, dtype,
                                                   weight_decay, n):
    """One launch over the whole leaf, one a piece of 1001 elements (each
    piece's g, m, v, p at one offset that is not 16-byte aligned: a scalar
    head, then vectors), and pieces whose m, v are fresh copies (aligned
    while g, p are not: all scalar) give m, v and p bitwise those of the
    plain slice loop on the card."""
    (g, m, v, p), ctx = _adamw_leaf_inputs(cuda, n, dtype, n)
    hp = dict(ADAMW_HP, weight_decay=weight_decay)
    want = [t.clone() for t in (m, v, p)]
    ka.adamw_leaf_plain(g, *want, *ctx, chunk=1000, **hp)
    whole = [t.clone() for t in (m, v, p)]
    before = ka.launches_leaf
    ka.adamw_leaf(g, *whole, *ctx, chunk=1000, **hp)
    assert ka.launches_leaf == before + 1
    pieces = [t.clone() for t in (m, v, p)]
    copied = [t.clone() for t in (m, v, p)]
    for lo in range(0, n, 1001):
        hi = min(lo + 1001, n)
        ka.adamw_leaf(g[lo:hi], *(t[lo:hi] for t in pieces), *ctx,
                      chunk=1000, **hp)
        mc, vc = (t[lo:hi].clone() for t in copied[:2])
        ka.adamw_leaf(g[lo:hi], mc, vc, copied[2][lo:hi], *ctx, chunk=1000,
                      **hp)
        copied[0][lo:hi], copied[1][lo:hi] = mc, vc
    torch.cuda.synchronize()
    assert ka.launches_leaf == before + 1 + 2 * -(-n // 1001)
    for got in (whole, pieces, copied):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(m, want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 9, 4099, 1_000_003])
def test_cuda_square_sum_matches_fp64(cuda, dtype, n):
    """Σ g² within 1e-6 relative of the fp64 sum, bitwise the same on a
    second run, and on a slice that starts off 16 bytes; one launch a
    call."""
    gen = torch.Generator(cuda).manual_seed(n)
    g = torch.randn(n + 3, generator=gen, device=cuda).to(dtype)
    before = ka.launches_square_sum
    for x in (g[:n], g[3:]):
        want = float(x.double().square().sum())
        first = ka.square_sum(x, chunk=1000)
        again = ka.square_sum(x, chunk=1000)
        torch.cuda.synchronize()
        assert first.dtype == torch.float32 and first.ndim == 0
        assert torch.equal(first, again)
        assert abs(float(first) - want) <= 1e-6 * want
    assert ka.launches_square_sum == before + 4


def test_cuda_adamw_kernels_raise_on_what_they_do_not_take(cuda):
    (g, m, v, p), ctx = _adamw_leaf_inputs(cuda, 64, torch.bfloat16, 0)
    def leaf(*a, c=ctx):
        ka.adamw_leaf(*a, *c, chunk=1000, weight_decay=0.0, **ADAMW_HP)
    before = (ka.launches_leaf, ka.launches_square_sum)
    with pytest.raises(TypeError):
        leaf(g.float(), m, v, p)                   # g and p differ
    with pytest.raises(TypeError):
        leaf(g, m.to(torch.bfloat16), v, p)        # state not fp32
    with pytest.raises(TypeError):
        leaf(g.double(), m, v, p.double())         # a type not taken
    with pytest.raises(TypeError):
        leaf(g, m, v, p, c=(ctx[0].double(), *ctx[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        leaf(*(t.view(8, 8).t() for t in (g, m, v, p)))
    with pytest.raises(ValueError, match="one device"):
        leaf(g, m.cpu(), v, p)
    with pytest.raises(ValueError, match="lengths"):
        leaf(g, m[:32], v, p)
    with pytest.raises(TypeError):
        ka.square_sum(g.to(torch.int32), chunk=1000)
    with pytest.raises(ValueError, match="contiguous"):
        ka.square_sum(g.view(8, 8).t(), chunk=1000)
    assert (ka.launches_leaf, ka.launches_square_sum) == before


def test_cuda_adamw_kernels_count_under_the_update_range(cuda):
    """Under a profiler both kernels' device time counts under the
    optimizer's range (``trace.UPDATE_RANGE``) through their operators
    (``repro_torch::adamw_leaf``, ``repro_torch::square_sum``): the range
    ``optim.update_ms.train`` reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw
    from repro_torch.trace import UPDATE_RANGE
    (g, _, _, p), _ = _adamw_leaf_inputs(cuda, 1 << 20, torch.bfloat16, 0)
    opt = adamw()
    params = {"w": p}
    state = opt.init(params)
    opt.update({"w": g}, state, params)            # builds, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.update({"w": g}, state, params)
        torch.cuda.synchronize()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    update = [e for e in cpu if e.name == UPDATE_RANGE]
    ops = {name: sum(e.device_time_total for e in cpu if e.name == name)
           for name in ("repro_torch::adamw_leaf", "repro_torch::square_sum")}
    assert len(update) == 1 and all(t > 0 for t in ops.values()), ops
    assert update[0].device_time_total >= 0.999 * sum(ops.values())


@pytest.mark.parametrize("chunk", [None, 1000, 1001],
                         ids=["on_card", "offload_1000", "offload_1001"])
def test_cuda_adamw_launches_once_a_leaf(cuda, chunk, monkeypatch):
    """One update of reduced qwen2.5-14b's bf16 params launches
    ``square_sum`` once a leaf and ``adamw_leaf`` once a leaf on the card,
    or once a piece under ``offloaded_optimizer`` (pieces of 1000 and 1001
    elements: the latter's g and p start off 16 bytes, their m, v copies
    do not); the offloaded params and state equal the on-card ones bit
    for bit."""
    from repro_torch.optim import adamw, offload, offloaded_optimizer
    from repro_torch.tree import unflatten
    cfg = reduced(get_config("qwen2.5-14b"))
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen, dtype=torch.bfloat16)
    flat = _tree_leaves(params)
    grads = unflatten(params, [torch.randn(t.shape, generator=gen,
                                           device=cuda).to(t.dtype)
                               for t in flat])
    runs = {}
    for off in ([False] if chunk is None else [False, True]):
        if off:
            monkeypatch.setattr(offload, "CHUNK", chunk)
        opt = offloaded_optimizer(adamw()) if off else adamw()
        p = unflatten(params, [t.clone() for t in flat])
        state = opt.init(p)
        before = (ka.launches_leaf, ka.launches_square_sum)
        opt.update(grads, state, p)
        torch.cuda.synchronize()
        counts = (ka.launches_leaf - before[0],
                  ka.launches_square_sum - before[1])
        units = sum(-(-t.numel() // chunk) for t in flat) if off \
            else len(flat)
        assert counts == (units, len(flat))
        runs[off] = [t.cpu() for t in _tree_leaves(p) + _tree_leaves(state)]
    if chunk is not None:
        assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))


@pytest.mark.parametrize("pressure", [False, True],
                         ids=["quiet", "allocator_pressure"])
def test_cuda_prefetch_iterator_under_allocator_pressure(cuda, pressure):
    """Batches copied on the producer's stream arrive intact on the
    consumer's stream while the caching allocator recycles memory as fast
    as it can (tensors the size of a batch allocated, written and freed
    around every step): each batch equals the source's, in order."""
    from repro_torch.data import PrefetchIterator, SyntheticLM
    cfg = reduced(get_config("musicgen-large"))
    src = SyntheticLM(cfg, 4, 256, seed=2)
    it = PrefetchIterator(src, start_index=5, depth=2)
    try:
        for i in range(5, 25):
            b = next(it)
            if pressure:
                for _ in range(4):
                    junk = [torch.full(t.shape, -7, dtype=t.dtype,
                                       device=cuda) for t in b.values()]
                    del junk
                torch.cuda._sleep(200_000)       # the card stays busy
            got = {k: v.cpu().numpy() for k, v in b.items()}
            for k, want in src.batch_at(i).items():
                np.testing.assert_array_equal(got[k], want)
            assert all(t.device.type == "cuda" for t in b.values())
    finally:
        it.close()


def test_cuda_restart_is_bitwise(cuda, tmp_path):
    """``train`` on the card, straight and (crash at step 6, resume from
    the step-4 checkpoint): bitwise the same params, and a second straight
    run gives them again."""
    from repro_torch.launch.train import train
    from repro_torch.runtime import FaultInjector
    cfg = reduced(get_config("internlm2-20b"))
    kw = dict(steps=8, batch=8, seq=64, ckpt_every=4, log_every=100)
    a = train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    inj = FaultInjector((6,))
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, ckpt_dir=str(tmp_path / "b"), injector=inj, **kw)
    b = train(cfg, ckpt_dir=str(tmp_path / "b"), injector=inj, **kw)
    c = train(cfg, ckpt_dir=str(tmp_path / "c"), **kw)
    for x, y, z in zip(*(_tree_leaves(o["params"]) for o in (a, b, c))):
        assert x.device.type == "cuda"
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("route,calm", [("simt", False), ("sm90", False),
                                        ("sm90", True)],
                         ids=["simt", "sm90", "sm90-calm"])
def test_cuda_model_backward_through_flash_matches_plain(cuda, route, calm):
    """``loss.backward()`` with use_pallas=True against the plain path on
    the same weights, two launches per attention layer (the forward and
    the per-layer recompute).  The SIMT route in fp32 (reduced
    qwen2.5-14b): every gradient leaf within 1e-4 normwise.  The sm90
    route in bf16 (d_head 128): both bf16 paths are held against the
    plain path in fp32 on the same weights, and the kernel's gradients
    may lie at most 10 % farther from it than the plain bf16 path's own
    (normwise over all leaves).  With the seeded weights attention is
    nearly an argmax and bf16 alone moves the gradients ~70 % (PERF.md
    §6); ``calm`` scales w_q and w_k by 0.1, where it moves them
    far less and the bound is tighter."""
    cfg = reduced(get_config("qwen2.5-14b"))
    dtype = torch.float32
    if route == "sm90":
        cfg, dtype = dataclasses.replace(cfg, d_head=128), torch.bfloat16
    gen = torch.Generator(cuda).manual_seed(0)
    params = Transformer(cfg).init(gen, dtype=dtype)
    _perturb_constants(params, gen)
    if calm:
        for k in ("w_q", "w_k"):
            params["layers"]["attn"][k].mul_(0.1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}

    def grads(p, pallas):
        flat = _tree_leaves(p)
        for t in flat:
            t.grad = None
            t.requires_grad_(True)
        before = _flash_counts()
        loss, _ = Transformer(cfg, use_pallas=pallas).loss(p, batch)
        loss.backward()
        torch.cuda.synchronize()
        n = 2 * cfg.layer_kinds().count("attn") if pallas else 0
        assert tuple(a - b for a, b in zip(_flash_counts(), before)) == (
            (n, 0, n // 2) if route == "sm90" else (0, n, 0))
        return [t.grad.float() for t in flat]

    def normwise(a, b):
        num = sum(float((x - y).norm() ** 2) for x, y in zip(a, b))
        return (num / sum(float(y.norm() ** 2) for y in b)) ** 0.5

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, want = grads(params, True), grads(params, False)
        if route == "simt":
            for a, b in zip(got, want):
                assert ((a - b).norm() / b.norm()).item() <= 1e-4
            return
        fp32 = grads(_float_tree(params), False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    e_kernel, e_plain = normwise(got, fp32), normwise(want, fp32)
    assert e_kernel <= 1.1 * e_plain, (e_kernel, e_plain,
                                       normwise(got, want))


def _float_tree(tree):
    return {k: _float_tree(v) if isinstance(v, dict)
            else v.detach().float() for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The mesh on the card: a 1×1 ("data", "model") DeviceMesh of one NCCL rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world-size-1 NCCL group and its 1×1 mesh, for this module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh runs on NCCL")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_mesh
    init_process_group("cuda", 0, 1, str(tmp_path_factory.mktemp("nccl")))
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def test_cuda_mesh_backend_3mm(nccl_mesh, tmp_path):
    from repro_torch.core import TuneCache, execute, plan, run_host_oracle
    from repro_torch.core.tunecache import backend_fingerprint
    from repro_torch.distributed.mesh_backend import MeshBackend
    from repro_torch.polybench import build_3mm
    be = MeshBackend(mesh=nccl_mesh)
    assert backend_fingerprint(be).endswith(":meshdata1xmodel1")
    p, _ = build_3mm(n=256)
    pl = plan(p, policy="auto", backend=be, cache=TuneCache(tmp_path),
              reps=1)
    assert pl.meta["verify"]["ok"]
    out, _ = execute(pl, backend=be)
    want = run_host_oracle(p)["out"]
    err = np.abs(np.asarray(out["out"]) - want).max() / np.abs(want).max()
    assert err <= 1e-3


def _kernel_case(name, device):
    """(kernel call, its inputs) at a small shape."""
    gen = torch.Generator(device).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    if name == "flash":
        return (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                (rnd(2, 128, 4, 2, 64), rnd(2, 128, 4, 64),
                 rnd(2, 128, 4, 64)))
    if name == "wkv6":
        w = torch.exp(-torch.exp(rnd(2, 64, 4, 64) * 0.1))
        return (lambda r, k, v, w, u: ops.wkv6(r, k, v, w, u),
                (rnd(2, 64, 4, 64), rnd(2, 64, 4, 64), rnd(2, 64, 4, 64),
                 w, rnd(4, 64)))
    a = torch.sigmoid(rnd(2, 64, 256))
    return (lambda a, b: ops.rglru_scan(a, b), (a, rnd(2, 64, 256)))


@pytest.mark.parametrize("name", ["flash", "wkv6", "rglru_scan"])
def test_cuda_kernel_under_local_map_equals_unsharded(nccl_mesh, name):
    """Each kernel on its rank's shard (``local_apply``, which the model
    path calls) gives the unsharded kernel's bits."""
    from repro_torch.distributed.sharding import distribute, local_apply
    fn, args = _kernel_case(name, "cuda")
    want = fn(*args)
    dargs = [distribute(a, nccl_mesh, ("data",) + (None,) * (a.ndim - 1)
                        if a.ndim > 2 else ()) for a in args]
    n_out = 2 if name == "wkv6" else 1
    plc = [tuple(dargs[0].placements)] * n_out
    got = local_apply(fn, tuple(plc) if n_out > 1 else list(plc[0]), *dargs)
    for g, w in zip(got if n_out > 1 else [got],
                    want if n_out > 1 else [want]):
        assert torch.equal(g.full_tensor(), w)


def test_cuda_build_cell_on_mesh_matches_unmeshed(nccl_mesh):
    """``build_cell(mesh=...)`` of reduced qwen2.5-14b with flash on the
    1×1 mesh: the step's loss within 1e-5 of the unmeshed cell's."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.optim import default_optimizer
    cfg = reduced(get_config("qwen2.5-14b"))
    shape = ShapeSpec("t", "train", 64, 2)
    params = Transformer(cfg).init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    losses = []
    for mesh in (None, nccl_mesh):
        cell = steps.build_cell(cfg, shape, mesh, use_pallas=True)
        p = steps.unflatten(params, [t.clone() for t in
                                     steps.leaves(params)])
        args = cell.place(p, default_optimizer(cfg).init(p), batch)
        _, _, m = cell.fn(*args)
        loss = m["loss"]
        losses.append(float(loss.full_tensor() if mesh is not None
                            else loss))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_cuda_moe_on_mesh_matches_unmeshed(nccl_mesh, name):
    """The MoE layer's mesh path (``moe_apply`` on DTensors with its
    policy: routing on the gathered tokens, the dispatch buffer at the
    ``moe_buf`` placement, one reduction of the partial outputs) on the
    1×1 mesh, reduced, fp32: loss, router aux and every gradient within
    1e-6 (relative, normwise) of the unmeshed layer's."""
    from repro_torch.distributed.sharding import (MeshPolicy, distribute,
                                                  make_rules, place,
                                                  tree_shardings)
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.tree import leaves
    cfg = reduced(get_config(name))
    model = Transformer(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    rules = make_rules(nccl_mesh, "train")
    dp = place(params, tree_shardings(rules, params, model.logical_axes()))
    db = {k: distribute(v, nccl_mesh, ("data", None))
          for k, v in batch.items()}
    loss, met, grads = value_and_grad(model, dp, db,
                                      policy=MeshPolicy(rules, cfg))
    want, want_m, want_g = value_and_grad(model, params, batch)
    for got, ref in ((loss, want), (met["aux"], want_m["aux"])):
        got, ref = float(got.full_tensor()), float(ref)
        assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)
    for g, w in zip(leaves(grads), leaves(want_g)):
        g = g.full_tensor()
        assert float((g - w).norm()) <= 1e-6 * max(float(w.norm()), 1e-30)


def test_cuda_offloaded_step_on_mesh_equals_on_card_step(nccl_mesh):
    """One train step of reduced qwen2.5-14b on the 1×1 mesh with the
    AdamW state offloaded (each rank's shards in pinned host memory,
    ``offload_shardings``) equals the step with the state on the card,
    bit for bit, params and state; the offloaded arrays stay pinned."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch import steps
    from repro_torch.optim import default_optimizer
    cfg = reduced(get_config("qwen2.5-14b"))
    shape = ShapeSpec("t", "train", 64, 2)
    params = Transformer(cfg).init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for offload in (False, True):
        cell = steps.build_cell(cfg, shape, nccl_mesh, use_pallas=True,
                                offload_opt=offload)
        p = steps.unflatten(params, [t.clone() for t in
                                     steps.leaves(params)])
        new_p, new_s, _ = cell.fn(*cell.place(
            p, default_optimizer(cfg).init(p), batch))
        torch.cuda.synchronize()
        out[offload] = [[(t.to_local() if is_dtensor(t) else t).detach()
                         for t in steps.leaves(tree)]
                        for tree in (new_p, new_s)]
    state = [t for t in out[True][1] if t.ndim]
    assert state and all(t.is_pinned() for t in state)
    for a, b in zip(sum(out[True], []), sum(out[False], [])):
        assert torch.equal(a.cpu(), b.cpu())


def _offloaded_arctic_steps(nccl_mesh, monkeypatch):
    """One train step of reduced arctic-480b on the 1×1 mesh with its
    own optimizer (``default_optimizer`` of the published config:
    Adafactor; the reduced config's parameter count would pick AdamW),
    the state on the card and offloaded, from the same params and batch.
    Returns {offload: (cell, params, state)}."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.optim import default_optimizer
    arctic = get_config("arctic-480b")
    assert default_optimizer(arctic).name == "adafactor"
    monkeypatch.setattr(steps, "default_optimizer",
                        lambda cfg: default_optimizer(arctic))
    cfg = reduced(arctic)
    shape = ShapeSpec("t", "train", 64, 2)
    params = Transformer(cfg).init(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    out = {}
    for offload in (False, True):
        cell = steps.build_cell(cfg, shape, nccl_mesh, use_pallas=True,
                                offload_opt=offload)
        p = steps.unflatten(params, [t.clone() for t in
                                     steps.leaves(params)])
        new_p, new_s, _ = cell.fn(*cell.place(
            p, default_optimizer(arctic).init(p), batch))
        torch.cuda.synchronize()
        assert cell.meta["optimizer"] == "adafactor" + (
            "+offload" if offload else "")
        out[offload] = (cell, new_p, new_s)
    return out


def test_cuda_offloaded_adafactor_on_mesh_equals_on_card_step(nccl_mesh,
                                                              monkeypatch):
    """The Adafactor twin of the AdamW test above: one train step of
    reduced arctic-480b on the 1×1 mesh with Adafactor's state offloaded
    (pinned ``PinnedShard``s; each piece's factors back as DTensors at the
    on-card state's placements) equals the on-card step bit for bit,
    params and state; the offloaded arrays stay pinned."""
    from repro_torch.distributed.sharding import PinnedShard, local_shard
    from repro_torch.launch import steps
    out = _offloaded_arctic_steps(nccl_mesh, monkeypatch)
    (_, p_card, s_card), (_, p_off, s_off) = out[False], out[True]
    state = [t for t in steps.leaves(s_off) if t.ndim]
    assert state and all(isinstance(t, PinnedShard) and t.is_pinned()
                         for t in state)
    for a, b in zip(steps.leaves(p_off) + steps.leaves(s_off),
                    steps.leaves(p_card) + steps.leaves(s_card)):
        assert torch.equal(local_shard(a).cpu(), local_shard(b).cpu())


def test_cuda_offloaded_state_checkpoint_on_mesh(nccl_mesh, monkeypatch,
                                                 tmp_path):
    """That offloaded Adafactor state saved by ``CheckpointManager`` on the
    1×1 mesh writes the same files as the on-card state, and restored by
    its offload shardings (or by itself) comes back bitwise, each array a
    pinned ``PinnedShard`` of its global shape."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import PinnedShard, local_shard
    from repro_torch.launch import steps
    out = _offloaded_arctic_steps(nccl_mesh, monkeypatch)
    (_, _, s_card), (cell, _, s_off) = out[False], out[True]
    CheckpointManager(tmp_path / "card").save(1, s_card, blocking=True)
    mgr = CheckpointManager(tmp_path / "off")
    mgr.save(1, s_off, blocking=True)
    a, b = (tmp_path / d / "step_0000000001" for d in ("off", "card"))
    names = sorted(p.name for p in b.iterdir())
    assert names == sorted(p.name for p in a.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    for shardings in (cell.in_shardings[1], None):
        back, _ = mgr.restore(1, s_off, shardings=shardings)
        for x, y in zip(steps.leaves(back), steps.leaves(s_off)):
            if isinstance(y, PinnedShard):
                assert isinstance(x, PinnedShard) and x.is_pinned()
                assert x.global_shape == y.global_shape
            elif shardings is None:
                continue      # the step's DTensor comes back plain
            assert torch.equal(local_shard(x).cpu(),
                               local_shard(y).cpu())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_cuda_offloaded_init_on_mesh_places_as_the_cell(nccl_mesh, name,
                                                        monkeypatch):
    """``offloaded_optimizer(opt).init`` of DTensor params on the 1×1
    mesh gives the state ``build_cell(offload_opt=True)`` places for
    ``opt``: the same tree, each array a pinned zero ``PinnedShard`` of
    the same global shape, local shape and placements, the step a
    DTensor."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import PinnedShard, is_dtensor
    from repro_torch.launch import steps
    from repro_torch.optim import adafactor, adamw, offloaded_optimizer
    make = {"adamw": adamw, "adafactor": adafactor}[name]
    monkeypatch.setattr(steps, "default_optimizer", lambda cfg: make())
    cfg = reduced(get_config("qwen2.5-14b"))
    params = Transformer(cfg).init(torch.Generator("cuda").manual_seed(0))
    cell = steps.build_cell(cfg, ShapeSpec("t", "train", 64, 2), nccl_mesh,
                            offload_opt=True)
    batch = {k: torch.zeros((2, 64), dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}
    dparams, placed, _ = cell.place(params, make().init(params), batch)
    got = offloaded_optimizer(make()).init(dparams)
    flat_got, flat_want = steps.leaves(got), steps.leaves(placed)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert type(a) is type(b)
        if isinstance(b, PinnedShard):
            assert a.is_pinned() and not a.any()
            assert (a.shape, a.global_shape, a.dtype) == \
                (b.shape, b.global_shape, b.dtype)
            assert tuple(a.placements) == tuple(b.placements)
        else:
            assert is_dtensor(a) and a.shape == b.shape
