"""wkv6's chunked algorithm, as the CUDA kernel computes it, on the CPU:
``wkv6_chunked_plain`` (chunks of 64, sub-chunks of 16, decays as direct
sums of log w) against the sequential recurrence ``ref.wkv6_ref`` and
against the reference's Pallas kernel in interpret mode.

Tolerance: |got - want| <= 2e-4 x (1 + |want|), the reference sweep's
wkv6 tolerance scaled by the output (the state grows with T).  The
extreme decays (exact 0, 1e-30 and 1.0 among moderate ones) are where a
form that subtracts two prefix sums of log w loses digits; the Pallas
kernel divides by a decay product there and underflows, so the
sequential recurrence is the comparator for them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wk

WKV6_TOL = 2e-4


def _inputs(BH, T, hs, seed, extreme):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (BH, T, hs)).astype(np.float32)
    if extreme:
        pick = rng.uniform(size=w.shape)
        w[pick < 0.1] = 0.0
        w[(pick >= 0.1) & (pick < 0.2)] = 1e-30
        w[(pick >= 0.2) & (pick < 0.4)] = 1.0
    u = rng.standard_normal((BH, hs)).astype(np.float32)
    return [torch.from_numpy(x) for x in (r, k, v, w, u)]


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    excess = np.abs(got - want) - WKV6_TOL * (1 + np.abs(want))
    assert excess.max() <= 0, (
        f"max |err| / (1 + |want|) = "
        f"{(np.abs(got - want) / (1 + np.abs(want))).max()}")


@pytest.mark.parametrize("hs", wk.HEAD_SIZES)
@pytest.mark.parametrize("T", [1, 15, 65, 100, 129])
def test_chunked_matches_sequential_extreme_decays(hs, T):
    inputs = _inputs(3, T, hs, seed=T * 1000 + hs, extreme=True)
    got_o, got_s = wk.wkv6_chunked_plain(*inputs)
    want_o, want_s = ref.wkv6_ref(*inputs)
    assert got_o.dtype == got_s.dtype == torch.float32
    _assert_close(got_o, want_o)
    _assert_close(got_s, want_s)


@pytest.mark.parametrize("hs", [8, 64])
def test_chunked_matches_sequential_long_extreme(hs):
    """Several chunks deep, so states carried across many chunks (and the
    sub-chunk advances inside each) are checked, ragged at the end."""
    inputs = _inputs(2, 4 * wk.CHUNK + 13, hs, seed=hs, extreme=True)
    for got, want in zip(wk.wkv6_chunked_plain(*inputs),
                         ref.wkv6_ref(*inputs)):
        _assert_close(got, want)


@pytest.mark.parametrize("T,block_t", [(128, 64), (128, 32), (96, 96),
                                       (200, 40)])
def test_chunked_matches_reference_kernel(T, block_t):
    """Moderate decays, uniform(0.2, 0.99), where the Pallas form holds."""
    B, H, hs = 1, 2, 8
    rng = np.random.default_rng(T + block_t)
    r, k, v = (rng.standard_normal((B, T, H, hs)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 0.99, (B, T, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    want_o, want_s = ref_ops.wkv6(*map(jnp.asarray, (r, k, v, w, u)),
                                  block_t=block_t, interpret=True)

    def fold(x):
        return torch.from_numpy(x).permute(0, 2, 1, 3) \
            .reshape(B * H, T, hs).contiguous()
    uu = torch.from_numpy(np.broadcast_to(u, (B, H, hs))
                          .reshape(B * H, hs).copy())
    got_o, got_s = wk.wkv6_chunked_plain(fold(r), fold(k), fold(v), fold(w),
                                         uu)
    got_o = got_o.reshape(B, H, T, hs).permute(0, 2, 1, 3)
    _assert_close(got_o, np.asarray(want_o))
    _assert_close(got_s.reshape(B, H, hs, hs), np.asarray(want_s))


def test_chunked_zero_decay_cuts_the_past():
    """w = 0 at a token wipes the state: the output after it equals a run
    started at that token (up to the clamp's 1e-38)."""
    r, k, v, w, u = _inputs(2, 90, 16, seed=3, extreme=False)
    w[:, 40] = 0.0
    o, s = wk.wkv6_chunked_plain(r, k, v, w, u)
    # from S = 0 at token 41, fed the same tokens: the cut at 40 leaves
    # only k_40 v_40 in the state
    o_tail, s_tail = wk.wkv6_chunked_plain(r[:, 40:], k[:, 40:], v[:, 40:],
                                           w[:, 40:], u)
    _assert_close(o[:, 41:], o_tail[:, 1:])
    _assert_close(s, s_tail)
