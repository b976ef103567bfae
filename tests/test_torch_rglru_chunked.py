"""rglru_scan's chunked algorithm, as the CUDA kernel computes it, on the
CPU: ``rglru_scan_chunked_plain`` (per-chunk aggregates, a look-back over
0, 1 or all predecessors' aggregates before an inclusive value, the rescan
from the carry) against the sequential scan ``ref.rglru_scan_ref`` and
against the reference's Pallas kernel in interpret mode.

Tolerance: |got - want| <= 1e-5 x (1 + |want|), the reference sweep's
rglru_scan tolerance scaled by the output.  Inputs come from a seeded
numpy generator: a uniform(0.4, 0.999), or an extreme mix of 10% exact
0.0, 10% 1e-30, 20% exact 1.0 and the rest uniform(0.4, 0.999) (runs of
1.0 stay short: a long one turns the scan into a plain sum whose rounding
neither form holds to 1e-5); b standard normal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.rglru_scan as ref_rglru
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rg

RGLRU_TOL = 1e-5
LOOKBACKS = [0, 1, None]  # None: fold every predecessor's aggregate


def _inputs(shape, seed, mix):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, shape).astype(np.float32)
    if mix == "extreme":
        pick = rng.uniform(size=shape)
        a[pick < 0.1] = 0.0
        a[(pick >= 0.1) & (pick < 0.2)] = 1e-30
        a[(pick >= 0.2) & (pick < 0.4)] = 1.0
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    excess = np.abs(got - want) - RGLRU_TOL * (1 + np.abs(want))
    assert excess.max() <= 0, (
        f"max |err| / (1 + |want|) = "
        f"{(np.abs(got - want) / (1 + np.abs(want))).max()}")


@pytest.mark.parametrize("lookback", LOOKBACKS)
@pytest.mark.parametrize("mix", ["uniform", "extreme"])
@pytest.mark.parametrize("D", [5, 33, 512])
@pytest.mark.parametrize("B", [1, 3])
def test_chunked_matches_sequential(B, D, mix, lookback):
    T = 3 * rg.CHUNK + 5  # ragged against the chunk
    a, b = map(torch.from_numpy,
               _inputs((B, T, D), seed=B * 100 + D, mix=mix))
    got = rg.rglru_scan_chunked_plain(a, b, rg.CHUNK, lookback)
    assert got.dtype == torch.float32
    _assert_close(got, ref.rglru_scan_ref(a, b))


@pytest.mark.parametrize("mix", ["uniform", "extreme"])
@pytest.mark.parametrize("D", [5, 33, 512])
@pytest.mark.parametrize("B", [1, 3])
def test_chunked_matches_reference_kernel(B, D, mix):
    """T = 40 is ragged against the kernel's chunk; the Pallas kernel takes
    block_t = 20, which divides T as it asserts."""
    T = 40
    assert T % rg.CHUNK
    a, b = _inputs((B, T, D), seed=B * 1000 + D, mix=mix)
    want = ref_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), block_t=20,
                                interpret=True)
    got = rg.rglru_scan_chunked_plain(torch.from_numpy(a),
                                      torch.from_numpy(b), rg.CHUNK, None)
    _assert_close(got, np.asarray(want))


@pytest.mark.parametrize("lookback", LOOKBACKS)
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_long_chain(chunk, lookback):
    """The chunk lengths measured for the kernel (PERF.md), several chunks
    deep and ragged at the end, at the extreme mix: carries cross many
    chunks."""
    T = 5 * chunk + 13
    a, b = map(torch.from_numpy,
               _inputs((2, T, 12), seed=chunk, mix="extreme"))
    got = rg.rglru_scan_chunked_plain(a, b, chunk, lookback)
    _assert_close(got, ref.rglru_scan_ref(a, b))


def test_chunked_inside_a_chunk_is_the_plain_loop():
    """With the carry exact (one chunk), the chunked form is the plain
    loop bit for bit: each step is rounded the same way."""
    a, b = map(torch.from_numpy, _inputs((2, rg.CHUNK, 7), seed=4,
                                         mix="uniform"))
    assert torch.equal(rg.rglru_scan_chunked_plain(a, b),
                       ref.rglru_scan_ref(a, b))


def test_zero_decay_cuts_the_past():
    """a = 0 at a token wipes the state: h from there on equals a scan
    started at that token, whatever the look-back depth."""
    a, b = map(torch.from_numpy, _inputs((1, 70, 9), seed=5, mix="uniform"))
    a[:, 37] = 0.0
    tail = ref.rglru_scan_ref(a[:, 37:], b[:, 37:])
    for lookback in LOOKBACKS:
        got = rg.rglru_scan_chunked_plain(a, b, rg.CHUNK, lookback)
        _assert_close(got[:, 37:], tail)
