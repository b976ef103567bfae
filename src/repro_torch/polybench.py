"""Polybench problems as offload block-programs — the paper's workloads.

Each builder mirrors the paper's C structure: host init loops, one or more
``#pragma omp parallel for target cuda`` blocks (→ ``Program.offload``),
host consumption of results.  The 3MM builder reproduces the paper's
Tables 1-2 worked example; the full set backs Fig. 6's speedup comparison
(benchmarks/transfer_polybench.py).

Every builder returns (Program, dict of input arrays).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import Program

__all__ = ["build", "PROBLEMS"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def build_3mm(n: int = 512, iters: int = 1, seed: int = 0
              ) -> Tuple[Program, Dict[str, np.ndarray]]:
    """E := A·B;  F := C·D;  G := E·F  (paper Table 1/2)."""
    rng = np.random.default_rng(seed)
    p = Program("3mm")
    for nm in "ABCD":
        p.bind(nm, _rand(rng, n, n))
    p.offload(lambda xp, A, B: {"E": A @ B}, reads=("A", "B"),
              writes=("E",), name="mm_E")
    p.offload(lambda xp, C, D: {"F": C @ D}, reads=("C", "D"),
              writes=("F",), name="mm_F")
    p.offload(lambda xp, E, F: {"G": E @ F}, reads=("E", "F"),
              writes=("G",), name="mm_G")
    p.host(lambda xp, G: {"out": G.sum(axis=0, keepdims=True)},
           reads=("G",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_2mm(n: int = 512, iters: int = 1, seed: int = 0):
    """D := alpha·A·B·C + beta·D."""
    rng = np.random.default_rng(seed)
    p = Program("2mm")
    for nm in ("A", "B", "C", "D"):
        p.bind(nm, _rand(rng, n, n))
    p.offload(lambda xp, A, B: {"tmp": 1.5 * (A @ B)},
              reads=("A", "B"), writes=("tmp",), name="mm1")
    p.offload(lambda xp, tmp, C, D: {"D": tmp @ C + 1.2 * D},
              reads=("tmp", "C", "D"), writes=("D",), name="mm2")
    p.host(lambda xp, D: {"out": D.sum(axis=0, keepdims=True)},
           reads=("D",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_gemm(n: int = 768, iters: int = 4, seed: int = 0):
    """Repeated C := alpha·A·B + beta·C inside a host-visible loop — the
    loop residency case (C stays on device across iterations)."""
    rng = np.random.default_rng(seed)
    p = Program("gemm")
    p.bind("A", _rand(rng, n, n))
    p.bind("B", _rand(rng, n, n))
    p.bind("C", _rand(rng, n, n))
    with p.loop(iters):
        p.offload(lambda xp, A, B, C: {"C": 0.5 * (A @ B) + 0.9 * C},
                  reads=("A", "B", "C"), writes=("C",), name="gemm")
    p.host(lambda xp, C: {"out": C.sum(axis=0, keepdims=True)},
           reads=("C",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_atax(n: int = 2048, iters: int = 1, seed: int = 0):
    """y := Aᵀ·(A·x)."""
    rng = np.random.default_rng(seed)
    p = Program("atax")
    p.bind("A", _rand(rng, n, n))
    p.bind("x", _rand(rng, n))
    p.offload(lambda xp, A, x: {"tmp": A @ x}, reads=("A", "x"),
              writes=("tmp",), name="Ax")
    p.offload(lambda xp, A, tmp: {"y": A.T @ tmp}, reads=("A", "tmp"),
              writes=("y",), name="ATtmp")
    p.host(lambda xp, y: {"out": y[:8]}, reads=("y",), writes=("out",),
           name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_bicg(n: int = 2048, iters: int = 1, seed: int = 0):
    """s := Aᵀ·r;  q := A·p."""
    rng = np.random.default_rng(seed)
    p = Program("bicg")
    p.bind("A", _rand(rng, n, n))
    p.bind("r", _rand(rng, n))
    p.bind("pv", _rand(rng, n))
    p.offload(lambda xp, A, r: {"s": A.T @ r}, reads=("A", "r"),
              writes=("s",), name="ATr")
    p.offload(lambda xp, A, pv: {"q": A @ pv}, reads=("A", "pv"),
              writes=("q",), name="Ap")
    p.host(lambda xp, s, q: {"out": s[:4] + q[:4]}, reads=("s", "q"),
           writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_mvt(n: int = 2048, iters: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = Program("mvt")
    p.bind("A", _rand(rng, n, n))
    p.bind("x1", _rand(rng, n))
    p.bind("x2", _rand(rng, n))
    p.bind("y1", _rand(rng, n))
    p.bind("y2", _rand(rng, n))
    p.offload(lambda xp, A, x1, y1: {"x1": x1 + A @ y1},
              reads=("A", "x1", "y1"), writes=("x1",), name="mvt1")
    p.offload(lambda xp, A, x2, y2: {"x2": x2 + A.T @ y2},
              reads=("A", "x2", "y2"), writes=("x2",), name="mvt2")
    p.host(lambda xp, x1, x2: {"out": x1[:4] + x2[:4]},
           reads=("x1", "x2"), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_gesummv(n: int = 1536, iters: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = Program("gesummv")
    p.bind("A", _rand(rng, n, n))
    p.bind("B", _rand(rng, n, n))
    p.bind("x", _rand(rng, n))
    p.offload(lambda xp, A, B, x: {"y": 1.1 * (A @ x) + 0.9 * (B @ x)},
              reads=("A", "B", "x"), writes=("y",), name="gesummv")
    p.host(lambda xp, y: {"out": y[:8]}, reads=("y",), writes=("out",),
           name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_syrk(n: int = 640, iters: int = 2, seed: int = 0):
    """C := alpha·A·Aᵀ + beta·C, iterated."""
    rng = np.random.default_rng(seed)
    p = Program("syrk")
    p.bind("A", _rand(rng, n, n))
    p.bind("C", _rand(rng, n, n))
    with p.loop(iters):
        p.offload(lambda xp, A, C: {"C": 0.1 * (A @ A.T) + 0.9 * C},
                  reads=("A", "C"), writes=("C",), name="syrk")
    p.host(lambda xp, C: {"out": C.sum(axis=0, keepdims=True)},
           reads=("C",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_covariance(n: int = 768, iters: int = 1, seed: int = 0):
    """The paper's best case (near hand-CUDA): mean, center, cov."""
    rng = np.random.default_rng(seed)
    p = Program("covariance")
    p.bind("data", _rand(rng, n, n))
    p.offload(lambda xp, data: {"mean": data.mean(axis=0, keepdims=True)},
              reads=("data",), writes=("mean",), name="mean")
    p.offload(lambda xp, data, mean: {"cent": data - mean},
              reads=("data", "mean"), writes=("cent",), name="center")
    p.offload(lambda xp, cent: {"cov": cent.T @ cent / (cent.shape[0] - 1)},
              reads=("cent",), writes=("cov",), name="cov")
    p.host(lambda xp, cov: {"out": cov.sum(axis=0, keepdims=True)},
           reads=("cov",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


def build_jacobi2d(n: int = 1024, iters: int = 20, seed: int = 0):
    """Stencil iterated on device — residency across a long loop; host
    samples the field every iteration chunk."""
    rng = np.random.default_rng(seed)
    p = Program("jacobi2d")
    p.bind("U", _rand(rng, n, n))

    def jacobi(xp, U):
        inner = 0.2 * (U[1:-1, 1:-1] + U[:-2, 1:-1] + U[2:, 1:-1]
                       + U[1:-1, :-2] + U[1:-1, 2:])
        if xp is np:
            out = U.copy()
        else:
            out = U
        out = xp.asarray(out)
        # functional update for jax / numpy parity
        out = xp.concatenate([
            U[:1],
            xp.concatenate([U[1:-1, :1], inner, U[1:-1, -1:]], axis=1),
            U[-1:],
        ], axis=0)
        return {"U": out}

    with p.loop(iters):
        p.offload(jacobi, reads=("U",), writes=("U",), name="jacobi")
    p.host(lambda xp, U: {"out": U.sum(axis=0, keepdims=True)},
           reads=("U",), writes=("out",), name="consume")
    p.set_outputs("out")
    return p, dict(p.inputs)


PROBLEMS = {
    "2mm": build_2mm,
    "3mm": build_3mm,
    "gemm": build_gemm,
    "atax": build_atax,
    "bicg": build_bicg,
    "mvt": build_mvt,
    "gesummv": build_gesummv,
    "syrk": build_syrk,
    "covariance": build_covariance,
    "jacobi2d": build_jacobi2d,
}


def build(name: str, **kw):
    return PROBLEMS[name](**kw)
