"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  ``load(name)``
compiles it with ``nvcc -gencode arch=compute_90a,code=sm_90a`` at first
use into ``build/<name>-<hash>/lib<name>.so`` at the root of the checkout
(the hash covers the source and the flags, so an edited source rebuilds)
and loads it with ``ctypes``.  A failed ``nvcc`` raises with its log;
nothing falls back to a plain version.  Independent kernels build in
parallel when ``load`` is called from several threads: each call waits
only on its own ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.so"
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                              str(source)], capture_output=True, text=True)
        (out_dir / "nvcc.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
