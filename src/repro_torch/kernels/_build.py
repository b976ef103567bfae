"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  ``load(name)``
compiles it with ``nvcc -gencode arch=compute_90a,code=sm_90a`` (plus the
kernel's own ``extra_flags``, e.g. ``-lcuda``) at first use into
``build/<name>-<digest>/lib<name>.so`` at the root of the checkout and
loads it with ``ctypes``.  The digest covers everything the build reads:
the source, every ``csrc/*.cuh`` header, the global flags and the extra
flags, so a change to any of them rebuilds.  A failed ``nvcc`` raises
with its log; nothing falls back to a plain version.  Independent kernels
build in parallel when ``load`` is called from several threads: each call
waits only on its own ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "digest", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def digest(name: str, extra_flags: tuple = ()) -> str:
    """Hash of what building ``csrc/<name>.cu`` reads: the source, every
    ``csrc/*.cuh`` header (by name and content), the global flags and
    ``extra_flags``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join((*NVCC_FLAGS, "--", *extra_flags)).encode())
    return h.hexdigest()[:16]


def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per digest) and load it."""
    source = CSRC / f"{name}.cu"
    out_dir = BUILD_ROOT / f"{name}-{digest(name, extra_flags)}"
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.so"
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source),
                              *extra_flags], capture_output=True, text=True)
        (out_dir / "nvcc.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
