"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the root of
the checkout on first use. The hash covers the source and the flags, so an
edited kernel is rebuilt and a stale library is never loaded. The build
runs only when a kernel is launched on a CUDA tensor, never on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from cuadmm_tpu_torch import trace

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept in the log
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str, variant: Optional[str] = None, flags: Sequence[str] = ()) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built; a
    ``variant`` (extra nvcc ``flags``) gets a name of its own."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join((*NVCC_FLAGS, *flags)).encode()).hexdigest()
    stem = name if variant is None else f"{name}_{variant}"
    return BUILD_DIR / f"lib{stem}-{digest[:12]}.so"


def build(name: str, variant: Optional[str] = None, flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's output (ptxas register and spill report included) goes to
    the ``.log`` beside the library. Raises with that output if nvcc fails.
    """
    out = library_path(name, variant, flags)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, variant: Optional[str] = None, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<name>.cu``. Inside
    a set-up stage (the normal solver's ``neq`` stages) the build is the
    span ``neq.build`` and its seconds are ``build``'s, not the stage's."""
    with trace.building():
        return ctypes.CDLL(str(build(name, variant, flags)))
