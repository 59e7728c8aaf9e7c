"""Products known to be symmetric, computed on one triangle, and the pass
that mirrors a triangle into the full matrix.

The poly filter's one-triangle route (ops/polyfilter.py) multiplies
commuting symmetric matrices, whose products are symmetric: only the upper
triangle of each (row-major) is computed.

- ``syrk(a, out)``: the upper triangle of alpha a a^T into ``out``;
- ``syrkx(a, b, out)``: the upper triangle of a b^T, for a b^T known to
  be symmetric;
- ``mirror(t)``: the full matrix alpha s (T + coef W) + shift I from the
  upper triangles of T and W, in place by default.

On CUDA ``syrk`` and ``syrkx`` call cuBLAS's ``<t>syrk`` and ``<t>syrkx``
(D and S) through ctypes, in the ``libcublas`` that torch loaded, on
torch's handle and current stream: a CUDA graph captures them, and a call
makes no host wait and no device allocation. ``mirror`` launches the
hand-written kernel of ``csrc/sym_mirror.cu`` (its source says what bounds
it). On a CPU tensor each runs its plain version: a full ``torch.addmm``
(the lower triangle then holds what nobody reads) and a mirror by
``torch.triu``. There is no fallback: on CUDA they launch or raise.

A launch of the mirror kernel adds one to ``trace.COUNTS["sym_mirror"]``
(its plain version counts nothing); the caller counts the products.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from cuadmm_tpu_torch import _build, trace

# cuBLAS is column-major: a row-major matrix is the column-major view of its
# transpose, so cuBLAS's lower triangle is the row-major upper one (see
# ``_cublas_call``).
_FILL_LOWER, _OP_T, _POINTER_MODE_HOST = 0, 1, 0

_CUBLAS = None  # the cuBLAS library torch loaded, bound on the first CUDA call
_MIRROR = None  # the mirror kernel's library, built on the first CUDA launch


def _check_operands(out: torch.Tensor, *ins: Optional[torch.Tensor], product: bool = False) -> None:
    if out.dim() != 2 or out.shape[0] != out.shape[1]:
        raise ValueError(f"need a square out, got {tuple(out.shape)}")
    for x in (out, *ins):
        if x is None:
            continue
        if x.dtype != out.dtype or x.device != out.device:
            raise ValueError(f"operands differ: {x.dtype} on {x.device} against {out.dtype} on {out.device}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if product and any(x.data_ptr() == out.data_ptr() for x in ins):
        raise ValueError("a product's out must not be one of its factors")
    if out.device.type == "cuda" and out.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"need float32 or float64, got {out.dtype}")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {out.device}")


def _loaded_library(stem: str) -> str:
    """The path of the shared library ``<stem>.so*`` mapped into this process."""
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split(maxsplit=5)
            if len(parts) == 6 and os.path.basename(parts[5].strip()).startswith(stem + ".so"):
                return parts[5].strip()
    raise RuntimeError(f"{stem} is not loaded in this process: torch's CUDA build has no shared {stem}")


def _cublas() -> ctypes.CDLL:
    global _CUBLAS
    if _CUBLAS is None:
        torch.cuda.current_blas_handle()  # torch's cuBLAS is loaded and has a handle
        lib = ctypes.CDLL(_loaded_library("libcublas"))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, t in (("D", ctypes.c_double), ("S", ctypes.c_float)):
            s = ctypes.POINTER(t)
            syrk = getattr(lib, f"cublas{name}syrk_v2")
            syrk.argtypes = [p, i, i, i, i, s, p, i, s, p, i]
            syrk.restype = i
            syrkx = getattr(lib, f"cublas{name}syrkx")
            syrkx.argtypes = [p, i, i, i, i, s, p, i, p, i, s, p, i]
            syrkx.restype = i
        lib.cublasSetPointerMode_v2.argtypes = [p, i]
        lib.cublasSetPointerMode_v2.restype = i
        lib.cublasGetStatusString.argtypes = [i]
        lib.cublasGetStatusString.restype = ctypes.c_char_p
        _CUBLAS = lib
    return _CUBLAS


def _cublas_call(a: torch.Tensor, b: Optional[torch.Tensor], out: torch.Tensor, alpha: float) -> None:
    """cuBLAS's <t>syrk (``b`` None: b = a) or <t>syrkx on torch's handle:
    the row-major upper triangle of alpha a b^T into ``out``, beta 0
    (``out`` is not read). With trans "T" cuBLAS computes A^T B of the
    column-major views A = b^T and B = a^T (k x n, leading dimension k):
    b a^T, whose row-major view is a b^T."""
    lib = _CUBLAS or _cublas()
    what = "syrk" if b is None else "syrkx"
    n, k = a.shape
    f64 = out.dtype == torch.float64
    scalar = ctypes.c_double if f64 else ctypes.c_float
    one_letter = "D" if f64 else "S"
    al, be = ctypes.byref(scalar(alpha)), ctypes.byref(scalar(0.0))
    idx = out.device.index
    with torch.cuda.device(idx):
        handle = torch.cuda.current_blas_handle()  # bound to the current stream by torch
        err = lib.cublasSetPointerMode_v2(handle, _POINTER_MODE_HOST)
        if err == 0 and b is None:
            err = getattr(lib, f"cublas{one_letter}syrk_v2")(
                handle, _FILL_LOWER, _OP_T, n, k, al, a.data_ptr(), k, be, out.data_ptr(), n)
        elif err == 0:
            err = getattr(lib, f"cublas{one_letter}syrkx")(
                handle, _FILL_LOWER, _OP_T, n, k, al, b.data_ptr(), k, a.data_ptr(), k, be, out.data_ptr(), n)
    if err != 0:
        raise RuntimeError(f"cuBLAS {what} failed: {lib.cublasGetStatusString(err).decode()} (status {err})")


def syrk(a: torch.Tensor, out: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """The upper triangle of ``alpha * a @ a.T`` into ``out`` (n, n), for
    ``a`` (n, k); below the diagonal ``out`` holds nothing of use."""
    _check_operands(out, a, product=True)
    if a.dim() != 2 or a.shape[0] != out.shape[0]:
        raise ValueError(f"need a (n, k) with n = {out.shape[0]}, got {tuple(a.shape)}")
    if out.device.type == "cpu":
        out.addmm_(a, a.mT, beta=0.0, alpha=alpha)
    else:
        _cublas_call(a, None, out, alpha)
    return out


def syrkx(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The upper triangle of ``a @ b.T`` into ``out`` (n, n), for ``a`` and
    ``b`` (n, k) whose product the caller knows to be symmetric."""
    _check_operands(out, a, b, product=True)
    if a.dim() != 2 or a.shape[0] != out.shape[0] or a.shape != b.shape:
        raise ValueError(f"need a and b (n, k) with n = {out.shape[0]}, got {tuple(a.shape)}, {tuple(b.shape)}")
    if out.device.type == "cpu":
        out.addmm_(a, b.mT, beta=0.0)
    else:
        _cublas_call(a, b, out, 1.0)
    return out


def mirror_ref(t: torch.Tensor, out: torch.Tensor, alpha: float, scale: Optional[torch.Tensor], shift: float,
               add: Optional[torch.Tensor], add_coef: float) -> torch.Tensor:
    """Plain version of ``mirror``, in the kernel's order of operations."""
    u = torch.triu(t)
    if add is not None:
        u = u + add_coef * torch.triu(add)
    u = u * (alpha * scale.reshape(()) if scale is not None else alpha)
    u.diagonal().add_(shift)
    return out.copy_(u + torch.triu(u, 1).mT)


def _load_mirror() -> ctypes.CDLL:
    global _MIRROR
    if _MIRROR is None:
        lib = _build.load("sym_mirror")
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, t in (("f64", ctypes.c_double), ("f32", ctypes.c_float)):
            fn = getattr(lib, f"cuadmm_sym_mirror_{name}")
            fn.argtypes = [p, p, t, p, t, t, p, i, p]
            fn.restype = i
        lib.cuadmm_cuda_error_string.argtypes = [i]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _MIRROR = lib
    return _MIRROR


def mirror(t: torch.Tensor, out: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
           scale: Optional[torch.Tensor] = None, shift: float = 0.0, add: Optional[torch.Tensor] = None,
           add_coef: float = 1.0) -> torch.Tensor:
    """The full symmetric ``alpha * scale * (T + add_coef * W) + shift * I``
    from the upper triangles of ``t`` (T) and ``add`` (W, optional), into
    ``out`` (``t`` itself by default). ``scale`` is an optional one-element
    tensor on ``t``'s device, read there; ``add`` must not be ``out``."""
    out = t if out is None else out
    _check_operands(out, t, add, scale.reshape(1, 1) if scale is not None else None)
    if t.shape != out.shape or (add is not None and add.shape != out.shape):
        raise ValueError(f"need t, out and add of one shape, got {tuple(t.shape)}, {tuple(out.shape)}")
    if scale is not None and scale.numel() != 1:
        raise ValueError(f"scale must hold one number, got {tuple(scale.shape)}")
    if add is not None and add.data_ptr() == out.data_ptr():
        raise ValueError("add must not be out")
    if out.device.type == "cpu":
        return mirror_ref(t, out, alpha, scale, shift, add, add_coef)
    lib = _MIRROR or _load_mirror()
    fn = lib.cuadmm_sym_mirror_f64 if out.dtype == torch.float64 else lib.cuadmm_sym_mirror_f32
    idx = out.device.index
    with torch.cuda.device(idx):
        err = fn(t.data_ptr(), add.data_ptr() if add is not None else None, add_coef,
                 scale.data_ptr() if scale is not None else None, alpha, shift, out.data_ptr(), out.shape[0],
                 torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"sym_mirror kernel launch failed: {lib.cuadmm_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    trace.COUNTS["sym_mirror"] += 1
    return out
