"""Batched cyclic-Jacobi symmetric eigendecomposition (K4).

Port of cuadmm_tpu/ops/jacobi.py. ``jacobi_eigh_ref`` is the plain PyTorch
version of ``jacobi_eigh_jnp``: the same cyclic-by-rows pair order, the
same fixed sweep count (``default_sweeps``) and the same rotation formula,
so its unsorted eigenvalues and eigenvectors agree with the JAX package's
to rounding. The CUDA kernel in ``csrc/jacobi_eigh.cu`` replaces the Pallas
kernel ``cuadmm_tpu/ops/jacobi.py::_jacobi_kernel``; the source says what
bounds it and how its design answers that.

``jacobi_eigh`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors. There is no fallback: on CUDA it launches or
raises. The kernel reports no status to the host, so a projection through
it never waits for the device. Both versions let a non-finite block come
out non-finite, as XLA does, so the driver's divergence guard fires.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cuadmm_tpu_torch import _build
from cuadmm_tpu_torch.ops import launches

_LIB = None  # the loaded kernel library, built on the first CUDA launch
_READY: set = set()  # device indices whose shared-memory attribute is set


def default_sweeps(n: int) -> int:
    """Sweep counts sized for ~1e-6 off-diagonal reduction (the JAX
    package's, cuadmm_tpu/ops/jacobi.py:31)."""
    if n <= 4:
        return 6
    if n <= 8:
        return 8
    if n <= 16:
        return 10
    return 12


def _pair_schedule(n: int):
    """Cyclic-by-rows pivot order: all (p, q), p < q."""
    return [(p, q) for p in range(n) for q in range(p + 1, n)]


def _rotation(app, aqq, apq, eps: float):
    """Jacobi rotation (c, s) zeroing a_pq; c=1, s=0 when |a_pq| <= eps and
    a 45-degree rotation when theta == 0."""
    safe = torch.abs(apq) > eps
    denom = torch.where(safe, 2.0 * apq, 1.0)
    theta = (aqq - app) / denom
    t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(1.0 + theta * theta))
    t = torch.where(theta == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return torch.where(safe, c, 1.0), torch.where(safe, s, 0.0)


def _rotate_ref(a: torch.Tensor, v: torch.Tensor, p: int, q: int, eps: float) -> None:
    """One rotation in place on a (B, n, n) and the eigenvector columns of
    v (B, n, n): rows p, q of a, then columns p, q of a, then columns p, q
    of v. Every product is formed even when s == 0, so NaN spreads."""
    c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q], eps)
    c, s = c[:, None], s[:, None]
    rp, rq = a[:, p, :].clone(), a[:, q, :].clone()
    a[:, p, :] = c * rp - s * rq
    a[:, q, :] = s * rp + c * rq
    cp, cq = a[:, :, p].clone(), a[:, :, q].clone()
    a[:, :, p] = c * cp - s * cq
    a[:, :, q] = s * cp + c * cq
    vp, vq = v[:, :, p].clone(), v[:, :, q].clone()
    v[:, :, p] = c * vp - s * vq
    v[:, :, q] = s * vp + c * vq


def jacobi_eigh_ref(mats: torch.Tensor, sweeps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version. mats: (B, n, n) symmetric.

    Returns (w (B, n) unsorted, v (B, n, n)) with mats @ v ~= v * w: the
    columns of v are eigenvectors, as in ``torch.linalg.eigh``.
    """
    b, n, _ = mats.shape
    if n == 1:
        return mats[:, :, 0], torch.ones_like(mats)
    sweeps = default_sweeps(n) if sweeps is None else sweeps
    eps = 1e-30 if mats.dtype == torch.float64 else 1e-18
    a = mats.clone()
    v = torch.eye(n, dtype=mats.dtype, device=mats.device).expand(b, n, n).clone()
    pairs = _pair_schedule(n)
    for _ in range(sweeps):
        for p, q in pairs:
            _rotate_ref(a, v, p, q, eps)
    return torch.diagonal(a, dim1=1, dim2=2).clone(), v


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuadmm_cuda_error_string(err).decode()
        raise RuntimeError(f"jacobi_eigh {what} failed: {msg} (cudaError {err})")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("jacobi_eigh")
        lib.cuadmm_jacobi_eigh_init.argtypes = []
        lib.cuadmm_jacobi_eigh_init.restype = ctypes.c_int
        for fn in (lib.cuadmm_jacobi_eigh_f64, lib.cuadmm_jacobi_eigh_f32):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.cuadmm_jacobi_eigh_work_elems.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.cuadmm_jacobi_eigh_work_elems.restype = ctypes.c_int
        lib.cuadmm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def jacobi_eigh(mats: torch.Tensor, sweeps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Jacobi eigh of (B, n, n) symmetric f32 or f64 ``mats``.

    Returns (w (B, n) unsorted, v (B, n, n)), eigenvectors in the columns of
    v. On CUDA the kernel is launched on the current stream without
    synchronizing. Any n >= 1, as ``jacobi_eigh_jnp`` takes.
    """
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"need mats (B, n, n), got {tuple(mats.shape)}")
    if mats.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"need float32 or float64 mats, got {mats.dtype}")
    b, n, _ = mats.shape
    sweeps = default_sweeps(n) if sweeps is None else int(sweeps)
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    if mats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mats.device}")
    if b == 0:
        return mats.new_empty((0, n)), mats.new_empty((0, n, n))
    if mats.device.type == "cpu" or n == 1:  # n == 1: nothing to rotate, no launch
        return jacobi_eigh_ref(mats, sweeps)
    mats = mats.contiguous()
    lib = _load()
    idx = mats.device.index if mats.device.index is not None else torch.cuda.current_device()
    w = torch.empty((b, n), dtype=mats.dtype, device=mats.device)
    v = torch.empty_like(mats)
    fn = lib.cuadmm_jacobi_eigh_f64 if mats.dtype == torch.float64 else lib.cuadmm_jacobi_eigh_f32
    with torch.cuda.device(idx):
        if idx not in _READY:
            _check(lib, lib.cuadmm_jacobi_eigh_init(), "set-up")
            _READY.add(idx)
        # A past the shared-memory budget streams from a scratch copy.
        work_elems = lib.cuadmm_jacobi_eigh_work_elems(n, mats.element_size())
        work = torch.empty((b, work_elems), dtype=mats.dtype, device=mats.device) if work_elems else None
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(mats.data_ptr(), w.data_ptr(), v.data_ptr(), work.data_ptr() if work is not None else None,
                 b, n, sweeps, stream)
    _check(lib, err, "kernel launch")
    launches.LAUNCHES["k4"] += 1
    launches.LAUNCHES["k4_f32"] += mats.dtype == torch.float32
    return w, v
