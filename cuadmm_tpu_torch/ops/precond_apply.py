"""Fused preconditioner application y = M^T (M r) in one pass over M (K1).

The precond normal solver applies its explicitly inverted, zero-padded f32
Cholesky factor M once per refinement sweep (ops/chol.py). As two matvecs
that reads M from device memory twice; the CUDA kernel in
``csrc/precond_apply.cu`` reads it once. It replaces the Pallas kernel
``cuadmm_tpu/ops/precond_apply.py::_kernel``; the source says what bounds
it and how its design answers that.

``fused_spd_apply`` launches the kernel for CUDA tensors and runs the
plain version ``fused_spd_apply_ref`` for CPU tensors. There is no
fallback: on CUDA it launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cuadmm_tpu_torch import _build

LANE = 128  # n_pad granularity (a float4 per thread, rows 512-byte aligned)
MAX_N_PAD = 32768  # dense_chol_max; the kernel's shared-memory budget

# Kernel launches so far (one per fused_spd_apply call on a CUDA tensor).
LAUNCHES = 0

_LIB = None  # the loaded kernel library, built on the first CUDA launch
_GRID: dict = {}  # device index -> persistent CTAs (one per SM), once set up


def fused_spd_apply_ref(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version: y = m^T (m r) as two matvecs."""
    return m.T @ (m @ r)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuadmm_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_spd_apply {what} failed: {msg} (cudaError {err})")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("precond_apply")
        lib.cuadmm_fused_spd_apply_init.argtypes = []
        lib.cuadmm_fused_spd_apply_init.restype = ctypes.c_int
        fn = lib.cuadmm_fused_spd_apply
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cuadmm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _grid(lib: ctypes.CDLL, device: torch.device) -> int:
    """CTAs for ``device``; on its first use, let the kernel take the shared
    memory of the largest n_pad (an attribute set once per device)."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    if idx not in _GRID:
        with torch.cuda.device(idx):
            _check(lib, lib.cuadmm_fused_spd_apply_init(), "set-up")
        _GRID[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _GRID[idx]


def fused_spd_apply(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y = m^T (m r) for square f32 ``m`` (n_pad, n_pad) and ``r`` (n_pad,).

    ``n_pad`` must be a positive multiple of 128 and at most 32768 (see
    ``pad_factor``). On CUDA the kernel is launched on the current stream
    without synchronizing.
    """
    global LAUNCHES
    if m.dim() != 2 or m.shape[0] != m.shape[1] or tuple(r.shape) != (m.shape[0],):
        raise ValueError(f"need m (n, n) and r (n,), got {tuple(m.shape)} and {tuple(r.shape)}")
    if m.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"need float32 m and r, got {m.dtype} and {r.dtype}")
    n_pad = m.shape[0]
    if n_pad == 0 or n_pad % LANE or n_pad > MAX_N_PAD:
        raise ValueError(f"n_pad={n_pad} must be a positive multiple of {LANE} <= {MAX_N_PAD}")
    if m.device != r.device:
        raise ValueError(f"m on {m.device} but r on {r.device}")
    if not (m.is_contiguous() and r.is_contiguous()):
        raise ValueError("m and r must be contiguous")
    if m.device.type == "cpu":
        return fused_spd_apply_ref(m, r)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    if m.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("m and r must be 16-byte aligned")
    lib = _load()
    grid = min(_grid(lib, m.device), n_pad)
    partial = torch.empty((grid, n_pad), dtype=torch.float32, device=m.device)
    y = torch.empty(n_pad, dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        err = lib.cuadmm_fused_spd_apply(
            m.data_ptr(), r.data_ptr(), partial.data_ptr(), y.data_ptr(), n_pad, grid, stream
        )
    _check(lib, err, "kernel launch")
    LAUNCHES += 1
    return y


def pad_factor(inv_l: torch.Tensor) -> torch.Tensor:
    """Zero-pad an (n, n) factor to the next multiple of 128 (exact: zero
    rows and columns contribute nothing)."""
    n = inv_l.shape[0]
    n_pad = -(-n // LANE) * LANE
    if n_pad == n:
        return inv_l.contiguous()
    out = inv_l.new_zeros((n_pad, n_pad))
    out[:n, :n] = inv_l
    return out
