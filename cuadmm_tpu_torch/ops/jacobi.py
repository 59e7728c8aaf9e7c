"""Batched Jacobi symmetric eigendecomposition (K4).

Port of cuadmm_tpu/ops/jacobi.py. ``jacobi_eigh_ref`` is the plain PyTorch
version of ``jacobi_eigh_jnp``: the same cyclic-by-rows pair order, the
same fixed sweep count (``default_sweeps``) and the same rotation formula,
so its unsorted eigenvalues and eigenvectors agree with the JAX package's
to rounding. The CUDA kernel in ``csrc/jacobi_eigh.cu`` replaces the Pallas
kernel ``cuadmm_tpu/ops/jacobi.py::_jacobi_kernel``; the source says what
bounds it and how its design answers that.

The kernel has two launch plans (``PLANS``), chosen per call by
``k4_plan(n, batch, dtype, smem)``:

- "warp": one warp a matrix in the reference's cyclic-by-rows order, for
  n < 6, for n = 6-7 past ``FEW_BATCH`` matrices, and where the "cta"
  plan's shared memory does not fit;
- "cta": one thread block a matrix in the round-robin parallel order
  (``parallel_schedule``): each sweep is n - 1 steps (n even; n odd takes
  n steps, each index idle once) of disjoint rotations applied together,
  so a sweep's chain of dependent steps is n - 1 long, not n(n-1)/2.
  ``jacobi_eigh_parallel_ref`` is its plain version. Both orders run the
  same sweeps of the same rotations and converge to the same
  eigendecomposition. It runs everywhere else.

``K4_SHAPES`` and ``k4_tol`` are the shapes and tolerances at which
chip_smoke.py and the ``cuda`` tests hold the kernel to its plain versions.

``jacobi_eigh`` launches the kernel for CUDA tensors and runs the plain
version of the reference's order for CPU tensors. There is no fallback:
on CUDA it launches or raises. The kernel reports no status to the host,
so a projection through it never waits for the device. Both versions let a
non-finite block come out non-finite, as XLA does, so the driver's
divergence guard fires.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from cuadmm_tpu_torch import _build, trace

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


# (n, batch): the batch of the grid problem's pow2 bucket n falls in (the
# grid's own buckets: 4x80, 8x598, 16x182, 32x49, 64x11); 128x56 is the
# grid under pack_to=128, 8x1556 the stand-in's bucket; 8x1500, 16x570 and
# 32x90 are G50's buckets that take K4.
K4_SHAPES = ((2, 80), (3, 80), (4, 80), (5, 598), (8, 598), (8, 1556), (13, 182), (16, 182),
             (32, 49), (45, 11), (64, 11), (80, 11), (128, 56), (8, 1500), (16, 570), (32, 90))


def k4_tol(n: int, dtype: torch.dtype) -> float:
    """K4 against a plain version, relative to the largest |entry|: 1e-10
    in f64 and 5e-5 in f32 (tests/test_jacobi.py:67-73) up to n = 64;
    past that in f32 5e-5 n/32, since the plain version's own f32 error
    grows with n (4.0e-5 at n = 64, 8.8e-5 at 128, relative to the f64
    eigenvalues: tests/test_torch_jacobi.py::
    test_plain_f32_error_grows_with_n) and two f32 runs that round
    differently differ by up to twice that."""
    if dtype == torch.float64:
        return 1e-10
    return 5e-5 if n <= 64 else 5e-5 * n / 32


def _pair_schedule(n: int):
    """Cyclic-by-rows pivot order: all (p, q), p < q."""
    return [(p, q) for p in range(n) for q in range(p + 1, n)]


def parallel_schedule(n: int) -> List[Tuple[List[int], List[int]]]:
    """Round-robin pivot order of the "cta" plan: one sweep as a list of
    steps, each (P, Q) with P[k] < Q[k] and all 2 len(P) indices distinct.
    With m = n rounded up to even and m1 = m - 1, step r pairs (r, m1) and
    ((r + k) mod m1, (r - k) mod m1) for k = 1 .. m/2 - 1, so every pair
    p < q comes once a sweep; for n odd, index m1 = n is a dummy and the
    pair holding it is left out (its other index waits that step). The
    kernel forms the same pairs (csrc/jacobi_eigh.cu, ``partner``)."""
    m = n + (n & 1)
    m1 = m - 1
    steps = []
    for r in range(m1):
        pairs = [(r, m1)] + [tuple(sorted(((r + k) % m1, (r - k) % m1))) for k in range(1, m // 2)]
        pairs = [pq for pq in pairs if pq[1] < n]
        steps.append(([p for p, _ in pairs], [q for _, q in pairs]))
    return steps


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


def jacobi_eigh_parallel_ref(mats: torch.Tensor, sweeps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the "cta" plan: ``jacobi_eigh_ref`` with the pairs
    of each ``parallel_schedule`` step rotated together. The step's (c, s)
    all come from A before it (its pairs are disjoint, so that is what the
    one-at-a-time order would read too); then rows p, q of A for every
    pair, then columns p, q of A, then columns p, q of v, each as one
    batched tensor op. Returns (w (B, n) unsorted, v (B, n, n))."""
    b, n, _ = mats.shape
    if n == 1:
        return mats[:, :, 0], torch.ones_like(mats)
    sweeps = default_sweeps(n) if sweeps is None else sweeps
    eps = 1e-30 if mats.dtype == torch.float64 else 1e-18
    a = mats.clone()
    v = torch.eye(n, dtype=mats.dtype, device=mats.device).expand(b, n, n).clone()
    steps = [(torch.tensor(p, device=mats.device), torch.tensor(q, device=mats.device))
             for p, q in parallel_schedule(n)]
    for _ in range(sweeps):
        for p, q in steps:
            c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q], eps)  # (B, pairs)
            cr, sr = c[:, :, None], s[:, :, None]
            rp, rq = a[:, p, :], a[:, q, :]
            a[:, p, :] = cr * rp - sr * rq
            a[:, q, :] = sr * rp + cr * rq
            cc, sc = c[:, None, :], s[:, None, :]
            cp, cq = a[:, :, p], a[:, :, q]
            a[:, :, p] = cc * cp - sc * cq
            a[:, :, q] = sc * cp + cc * cq
            vp, vq = v[:, :, p], v[:, :, q]
            v[:, :, p] = cc * vp - sc * vq
            v[:, :, q] = sc * vp + cc * vq
    return torch.diagonal(a, dim1=1, dim2=2).clone(), v


PLANS = ("warp", "cta")


def cta_smem_bytes(n: int, itemsize: int) -> int:
    """Shared memory of one "cta" launch (csrc/jacobi_eigh.cu, ``cta_bytes``):
    with m = n rounded up to even and h = m/2, V^T (m x m), A's upper
    triangle packed (m(m+1)/2), two buffers of (c, s) by index (4m), and
    the table of A's 2x2 block items, two bytes each (h(h-1)/2, or 1 for
    n = 2)."""
    m = n + (n & 1)
    h = m // 2
    return (m * m + m * (m + 1) // 2 + 4 * m) * itemsize + 2 * (1 if h == 1 else h * (h - 1) // 2)


# Where "cta" runs: n at least CTA_MIN_N, or at least CTA_MIN_N_FEW with
# at most FEW_BATCH matrices, and V^T, A and the tables in the card's
# shared memory. Measured on an NVIDIA H100 80GB HBM3 at 700 W by
# cuadmm_tpu_torch/k4_ab.py's PLAN_SHAPES (graph-replayed device time, 64
# to 4,096 matrices, PERF.md): at n = 4 and 5 "warp" is faster at every
# batch (n = 4, f64: 0.010 against 0.014 ms at 64 matrices, 0.039 against
# 0.082 at 4,096); at n = 6 and 7 "cta" is faster up to 512 matrices
# (n = 6, f64: 0.021 against 0.026 ms at 64; n = 7, f64, at 512 a tie,
# 0.0347 against 0.0343) and "warp" from 1,024 (n = 7, f64: 0.044 against
# 0.053 ms at 1,024, 0.150 against 0.184 at 4,096); at n = 8 "cta" is
# as fast or faster at every batch (0.029 against 0.044 ms at 64, 0.184
# against 0.194 at 4,096) and from n = 13 on 1.4-3.6x faster.
CTA_MIN_N = 8
CTA_MIN_N_FEW = 6
FEW_BATCH = 512


def k4_plan(n: int, batch: int, dtype: torch.dtype, smem_bytes: int) -> str:
    """The launch plan ("warp" or "cta") for ``batch`` (n, n) matrices of
    ``dtype`` on a card whose blocks may take ``smem_bytes`` of shared
    memory (the device's opt-in limit)."""
    itemsize = 8 if dtype == torch.float64 else 4
    wins = n >= CTA_MIN_N or (n >= CTA_MIN_N_FEW and batch <= FEW_BATCH)
    return "cta" if wins and cta_smem_bytes(n, itemsize) <= smem_bytes else "warp"


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
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.cuadmm_jacobi_eigh_work_elems.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.cuadmm_jacobi_eigh_work_elems.restype = ctypes.c_int
        lib.cuadmm_jacobi_eigh_max_smem.argtypes = []
        lib.cuadmm_jacobi_eigh_max_smem.restype = ctypes.c_int
        lib.cuadmm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def card_smem(idx: int) -> int:
    """The opt-in shared memory per block of CUDA device ``idx``, read by the
    kernel library's set-up (run here once per device)."""
    lib = _load()
    if idx not in _READY:
        with torch.cuda.device(idx):
            _check(lib, lib.cuadmm_jacobi_eigh_init(), "set-up")
        _READY.add(idx)
    return lib.cuadmm_jacobi_eigh_max_smem()


def jacobi_eigh(mats: torch.Tensor, sweeps: Optional[int] = None, *,
                _plan: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Jacobi eigh of (B, n, n) symmetric f32 or f64 ``mats``.

    Returns (w (B, n) unsorted, v (B, n, n)), eigenvectors in the columns of
    v. On CUDA the kernel is launched on the current stream without
    synchronizing, in ``k4_plan``'s plan. Any n >= 1, as
    ``jacobi_eigh_jnp`` takes. CPU tensors take ``jacobi_eigh_ref``.

    ``_plan`` (one of ``PLANS``) forces a plan, for k4_ab.py's timing of
    both plans where ``k4_plan``'s thresholds are set and for the tests of
    a plan the card refuses (which raises); the solver never passes it.
    """
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"need mats (B, n, n), got {tuple(mats.shape)}")
    if mats.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"need float32 or float64 mats, got {mats.dtype}")
    if _plan is not None and _plan not in PLANS:
        raise ValueError(f"plan must be one of {PLANS}, got {_plan!r}")
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
        plan = _plan or k4_plan(n, b, mats.dtype, card_smem(idx))
        # The warp plan's A past its shared-memory budget streams from a scratch copy.
        work_elems = lib.cuadmm_jacobi_eigh_work_elems(n, mats.element_size()) if plan == "warp" else 0
        work = torch.empty((b, work_elems), dtype=mats.dtype, device=mats.device) if work_elems else None
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(mats.data_ptr(), w.data_ptr(), v.data_ptr(), work.data_ptr() if work is not None else None,
                 b, n, sweeps, PLANS.index(plan), stream)
    _check(lib, err, f"kernel launch ({plan} plan)")
    trace.COUNTS["k4"] += 1
    trace.COUNTS["k4_f32"] += mats.dtype == torch.float32
    return w, v
