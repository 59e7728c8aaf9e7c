"""Fused preconditioner application y = M^T (M r) in one pass over M's lower
triangle (K1).

The precond normal solver (and split's coupled prefix) applies its
explicitly inverted, zero-padded f32 Cholesky factor M once per refinement
sweep (ops/chol.py). M is lower triangular; as two matvecs that reads the
square from device memory twice, while the CUDA kernel in
``csrc/precond_apply.cu`` reads only the lower triangle, once. It replaces
the Pallas kernel ``cuadmm_tpu/ops/precond_apply.py::_kernel``; the source
says what bounds it and how its design answers that. ``launch_plan`` below
sizes its launch for each n_pad.

``fused_spd_apply`` launches the kernel for CUDA tensors and runs the
plain version ``fused_spd_apply_ref`` for CPU tensors. There is no
fallback: on CUDA it launches or raises. ``apply_padded`` pads an
unpadded right-hand side around it.

A batch of right-hand sides (B, n_pad) that share M (the batched solver's
instances) takes the B kernel, ``fused_spd_apply_kernel_rhs``, which reads
the triangle once for up to 8 of them; ``rhs_groups`` splits any B into
such launches. A single right-hand side keeps the one-RHS kernel and its
plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import torch

from cuadmm_tpu_torch import _build, trace

LANE = 128  # n_pad granularity and the kernel's column chunk
# The kernel's constants (csrc/precond_apply.cu).
THREADS = 512
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # past 8 non-portable
ROWS_PER_STEP = (8, 4, 2, 1)
SLOTS_PER_THREAD = {1: 10, 2: 4, 4: 2, 8: 2}  # float4 of r and y a thread keeps, by rows a step
MAX_STAGES = 8
SLOT_BYTES = LANE * 4  # shared memory per owned chunk of one row
MAX_SMEM = 444 * SLOT_BYTES  # dynamic shared memory of one CTA, 222 KB
# The largest member slice: three stages of one row fit (one in flight).
MAX_MEMBER_CHUNKS = MAX_SMEM // (3 * SLOT_BYTES)
MAX_N_PAD = CLUSTER_SIZES[-1] * MAX_MEMBER_CHUNKS * LANE  # 303,104: a 367 GB square
# The B kernel's constants: two groups of at most RHS_WARPS warps, each
# group BT = rhs / 2 of a launch's right-hand sides, a thread 32 / rhs
# float4 slots of r and y for each of its BT.
RHS_SIZES = (8, 4, 2)  # right-hand sides a launch takes, largest first
RHS_GROUPS = 2
RHS_WARPS = 5
RHS_ROWS = (8, 4, 2)  # rows a step: even (the groups copy alternate rows)
RHS_MAX_SMEM = 432 * SLOT_BYTES  # 216 KB
RHS_MIN_STAGES = 3  # steps s - 1 and s, and one in flight

_LIB = None  # the loaded kernel library, built on the first CUDA launch
_READY: set = set()  # devices whose kernel attributes are set
_PLANS: dict = {}  # (device index, n_pad[, b]) -> LaunchPlan
_GROUPS: dict = {}  # (device index, n_pad, B) -> a batch's launches: (right-hand sides, LaunchPlan), ...


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    cluster: int  # C: CTAs a cluster; member m owns the chunks c = m (mod C)
    clusters: int  # K: clusters launched
    rows: int  # R: rows a step; panel p of R rows is paired with panel P - 1 - p
    stages: int  # S: ring stages of R row slices: one in use, one awaiting its t, S - 2 in flight
    smem: int  # dynamic shared memory of a CTA: S x R row slices
    rhs: int = 1  # right-hand sides a launch takes: 1, or 2, 4, 8 for the B kernel
    warps: int = THREADS // 32  # warps of a CTA (the B kernel's: both groups)


def member_slice(n_pad: int, cluster: int) -> int:
    """Bytes of one row that the largest member holds: its
    ceil(chunks / cluster) chunks."""
    return -(-(n_pad // LANE) // cluster) * SLOT_BYTES


def rhs_slots(rhs: int) -> int:
    """Float4 slots a thread of the B kernel keeps at ``rhs`` right-hand
    sides a launch: 16 float4 of r and of y for its rhs / 2."""
    return 32 // rhs


def launch_plan(n_pad: int, resident: Callable[..., int], b: int = 1) -> LaunchPlan:
    """K1's launch for ``n_pad`` and ``b`` right-hand sides (1, or 2, 4, 8
    for the B kernel); ``resident(cluster, rows, smem[, rhs, warps])`` is
    how many such clusters the card holds at once (the kernel's occupancy
    query).

    One right-hand side: the smallest cluster whose members hold three
    stages of one row; then as many rows a step as still leave four
    stages, fit the threads' registers and keep R x C within a warp's lanes
    (each lane pushes one partial); then as many stages as fit, at most
    MAX_STAGES; then one wave of clusters, no more than there are panel
    pairs. B kernel: the smallest cluster whose largest member's chunks
    its RHS_WARPS warps a group cover (rhs_slots each) and whose members
    hold RHS_MIN_STAGES stages of two rows; then as many rows a step as
    leave one stage more, with R x BT sums a warp (one a lane); the rest
    as above. Raises ValueError where ``n_pad`` or ``b`` does not fit
    (``rhs_groups`` asks ``fits`` first)."""
    if n_pad <= 0 or n_pad % LANE or n_pad > MAX_N_PAD:
        raise ValueError(f"n_pad={n_pad} must be a positive multiple of {LANE} <= {MAX_N_PAD}")
    if b != 1:
        return _rhs_plan(n_pad, resident, b)
    c = next(c for c in CLUSTER_SIZES if 3 * member_slice(n_pad, c) <= MAX_SMEM)
    piece = member_slice(n_pad, c)
    fits_registers = lambda r: piece <= SLOTS_PER_THREAD[r] * THREADS * 16
    rows = next((r for r in ROWS_PER_STEP
                 if r * c <= 32 and fits_registers(r) and 4 * r * piece <= MAX_SMEM), 1)
    stages = min(MAX_STAGES, MAX_SMEM // (rows * piece))
    smem = stages * rows * piece
    pairs = n_pad // rows // 2
    k = max(1, min(resident(c, rows, smem), pairs))
    return LaunchPlan(cluster=c, clusters=k, rows=rows, stages=stages, smem=smem)


def _rhs_cluster(n_pad: int, b: int) -> Optional[int]:
    """The B kernel's cluster at ``n_pad`` for ``b`` right-hand sides, or
    None where no cluster fits."""
    if b not in RHS_SIZES:
        return None
    chunks = n_pad // LANE
    return next((c for c in CLUSTER_SIZES if -(-chunks // c) <= RHS_WARPS * rhs_slots(b)
                 and RHS_MIN_STAGES * RHS_ROWS[-1] * member_slice(n_pad, c) <= RHS_MAX_SMEM), None)


def fits(n_pad: int, b: int) -> bool:
    """Whether one launch of the B kernel takes ``b`` right-hand sides at
    ``n_pad``."""
    return 0 < n_pad <= MAX_N_PAD and n_pad % LANE == 0 and _rhs_cluster(n_pad, b) is not None


def _rhs_plan(n_pad: int, resident: Callable[..., int], b: int) -> LaunchPlan:
    c = _rhs_cluster(n_pad, b)
    if c is None:
        raise ValueError(f"the B kernel takes no {b} right-hand sides at n_pad={n_pad}")
    piece = member_slice(n_pad, c)
    bt = b // RHS_GROUPS
    rows = next((r for r in RHS_ROWS if r * bt <= 32 and (RHS_MIN_STAGES + 1) * r * piece <= RHS_MAX_SMEM),
                RHS_ROWS[-1])
    stages = min(MAX_STAGES, RHS_MAX_SMEM // (rows * piece))
    smem = stages * rows * piece
    warps = min(RHS_WARPS, piece // SLOT_BYTES)
    pairs = n_pad // rows // 2
    k = max(1, min(resident(c, rows, smem, b, warps), pairs))
    return LaunchPlan(cluster=c, clusters=k, rows=rows, stages=stages, smem=smem, rhs=b,
                      warps=RHS_GROUPS * warps)


def rhs_groups(n_pad: int, b: int) -> tuple:
    """How a batch of ``b`` right-hand sides at ``n_pad`` is served: a
    tuple of (right-hand sides, the launch's ``rhs``) in order, each one
    read of the factor. Launches of the largest ``rhs`` that fits, then the
    rest: one right-hand side left over takes the one-RHS kernel (rhs 1),
    more take the smallest ``rhs`` that holds them (its spare columns
    zero). Where no B kernel fits, one launch a right-hand side."""
    top = next((r for r in RHS_SIZES if fits(n_pad, r)), None)
    if b == 1 or top is None:
        return ((1, 1),) * b
    out = [(top, top)] * (b // top)
    rest = b % top
    if rest == 1:
        out.append((1, 1))
    elif rest:
        out.append((rest, min(r for r in RHS_SIZES if r >= rest)))
    return tuple(out)


def fused_spd_apply_ref(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version: y = m^T (m r) as two matvecs; for r (B, n_pad) the
    rows' results stacked."""
    if r.dim() > 1:
        return torch.stack([m.T @ (m @ row) for row in r])
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
        q = lib.cuadmm_fused_spd_apply_resident_clusters
        q.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        q.restype = ctypes.c_int
        q = lib.cuadmm_fused_spd_apply_rhs_resident_clusters
        q.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        q.restype = ctypes.c_int
        fn = lib.cuadmm_fused_spd_apply
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.cuadmm_fused_spd_apply_rhs
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cuadmm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _plan(lib: ctypes.CDLL, idx: int, n_pad: int, b: int = 1) -> LaunchPlan:
    """The launch plan for ``n_pad`` and ``b`` right-hand sides a launch on
    CUDA device ``idx``, made once; on a device's first use, set the
    kernels' attributes there."""
    key = (idx, n_pad) if b == 1 else (idx, n_pad, b)
    if key not in _PLANS:
        with torch.cuda.device(idx):
            if idx not in _READY:
                _check(lib, lib.cuadmm_fused_spd_apply_init(), "set-up")
                _READY.add(idx)

            def resident(cluster: int, rows: int, smem: int, rhs: int = 1, warps: int = 0) -> int:
                out = ctypes.c_int(0)
                if rhs == 1:
                    err = lib.cuadmm_fused_spd_apply_resident_clusters(cluster, rows, smem, ctypes.byref(out))
                else:
                    err = lib.cuadmm_fused_spd_apply_rhs_resident_clusters(cluster, rows, rhs, warps, smem,
                                                                           ctypes.byref(out))
                _check(lib, err, "occupancy query")
                if out.value < 1:
                    raise RuntimeError(f"fused_spd_apply: no cluster of {cluster} CTAs with {smem} bytes fits")
                return out.value

            _PLANS[key] = launch_plan(n_pad, resident, b)
    return _PLANS[key]


def _launch(lib: ctypes.CDLL, fn, idx: int, args: tuple) -> None:
    # The raw handle of the device's current stream, as Triton's launcher
    # takes it: torch.cuda.current_stream() costs as much host time as the
    # launch itself.
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        err = fn(*args, stream)
    else:  # the launch goes to the current device
        with torch.cuda.device(idx):
            err = fn(*args, stream)
    _check(lib, err, "kernel launch")


def fused_spd_apply(m: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y = m^T (m r) for lower-triangular f32 ``m`` (n_pad, n_pad) and ``r``
    (n_pad,), or Y (B, n_pad) for right-hand sides R (B, n_pad), row b
    m^T (m R[b]).

    ``n_pad`` must be a positive multiple of 128 and at most MAX_N_PAD (see
    ``pad_factor``). On CUDA the kernel reads only ``m``'s lower triangle
    and is launched on the current stream without synchronizing; the
    refinement sweeps call it several times an iteration, so the host work
    of a call is kept to one allocation and one foreign call a launch. R
    takes one launch of the B kernel for each of ``rhs_groups``' groups,
    each reading the triangle once; ``COUNTS["k1"]`` counts the launches
    and ``COUNTS["k1_rhs"]`` the right-hand sides they served.
    """
    n = m.shape[0] if m.dim() == 2 else -1
    if m.dim() != 2 or m.shape[1] != n or r.dim() not in (1, 2) or r.shape[-1] != n or r.numel() == 0:
        raise ValueError(f"need m (n, n) and r (n,) or (B, n), got {tuple(m.shape)} and {tuple(r.shape)}")
    if m.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"need float32 m and r, got {m.dtype} and {r.dtype}")
    n_pad = m.shape[0]
    if n_pad == 0 or n_pad % LANE or n_pad > MAX_N_PAD:
        raise ValueError(f"n_pad={n_pad} must be a positive multiple of {LANE} <= {MAX_N_PAD}")
    dev = m.device
    if dev != r.device:
        raise ValueError(f"m on {dev} but r on {r.device}")
    if not (m.is_contiguous() and r.is_contiguous()):
        raise ValueError("m and r must be contiguous")
    if dev.type == "cpu":
        return fused_spd_apply_ref(m, r)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    m_ptr, r_ptr = m.data_ptr(), r.data_ptr()
    if m_ptr % 16 or r_ptr % 16:
        raise ValueError("m and r must be 16-byte aligned")
    lib = _LIB or _load()
    idx = dev.index
    if r.dim() == 2:
        return _apply_rhs(lib, m_ptr, r_ptr, r.shape[0], n_pad, dev)
    plan = _PLANS.get((idx, n_pad)) or _plan(lib, idx, n_pad)
    k = plan.clusters
    out = torch.empty((k + 1) * n_pad, dtype=torch.float32, device=dev)  # K partial rows, then y
    ptr = out.data_ptr()
    args = (m_ptr, r_ptr, ptr, ptr + 4 * k * n_pad, n_pad, plan.cluster, k, plan.rows, plan.stages, plan.smem)
    _launch(lib, lib.cuadmm_fused_spd_apply, idx, args)
    trace.COUNTS["k1"] += 1
    trace.COUNTS["k1_rhs"] += 1
    return out[k * n_pad:]


def _apply_rhs(lib: ctypes.CDLL, m_ptr: int, r_ptr: int, b: int, n_pad: int, dev: torch.device) -> torch.Tensor:
    """Y = fused_spd_apply for ``b`` right-hand sides (the rows at
    ``r_ptr``): one launch a group of ``rhs_groups``, in order, sharing one
    scratch (the stream orders them)."""
    idx = dev.index
    key = (idx, n_pad, b)
    if key not in _GROUPS:
        _GROUPS[key] = tuple((nb, _plan(lib, idx, n_pad, rhs)) for nb, rhs in rhs_groups(n_pad, b))
    groups = _GROUPS[key]
    scratch = max(nb * plan.clusters for nb, plan in groups) * n_pad
    out = torch.empty(scratch + b * n_pad, dtype=torch.float32, device=dev)  # partials, then Y
    ptr = out.data_ptr()
    row = 0
    for nb, plan in groups:
        r_at, y_at = r_ptr + 4 * row * n_pad, ptr + 4 * (scratch + row * n_pad)
        if plan.rhs == 1:
            _launch(lib, lib.cuadmm_fused_spd_apply, idx, (m_ptr, r_at, ptr, y_at, n_pad, plan.cluster,
                                                         plan.clusters, plan.rows, plan.stages, plan.smem))
        else:
            _launch(lib, lib.cuadmm_fused_spd_apply_rhs, idx,
                    (m_ptr, r_at, ptr, y_at, n_pad, nb, plan.rhs, plan.cluster, plan.clusters, plan.rows,
                     plan.warps // RHS_GROUPS, plan.stages, plan.smem))
        trace.COUNTS["k1"] += 1
        trace.COUNTS["k1_rhs"] += nb
        row += nb
    return out[scratch:].view(b, n_pad)


def apply_padded(m_padded: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``fused_spd_apply`` on an unpadded ``r`` (n,) with n <= n_pad: r is
    cast to m's dtype and zero-padded to n_pad, and y sliced back to n
    (cuadmm_tpu/ops/precond_apply.py::apply_padded). One K1 launch on
    CUDA."""
    n, n_pad = r.shape[0], m_padded.shape[0]
    rp = torch.nn.functional.pad(r.to(m_padded.dtype), (0, n_pad - n)).contiguous()
    return fused_spd_apply(m_padded, rp)[:n]


def pad_factor(inv_l: torch.Tensor) -> torch.Tensor:
    """The lower triangle of an (n, n) factor, zero-padded to the next
    multiple of 128, as a new row-major tensor.

    Zero rows and columns contribute nothing, and the strict upper triangle
    is exactly zero whatever the triangular solve left there, so the plain
    version, which reads the square, agrees with the kernel, which reads the
    triangle. The triangle is taken in place on the padded copy."""
    n = inv_l.shape[0]
    n_pad = -(-n // LANE) * LANE
    if n_pad == n:
        return torch.tril(inv_l).contiguous()
    out = inv_l.new_zeros((n_pad, n_pad))
    out[:n, :n] = inv_l
    return out.tril_()
