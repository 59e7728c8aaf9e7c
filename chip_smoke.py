"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels K1 (csrc/precond_apply.cu), K4
   (csrc/jacobi_eigh.cu) and K2/K3 (csrc/tri_stream.cu) into build/, one
   nvcc each, all at once;
3. hold K1 against its plain PyTorch version at n_pad 128, 1024, 5120
   (QUASAR-500's coupled prefix), 17152, 32512, 32768, 44416 (the 20x80
   grid) and 65536, on M = inv(L) up to 32768 and a unit-diagonal random
   lower triangle past it, with NaN written above the diagonal before the
   kernel runs: finite, bitwise equal over two calls, and within 1e-5
   (relative) of the plain version on the lower triangle; both times from
   CUDA events, one torch.linalg.multi_dot call (two cuBLAS matvecs) as
   library_ms, the bound over the triangle; then ``apply_padded`` at n =
   1,000 and 5,001 (no multiples of 128): one K1 launch each, within 1e-5
   of the plain version on the same padded operands;
4. hold K4, in the launch plan ``k4_plan`` picks at each shape ("warp":
   one warp a matrix in the reference's cyclic order, n = 2-5 here; "cta":
   one thread block a matrix in the round-robin parallel order, n >= 8
   here), against both plain versions
   (``jacobi_eigh_ref``, the cyclic order, and ``jacobi_eigh_parallel_ref``,
   the parallel one) at n = 2, 3, 4, 5, 8, 13, 16, 32, 45, 64, 80, 128
   with the batch of the grid problem's bucket each n falls in (80, 598,
   182, 49, 11; 56 at n = 128, the bucket under pack_to=128), at the
   stand-in's 8x1556 and at G50's K4 buckets 8x1500, 16x570 and 32x90 (the
   gset_g50_chordal cell's), in f64 and f32, at full sweeps: sorted
   eigenvalues, the projection V diag(w+) V^T and the orthogonality of V,
   relative to the largest |entry|, within 1e-10 (f64) / 5e-5 (f32; 5e-5 n/32 past n = 64, see k4_tol), bitwise
   equal over two launches; the plan ("cta" at 32x49 and 64x11) named in
   each row; at n = 128 in f64 also against torch.linalg.eigh; K4 and K4 +
   reconstruction as
   replayed CUDA graphs (as the chunk runner runs them), both plain
   versions, eigh + reconstruction and eigh alone (library_ms) eagerly,
   timed with CUDA events (each plain version once a shape; the cyclic one
   as one sweep of its rotations replayed from a CUDA graph after a
   bitwise check against the eager plain version at n = 8), us per
   rotation and per parallel step;
5. run the stand-in problem (max-cut, chordally decomposed, banded graph
   n=1560 with off-diagonals 1..4: 17,110 constraints, 1,556 5x5 blocks)
   through SDPSolver in float64 with normal_solver and projection "auto":
   100 warm iterations, 500 timed plain-ADMM iterations, 200 sGS
   iterations, gated on finite and decreasing residuals and on K1 having
   run on every refinement sweep; then 50 more iterations of each mode
   under torch.profiler for the device busy share, the device ops per
   iteration, K1's share and the costliest device ops;
6. run the grid problem (max-cut, chordally decomposed, 4-neighbour 20x60
   grid graph: 32,427 constraints, 920 blocks of sizes 3..45 in pow2
   buckets 4x80, 8x598, 16x182, 32x49, 64x11; precond with n_pad 32,512)
   plain ADMM with each projection "jacobi", "poly", "eigh" and "auto"
   (the committed CUDA table): 100 warm and 200 timed iterations, gated as
   the stand-in and, for "jacobi", on K4 having run on every bucket of
   every iteration (each jacobi bucket's K4 plan named); host syncs per
   iteration of each method, 0 for "auto" where it gives no bucket to
   eigh; a profile of "jacobi" and "eigh"; "auto" again with pack_to=128;
   "jacobi" with
   pack_to=128 (one 128x56 bucket: 20 warm, 50 timed iterations, gated on
   K4 on that bucket every iteration); then ``psd_project`` on the grid's
   structure under "eigh", "jacobi" (K4 once a bucket, counted) and
   "poly", within 1e-10 (f64, of the largest |entry|) of the pool route
   svec_from_pool(psd_project_pool(pool_from_svec(x)));
7. hold K2 (packed_solve) and K3 (band_solve) against their plain versions
   on synthetic factors made on the card (diagonal tiles near the
   identity, off-diagonal tiles scaled by 1/sqrt(B nbw)) at eight layouts,
   one at a time, K3 in the form the solver runs (the one-hop form, with
   its derived tiles, to nbw 4): packed n=256/B=128, packed at the large
   grid's (nb 67, T 2,278, 9.55 GB), band n=512/B=128/nbw=1, band at the
   large grid's (B 512, nb 134, nbw 1) and at its B 1024 (nb 67),
   pendulum N=80's (n 112,028, bandwidth 1,615: nb 110, nbw 2), PushBox
   N=30's (n 154,256, bandwidth 20,512: nb 151, nbw 21, 13.9 GB, two-hop);
   relative error <= 1e-5, two solves of one r bitwise equal, exactly 2
   sweep kernels launched per solve (torch.profiler), times from CUDA
   events both eager and as a replayed CUDA graph (the chunk runner's
   way; the kernels line takes it), the bound counting every tile once per
   sweep (a solve is two sweeps, and no factor here stays in the 50 MB L2
   between them); at the large grid's two layouts one
   torch.cholesky_solve on the dense expansion of the factor (18.8 GB) as
   library_ms;
7a. hold K3's segments form (one launch a solve, one thread a segment)
   against ``band_segments_solve_ref`` on card tensors: G50's normal
   solver as ``auto`` builds it on the card (the gset_g50_chordal cell's:
   checked to be banded in the segments form, 51,653 segments, the longest
   30, no tile) and a synthetic band of SEGMENT_MAX_ROWS-row segments at
   SEGMENT_MAX_BW, f64 and f32 r: within 1e-12 (f64) or one f32 rounding,
   the same bits twice, exactly one launch a solve (torch.profiler), the
   kernel timed as a replayed CUDA graph beside the bound (the band's n
   (bw + 1) f32 entries, r and y once, as band.k3_roofline counts them);
   pendulum N=80's and PushBox N=30's bandwidths keep the tile forms;
7b. hold the mirror kernel of the poly filter's one-triangle route
   (csrc/sym_mirror.cu) against ``mirror_ref`` at QUASAR-500's n = 2004,
   in f64 and f32, plain and with the addend and device scale of the
   projection's last pass, NaN written below the diagonal of T and W:
   finite, exactly symmetric, bitwise equal in place and twice, within
   1e-15 (f64) / 1e-6 (f32) of the largest |entry|; kernel and plain
   version timed as replayed CUDA graphs beside the bound (the triangles
   read and the square written, 48.2 MB in f64, at 3.35 TB/s);
7c. hold the bucketed-ELL product kernel (csrc/ell_products.cu) against
   its plain versions on the tables the solver builds for G11's torus
   (the gset_g11 cells; also with 8 instances, as the family runs them),
   G50's (the gset_g50_chordal cell's), QUASAR-500 and the G22-size
   max-cut (A^T placed by out_pos: the compact AA^T), in f64 and f32:
   A x, A^T y and AA^T y, one launch a product and two an AA^T y, the
   same bits twice, within 1e-14 (f64) / 1e-6 (f32) relative; kernel and
   plain version timed as replayed CUDA graphs beside the byte bound
   (tables, maps, input and output once). Every main-path run below is
   gated on the kernel's launches: 5 an sGS iteration and 3 an ADMM one,
   two a refinement sweep;
8. run the large grid problem (max-cut, chordally decomposed, 4-neighbour
   20x120 grid graph: 68,350 constraints, past dense_chol_max) plain ADMM,
   projection "auto", 100 warm and 200 timed iterations, with
   normal_solver "auto" (resolves to banded: RCM bandwidth 4, run in K3's
   segments form: 24,354 segments, the longest 27), with "banded" rebuilt
   with the segments form off (K3's tile forms, as every band too wide or
   with too long a segment for that form takes them: B 512, nb 134, nbw 1
   by the card's band model, the one-hop form, under the RCM permutation)
   and with "packed", each gated on the probe rhs residual, finite and
   decreasing residuals and K3's segments form, K3's tile forms (resp. K2)
   on every refinement sweep; each banded run's last errRp agrees with
   packed's to 1e-6; host syncs per iteration of each, a profile of the
   banded runs (device ops per iteration, busy share);
9. run QUASAR-500 at full size (one 2004x2004 block, 756,501 constraints,
   1,515,004 A^T nonzeros, b = 501 e_0 as in the reference's b.txt, C a
   seeded symmetric stand-in for the measurement data) plain ADMM with
   projection "auto" and "eigh", normal_solver "auto": it must resolve to
   split with the 5,001 coupled rows as the prefix (no permutation, K1 at
   n_pad 5,120); 20 warm and 100 timed iterations, gated on the probe rhs
   residual, finite and decreasing residuals and K1 on exactly every
   refinement sweep, and where the block takes the poly filter's
   one-triangle route ("auto" picks poly) on 40 triangle products and 40
   mirror launches an iteration (none under "eigh"); init breakdown, peak
   memory, host syncs per iteration and a profile;
10. run the 20x80 grid (max-cut, chordally decomposed, 44,312
   constraints) with dense_chol_max=45_056 and normal_solver "auto", which
   must resolve to precond at n_pad 44,416 (K1 past the first design's
   32,768 cap) with AA^T formed from dense A on the card (the card's
   dense-A budget), and with "banded": projection "auto", 20 warm and 100
   timed plain-ADMM iterations, gated on the probe rhs residual, finite and
   decreasing residuals and (precond) K1 on exactly every refinement
   sweep; the two runs' last errRp agree to 1e-6; init breakdown, peak
   memory after init and after the run, and a profile of the precond run;
10b. the card's limits (cuadmm_tpu_torch/ops/limits.py): the card line,
   its memory and every derived limit; the build peaks the limits were
   fitted to, measured again with cuadmm_tpu_torch/card_fit.py (packed and
   banded on the 20x60 and 20x120 grids, precond on the 20x60 and 20x80
   grids, band_cholesky on a synthetic PushBox N=30 band), each within 2%
   (or 64 MiB) of its committed line; K3 at B 1024, 512 and 256 on the
   20x120 grid's, a mid, pendulum N=80's and PushBox N=30's bands beside
   the band model's prediction, the model's pick the fastest measured on
   each or within 3% of it (K3 in the tile form the solver runs there);
   K3's segments form on synthetic bands of 139,192 rows in segments of
   1-512 rows at bandwidth 4 and 16 within 20% of SEGMENT_MODEL, and at
   the large grid's band (where the build takes it) faster than the
   fastest of the tile-form times there; the 20x60 grid through "banded" (gated as the grid runs) beside phase 6's
   precond rate, and the 20x80 pair of phase 10; precond on QUASAR-500
   (756,501 rows, past the card's n_pad) raising with
   max_memory_allocated unchanged;
11. run a plain max-cut SDP at the G-set's G22 size (2,000 nodes, edge
   probability 0.01: ~19,990 edges) the same way with projection "auto":
   split with no coupled row (an elementwise solve), and no K1 launch;
12. run the stand-in with normal_solver "cg": FSAI built, the probe rhs
   solved, 20 warm and 20 timed iterations with finite and decreasing
   residuals; CG steps and host waits per solve, and a profile;
13. solve a certified random SDP to 1e-6 and match its known optimum
   through normal_solver "precond", "auto" (split), "dense", "cg" and
   "host", and through "dense" with its factor zeroed, where divergence
   recovery must end in the level-2 CG rebuild and still converge;
14. float32 state beside float64, TF32 asserted off before every f32 run:
   the stand-in plain ADMM (precond + K1; 100 warm, 500 timed iterations,
   timed f64, f32, f32, f64 in turns as rate_ab.py pairs checkouts), gated
   on finite, decreasing residuals and exactly one K1 launch per
   calibrated sweep, with both sweep counts, rates, device ms, busy shares
   and K1 ms; the grid with "jacobi" and "auto" from the f32 table (100
   warm, 200 timed), gated on K4's f32 instantiation on every jacobi
   bucket of every iteration, device and K4 ms beside the grid's f64
   jacobi run; the large grid (auto -> banded + K3) and QUASAR-500
   (split + K1, "poly" with the f32 sign schedule on one triangle: 28
   triangle products and mirror launches an iteration), rate and device
   ms beside the f64 runs above;
15. the certified SDP in f32 through every normal solver of 13 and
   "packed" and "banded" (K2 and K3 at one 256-wide block) to stop_tol
   2e-4 and its optimum within 5e-3 (tests/test_solver.py:101),
   then solve_escalated on tests/test_solver.py:194's instance at
   stop_tol 1e-4: converged, optimum within 1e-2;
16. BatchedSDPSolver on 8 stand-ins (the banded graph with weights from
   uniform(0.5, 1.5) under seeds 0-7: one A, eight C) in f64 (precond +
   K1, eigh): 20 warm and 100 timed plain-ADMM iterations, gated on K1
   launched exactly B times a sweep and on each instance's last errRp
   within 1e-9 (relative) of its own SDPSolver(projection="eigh") run of
   100 iterations; instance-iterations per second beside the single runs'
   it/s;
16b. graphs: every path of the phases above through the chunk runner's
   CUDA graphs and through the eager loop (``run_chunk``) in this process,
   100 iterations each from one state, in the order eager, graph, graph,
   eager: the stand-in f64 ADMM and sGS (K1, K4), the stand-in f32 with
   rp_hp, the grid with "jacobi" (K1, K4) and "auto" (an eigh segment),
   the large grid banded in K3's segments form with "jacobi" (K4) and
   "auto", in K3's tile forms with "jacobi" (K3, K4), packed (K2),
   QUASAR-500 split "poly" (K1, the mirror kernel) and the 8 batched
   stand-ins (eigh); all
   end states and info rows bitwise equal (else within 1e-12 relative),
   it/s of each run, device ms, busy share, device ops and kernel
   launches per iteration (a graph run's counters held to the profiler's
   kernel counts), host syncs per iteration (0 without an eigh bucket; the
   eigh's own with one), capture seconds and peak memory;
17. front ends, with files under build/frontends (removed at the end): the
   stand-in and the grid written as a TXT directory, SDPA (plain and .gz),
   SeDuMi, MOSEK and cuADMM .mat by this script's writers (the exact
   inverses of the importers), and a certified random SDP with an LP part
   and a free part in each format that holds its block order; each file
   imported with the port's importer, every Problem field equal to the
   generator's (exactly for .mat, within 1e-15 relative for text), import
   seconds and file MB at the grid's size; ``python -m cuadmm_tpu_torch
   info`` and ``solve DIR --device cuda --switch-admm 0 --check-every 100
   --max-iter 300 --quiet`` on the stand-in as subprocesses (exit code 0
   where the in-process SDPSolver run of the same configuration converged,
   2 where it did not; no kernel rebuilt; X_opt.txt finite and within
   1e-10 relative of that run); ``cuadmm`` on the
   grid imported from SeDuMi (projection "jacobi", plain ADMM, 200
   iterations), gated as the grid phase gates (K1 on every sweep, K4 on
   every bucket of every iteration); the certified SDP from SDPA through
   ``cuadmm`` to 1e-6 and its optimum, and with its free part from SeDuMi
   through SDPSolver, each resumed from its converged checkpoint within 60
   iterations (the SDPSolver run also from a 1e-4 checkpoint, within 60
   of what the uninterrupted run took past 1e-4); the examples minimizer, maxcut_demo and mosek_pipeline (on
   the stand-in's MOSEK file, and with no path, which must exit 2) as
   subprocesses;
18. several devices (cuadmm_tpu_torch/parallel/): one rank over NCCL in
   this process (a world of 1 from a FileStore under build/) solves the
   certified SDP through normal_solver "sharded" to 1e-6 and its optimum
   (its collectives run at one rank too; all_reduces per normal solve
   and per run), runs dryrun_multichip(1, "nccl") and the large grid
   through "sharded" at full size (nb 67, the whole 18.8 GB slab on the
   card: NCCL's broadcasts of up to 281 MB a Cholesky step; 20
   iterations, errRp within 1e-6 of the banded run's below); then two gloo
   ranks share cuda:0 (NCCL refuses two ranks on one GPU) in one spawn
   of rank_jobs.chip_mesh: the grid with "jacobi" (20 warm, 100 timed
   iterations continued from them; K4 exactly once per bucket share and
   iteration, K1 on every sweep, errRp within 1e-9 of one rank's same
   120 iterations), the large grid through "sharded" (B 1024, nb 68, 34
   block columns a rank, 9.70 GB a rank; the distributed Cholesky's
   seconds, each rank's peak memory, one timed normal solve with its
   all_reduces, 20 iterations whose errRp is within 1e-6 of a banded
   run's), QUASAR-500 with "poly" (its 2004 block's rows split over the
   ranks: 40 all_reduces a projection and no triangle product; K1 on
   every sweep; errRp within 1e-9 of one rank, whose block takes the
   one-triangle route, 40 triangle products and mirror launches an
   iteration) and the 8 batched stand-ins (4 a rank, K1 4 times a
   sweep on each, every instance within 1e-9 of its single run from
   phase 16); every rank's X, y, S and info rows bitwise equal.

Every solve above runs its chunks through the chunk runner
(cuadmm_tpu_torch/solver/step.py): CUDA graphs, checked per run by
``solver.chunk_runner``, except cg, host and the mesh, which run eagerly.
The launch counts the gates read are replay-aware, and every profiled
window of a graphed run holds them to the profiler's count of each
kernel (an eager window's counts print beside the profiler's).

The next-to-last line is the kernel table as JSON (each kernel's bound_ms
is the least time for its work on the card: bytes at 3.35 TB/s or flops at
the data sheet's peak, whichever is larger), the last line
{"ok": true, "device": {...}}. Everything printed also goes to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

import cuadmm_tpu_torch  # noqa: F401  (first: fails alone, without the repo)

import dataclasses
import datetime
import gzip
import json
import shutil
import subprocess
import sys
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.io as sio
import scipy.sparse as sp
import torch
import torch.distributed as dist

from cuadmm_tpu_torch import BatchedSDPSolver, SDPSolver, SolverConfig, _build, card_fit, compat, solve_escalated
from cuadmm_tpu_torch.compat import cuadmm
from cuadmm_tpu_torch.device import card_line
from cuadmm_tpu_torch.io import txt as txtio
from cuadmm_tpu_torch.io.admm_mat import load_admm_mat
from cuadmm_tpu_torch.io.conewise import SQRT2
from cuadmm_tpu_torch.io.mosek import load_mosek_mat
from cuadmm_tpu_torch.io.sdpa import load_sdpa
from cuadmm_tpu_torch.io.sedumi import load_sedumi_mat
from cuadmm_tpu_torch.k1_ab import unit_lower
from cuadmm_tpu_torch.k4_ab import graph_ms
from cuadmm_tpu_torch.models.chordal import maxcut_chordal, maxcut_chordal_family
from cuadmm_tpu_torch.models.maxcut import maxcut_sdp, random_graph
from cuadmm_tpu_torch.models.quasar import quasar_constraints
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import chol, jacobi, limits, polyfilter, precond_apply, sparse, sym_products, tri_stream
from cuadmm_tpu_torch.ops.dispatch import bucket_method, choose_methods
from cuadmm_tpu_torch.ops.projection import psd_project, psd_project_pool, reconstruct_clamped
from cuadmm_tpu_torch.ops.sparse import aat_matvec, build_sparse_a, normalize_rows
from cuadmm_tpu_torch.ops.svec import device_maps, pool_from_svec, svec_from_pool
from cuadmm_tpu_torch.parallel import rank_jobs
from cuadmm_tpu_torch.parallel.dryrun import dryrun_multichip
from cuadmm_tpu_torch.parallel.launch import run_ranks
from cuadmm_tpu_torch.parallel.mesh import make_mesh
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver import step as step_mod
from cuadmm_tpu_torch.solver.step import make_chunk_runner, run_chunk
from cuadmm_tpu_torch.structure import BlockStructure
from cuadmm_tpu_torch.trace import COUNTS, reset as reset_counts
from cuadmm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from portbench.generators.toroidal_maxcut import toroidal_grid

# 5120: QUASAR-500, 17152: stand-in, 32512: grid, 44416: the 20x80 grid.
K1_SIZES = (128, 1024, 5120, 17152, 32512, 32768, 44416, 65536)
K1_SOLVE_MAX = 32768  # past it the test M is made directly, not as inv(L)
K1_REL_TOL = 1e-5  # f32 sums taken in another order than cuBLAS's
K1_REPS = 20
APPLY_PADDED_SIZES = (1000, 5001)  # apply_padded's r: not multiples of 128
STANDIN_N_PAD = 17152  # the stand-in's padded factor: the main path's K1 shape
# K1 over B right-hand sides: (n_pad, B), checked at each and timed at B = 8;
# 18,816 is G11's factor, the benchmark's family cell's K1 shape.
K1_RHS_SHAPES = ((5120, 8), (18816, 3), (18816, 8), (18816, 11), (44416, 8))
K1_RHS_MAIN = (18816, 8)
PROFILE_ITERS = 50
PROFILE_TOP = 10  # device ops listed per mode, by self time
K4_REPS = 5
K4_CTA_SHAPES = ((32, 49), (64, 11))  # the grid buckets the "cta" plan must take
# Symmetric A: rows p, q and columns p, q coincide outside the 2x2 block,
# so one pass of 6n flops; V's columns p, q another 6n.
K4_FLOPS_PER_ROTATION_PER_N = 12
F64_FLOPS = 34e12  # H100 SXM f64 outside the tensor cores (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
GRID = (20, 60)
GRID_BUCKETS = ((4, 80), (8, 598), (16, 182), (32, 49), (64, 11))
GRID_N_PAD = 32512
GRID_WARM, GRID_ITERS, SYNC_ITERS = 100, 200, 10
PSD_PROJECT_TOL = 1e-10  # psd_project against the pool route, relative to the largest |entry| (f64)
# G50 (rudy's -toroidal_grid_2D 25 120 through the max-cut pipeline, the
# gset_g50_chordal cell): its constraints, and its band (RCM bandwidth 4)
# in K3's segments form: its segments and the longest one's rows.
G50_GRID, G50_CON, G50_SEGMENTS = (25, 120), 139192, (51653, 30)
SEG_REL_TOL = 1e-12  # the kernel's fma against the plain version's multiply and subtract, both in f64
SEG_REPS = 200
# K2/K3's layouts, (label, layout); "grid" are the large grid's own.
TRI_LAYOUTS = (
    ("packed probe", tri_stream.make_layout(256, 128)),
    ("packed grid", tri_stream.make_layout(68350)),
    ("band probe", tri_stream.make_band_layout(512, 128, 128)),
    ("band grid", tri_stream.make_band_layout(68350, 4)),
    ("band grid B 1024", tri_stream.make_band_layout(68350, 4, 1024)),
    ("band pendulum N=80", tri_stream.make_band_layout(112028, 1615)),
    ("band PushBox N=30", tri_stream.make_band_layout(154256, 20512)),
)
TRI_REL_TOL = 1e-5  # f32 products summed in another order than the plain version's
TRI_REPS = 5
MIRROR_N = 2004  # QUASAR-500's block, the one the poly filter's one-triangle route takes
# Of the largest |entry|: the kernel's one fma against mirror_ref's multiply and add.
MIRROR_REL_TOL = {torch.float64: 1e-15, torch.float32: 1e-6}
ELL_REL_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}  # sums in another order than the plain version's
ELL_LEAD = 8  # the family cell's instances
LARGE_GRID = (20, 120)
LARGE_GRID_CON = 68350
# The large grid's band (RCM bandwidth 4) as the card's band model picks it
# (ops/limits.py): B 512, nb 134, nbw 1, where K3's one-hop form runs
# faster than at B 1024 (the JAX package's TPU model's pick; PERF.md §6);
# the solver runs it in the segments form: its segments, the longest's rows.
LARGE_GRID_BAND, LARGE_GRID_SEGMENTS = (512, 134, 1), (24354, 27)
ERRRP_AGREE = 1e-6  # two normal solvers: same iteration, another f32 factor
# QUASAR-500 (cuadmm_tpu_torch/models/quasar.py): constraints, A^T
# nonzeros, block size, coupled rows and K1's padded prefix.
QUASAR_POSES = 500
QUASAR_SHAPE = (756501, 1515004, 2004)
QUASAR_P, QUASAR_N_PAD = 5001, 5120
BIG_BLOCK_WARM, BIG_BLOCK_ITERS = 20, 100  # QUASAR-500, the G22-size max-cut, the 20x80 grid
PAST_CAP_GRID = (20, 80)  # precond past the first K1's 32,768 cap
PAST_CAP_CON, PAST_CAP_N_PAD, PAST_CAP_DENSE_CHOL_MAX = 44312, 44416, 45_056
G22_NODES, G22_EDGE_P = 2000, 0.01  # the G-set's G22: 2,000 nodes, 19,990 edges
CG_ITERS = 20
CERT_MODES = ("precond", "auto", "dense", "cg", "host")
CERT_MODES_F32 = CERT_MODES + ("packed", "banded")  # every normal solver that needs no mesh
PROBE_TOL = {"float64": 1e-6, "float32": 1e-5}  # the f32 calibration target is 1e-6 to 1e-5
BATCH = 8  # stand-ins in the batched phase
# A build's measured peak against its committed line (ops/limits.py): 2%,
# or 64 MiB for small factors, whose fixed overhead differs by layout (the
# 20x60 grid's band peaks 29 MB above its tiles at B 1024, 9 MB at B 512;
# the limits concern factors of tens of GB).
PEAK_SLACK, PEAK_SLACK_BYTES = 1.02, 64 * 2**20
# A segments solve's measured time against SEGMENT_MODEL's (ops/limits.py):
# the fit's worst row read 14% (512-row segments at bandwidth 4), and a
# new measurement adds its own spread.
SEGMENT_FIT_TOL = 0.2
QUASAR_PRECOND_DENSE_CHOL_MAX = 10**6  # lets precond take QUASAR-500's 756,501 rows: past the card
REPORT = Path("chiprun_out") / "chip_smoke.json"
report: dict = {}  # everything printed, written to REPORT at the end


def emit(key: str, obj) -> None:
    report[key] = obj
    print(f"{key}: " + json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    out = card_line()
    print(out)
    report["card"] = out
    return torch.cuda.get_device_name(0)


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    names = ("precond_apply", "jacobi_eigh", "tri_stream", "ell_products")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for path in paths:
        print(f"  {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("    ptxas:", line.strip())


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _k1_operands(n: int, seed: int) -> tuple:
    """M lower triangular with NaN above the diagonal, and r. Up to
    K1_SOLVE_MAX M = inv(L), L well-conditioned lower triangular; past it
    k1_ab.py's unit-diagonal random lower triangle, made in place (no n^2
    solve)."""
    if n <= K1_SOLVE_MAX:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(seed)
        L = torch.eye(n, device=dev) + torch.tril(torch.randn(n, n, device=dev, generator=gen), -1) * (0.1 / n**0.5)
        m = torch.linalg.solve_triangular(L, torch.eye(n, device=dev), upper=False).contiguous()
        del L
        m.tril_()
        r = torch.randn(n, device=dev, generator=gen)
    else:
        m, r = unit_lower(n, seed)
    for r0 in range(0, n, 8192):  # NaN above the diagonal, a row block at a time
        blk = m[r0:r0 + 8192]
        blk.add_(torch.full_like(blk, float("nan")).triu_(r0 + 1))
    return m, r


def compare_k1() -> dict:
    """K1 against the plain version at each size: on M with NaN above the
    diagonal it must give a finite y, the same bits twice, and (M then made
    lower triangular in place) the plain version's y within K1_REL_TOL;
    times taken in turns (plain, K1, K1, plain)."""
    at_main_shape = None
    for i, n in enumerate(K1_SIZES):
        m, r = _k1_operands(n, seed=i)
        y = precond_apply.fused_spd_apply(m, r)
        again = precond_apply.fused_spd_apply(m, r)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"K1 n_pad={n}: non-finite output with NaN above the diagonal")
        check(torch.equal(y, again), f"K1 n_pad={n}: two calls differ")
        del again
        m.tril_()
        ref = precond_apply.fused_spd_apply_ref(m, r)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        max_abs = float((y - ref).abs().max())
        check(rel <= K1_REL_TOL, f"K1 n_pad={n} rel err {rel:.3e}")
        k1 = lambda: precond_apply.fused_spd_apply(m, r)
        plain = lambda: precond_apply.fused_spd_apply_ref(m, r)
        for _ in range(3):
            k1(), plain()
        p1 = _time_ms(plain, K1_REPS)
        k_1 = _time_ms(k1, K1_REPS)
        k_2 = _time_ms(k1, K1_REPS)
        p2 = _time_ms(plain, K1_REPS)
        k_ms, p_ms = (k_1 + k_2) / 2, (p1 + p2) / 2
        library = lambda: torch.linalg.multi_dot([m.T, m, r])  # one call, two cuBLAS matvecs
        library()
        l_ms = _time_ms(library, K1_REPS)
        tri_bytes = 4.0 * n * (n + 1) / 2
        # Bound: M's lower triangle (f32) read once, r in, y out, at the HBM
        # rate; the 4 flops an entry take a tenth of that at the f32 peak.
        bound_ms = (tri_bytes + 8.0 * n) / HBM_BYTES_PER_S * 1e3
        gbs = tri_bytes / (k_ms * 1e-3) / 1e9
        print(
            f"K1 n_pad={n}: rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
            f"k1_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound_ms:.4f} "
            f"share={bound_ms / k_ms:.3f} k1_triangle_GB/s={gbs:.1f}"
        )
        report.setdefault("k1", []).append(dict(n_pad=n, rel_err=rel, max_abs_err=max_abs, k1_ms=k_ms,
                                                plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                                                share=bound_ms / k_ms, deterministic=True))
        if n == STANDIN_N_PAD:
            at_main_shape = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                 bound_by="bytes", library_ms=l_ms)
        del m, r, y, ref
        torch.cuda.empty_cache()
    compare_apply_padded()
    report["k1_rhs_main"] = compare_k1_rhs()
    return at_main_shape


def compare_k1_rhs() -> dict:
    """K1 over B right-hand sides at K1_RHS_SHAPES: on M with NaN above the
    diagonal the same checks as compare_k1 for every column (finite, the
    same bits twice, within K1_REL_TOL of the plain version on tril(M)),
    one launch a group of ``rhs_groups`` serving B right-hand sides; at
    B = 8 the time beside the bound (the triangle once, R in and Y out),
    the B one-RHS launches it replaces, the plain version and
    ``torch.linalg.multi_dot`` (M^T (M R^T), two cuBLAS GEMMs over the
    square). Returns the row at K1_RHS_MAIN."""
    main = None
    for i, (n, b) in enumerate(K1_RHS_SHAPES):
        m, _ = _k1_operands(n, seed=70 + i)
        gen = torch.Generator(device="cuda").manual_seed(80 + i)
        rr = torch.randn(b, n, device="cuda", generator=gen)
        before = dict(COUNTS)
        y = precond_apply.fused_spd_apply(m, rr)
        again = precond_apply.fused_spd_apply(m, rr)
        torch.cuda.synchronize()
        groups = precond_apply.rhs_groups(n, b)
        launches, served = COUNTS["k1"] - before["k1"], COUNTS["k1_rhs"] - before["k1_rhs"]
        check(launches == 2 * len(groups) and served == 2 * b,
              f"K1 over B n_pad={n} B={b}: {launches} launches served {served} right-hand sides")
        check(bool(torch.isfinite(y).all()), f"K1 over B n_pad={n} B={b}: non-finite output")
        check(torch.equal(y, again), f"K1 over B n_pad={n} B={b}: two calls differ")
        del again
        m.tril_()
        ref = precond_apply.fused_spd_apply_ref(m, rr)
        rel = [float(torch.linalg.norm(y[j] - ref[j]) / torch.linalg.norm(ref[j])) for j in range(b)]
        check(max(rel) <= K1_REL_TOL, f"K1 over B n_pad={n} B={b}: rel err {max(rel):.3e}")
        row = dict(n_pad=n, rhs=b, groups=groups, rel_err=max(rel), deterministic=True)
        if b == 8:
            k1 = lambda: precond_apply.fused_spd_apply(m, rr)
            each = lambda: [precond_apply.fused_spd_apply(m, rr[j]) for j in range(b)]
            plain = lambda: precond_apply.fused_spd_apply_ref(m, rr)
            library = lambda: torch.linalg.multi_dot([m.T, m, rr.T])
            for fn in (k1, each, plain, library):
                fn()
            p1, k_1, k_2, p2 = (_time_ms(fn, K1_REPS) for fn in (plain, k1, k1, plain))
            e_ms, l_ms = _time_ms(each, K1_REPS), _time_ms(library, K1_REPS)
            bound_ms = (4.0 * n * (n + 1) / 2 + 8.0 * b * n) / HBM_BYTES_PER_S * 1e3
            k_ms = (k_1 + k_2) / 2
            row.update(k1_ms=k_ms, one_rhs_launches_ms=e_ms, plain_ms=(p1 + p2) / 2, library_ms=l_ms,
                       bound_ms=bound_ms, bound_by="bytes", share=bound_ms / k_ms)
        print("K1 over B " + json.dumps(row), flush=True)
        report.setdefault("k1_rhs", []).append(row)
        if (n, b) == K1_RHS_MAIN:
            main = row
        del m, rr, y, ref
        torch.cuda.empty_cache()
    return main


def compare_apply_padded() -> None:
    """``apply_padded`` on an r that is no multiple of 128: one K1 launch on
    the padded factor, held to the plain version on the same padded operands
    within K1_REL_TOL."""
    for i, n in enumerate(APPLY_PADDED_SIZES):
        m, r = _k1_operands(n, seed=50 + i)
        mp = precond_apply.pad_factor(m)  # the lower triangle, zero-padded
        del m
        before = COUNTS["k1"]
        y = precond_apply.apply_padded(mp, r)
        torch.cuda.synchronize()
        check(COUNTS["k1"] == before + 1, f"apply_padded n={n}: {COUNTS['k1'] - before} K1 launches, not 1")
        ref = precond_apply.fused_spd_apply_ref(mp, torch.nn.functional.pad(r, (0, mp.shape[0] - n)))[:n]
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        check(y.shape == (n,) and bool(torch.isfinite(y).all()) and rel <= K1_REL_TOL,
              f"apply_padded n={n}: rel err {rel:.3e}")
        row = dict(n=n, n_pad=mp.shape[0], rel_err=rel, max_abs_err=float((y - ref).abs().max()))
        print("K1 apply_padded " + json.dumps(row), flush=True)
        report.setdefault("k1_apply_padded", []).append(row)
        del mp, r, y, ref
        torch.cuda.empty_cache()


def k4_bound_ms(n: int, batch: int, dtype) -> tuple:
    """The least time for K4's work on the card: 12n flops a rotation at the
    f64 (f32) peak outside the tensor cores, or the bytes in (A) and out (w,
    V) at the HBM rate; the larger, and which one it is."""
    rotations = jacobi.default_sweeps(n) * n * (n - 1) // 2
    flops = batch * rotations * K4_FLOPS_PER_ROTATION_PER_N * n
    size = torch.finfo(dtype).bits // 8
    ops_ms = flops / (F64_FLOPS if dtype == torch.float64 else F32_FLOPS) * 1e3
    bytes_ms = batch * (2 * n * n + n) * size / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def plain_k4(mats: torch.Tensor) -> tuple:
    """jacobi_eigh_ref, op for op, with one sweep of its rotations captured
    into a CUDA graph and replayed default_sweeps(n) times: the same
    kernels on the same buffers in the same order, without the Python loop
    (about 50 launches a rotation, a minute and more a shape at n = 128).
    compare_k4 holds it to jacobi_eigh_ref bit for bit at n = 8."""
    b, n, _ = mats.shape
    eps = 1e-30 if mats.dtype == torch.float64 else 1e-18
    a = mats.clone()
    v = torch.eye(n, dtype=mats.dtype, device=mats.device).expand(b, n, n).clone()
    pairs = jacobi._pair_schedule(n)
    jacobi._rotate_ref(a.clone(), v.clone(), *pairs[0], eps)  # loads every kernel before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for p, q in pairs:
            jacobi._rotate_ref(a, v, p, q, eps)
    for _ in range(jacobi.default_sweeps(n)):
        graph.replay()
    out = torch.diagonal(a, dim1=1, dim2=2).clone(), v.clone()
    torch.cuda.synchronize()
    del graph
    return out


def _sym_batch(n: int, batch: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((batch, n, n), dtype=dtype, device="cuda", generator=gen)
    return (m + m.transpose(1, 2)) / 2


def _k4_errors(mats, w, v, wr, vr) -> tuple:
    """Errors relative to the largest |entry|: sorted w, projection, and
    orthogonality of v (absolute)."""
    scale = float(mats.abs().max())
    dw = float((w.sort(dim=1).values - wr.sort(dim=1).values).abs().max())
    dp = float((reconstruct_clamped(w, v) - reconstruct_clamped(wr, vr)).abs().max())
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    orth = float((v.transpose(1, 2) @ v - eye).abs().max())
    return dw / scale, dp / scale, orth, max(dw, dp)


def compare_k4() -> dict:
    """K4 in the launch plan ``k4_plan`` picks against both plain versions
    at every ``jacobi.K4_SHAPES`` point, f64 and f32, at full sweeps (after two sweeps the iteration is far from
    converged and amplifies rounding: 1e-7 of input noise moves the plain
    version's sorted f32 w by 4e-4 of the largest entry at n = 80,
    tests/test_torch_jacobi.py::test_unconverged_sweeps_amplify_rounding):
    jacobi_eigh_ref, the reference's cyclic order (its rotations replayed
    from a CUDA graph, ``plain_k4``, first held to the eager jacobi_eigh_ref
    bit for bit), and jacobi_eigh_parallel_ref, the "cta" plan's
    round-robin order, each within k4_tol; bitwise equal over two
    launches. Each row names the plan that ran ("cta" at K4_CTA_SHAPES)
    and times K4 (as replayed CUDA graphs, ``k4_ab.graph_ms``) beside both
    plain versions once, eigh + reconstruction and eigh alone (library_ms).
    At n = 128 in f64 the kernel is also held against torch.linalg.eigh.
    Returns the f64 sums over the grid's bucket shapes
    for the kernel table."""
    at_grid = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    rows = []
    smem = jacobi.card_smem(torch.cuda.current_device())
    for dtype in (torch.float64, torch.float32):
        mats = _sym_batch(8, 598, dtype, seed=0)
        eager, graphed = jacobi.jacobi_eigh_ref(mats), plain_k4(mats)
        check(all(torch.equal(x, y) for x, y in zip(eager, graphed)),
              f"K4 plain version replayed from a graph differs from jacobi_eigh_ref ({dtype})")
    for dtype in (torch.float64, torch.float32):
        for n, batch in jacobi.K4_SHAPES:
            tol = jacobi.k4_tol(n, dtype)
            mats = _sym_batch(n, batch, dtype, seed=n)
            plan = jacobi.k4_plan(n, batch, dtype, smem)
            if (n, batch) in K4_CTA_SHAPES:
                check(plan == "cta", f"K4 n={n} batch={batch} {dtype}: plan {plan!r}, not the parallel 'cta'")
            k4 = lambda: jacobi.jacobi_eigh(mats)
            plain = lambda: plain_k4(mats)
            eigh = lambda: reconstruct_clamped(*torch.linalg.eigh(mats))
            k4_proj = lambda: reconstruct_clamped(*jacobi.jacobi_eigh(mats))
            library = lambda: torch.linalg.eigh(mats)
            w, v = k4()  # first launch, untimed
            w2, v2 = k4()
            torch.cuda.synchronize()
            check(torch.equal(w, w2) and torch.equal(v, v2), f"K4 {plan} n={n} {dtype}: two launches differ")
            finite = bool(torch.isfinite(w).all() and torch.isfinite(v).all())
            ref, par = [], []
            p1 = _time_ms(lambda: ref.append(plain()), 1)
            pp1 = _time_ms(lambda: par.append(jacobi.jacobi_eigh_parallel_ref(mats)), 1)
            k_ms = graph_ms(k4)
            eigh()
            e_ms = _time_ms(eigh, K4_REPS)
            kp_ms = graph_ms(k4_proj)
            l_ms = _time_ms(library, K4_REPS)
            against = {}
            for name, plain_out in (("ref", ref[0]), ("parallel_ref", par[0])):
                pw, pp, po, pa = _k4_errors(mats, w, v, *plain_out)
                check(finite and max(pw, pp, po) <= tol,
                      f"K4 {plan} n={n} batch={batch} {dtype} against {name}: "
                      f"rel w {pw:.2e} proj {pp:.2e} orth {po:.2e}")
                against[name] = dict(rel_err_w=pw, rel_err_proj=pp, orth_err=po, max_abs_err=pa)
            max_abs = against["ref"]["max_abs_err"]
            rotations = jacobi.default_sweeps(n) * n * (n - 1) // 2
            steps = jacobi.default_sweeps(n) * len(jacobi.parallel_schedule(n))
            bound_ms, bound_by = k4_bound_ms(n, batch, dtype)
            row = dict(n=n, batch=batch, dtype=str(dtype).split(".")[-1], plan=plan, tol=tol, **against["ref"],
                       k4_ms=k_ms, us_per_rotation=k_ms * 1e3 / rotations,
                       us_per_step=k_ms * 1e3 / steps, plain_ms=p1, parallel_plain_ms=pp1, k4_proj_ms=kp_ms,
                       eigh_ms=e_ms, library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by, against=against)
            if n == 128 and dtype == torch.float64:  # converged: the kernel against eigh itself
                we, ve = torch.linalg.eigh(mats)
                rel_we, rel_pe, _, _ = _k4_errors(mats, w, v, we, ve)
                check(max(rel_we, rel_pe) <= tol, f"K4 n=128 f64 against eigh: w {rel_we:.2e} proj {rel_pe:.2e}")
                row.update(rel_err_w_vs_eigh=rel_we, rel_err_proj_vs_eigh=rel_pe)
            rows.append(row)
            print("K4 " + json.dumps(row), flush=True)
            if dtype == torch.float64 and (n, batch) in GRID_BUCKETS:
                at_grid["max_abs_err"] = max(at_grid["max_abs_err"], max_abs)
                for key, val in (("ms", k_ms), ("plain_ms", row["plain_ms"]), ("bound_ms", bound_ms),
                                 ("library_ms", l_ms)):
                    at_grid[key] += val
    report["k4"] = rows
    return dict(at_grid, bound_by="operations")


def _gates(res, vec_len: int, what: str) -> None:
    err = res.info["errRp"]
    finite = bool(
        np.isfinite(res.errRp) and np.isfinite(res.errRd) and np.isfinite(res.relgap)
        and not res.diverged and np.all(np.isfinite(err))
    )
    check(finite, f"{what}: non-finite residuals or divergence")
    check(len(err) >= 2 and err[-1] < err[0], f"{what}: errRp did not decrease ({err[0]} -> {err[-1]})")
    check(res.X.shape == (vec_len,) and bool(np.all(np.isfinite(res.X))), f"{what}: bad X")


KERNEL_OPS = {  # device-op names of each hand-written kernel
    "k1": ("fused_spd_apply_kernel", "sum_partials_kernel"),
    "k4": ("jacobi_eigh_kernel", "jacobi_cta_kernel"),
    "k2k3": ("tri_sweep_kernel", "chain_sweep_kernel"),  # the two-hop and one-hop sweeps, the segments solve
    "sym_mirror": ("sym_mirror_kernel",),  # the poly filter's mirror pass
    "ell": ("ell_gather_kernel",),  # the bucketed-ELL products
}
# Each normal-solver mode's kernel (split: K1 on the coupled prefix).
FACTOR_KERNEL = {"precond": "k1", "split": "k1", "packed": "k2", "banded": "k3"}


def factor_kernel(neq) -> str:
    """The counter of ``neq``'s kernel: its mode's, and for banded K3 in
    its form (``k3_seg``: the segments form)."""
    return "k3_seg" if isinstance(neq.factor, chol.SegmentFactor) else FACTOR_KERNEL[neq.mode]


def band_form(neq) -> str:
    """K3's form in a banded ``neq``: "segments", or its tile form's name."""
    return "segments" if isinstance(neq.factor, chol.SegmentFactor) else neq.factor.form


def in_tile_forms(solver) -> None:
    """Rebuild ``solver``'s banded normal solver with K3's segments form off
    (``card_fit.tile_forms``), so it runs the tile forms that every band
    wider than SEGMENT_MAX_BW or with a segment longer than
    SEGMENT_MAX_ROWS takes, and swap it into the solver's parameters."""
    neq = solver._normal_solver("banded", solver.config.cg_max_iter, limits=card_fit.tile_forms(solver.device))
    check(isinstance(neq.factor, chol.BandFactor), f"tile forms: built {type(neq.factor).__name__}")
    solver.params = dataclasses.replace(solver.params, neq=neq)


# The device op one launch of each wrapper makes exactly once (K2/K3's tile
# forms: twice, one sweep kernel per sweep; the segments form once), which
# the profiler counts.
# K4 launches one of its plans' kernels.
# The ELL kernel's launches are gated by ``ell_schedule`` instead: 11 to 25
# an iteration, they would make a dropped profiler event (below) hit a
# counted kernel several times as often.
KERNEL_EVENT = {"k1": ("fused_spd_apply_kernel",), "k4": KERNEL_OPS["k4"], "k2k3": KERNEL_OPS["k2k3"],
                "sym_mirror": KERNEL_OPS["sym_mirror"]}


def _profiler_launches(dev_events) -> dict:
    return {k: sum(e.count for e in dev_events if any(name in e.key for name in names))
            for k, names in KERNEL_EVENT.items()}


# The profiler drops a kernel event now and then (1-2 of 1,600 K1 launches
# in the eager batched window on an H100): a graphed window that disagrees
# with the counters is traced again over half the iterations, up to
# PROFILE_TRIES times.
PROFILE_TRIES = 3
# In a long-lived process the profiler also loses the first few kernel
# records of a trace: in the graphs phase the first K1 of a graphed window,
# six kernels into it, went missing in every trace on an H100.
# PROFILE_SPINS spin kernels open each trace in its place and are left out
# of every count and time.
PROFILE_SPINS = 64
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def profiled(fn, iters: int, what: str, graphed: bool = True) -> tuple:
    """Run ``fn(iters)`` under torch.profiler: (device events, wall us, the
    wrappers' launches, the profiler's kernel counts, iterations traced).
    In a ``graphed`` window the replay-aware counters (a replay adds what
    its capture counted) must equal the profiler's counts of each kernel in
    one of PROFILE_TRIES traces (``iters``, then half as many each time).
    An eager window's counters are the wrappers' own counts, one per call
    that launched; its one trace is returned as it is, the profiler's
    counts beside them."""
    act = torch.profiler.ProfilerActivity
    for _ in range(PROFILE_TRIES if graphed else 1):
        torch.cuda.synchronize()
        before = dict(COUNTS)
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(PROFILE_SPINS):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(iters)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        counted = {k: v - before[k] for k, v in COUNTS.items()}
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and SPIN_KERNEL not in e.key]
        events = _profiler_launches(dev)
        want = dict(k1=counted["k1"], k4=counted["k4"],
                    k2k3=2 * (counted["k2"] + counted["k3"]) + counted["k3_seg"],
                    sym_mirror=counted["sym_mirror"])
        if events == want or not graphed:
            return dev, wall_us, counted, events, iters
        print(f"{what}: {iters} iterations traced, launch counters {want} against the profiler's {events}")
        iters = max(iters // 2, 1)
    check(False, f"{what}: launch counters {want} against the profiler's {events} in {PROFILE_TRIES} traces")


def profile_window(solver, timed_ms_per_it: float) -> dict:
    """Trace PROFILE_ITERS iterations with torch.profiler. Device ops count
    kernels, memsets and copies (one stream, so they do not overlap). The
    tracer slows the host, so the busy share is the traced device time per
    iteration over ``timed_ms_per_it`` from the untraced run, and
    ``busy_share_traced`` is the same over the traced wall time."""
    dev, wall_us, launches, events, iters = profiled(lambda n: solver.solve(max_iter=n, stop_tol=0.0),
                                                     PROFILE_ITERS, "profile window",
                                                     graphed=solver.chunk_runner == "graphs")
    dev.sort(key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in dev)
    per_it = lambda us: us / 1e3 / iters
    out = dict(
        wall_ms_per_it=per_it(wall_us),
        device_ms_per_it=per_it(dev_us),
        busy_share=per_it(dev_us) / timed_ms_per_it,  # 0.0 where the profiler saw no device time
        busy_share_traced=dev_us / wall_us,
        device_ops_per_it=sum(e.count for e in dev) / iters,
        chunk_runner=solver.chunk_runner,
        kernel_launches=events,  # the wrappers' counters, checked equal when graphed
        launches=launches,
        iterations_traced=iters,
    )
    for k, names in KERNEL_OPS.items():
        k_us = sum(e.self_device_time_total for e in dev if any(m in e.key for m in names))
        out[f"{k}_ms_per_it"] = per_it(k_us)
        out[f"{k}_share_of_device"] = k_us / dev_us if dev_us else None
    return dict(
        out,
        top_device_ops=[  # [op, self ms per iteration, launches per iteration]
            [e.key.replace("(anonymous namespace)::", "")[:60],
             per_it(e.self_device_time_total), e.count / iters]
            for e in dev[:PROFILE_TOP]
        ],
    )


def _methods(solver) -> list:
    """The projection method of each bucket, as the solver resolved it."""
    return [bucket_method(solver._projection, i) for i in range(len(solver.structure.buckets))]


def _k4_plans(solver) -> list:
    """The K4 plan of each jacobi bucket (``jacobi.k4_plan``), None for the
    other methods."""
    smem = jacobi.card_smem(torch.cuda.current_device())
    dtype = getattr(torch, solver.config.dtype)
    return [jacobi.k4_plan(bk.n, bk.count, dtype, smem) if m == "jacobi" and bk.n > 1 else None
            for m, bk in zip(_methods(solver), solver.structure.buckets)]


def timed_run(solver, iters: int, warm: int = 100):
    """``warm`` untimed iterations, then ``iters`` timed ones with every
    kernel's launch count set to 0 just before and read just after (the
    counters are replay-aware: trace.COUNTS), run as CUDA graphs (one
    replay an iteration, split at each eigh bucket)."""
    solver.solve(max_iter=warm, stop_tol=0.0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(max_iter=iters, stop_tol=0.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(COUNTS)
    check(res.iterations == iters, f"ran {res.iterations} of {iters} iterations")
    check(solver.chunk_runner == "graphs", f"the chunks ran {solver.chunk_runner!r}, not as graphs")
    return res, elapsed, counts


def ell_schedule(solver, iters: int) -> int:
    """The ELL kernel's launches in ``iters`` iterations of a cold solve:
    the step's products (5 an sGS iteration, 3 an ADMM one; solver/step.py)
    and two a refinement sweep (aat_matvec), ``applies`` a normal solve."""
    sgs = min(iters, max(solver.config.switch_admm - 1, 0))
    solves = 2 * sgs + (iters - sgs)
    return 5 * sgs + 3 * (iters - sgs) + 2 * solver.params.neq.applies * solves


def _gate_ell(solver, launched: int, iters: int, what: str, built: bool = False) -> None:
    """``launched`` is the schedule's count, or at least it where the count
    also covers the solver's build (``built``: its calibration's products)."""
    want = ell_schedule(solver, iters)
    check(launched >= want if built else launched == want,
          f"{what}: the ELL kernel launched {launched} times, not {want}{' or more' if built else ''}")


def _gate_launches(solver, counts: dict, iters: int, solves: int, what: str, built: bool = False) -> None:
    """The normal solver's kernel (K1, K2 or K3 by its mode and form,
    ``factor_kernel``) on every refinement sweep; K4 on every jacobi bucket
    of every iteration, and nowhere else; the ELL kernel as
    ``ell_schedule`` says (``_gate_ell``)."""
    applies = solver.params.neq.applies
    k = factor_kernel(solver.params.neq)
    check(counts[k] >= iters * solves * applies,
          f"{what}: {k} launched {counts[k]} times, fewer than {iters}x{solves}x{applies} sweeps")
    k4_buckets = sum(m == "jacobi" and bk.n > 1
                     for m, bk in zip(_methods(solver), solver.structure.buckets))
    check(counts["k4"] >= iters * k4_buckets and (k4_buckets or counts["k4"] == 0),
          f"{what}: K4 launched {counts['k4']} times for {k4_buckets} jacobi buckets x {iters}")
    _gate_ell(solver, counts["ell"], iters, what, built)


def _probe_normal_solve(solver, con_num: int) -> float:
    """The normal solve of a consistent probe rhs in f64, to the state
    dtype's PROBE_TOL (an f32 state calibrates its sweeps to 1e-6-1e-5)."""
    neq = solver.params.neq
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(con_num), device="cuda")
    rhs = aat_matvec(neq.sparse_a, v)
    resid = float(neq.residual_norm(rhs, neq.solve(rhs)))
    tol = PROBE_TOL[solver.config.dtype]
    check(resid < tol, f"normal-solve residual {resid:.3e} on the probe rhs (limit {tol:g})")
    return resid


def _no_tf32() -> None:
    """TF32 off (device.resolve_device): an f32 run's matmuls at full f32."""
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on before an f32 run")


def standin_problem() -> Problem:
    n = 1560
    t0 = time.perf_counter()
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    prob, _ = maxcut_chordal(W + W.T)
    print(
        f"stand-in: con_num={prob.con_num} vec_len={prob.vec_len} blocks={len(prob.blk)} "
        f"host_build_s={time.perf_counter() - t0:.2f}"
    )
    return prob


def standin(prob: Problem) -> int:
    launches = None
    for mode, switch, iters in (("admm", 0, 500), ("sgs", 10**9, 200)):
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=switch, stop_tol=0.0)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond", f"normal solver resolved to {neq.mode!r}, not precond")
        check(neq.factor.inv_l.shape[0] == STANDIN_N_PAD, f"factor n_pad {neq.factor.inv_l.shape[0]}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, iters)
        _gates(res, prob.vec_len, f"stand-in {mode}")
        _gate_launches(solver, counts, iters, 1 if mode == "admm" else 2, f"stand-in {mode}")
        if mode == "admm":
            launches = counts["k1"]
        emit(f"stand-in {mode}", dict(
            it_per_s=iters / elapsed, init_s=init_s, methods=_methods(solver),
            applies=neq.applies, launches=counts, residual_norm=resid,
            errRp_first=float(res.info["errRp"][0]), errRp_last=float(res.info["errRp"][-1]),
            init_breakdown=solver.init_breakdown,
            profile=profile_window(solver, elapsed * 1e3 / iters),
        ))
        del solver, neq, res
        torch.cuda.empty_cache()
    return launches


def grid_problem(shape=GRID):
    return card_fit.grid_problem(shape)


def host_syncs_per_iteration(solver) -> dict:
    """Synchronizing calls per iteration inside the chunk loop: the warnings
    of torch's sync debug mode over a 2k-iteration solve less those over a
    k-iteration one (each one chunk; the difference drops the solve's fixed
    start and end). A first k-iteration solve, not counted, settles the
    caching allocator, whose own synchronizing calls would count once."""
    counts = []
    for iters in (SYNC_ITERS, SYNC_ITERS, 2 * SYNC_ITERS):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                solver.solve(max_iter=iters, stop_tol=0.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return dict(per_it=(counts[2] - counts[1]) / SYNC_ITERS, per_solve=counts)


def grid() -> int:
    t0 = time.perf_counter()
    prob = grid_problem()
    emit("grid problem", dict(
        graph=f"{GRID[0]}x{GRID[1]} grid", con_num=prob.con_num, vec_len=prob.vec_len,
        blocks=len(prob.blk), host_build_s=time.perf_counter() - t0))
    launches = None
    rates = {}
    # (projection, pack_to, warm, timed): jacobi at pack_to=128 runs K4 on
    # one 128x56 bucket, ~95 ms an iteration, so it runs fewer iterations.
    runs = [("jacobi", 0, GRID_WARM, GRID_ITERS), ("poly", 0, GRID_WARM, GRID_ITERS),
            ("eigh", 0, GRID_WARM, GRID_ITERS), ("auto", 0, GRID_WARM, GRID_ITERS),
            ("auto", 128, GRID_WARM, GRID_ITERS), ("jacobi", 128, 20, 50)]
    for proj, pack_to, warm, iters in runs:
        what = f"grid {proj} pack_to={pack_to}"
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0,
                           projection=proj, pack_to=pack_to)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond", f"{what}: normal solver resolved to {neq.mode!r}")
        check(neq.factor.inv_l.shape[0] == GRID_N_PAD, f"{what}: factor n_pad {neq.factor.inv_l.shape[0]}")
        buckets = [(bk.n, bk.count) for bk in solver.structure.buckets]
        if pack_to == 0:
            check(tuple(buckets) == GRID_BUCKETS, f"{what}: buckets {buckets}")
        if proj != "auto":
            check(set(_methods(solver)) == {proj}, f"{what}: methods {_methods(solver)}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, iters, warm)
        _gates(res, prob.vec_len, what)
        _gate_launches(solver, counts, iters, 1, what)
        if (proj, pack_to) == ("jacobi", 0):
            launches = counts["k4"]
        rates[(proj, pack_to)] = iters / elapsed
        out = dict(
            it_per_s=iters / elapsed, iterations=iters, init_s=init_s, buckets=buckets,
            methods=_methods(solver), applies=neq.applies, launches=counts,
            residual_norm=resid, errRp_first=float(res.info["errRp"][0]),
            errRp_last=float(res.info["errRp"][-1]), init_breakdown=solver.init_breakdown,
            host_syncs=host_syncs_per_iteration(solver), k4_plans=_k4_plans(solver),
        )
        if proj == "auto" and "eigh" not in out["methods"]:  # one graph an iteration: no host wait
            check(out["host_syncs"]["per_it"] == 0, f"{what}: {out['host_syncs']} host syncs with no eigh bucket")
        if proj in ("jacobi", "eigh") and pack_to == 0:
            out["profile"] = profile_window(solver, elapsed * 1e3 / iters)
        emit(what, out)
        del solver, neq, res
        torch.cuda.empty_cache()
    emit("grid auto it/s by pack_to", {str(k[1]): v for k, v in rates.items() if k[0] == "auto"})
    compare_psd_project(prob)
    return launches


def compare_psd_project(prob: Problem) -> None:
    """``psd_project`` (svec -> blocks -> each method -> svec) on the grid's
    structure under "eigh", "jacobi" (K4 once a bucket) and "poly", held to
    the pool route svec_from_pool(psd_project_pool(pool_from_svec(x))) in
    f64 within PSD_PROJECT_TOL of the largest |entry|."""
    st = BlockStructure(prob.blk, "pow2", 64, 0)
    check(tuple((bk.n, bk.count) for bk in st.buckets) == GRID_BUCKETS, "psd_project: grid buckets")
    maps = device_maps(st, torch.float64, "cuda")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(st.vec_len), device="cuda")
    out = {}
    for method in ("eigh", "jacobi", "poly"):
        reset_counts()
        y = psd_project(x, maps, method=method)
        torch.cuda.synchronize()
        k4 = COUNTS["k4"]
        ref = svec_from_pool(psd_project_pool(pool_from_svec(x, maps), maps, method=method), maps)
        rel = float((y - ref).abs().max() / ref.abs().max())
        want_k4 = len(GRID_BUCKETS) if method == "jacobi" else 0
        check(k4 == want_k4, f"psd_project {method}: K4 launched {k4} times, not {want_k4}")
        check(bool(torch.isfinite(y).all()) and rel <= PSD_PROJECT_TOL, f"psd_project {method}: rel err {rel:.3e}")
        out[method] = dict(rel_err=rel, k4_launches=k4)
    emit("grid psd_project", out)


def _synthetic_factor(lay, seed: int) -> torch.Tensor:
    """A well-conditioned synthetic factor on the card, made in place:
    diagonal tiles near the identity, off-diagonal tiles N(0, 1/(B nbw))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = lay.block
    packed = isinstance(lay, tri_stream.PackedLayout)
    nbw = lay.nb - 1 if packed else lay.nbw
    tiles = torch.empty((lay.T + 1, B, B), device="cuda").normal_(generator=gen)
    tiles.mul_(1.0 / (B * max(nbw, 1)) ** 0.5)
    eye = torch.eye(B, device="cuda")
    for k in range(lay.nb):
        t = tri_stream.tid(k, k) if packed else tri_stream.tid_band(k, k, lay)
        tiles[t].mul_(0.1).add_(eye)
    return tiles


def _dense_factor(tiles, lay) -> torch.Tensor:
    """The factor's dense lower-triangular expansion (n_pad, n_pad) for
    torch.cholesky_solve: off-diagonal tiles as stored, each diagonal block
    the lower triangle of the inverse of its stored (inverted) tile. The
    synthetic diagonal tiles are full matrices, so this L differs from the
    kernel's in their upper triangles: the call does the same work on a
    factor of the same size, and its result is only timed. A band's
    expansion is the full square, which the call reads whole."""
    B, packed = lay.block, isinstance(lay, tri_stream.PackedLayout)
    L = torch.zeros((lay.n_pad, lay.n_pad), device="cuda")
    for i in range(lay.nb):
        for j in range(0 if packed else max(0, i - lay.nbw), i + 1):
            t = tri_stream.tid(i, j) if packed else tri_stream.tid_band(i, j, lay)
            L[i * B:(i + 1) * B, j * B:(j + 1) * B] = torch.linalg.inv(tiles[t]).tril_() if i == j else tiles[t]
    return L


def _launches_per_solve(kernel, r, tries: int = 3) -> tuple:
    """CUDA kernel launches of one solve ``kernel(r)``, counted by
    torch.profiler, and the traces before it that held no sweep kernel.
    The wrapper launches or raises, so a trace with no sweep kernel at all
    after a solve whose result was checked is a trace that dropped its
    events (it happens on the card, rarely; the count of such traces goes
    into the K2/K3 line); it is taken again, up to ``tries`` times. As in
    ``profiled``, PROFILE_SPINS spin kernels open each trace: a solve of
    one launch (K3's segments form) lost it in all three traces of this
    long process on an H100, though it was kept when run alone."""
    act = torch.profiler.ProfilerActivity
    for empty in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(PROFILE_SPINS):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            kernel(r)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                       and any(m in e.key for m in KERNEL_OPS["k2k3"]))
        if launches:
            return launches, empty
    return 0, tries


def compare_tri_stream() -> dict:
    """K2 and K3 against their plain versions at each TRI_LAYOUTS layout,
    one at a time, K3 in the form the solver runs there (the one-hop form's
    derived tiles formed first); times in turns (plain, kernel, kernel,
    plain) and as a replayed CUDA graph of TRI_REPS solves, as the chunk
    runner runs them (``k4_ab.graph_ms``); two solves of the same r bitwise
    equal; the sweep kernels a solve launches, from the profiler. At the
    large grid's own layouts one torch.cholesky_solve on the factor's dense
    expansion (``_dense_factor``, 18.8 GB) is timed as library_ms. Returns
    the kernel-table numbers at those layouts."""
    at_grid = {}
    for i, (label, lay) in enumerate(TRI_LAYOUTS):
        packed = isinstance(lay, tri_stream.PackedLayout)
        tiles = _synthetic_factor(lay, seed=100 + i)
        card_lim = limits.card_limits(tiles.device)
        form, chain = ("two_hop", None) if packed else chol.chain_tiles(tiles, lay, card_lim.band_max_bytes)
        if packed:
            kernel = lambda r: tri_stream.packed_solve(tiles, r, lay)
        else:
            kernel = lambda r: tri_stream.band_solve(tiles, r, lay, chain=chain, form=form)
        plain = tri_stream.packed_solve_ref if packed else tri_stream.band_solve_ref
        r = torch.randn(lay.n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(i))
        y = kernel(r)
        ref = plain(tiles, r, lay)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        max_abs = float((y - ref).abs().max())
        check(bool(torch.isfinite(y).all()) and rel <= TRI_REL_TOL, f"{label}: rel err {rel:.3e}")
        check(torch.equal(kernel(r), y), f"{label}: two solves of one r differ")
        launches, empty_traces = _launches_per_solve(kernel, r)
        check(launches == 2, f"{label}: {launches} sweep kernel launches per solve, not 2")
        p1 = _time_ms(lambda: plain(tiles, r, lay), 1)
        k_1 = _time_ms(lambda: kernel(r), TRI_REPS)
        k_2 = _time_ms(lambda: kernel(r), TRI_REPS)
        p2 = _time_ms(lambda: plain(tiles, r, lay), 1)
        g_ms = graph_ms(lambda: kernel(r), TRI_REPS)
        k_ms, p_ms = (k_1 + k_2) / 2, (p1 + p2) / 2
        tiles_read = len(tri_stream._sweep_tables(lay)[0][0])  # the tiles a sweep visits
        sweep_gb = tiles_read * lay.block**2 * 4 / 1e9
        # Bound: every tile read once per sweep, so twice per solve (the
        # forward and the backward sweep; a factor of these sizes does not
        # stay in the 50 MB L2 between them), r in and y out, at the HBM
        # rate (the 4 B^2 flops a tile takes over both sweeps are ~0.01 of
        # that). The one-hop form reads as many tiles a sweep.
        bound_ms = (2 * sweep_gb * 1e9 + 8.0 * lay.n_pad) / HBM_BYTES_PER_S * 1e3
        gbs = 2 * sweep_gb / (g_ms * 1e-3)  # both sweeps
        l_ms = None
        if label.endswith("grid"):
            L = _dense_factor(tiles, lay)
            rcol = torch.nn.functional.pad(r, (0, lay.n_pad - lay.n)).unsqueeze(1)
            library = lambda: torch.cholesky_solve(rcol, L)
            check(bool(torch.isfinite(library()).all()), f"{label}: cholesky_solve on the dense factor")
            l_ms = _time_ms(library, TRI_REPS)
            del L, rcol
        row = dict(layout=label, kind="packed" if packed else "band",
                   form={"chain": "one-hop", "two_hop": "two-hop"}[form], n=lay.n, block=lay.block, nb=lay.nb,
                   nbw=None if packed else lay.nbw, tiles=lay.T, gb_per_sweep=sweep_gb,
                   rel_err=rel, max_abs_err=max_abs, deterministic=True, launches_per_solve=launches,
                   empty_traces=empty_traces, ms=g_ms, eager_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                   share_of_bound=bound_ms / g_ms, gb_per_s=gbs, share_of_3350_gb_per_s=gbs / 3350)
        print("K2/K3 " + json.dumps(row), flush=True)
        report.setdefault("k2k3", []).append(row)
        if label.endswith("grid"):
            at_grid["k2" if packed else "k3"] = dict(max_abs_err=max_abs, ms=g_ms, eager_ms=k_ms, plain_ms=p_ms,
                                                     bound_ms=bound_ms, bound_by="bytes", library_ms=l_ms)
        del tiles, chain, r, y, ref
        torch.cuda.empty_cache()
    return at_grid


def _card_normal_solver(prob: Problem):
    """``prob``'s normal solver as ``auto`` builds it on the card, rows
    normalized as SDPSolver does (f64, no sweeps calibrated)."""
    _, vals = normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
    args = (prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len)
    dev = torch.device("cuda")
    return chol.build_normal_solver(*args, build_sparse_a(*args, torch.float64, dev), "auto", torch.float64, dev,
                                    applies=0)


def compare_segments() -> dict:
    """K3's segments form (csrc/tri_stream.cu) against
    ``band_segments_solve_ref`` on card tensors: at G50's factor as the card
    builds it (``_card_normal_solver``: banded, the segments form,
    G50_SEGMENTS) and at a synthetic band of SEGMENT_MAX_ROWS-row
    segments at SEGMENT_MAX_BW (``card_fit.synthetic_segments``), each with
    f64 and f32 r: within SEG_REL_TOL (f64 r; f32: one rounding of y), the
    same bits twice, one launch a solve (the profiler); the kernel as a
    replayed CUDA graph of SEG_REPS solves and the plain version once,
    beside the bound, the band's n (bw + 1) f32 entries, r and y once (f32)
    at the HBM rate, the bytes band.k3_roofline counts. Bands as wide as
    pendulum N=80's and PushBox N=30's keep the tile forms. Returns G50's
    f64 row for the kernels line."""
    model = limits.card_limits(torch.device("cuda")).segment_model
    for label, bw in (("pendulum N=80", 1615), ("PushBox N=30", 20512)):
        check(not limits.segment_form(model, G50_CON, bw, 1, float("inf")),
              f"segments: a band of {label}'s bandwidth {bw} takes the segments form")
    neq = _card_normal_solver(maxcut_chordal(toroidal_grid(*G50_GRID))[0])
    segments = isinstance(neq.factor, chol.SegmentFactor)
    seg = neq.factor.segments if segments else None
    check(segments and (seg.n_segments, seg.max_seg) == G50_SEGMENTS,
          f"segments: G50 resolved to {neq.mode} ({type(neq.factor).__name__}), "
          f"{None if seg is None else (seg.n_segments, seg.max_seg)}, not the segments form's {G50_SEGMENTS}")
    bands = (("G50", seg, neq.applies),
             ("synthetic max rows", card_fit.synthetic_segments(card_fit.SEG_N, limits.SEGMENT_MAX_ROWS,
                                                                limits.SEGMENT_MAX_BW, 300, "cuda"), None))
    g50 = None
    for label, band, applies in bands:
        n = band.n
        for dtype in (torch.float64, torch.float32):
            r = torch.randn(n, dtype=dtype, device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
            kernel = lambda r: tri_stream.band_segments_solve(band, r)
            plain = lambda r: tri_stream.band_segments_solve_ref(band, r)
            y, ref = kernel(r), plain(r.double())
            torch.cuda.synchronize()
            rel = float(torch.linalg.norm(y.double() - ref) / torch.linalg.norm(ref))
            tol = SEG_REL_TOL if dtype == torch.float64 else 1e-7
            what = f"segments {label} {str(dtype)[6:]}"
            check(y.dtype == dtype and bool(torch.isfinite(y).all()) and rel <= tol, f"{what}: rel err {rel:.3e}")
            check(torch.equal(kernel(r), y), f"{what}: two solves of one r differ")
            launches, empty_traces = _launches_per_solve(kernel, r)
            check(launches == 1, f"{what}: {launches} kernel launches a solve, not 1")
            g_ms = graph_ms(lambda: kernel(r), SEG_REPS)
            p_ms = _time_ms(lambda: plain(r), 1)
            bound_ms = (4 * n * (band.bw + 1) + 8 * n) / HBM_BYTES_PER_S * 1e3
            row = dict(band=label, dtype=str(dtype)[6:], n=n, bw=band.bw, segments=band.n_segments,
                       max_seg=band.max_seg, chunks=band.chunks.shape[0] - 1, chunk_rows=band.rows,
                       applies=applies, rel_err=rel, deterministic=True, launches_per_solve=launches,
                       empty_traces=empty_traces, ms=g_ms, plain_ms=p_ms, bound_ms=bound_ms,
                       share_of_bound=bound_ms / g_ms)
            print("K3 segments " + json.dumps(row), flush=True)
            report.setdefault("k3_segments", []).append(row)
            if label == "G50" and dtype == torch.float64:
                g50 = dict(max_abs_err=float((y - ref).abs().max()), ms=g_ms, plain_ms=p_ms, bound_ms=bound_ms,
                           bound_by="bytes", library_ms=None)
        del band
    del neq, seg
    torch.cuda.empty_cache()
    return g50


def compare_mirror() -> dict:
    """The mirror kernel (csrc/sym_mirror.cu) on card tensors at MIRROR_N,
    in f64 and f32, as the poly filter calls it (plain; with the addend W
    and the device scale, as in the projection's last pass), NaN written
    below the diagonal of T and W: finite, exactly symmetric, the same bits
    in place and twice, and within MIRROR_REL_TOL of ``mirror_ref``; the
    kernel and ``mirror_ref`` on the card timed as replayed CUDA graphs
    (the chunk runner's way), beside the bound: the triangles read and the
    square written at 3.35 TB/s. Returns the f64 plain row, the pass after
    every triangle product, for the kernels line."""
    n, rows = MIRROR_N, []
    for dtype in (torch.float64, torch.float32):
        t, w = _sym_batch(n, 1, dtype, seed=61)[0], _sym_batch(n, 1, dtype, seed=62)[0]
        scale = torch.full((1, 1, 1), 0.37, dtype=dtype, device="cuda")
        nan_low = torch.full_like(t, float("nan")).tril_(-1)
        size = t.element_size()
        tri_bytes = n * (n + 1) // 2 * size
        for form, kw, nbytes in (("plain", {}, tri_bytes + n * n * size),
                                 ("addend and scale", dict(add=w, add_coef=1.0, scale=scale, alpha=0.5),
                                  2 * tri_bytes + n * n * size)):
            ref = sym_products.mirror_ref(t, torch.empty_like(t), kw.get("alpha", 1.0), kw.get("scale"), 0.0,
                                          kw.get("add"), kw.get("add_coef", 1.0))
            kw_nan = dict(kw, add=w + nan_low) if "add" in kw else kw
            out = sym_products.mirror(t + nan_low, torch.empty_like(t), **kw_nan)
            again = sym_products.mirror(t + nan_low, torch.empty_like(t), **kw_nan)
            inplace = sym_products.mirror(t + nan_low, **kw_nan)
            torch.cuda.synchronize()
            what = f"mirror n={n} {str(dtype)[6:]} {form}"
            check(bool(torch.isfinite(out).all()), f"{what}: NaN below the diagonal leaked")
            check(torch.equal(out, out.mT), f"{what}: not exactly symmetric")
            check(torch.equal(out, again) and torch.equal(out, inplace), f"{what}: launches differ")
            max_abs = float((out - ref).abs().max())
            rel = max_abs / float(ref.abs().max())
            check(rel <= MIRROR_REL_TOL[dtype], f"{what}: rel err {rel:.3e}")
            dst = torch.empty_like(t)
            ms = graph_ms(lambda: sym_products.mirror(t, dst, **kw))
            plain_ms = graph_ms(lambda: sym_products.mirror_ref(t, dst, kw.get("alpha", 1.0), kw.get("scale"), 0.0,
                                                               kw.get("add"), kw.get("add_coef", 1.0)))
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append(dict(n=n, dtype=str(dtype)[6:], form=form, rel_err=rel, max_abs_err=max_abs, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms,
                             bytes=nbytes, deterministic=True))
            print(f"{what}: rel_err={rel:.3e} ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
                  f"share={bound_ms / ms:.3f}")
        del t, w, nan_low, ref, out, again, inplace, dst
        torch.cuda.empty_cache()
    emit("sym_mirror", rows)
    return {k: rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}


def _ell_tables(prob: Problem, dtype: torch.dtype) -> sparse.SparseA:
    """A's tables as the solver builds them (solver/driver.py, init.ell_tables):
    normalized rows in pool coordinates, an f32 copy the device cast of the
    f64 one."""
    cfg = SolverConfig()
    st = BlockStructure(prob.blk, cfg.bucket_rounding, cfg.exact_above, 0)
    _, at_vals = normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
    return sparse.build_sparse_a_pool(prob.At_rows, prob.At_cols, at_vals, prob.con_num, st,
                                      (torch.float64, dtype), "cuda")[-1]


def _ell_bytes(t: sparse.EllTable, lead: int, size: int, idx=None, placed: bool = True) -> dict:
    """What one launch over table ``t`` must move at the least: its indices
    and values, its placement map (none where ``placed`` is False: the
    compact sums in row order), the entries of x the table's indices name,
    and the output, once each; ``idx`` in place of the table's indices (the
    compact half's) for the tables' bytes."""
    own = torch.cat([i.reshape(-1) for i in t.idx])
    named = int(torch.unique(own[own < t.in_len]).numel())
    entries = sum(i.numel() for i in (t.idx if idx is None else idx))
    rows = sum(i.shape[0] for i in t.idx)
    maps = 0 if not placed else 8 * (t.out_perm.numel() if t.out_perm is not None else 2 * t.out_pos.numel())
    return dict(tables=entries * (8 + size) + maps, x=lead * size * named,
                out=lead * size * (t.out_len if placed else rows))


def compare_ell() -> dict:
    """The ELL kernel (csrc/ell_products.cu) on the tables of G11's torus
    (one instance and ELL_LEAD, as the family runs them), G50's,
    QUASAR-500 and the G22-size max-cut (A^T by out_pos, AA^T y compact),
    in f64 and f32: A x,
    A^T y and AA^T y against the plain versions on the same card tensors
    (within ELL_REL_TOL, the same bits twice, one launch a product and two
    an AA^T y), kernel and plain version timed as replayed CUDA graphs
    beside the byte bound (an AA^T y's without its intermediate; x's
    entries that the indices name, not all of x). Returns
    the f64 rows of QUASAR-500's, G11's and G50's AA^T y for the kernels line."""
    t0 = time.perf_counter()
    probs = (("gset_g11", maxcut_chordal(toroidal_grid(100, 8))[0], (1, ELL_LEAD)),
             ("gset_g50", maxcut_chordal(toroidal_grid(*G50_GRID))[0], (1,)),
             ("quasar500", quasar_problem(QUASAR_POSES), (1,)),
             ("g22_size", maxcut_sdp(random_graph(G22_NODES, p=G22_EDGE_P, seed=22)), (1,)))
    print(f"ell problems: {time.perf_counter() - t0:.1f} s")
    rows = []
    for name, prob, leads in probs:
        for dtype in (torch.float64, torch.float32):
            sa = _ell_tables(prob, dtype)
            size = 8 if dtype == torch.float64 else 4
            compact = sa.a_idx_compact is not None
            for lead in leads:
                shape = (lead,) if lead > 1 else ()
                rng = np.random.default_rng(71)
                x = torch.as_tensor(rng.standard_normal(shape + (sa.vec_len,)), dtype=dtype, device="cuda")
                y = torch.as_tensor(rng.standard_normal(shape + (sa.con_num,)), dtype=dtype, device="cuda")
                b_a, b_at = _ell_bytes(sa.a, lead, size), _ell_bytes(sa.at, lead, size)
                b_second = _ell_bytes(sa.a, lead, size, sa.a_idx_compact) if compact else b_a
                b_aat = (_ell_bytes(sa.at, lead, size, placed=False) if compact else b_at)["tables"] \
                    + b_at["x"] + b_second["tables"] + b_second["out"]
                products = (
                    ("A x", sparse.spmv_a, lambda v: sparse._ell_matvec_ref(sa.a, v), x, 1, sum(b_a.values())),
                    ("A^T y", sparse.spmv_at, lambda v: sparse._ell_matvec_ref(sa.at, v), y, 1, sum(b_at.values())),
                    ("AA^T y", sparse.aat_matvec,
                     (lambda v: sparse._aat_compact_ref(sa, v)) if compact
                     else (lambda v: sparse._ell_matvec_ref(sa.a, sparse._ell_matvec_ref(sa.at, v))),
                     y, 2, b_aat),
                )
                for what, fn, ref, v, launches, nbytes in products:
                    label = f"ell {name} lead {lead} {str(dtype)[6:]} {what}"
                    before = COUNTS["ell"]
                    got = fn(sa, v)
                    again = fn(sa, v)
                    torch.cuda.synchronize()
                    check(COUNTS["ell"] == before + 2 * launches,
                          f"{label}: {COUNTS['ell'] - before} launches for two calls, not {2 * launches}")
                    check(torch.equal(got, again), f"{label}: two launches differ")
                    want = ref(v)
                    rel = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
                    check(rel <= ELL_REL_TOL[dtype], f"{label}: rel err {rel:.3e}")
                    ms = graph_ms(lambda: fn(sa, v))
                    plain_ms = graph_ms(lambda: ref(v))
                    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    rows.append(dict(table=name, lead=lead, dtype=str(dtype)[6:], product=what, rel_err=rel,
                                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                                     share=bound_ms / ms, bytes=nbytes, launches=launches, compact=compact,
                                     a_widths=[i.shape[1] for i in sa.a.idx],
                                     at_widths=[i.shape[1] for i in sa.at.idx], deterministic=True))
                    print(f"{label}: rel_err={rel:.3e} ms={ms:.5f} plain_ms={plain_ms:.5f} "
                          f"bound_ms={bound_ms:.5f} share={bound_ms / ms:.3f}")
            del sa
            torch.cuda.empty_cache()
    emit("ell_gather", rows)
    pick = lambda table: next(r for r in rows if r["table"] == table and r["lead"] == 1
                              and r["dtype"] == "float64" and r["product"] == "AA^T y")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "rel_err")
    return {"quasar500_aat": {k: pick("quasar500")[k] for k in keys},
            "gset_g11_aat": {k: pick("gset_g11")[k] for k in keys},
            "gset_g50_aat": {k: pick("gset_g50")[k] for k in keys}}


def _tri_products_per_it(solver) -> int:
    """Triangle products (and mirror launches, one each) an iteration of
    the poly filter's one-triangle route: the schedule's for each poly
    bucket that takes the route, none for the others."""
    dtype = getattr(torch, solver.config.dtype)
    per = sum(2 if c == 0.0 else 3 for _, _, c in polyfilter.default_schedule(dtype)) + 1
    route = lambda bk: polyfilter.one_triangle(torch.empty((bk.count, bk.n, bk.n), dtype=dtype, device="meta"))
    return per * sum(m == "poly" and route(bk) for m, bk in zip(_methods(solver), solver.structure.buckets))


def large_grid_problem() -> Problem:
    t0 = time.perf_counter()
    prob = grid_problem(LARGE_GRID)
    emit("large grid problem", dict(
        graph=f"{LARGE_GRID[0]}x{LARGE_GRID[1]} grid", con_num=prob.con_num, vec_len=prob.vec_len,
        blocks=len(prob.blk), host_build_s=time.perf_counter() - t0))
    check(prob.con_num == LARGE_GRID_CON, f"large grid con_num {prob.con_num}")
    return prob


def large_grid(prob: Problem) -> dict:
    """The 20x120 grid past dense_chol_max: normal_solver "auto" (banded, in
    K3's segments form), "banded" rebuilt in K3's tile forms
    (``in_tile_forms``) and "packed", each timed, gated and counted;
    returns the launches of K3's segments form (``k3_seg``), of its tile
    forms (``k3``) and of K2 from those runs."""
    launches, last = {}, {}
    for ns, mode, k in (("auto", "banded", "k3_seg"), ("banded tile forms", "banded", "k3"),
                        ("packed", "packed", "k2")):
        what = f"large grid normal_solver={ns}"
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0,
                           projection="auto", normal_solver=ns.split()[0])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        if k == "k3":
            in_tile_forms(solver)
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == mode and factor_kernel(neq) == k,
              f"{what}: resolved to {neq.mode!r} ({type(neq.factor).__name__}), not {mode!r} with {k}")
        lay = None
        if k == "k3_seg":
            seg = neq.factor.segments
            check((seg.n_segments, seg.max_seg) == LARGE_GRID_SEGMENTS,
                  f"{what}: {seg.n_segments} segments, the longest {seg.max_seg}, not {LARGE_GRID_SEGMENTS}")
        elif k == "k3":
            lay = neq.factor.layout
            check((lay.block, lay.nb, lay.nbw) == LARGE_GRID_BAND, f"{what}: band layout {lay}")
            check(neq.factor.form == "chain" and neq.factor.chain is not None and neq.factor.perm is not None,
                  f"{what}: {neq.factor.form} form: nbw 1 takes K3's one-hop form with its derived tiles, "
                  f"under the RCM permutation")
        else:
            lay = neq.factor.layout
            check((lay.nb, lay.T) == (67, 2278), f"{what}: packed layout {lay}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, GRID_ITERS, GRID_WARM)
        _gates(res, prob.vec_len, what)
        _gate_launches(solver, counts, GRID_ITERS, 1, what)
        launches[k] = counts[k]
        last[ns] = float(res.info["errRp"][-1])
        out = dict(
            it_per_s=GRID_ITERS / elapsed, init_s=init_s, mode=neq.mode, layout=None if lay is None else lay._asdict(),
            band_form=band_form(neq) if mode == "banded" else None,
            methods=_methods(solver), applies=neq.applies, eps_used=neq.eps_used, launches=counts,
            residual_norm=resid, errRp_first=float(res.info["errRp"][0]), errRp_last=last[ns],
            init_breakdown=solver.init_breakdown, host_syncs=host_syncs_per_iteration(solver),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        if mode == "banded":
            out["profile"] = profile_window(solver, elapsed * 1e3 / GRID_ITERS)
        emit(what, out)
        del solver, neq, res
        torch.cuda.empty_cache()
    for ns in ("auto", "banded tile forms"):
        agree = abs(last[ns] - last["packed"]) / abs(last["packed"])
        emit(f"large grid errRp agreement {ns}", dict(banded=last[ns], packed=last["packed"], rel=agree))
        check(agree <= ERRRP_AGREE, f"large grid: banded ({ns}) and packed errRp differ by {agree:.3e}")
    return launches


def quasar_problem(n_poses: int, seed: int = 0) -> Problem:
    """QUASAR with ``n_poses`` poses: the structural constraints, b = (N+1)
    e_0 (the only nonzero of the reference's b.txt) and, for the
    measurement data C.txt that is not in the repo, a seeded symmetric C
    (the trace is fixed and X = I/4 is strictly feasible, so any C gives a
    well-posed SDP)."""
    rows, cols, vals, con_num, n = quasar_constraints(n_poses)
    m = np.random.default_rng(seed).standard_normal((n, n))
    r, c = np.tril_indices(n)
    return Problem(
        blk=[("s", n)], con_num=con_num, At_rows=rows, At_cols=cols, At_vals=vals,
        b_indices=np.array([0]), b_vals=np.array([n_poses + 1.0]),
        C_indices=np.arange(len(r)), C_vals=((m + m.T) / 2)[r, c] * np.where(r == c, 1.0, np.sqrt(2.0)),
        name=f"quasar-{n_poses}",
    )


def big_block_run(prob: Problem, projection: str, split_p: int, what: str, dtype: str = "float64") -> dict:
    """One big-block problem plain ADMM with normal_solver "auto", which must
    resolve to split with ``split_p`` coupled rows as its prefix (no
    permutation): BIG_BLOCK_WARM warm and BIG_BLOCK_ITERS timed iterations,
    gated on the probe rhs, finite and decreasing residuals, and K1 on
    exactly every refinement sweep (none when split_p is 0)."""
    cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection=projection,
                       dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = SDPSolver(prob, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    if dtype == "float32":
        _no_tf32()
    neq = solver.params.neq
    check(neq.mode == "split" and neq.split_p == split_p and neq.factor.perm is None,
          f"{what}: resolved to {neq.mode!r} with p={neq.split_p}, permuted={neq.factor.perm is not None}")
    n_pad = None if neq.inv_l is None else neq.inv_l.shape[0]
    check(n_pad == (-(-split_p // 128) * 128 if split_p else None), f"{what}: prefix n_pad {n_pad}")
    resid = _probe_normal_solve(solver, prob.con_num)
    res, elapsed, counts = timed_run(solver, BIG_BLOCK_ITERS, BIG_BLOCK_WARM)
    _gates(res, prob.vec_len, what)
    sweeps = BIG_BLOCK_ITERS * neq.applies if split_p else 0
    check(counts["k1"] == sweeps, f"{what}: K1 launched {counts['k1']} times, not {sweeps}")
    _gate_launches(solver, counts, BIG_BLOCK_ITERS, 1 if split_p else 0, what)
    tri = BIG_BLOCK_ITERS * _tri_products_per_it(solver)
    check(counts["poly_tri_products"] == tri and counts["sym_mirror"] == tri,
          f"{what}: {counts['poly_tri_products']} triangle products and {counts['sym_mirror']} mirror launches, "
          f"not {tri}")
    out = dict(
        it_per_s=BIG_BLOCK_ITERS / elapsed, init_s=init_s, init_breakdown=solver.init_breakdown,
        split_p=neq.split_p, n_pad=n_pad, methods=_methods(solver), applies=neq.applies,
        eps_used=neq.eps_used, launches=counts, residual_norm=resid,
        errRp_first=float(res.info["errRp"][0]), errRp_last=float(res.info["errRp"][-1]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        host_syncs=host_syncs_per_iteration(solver),
        profile=profile_window(solver, elapsed * 1e3 / BIG_BLOCK_ITERS),
    )
    emit(what, out)
    del solver, neq, res
    torch.cuda.empty_cache()
    return out


def quasar_500() -> Problem:
    t0 = time.perf_counter()
    prob = quasar_problem(QUASAR_POSES)
    shape = (prob.con_num, len(prob.At_vals), prob.blk[0][1])
    emit("quasar-500 problem", dict(con_num=shape[0], at_nnz=shape[1], block=shape[2], vec_len=prob.vec_len,
                                    host_build_s=time.perf_counter() - t0))
    check(shape == QUASAR_SHAPE and len(prob.blk) == 1, f"QUASAR-500 shape {shape}")
    return prob


def quasar(prob: Problem) -> None:
    """QUASAR-500 at full size, projection "auto" and "eigh"."""
    print("projection auto for a 2004x1 bucket:", choose_methods([(QUASAR_SHAPE[2], 1)], "cuda", "float64"))
    for proj in ("auto", "eigh"):
        big_block_run(prob, proj, QUASAR_P, f"quasar-500 projection={proj}")


def grid_past_cap() -> Problem:
    """The 20x80 grid with dense_chol_max raised past 32,768: "auto" must
    resolve to precond with K1 at n_pad 44,416 on exactly every refinement
    sweep, AA^T formed from dense A on the card (its 10.9 GB fit the card's
    dense-A budget); "banded" on the same problem is the yardstick for
    errRp. Returns the problem."""
    t0 = time.perf_counter()
    prob = grid_problem(PAST_CAP_GRID)
    emit("20x80 grid problem", dict(
        graph=f"{PAST_CAP_GRID[0]}x{PAST_CAP_GRID[1]} grid", con_num=prob.con_num, vec_len=prob.vec_len,
        blocks=len(prob.blk), host_build_s=time.perf_counter() - t0))
    check(prob.con_num == PAST_CAP_CON, f"20x80 grid con_num {prob.con_num}")
    last = {}
    for ns, mode in (("auto", "precond"), ("banded", "banded")):
        what = f"20x80 grid normal_solver={ns}"
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection="auto",
                           normal_solver=ns, dense_chol_max=PAST_CAP_DENSE_CHOL_MAX)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        peak_init = torch.cuda.max_memory_allocated() / 1e9
        neq = solver.params.neq
        check(neq.mode == mode, f"{what}: resolved to {neq.mode!r}, not {mode!r}")
        if mode == "precond":
            check(neq.factor.inv_l.shape[0] == PAST_CAP_N_PAD, f"{what}: factor n_pad {neq.factor.inv_l.shape[0]}")
            check(solver.init_breakdown.get("neq.aat") == "device",
                  f"{what}: AA^T formed on the {solver.init_breakdown.get('neq.aat')}, not from dense A on the card")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, BIG_BLOCK_ITERS, BIG_BLOCK_WARM)
        _gates(res, prob.vec_len, what)
        _gate_launches(solver, counts, BIG_BLOCK_ITERS, 1, what)
        if mode == "precond":
            sweeps = BIG_BLOCK_ITERS * neq.applies
            check(counts["k1"] == sweeps, f"{what}: K1 launched {counts['k1']} times, not {sweeps}")
        last[ns] = float(res.info["errRp"][-1])
        out = dict(
            it_per_s=BIG_BLOCK_ITERS / elapsed, init_s=init_s, init_breakdown=solver.init_breakdown,
            mode=neq.mode, n_pad=None if neq.inv_l is None else neq.inv_l.shape[0], methods=_methods(solver),
            applies=neq.applies, eps_used=neq.eps_used, launches=counts, residual_norm=resid,
            errRp_first=float(res.info["errRp"][0]), errRp_last=last[ns],
            peak_mem_gb_init=peak_init, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        if mode == "precond":
            out["profile"] = profile_window(solver, elapsed * 1e3 / BIG_BLOCK_ITERS)
        emit(what, out)
        del solver, neq, res
        torch.cuda.empty_cache()
    agree = abs(last["auto"] - last["banded"]) / abs(last["banded"])
    emit("20x80 grid errRp agreement", dict(precond=last["auto"], banded=last["banded"], rel=agree))
    check(agree <= ERRRP_AGREE, f"20x80 grid: precond and banded errRp differ by {agree:.3e}")
    return prob


def limits_phase(large: Problem, cap: Problem, quasar_prob: Problem) -> None:
    """The card's limits (ops/limits.py): the derived limits; the build
    peaks they were fitted to, measured again (card_fit.py) and held to the
    committed lines within PEAK_SLACK; K3 at B 1024, 512 and 256 on four
    bands beside the band model's prediction, its pick the fastest measured
    on each; K3's segments form on synthetic bands held to SEGMENT_MODEL
    within SEGMENT_FIT_TOL, and at the large grid's band, where the build
    takes it, faster than the tile forms' fastest measured time there;
    the 20x60 grid through "banded" beside its precond run of the
    grid phase (projection "auto" both); the 20x80 grid's precond init of
    the previous phase (dense A on the card); and precond past the card's
    n_pad (QUASAR-500's 756,501 rows) raising before it allocates."""
    dev = torch.device("cuda")
    lim = limits.card_limits(dev)
    out = dict(card=report["card"], total_bytes=lim.total_bytes, available_bytes=limits.available(lim.total_bytes),
               headroom=limits.HEADROOM, limits=dataclasses.asdict(lim))
    print("limits " + json.dumps(out), flush=True)
    grid = grid_problem()
    measured = card_fit.measure({GRID: grid, PAST_CAP_GRID: cap, LARGE_GRID: large}, dev)
    lines = {"packed": limits.PACKED_PEAK, "banded": limits.BAND_PEAK, "precond": limits.PRECOND_PEAK}
    for p in measured["peaks"]:
        p["line_bytes"] = lines[p["mode"]](p["factor_bytes"])
        print("limits peak " + json.dumps(p), flush=True)
        check(p["peak_bytes"] <= max(p["line_bytes"] * PEAK_SLACK, p["line_bytes"] + PEAK_SLACK_BYTES),
              f"limits: {p['mode']} {p['grid']} build peaked at {p['peak_bytes']} bytes, "
              f"past its line's {p['line_bytes']:.0f}")
    check(measured["peaks"][-1]["factored"], "limits: the synthetic PushBox band did not factor")
    ranking = card_fit.band_ranking(measured["k3"], limits.BAND_MODEL)
    for row in measured["k3"]:
        row["model_ms"] = limits.BAND_MODEL(row["T"], row["B"], row["nb"]) * 1e3
        print("limits K3 " + json.dumps(row), flush=True)
    for r in ranking:
        print("limits K3 ranking " + json.dumps(r), flush=True)
        check(r["pick_is_fastest"], f"limits: the band model picks B {r['model'][0]} on {r['band']}, "
                                    f"more than {card_fit.K3_TIE:.0%} slower than the fastest, B {r['measured'][0]}")
    for row in measured["k3_segments"]:
        row["model_ms"] = limits.SEGMENT_MODEL(row["n"], row["bw"], row["max_seg"]) * 1e3
        print("limits K3 segments " + json.dumps(row), flush=True)
        check(abs(row["model_ms"] / row["ms"] - 1) <= SEGMENT_FIT_TOL,
              f"limits: K3's segments form at bw {row['bw']}, {row['max_seg']}-row segments took {row['ms']:.4f} ms, "
              f"SEGMENT_MODEL says {row['model_ms']:.4f}")
    neq = _card_normal_solver(large)
    check(isinstance(neq.factor, chol.SegmentFactor),
          f"limits: the large grid's band built {type(neq.factor).__name__}, not the segments form")
    seg = neq.factor.segments
    r = torch.randn(seg.n, dtype=torch.float64, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    solve = lambda: tri_stream.band_segments_solve(seg, r)
    for _ in range(3):
        solve()
    tile_ms = min(row["ms"] for row in measured["k3"] if row["n"] == large.con_num)
    grid_form = dict(segments_ms=min(_time_ms(solve, card_fit.K3_REPS) for _ in range(card_fit.K3_ROUNDS)),
                     tile_forms_ms=tile_ms, segments=seg.n_segments, max_seg=seg.max_seg,
                     segments_model_ms=limits.SEGMENT_MODEL(seg.n, seg.bw, seg.max_seg) * 1e3)
    print("limits K3 form at the large grid " + json.dumps(grid_form), flush=True)
    check(grid_form["segments_ms"] < tile_ms,
          f"limits: the large grid's band takes the segments form, {grid_form['segments_ms']:.4f} ms a solve, "
          f"slower than the tile forms' {tile_ms:.4f}")
    del neq, seg, r
    out.update(peaks=measured["peaks"], k3=measured["k3"], k3_ranking=ranking,
               k3_segments=measured["k3_segments"], k3_form_at_large_grid=grid_form, refit=card_fit.fit(measured))

    what = "grid normal_solver=banded"
    cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection="auto",
                       normal_solver="banded")
    t0 = time.perf_counter()
    solver = SDPSolver(grid, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    neq = solver.params.neq
    check(neq.mode == "banded", f"{what}: resolved to {neq.mode!r}")
    resid = _probe_normal_solve(solver, grid.con_num)
    res, elapsed, counts = timed_run(solver, GRID_ITERS, GRID_WARM)
    _gates(res, grid.vec_len, what)
    _gate_launches(solver, counts, GRID_ITERS, 1, what)
    precond = report["grid auto pack_to=0"]
    out["grid precond and banded"] = dict(
        con_num=grid.con_num, precond_it_per_s=precond["it_per_s"], precond_applies=precond["applies"],
        banded_it_per_s=GRID_ITERS / elapsed, banded_applies=neq.applies, banded_init_s=init_s,
        band_form=band_form(neq), banded_launches=counts,
        banded_residual_norm=resid, banded_errRp_last=float(res.info["errRp"][-1]),
        precond_errRp_last=precond["errRp_last"])
    del solver, neq, res
    torch.cuda.empty_cache()
    pc, bd = report["20x80 grid normal_solver=auto"], report["20x80 grid normal_solver=banded"]
    out["20x80 grid precond and banded"] = dict(
        precond_it_per_s=pc["it_per_s"], banded_it_per_s=bd["it_per_s"], precond_init_s=pc["init_s"],
        precond_factorize_s=pc["init_breakdown"].get("neq.factorize"), aat=pc["init_breakdown"].get("neq.aat"),
        precond_peak_mem_gb_init=pc["peak_mem_gb_init"], banded_init_s=bd["init_s"])

    _, vals = normalize_rows(quasar_prob.At_rows, quasar_prob.At_cols, quasar_prob.At_vals, quasar_prob.con_num)
    args = (quasar_prob.At_rows, quasar_prob.At_cols, vals, quasar_prob.con_num, quasar_prob.vec_len)
    sa = build_sparse_a(*args, torch.float64, dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        chol.build_normal_solver(*args, sa, "precond", torch.float64, dev,
                                 dense_chol_max=QUASAR_PRECOND_DENSE_CHOL_MAX)
        raised = None
    except ValueError as e:
        raised = str(e)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(raised is not None and "precond" in raised, "limits: precond past precond_max_n_pad did not raise")
    check(peak == before, f"limits: precond past its n_pad allocated {peak - before} bytes before raising")
    out["precond past its n_pad"] = dict(con_num=quasar_prob.con_num, precond_max_n_pad=lim.precond_max_n_pad,
                                         raised=raised, bytes_allocated=peak - before)
    del sa
    torch.cuda.empty_cache()
    emit("limits", out)


def g22_maxcut() -> None:
    t0 = time.perf_counter()
    W = random_graph(G22_NODES, p=G22_EDGE_P, seed=22)
    prob = maxcut_sdp(W, name="maxcut-g22-size")
    emit("maxcut G22-size problem", dict(nodes=G22_NODES, edges=int(np.count_nonzero(np.triu(W))),
                                        con_num=prob.con_num, vec_len=prob.vec_len,
                                        host_build_s=time.perf_counter() - t0))
    big_block_run(prob, "auto", 0, "maxcut G22-size projection=auto")


def standin_cg(prob: Problem) -> None:
    """The stand-in through normal_solver "cg" (FSAI): the probe rhs, then
    CG_ITERS plain-ADMM iterations with CG's steps and host waits counted."""
    cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, normal_solver="cg")
    t0 = time.perf_counter()
    solver = SDPSolver(prob, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    neq = solver.params.neq
    check(neq.mode == "cg" and neq.factor.fsai_g is not None, f"stand-in cg: mode {neq.mode!r}, FSAI built: "
                                                              f"{neq.factor.fsai_g is not None}")
    COUNTS.update(cg_solves=0, cg_steps=0, cg_waits=0)
    resid = _probe_normal_solve(solver, prob.con_num)
    probe = {k[3:]: COUNTS[k] for k in ("cg_solves", "cg_steps", "cg_waits")}
    solver.solve(max_iter=CG_ITERS, stop_tol=0.0)  # warm
    torch.cuda.synchronize()
    COUNTS.update(cg_solves=0, cg_steps=0, cg_waits=0)
    t0 = time.perf_counter()
    res = solver.solve(max_iter=CG_ITERS, stop_tol=0.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    st = {k[3:]: COUNTS[k] for k in ("cg_solves", "cg_steps", "cg_waits")}
    check(res.iterations == CG_ITERS, f"stand-in cg: ran {res.iterations} of {CG_ITERS} iterations")
    check(solver.chunk_runner == "eager", f"stand-in cg: chunks ran {solver.chunk_runner!r}, not eagerly")
    _gates(res, prob.vec_len, "stand-in cg")
    emit("stand-in normal_solver=cg", dict(
        it_per_s=CG_ITERS / elapsed, init_s=init_s, init_breakdown=solver.init_breakdown,
        cg_tol=neq.factor.tol, cg_max_iter=neq.factor.max_iter, residual_norm=resid, probe_cg=probe,
        solves=st["solves"], cg_steps_per_solve=st["steps"] / st["solves"],
        host_waits_per_solve=st["waits"] / st["solves"], steps_queued_per_wait=chol.CG_BLOCK,
        errRp_first=float(res.info["errRp"][0]), errRp_last=float(res.info["errRp"][-1]),
        profile=profile_window(solver, elapsed * 1e3 / CG_ITERS),
    ))


def _certified_gates(res, opt: float, what: str) -> dict:
    check(res.converged and not res.diverged, f"{what}: did not converge: {res.message}")
    gap_p = abs(res.pobj - opt) / (1 + abs(opt))
    gap_d = abs(res.dobj - opt) / (1 + abs(opt))
    check(gap_p < 1e-4 and gap_d < 1e-4, f"{what}: optimum off: {gap_p:.2e} {gap_d:.2e}")
    return dict(iterations=res.iterations, pobj=res.pobj, optimum=opt, rel_gap_p=gap_p,
                recoveries=res.recoveries)


def certified() -> None:
    """A certified random SDP to 1e-6 through each CERT_MODES normal solver,
    then dense with its factor zeroed: the first chunk goes non-finite, and
    divergence recovery must reach the level-2 CG rebuild and converge
    (tests/test_solver.py:158)."""
    blk = [("s", 6), ("s", 4), ("s", 6)]
    prob, _, _, _, opt = random_certified_sdp(blk, con_num=12, seed=3)
    base = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    out = {}
    for mode in CERT_MODES:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver = SDPSolver(prob, base.replace(normal_solver=mode), device="cuda")
        resolved = solver.params.neq.mode
        check(resolved == ("split" if mode == "auto" else mode), f"certified {mode}: resolved to {resolved!r}")
        if mode == "host":
            check(any("host" in str(w.message) for w in caught), "certified host: no warning on CUDA")
        res = solver.solve(max_iter=6000, stop_tol=1e-6)
        want = "eager" if mode in ("cg", "host") else "graphs"
        check(solver.chunk_runner == want, f"certified {mode}: chunks ran {solver.chunk_runner!r}, not {want!r}")
        out[mode] = dict(_certified_gates(res, opt, f"certified {mode}"), mode=resolved,
                         chunk_runner=solver.chunk_runner)
    solver = SDPSolver(prob, base.replace(normal_solver="dense"), device="cuda")
    neq = solver.params.neq
    solver.params = dataclasses.replace(solver.params, neq=dataclasses.replace(
        neq, factor=chol.CholFactor(torch.zeros_like(neq.factor.chol_l))))
    res = solver.solve(max_iter=8000, stop_tol=1e-6)
    check(res.recoveries >= 1 and solver.params.neq.mode == "cg",
          f"certified recovery: {res.recoveries} recoveries, ended in {solver.params.neq.mode!r}")
    out["dense, factor zeroed"] = dict(_certified_gates(res, opt, "certified recovery"),
                                       mode=solver.params.neq.mode)
    emit("certified", out)


def _profile_numbers(out: dict) -> dict:
    """The profile numbers an f32 line prints beside f64's."""
    prof = out["profile"]
    return dict(it_per_s=out["it_per_s"], device_ms_per_it=prof["device_ms_per_it"],
                busy_share=prof["busy_share"], k1_ms_per_it=prof["k1_ms_per_it"],
                k4_ms_per_it=prof["k4_ms_per_it"], k2k3_ms_per_it=prof["k2k3_ms_per_it"])


def standin_f32(prob: Problem) -> int:
    """The stand-in plain ADMM in f32 and f64 (precond + K1, projection
    "auto" from each dtype's table): one solver each, 100 warm iterations,
    then 500 timed in the order f64, f32, f32, f64, each gated; one K1
    launch per calibrated sweep exactly; a profile of each. Returns the
    f32 run's K1 launches (the first timed f32 run)."""
    iters = 500
    solvers, lines = {}, {}
    for dt in ("float64", "float32"):
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, dtype=dt)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond" and neq.factor.inv_l.shape[0] == STANDIN_N_PAD,
              f"stand-in {dt}: {neq.mode!r} at n_pad {None if neq.inv_l is None else neq.inv_l.shape[0]}")
        solvers[dt] = solver
        lines[dt] = dict(init_s=init_s, applies=neq.applies, methods=_methods(solver),
                         residual_norm=_probe_normal_solve(solver, prob.con_num), it_per_s=[])
    launches = None
    for k, dt in enumerate(("float64", "float32", "float32", "float64")):
        solver = solvers[dt]
        if dt == "float32":
            _no_tf32()
        res, elapsed, counts = timed_run(solver, iters, 100 if k < 2 else 0)
        what = f"stand-in {dt} timed run {k}"
        _gates(res, prob.vec_len, what)
        sweeps = iters * solver.params.neq.applies
        check(counts["k1"] == sweeps, f"{what}: K1 launched {counts['k1']} times, not {sweeps}")
        _gate_ell(solver, counts["ell"], iters, what)
        lines[dt]["it_per_s"].append(iters / elapsed)
        lines[dt].update(launches=counts, errRp_first=float(res.info["errRp"][0]),
                         errRp_last=float(res.info["errRp"][-1]))
        if dt == "float32" and launches is None:
            launches = counts["k1"]
    for dt, solver in solvers.items():
        rate = float(np.mean(lines[dt]["it_per_s"]))
        lines[dt]["profile"] = profile_window(solver, 1e3 / rate)
        lines[dt]["it_per_s_mean"] = rate
    emit("stand-in f32 vs f64", lines)
    del solvers
    torch.cuda.empty_cache()
    return launches


def grid_f32() -> int:
    """The grid plain ADMM in f32 with "jacobi" and "auto" (the f32 table):
    100 warm and 200 timed iterations, gated as the f64 grid runs and, for
    jacobi, on K4's f32 instantiation launched exactly once per bucket and
    iteration; device and K4 ms beside the f64 jacobi run's. Returns those
    K4 launches."""
    prob = grid_problem()
    f64 = report["grid jacobi pack_to=0"]
    launches = None
    for proj in ("jacobi", "auto"):
        what = f"grid float32 {proj}"
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection=proj,
                           dtype="float32")
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        _no_tf32()
        neq = solver.params.neq
        check(neq.mode == "precond" and neq.factor.inv_l.shape[0] == GRID_N_PAD, f"{what}: {neq.mode!r}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, GRID_ITERS, GRID_WARM)
        _gates(res, prob.vec_len, what)
        _gate_launches(solver, counts, GRID_ITERS, 1, what)
        k4_buckets = sum(m == "jacobi" and bk.n > 1 for m, bk in zip(_methods(solver), solver.structure.buckets))
        check(counts["k4_f32"] == counts["k4"] == GRID_ITERS * k4_buckets,
              f"{what}: K4 f32 launches {counts['k4_f32']} of {counts['k4']}, not {GRID_ITERS} x {k4_buckets}")
        out = dict(it_per_s=GRID_ITERS / elapsed, init_s=init_s, methods=_methods(solver), applies=neq.applies,
                   applies_f64=f64["applies"], launches=counts, residual_norm=resid,
                   errRp_first=float(res.info["errRp"][0]), errRp_last=float(res.info["errRp"][-1]),
                   profile=profile_window(solver, elapsed * 1e3 / GRID_ITERS))
        if proj == "jacobi":
            launches = counts["k4_f32"]
            out["f64_jacobi"] = _profile_numbers(f64)
        emit(what, out)
        del solver, neq, res
        torch.cuda.empty_cache()
    return launches


def large_grid_f32(prob: Problem) -> int:
    """The large grid in f32, normal_solver "auto" (banded + K3): 100 warm
    and 200 timed iterations, gated as the f64 run; rate and device time
    beside its. Returns K3's launches (in the form it runs)."""
    what = "large grid float32 normal_solver=auto"
    cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection="auto",
                       dtype="float32")
    t0 = time.perf_counter()
    solver = SDPSolver(prob, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    _no_tf32()
    neq = solver.params.neq
    check(neq.mode == "banded", f"{what}: resolved to {neq.mode!r}")
    resid = _probe_normal_solve(solver, prob.con_num)
    res, elapsed, counts = timed_run(solver, GRID_ITERS, GRID_WARM)
    _gates(res, prob.vec_len, what)
    _gate_launches(solver, counts, GRID_ITERS, 1, what)
    out = dict(it_per_s=GRID_ITERS / elapsed, init_s=init_s, methods=_methods(solver), applies=neq.applies,
               launches=counts, residual_norm=resid, errRp_first=float(res.info["errRp"][0]),
               errRp_last=float(res.info["errRp"][-1]),
               profile=profile_window(solver, elapsed * 1e3 / GRID_ITERS))
    f64 = report["large grid normal_solver=auto"]
    out["f64"] = dict(_profile_numbers(f64), applies=f64["applies"])
    emit(what, out)
    return counts[factor_kernel(neq)]


def quasar_f32(prob: Problem) -> None:
    """QUASAR-500 in f32 (split + K1, "poly" with SIGN_SCHEDULE_F32), beside
    the f64 "auto" (poly) run."""
    out = big_block_run(prob, "poly", QUASAR_P, "quasar-500 float32 projection=poly", dtype="float32")
    f64 = report["quasar-500 projection=auto"]
    emit("quasar-500 float32 vs float64", dict(f32=_profile_numbers(out), f64=_profile_numbers(f64),
                                              applies_f32=out["applies"], applies_f64=f64["applies"]))


def certified_f32() -> None:
    """The certified SDP of tests/test_solver.py:101 in f32 through each
    CERT_MODES_F32 normal solver to stop_tol 2e-4, optimum within 5e-3; then
    solve_escalated on tests/test_solver.py:194's instance at stop_tol 1e-4,
    converged with the optimum within 1e-2. max_iter 6000 each."""
    prob, _, _, _, opt = random_certified_sdp([("s", 5), ("s", 3)], con_num=8, seed=23)
    base = SolverConfig(verbose=False, check_every=25, switch_admm=10**9, dtype="float32")
    out = {}
    for mode in CERT_MODES_F32:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # host mode's warning on CUDA (phase 13 checks it)
            solver = SDPSolver(prob, base.replace(normal_solver=mode), device="cuda")
        _no_tf32()
        resolved = solver.params.neq.mode
        check(resolved == ("split" if mode == "auto" else mode), f"certified f32 {mode}: resolved to {resolved!r}")
        res = solver.solve(max_iter=6000, stop_tol=2e-4)
        gap = abs(res.pobj - opt) / (1 + abs(opt))
        check(res.converged and gap < 5e-3, f"certified f32 {mode}: converged={res.converged} gap {gap:.2e}")
        out[mode] = dict(mode=solver.params.neq.mode, applies=solver.params.neq.applies,
                         iterations=res.iterations, rel_gap_p=gap, seconds=time.perf_counter() - t0)
    prob, _, _, _, opt = random_certified_sdp([("s", 6)] * 8, con_num=200, seed=3)
    t0 = time.perf_counter()
    _no_tf32()
    res = solve_escalated(prob, base.replace(check_every=100), max_iter=6000, stop_tol=1e-4)
    gap = abs(res.pobj - opt) / (1 + abs(opt))
    check(res.converged and gap < 1e-2, f"solve_escalated: converged={res.converged} gap {gap:.2e}")
    out["solve_escalated 1e-4"] = dict(iterations=res.iterations, rel_gap_p=gap, message=res.message,
                                       seconds=time.perf_counter() - t0)
    emit("certified float32", out)


def standin_family() -> list:
    """BATCH stand-ins: the banded graph of standin_problem with edge
    weights from uniform(0.5, 1.5) under seeds 0..BATCH-1 (one A, BATCH C),
    through maxcut_chordal_family: the first is converted whole, the others
    share its clique tree and constraints and take only their own
    objective, in a tenth of the time."""
    n = 1560
    Ws = []
    for seed in range(BATCH):
        rng = np.random.default_rng(seed)
        W = sp.diags([rng.uniform(0.5, 1.5, n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
        Ws.append((W + W.T).tocsr())
    return maxcut_chordal_family(Ws, name="stand-in")[0]


def batched() -> tuple:
    """BatchedSDPSolver on BATCH stand-ins, f64 plain ADMM (precond + K1,
    the "auto" projection resolved at the batch's bucket sizes): 20 warm
    and 100 timed iterations; K1 exactly once a sweep, BATCH right-hand
    sides a launch (K1 over B); one eigh segment an iteration for each
    bucket resolved to eigh; each instance's last errRp within 1e-9 of its
    own single SDPSolver run of 100 iterations with the batch's methods.
    Returns the timed run's K1 launches, the stand-ins and the single
    runs' last errRp."""
    iters = BIG_BLOCK_ITERS
    t0 = time.perf_counter()
    probs = standin_family()
    host_s = time.perf_counter() - t0
    cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0)
    t0 = time.perf_counter()
    batch = BatchedSDPSolver(probs, cfg)
    init_s = time.perf_counter() - t0
    neq = batch.params.neq
    check(neq.mode == "precond" and neq.factor.inv_l.shape[0] == STANDIN_N_PAD, f"batched: {neq.mode!r}")
    batch.solve(max_iter=BIG_BLOCK_WARM, stop_tol=0.0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = batch.solve(max_iter=iters, stop_tol=0.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    k1 = COUNTS["k1"]
    check(batch.chunk_runner == "graphs", f"batched: chunks ran {batch.chunk_runner!r}, not as graphs")
    _gate_ell(batch, COUNTS["ell"], iters, "batched")
    sweeps = iters * neq.applies
    check(k1 == sweeps, f"batched: K1 launched {k1} times, not {iters} x {neq.applies}")
    check(COUNTS["k1_rhs"] == BATCH * k1,
          f"batched: K1 served {COUNTS['k1_rhs']} right-hand sides in {k1} launches, not {BATCH} a launch")
    waits = iters * _eigh_buckets(batch._base.structure, batch._projection)
    check(COUNTS["eigh_waits"] == waits, f"batched: {COUNTS['eigh_waits']} eigh segments, not {waits}")
    single_rates, rel, single_errrp = [], [], []
    for i, (prob, rb) in enumerate(zip(probs, results)):
        _gates(rb, prob.vec_len, f"batched instance {i}")
        single = SDPSolver(prob, cfg, device="cuda")
        single._projection = batch._projection
        t0 = time.perf_counter()
        rs = single.solve(max_iter=iters, stop_tol=0.0)
        torch.cuda.synchronize()
        single_rates.append(iters / (time.perf_counter() - t0))
        rel.append(abs(rb.errRp - rs.errRp) / abs(rs.errRp))
        single_errrp.append(rs.errRp)
        check(rb.iterations == rs.iterations == iters and rel[-1] <= 1e-9,
              f"batched instance {i}: errRp {rb.errRp!r} against single {rs.errRp!r} (rel {rel[-1]:.2e})")
        del single
    emit("batched", dict(instances=BATCH, host_build_s=host_s, init_s=init_s, applies=neq.applies,
                         projection=batch._projection, eigh_waits=COUNTS["eigh_waits"],
                         k1_launches=k1, instance_it_per_s=BATCH * iters / elapsed,
                         batch_it_per_s=iters / elapsed, single_it_per_s=single_rates,
                         single_it_per_s_mean=float(np.mean(single_rates)), errRp_rel_to_single=rel))
    del batch
    torch.cuda.empty_cache()
    return k1, probs, single_errrp


# ---------------------------------------------------------------------------
# The chunk runner: CUDA graphs against the eager loop on every path.

GRAPH_ITERS = 100  # iterations of each path, from one state, in each of the four runs
GRAPH_SYNC_ITERS = 5
GRAPH_REL_TOL = 1e-12  # allowed only where a captured cuBLAS call sums in another order than eager


def _step_for(solver, projection=None, switch_admm=None, rp_hp=False):
    """The step SDPSolver.solve makes at stop_tol 0, with the projection,
    switch_admm and rp_hp given."""
    cfg = solver.config
    return step_mod.make_step(
        stop_tol=0.0, switch_admm=cfg.switch_admm if switch_admm is None else switch_admm,
        sig_update_threshold=cfg.sig_update_threshold, sig_update_stage_1=cfg.sig_update_stage_1,
        sig_min=cfg.sig_min, sig_max=cfg.sig_max, eig_rank=cfg.eig_rank,
        projection=solver._projection if projection is None else projection,
        rp_hp=solver._rp_hp if rp_hp else None,
    )


def _eigh_buckets(structure, projection) -> int:
    return sum(bucket_method(projection, i) == "eigh" and bk.n > 1 for i, bk in enumerate(structure.buckets))


def _window(fn, iters: int, what: str, graphed: bool) -> dict:
    """``fn(iters)`` under torch.profiler (``profiled``): device ms and ops
    per iteration, and the wrappers' launches per iteration beside the
    profiler's kernel counts (held equal when ``graphed``)."""
    dev, _, launches, events, iters = profiled(fn, iters, what, graphed)
    return dict(device_ms_per_it=sum(e.self_device_time_total for e in dev) / 1e3 / iters,
                device_ops_per_it=sum(e.count for e in dev) / iters, kernel_events=events,
                launches_per_it={k: v / iters for k, v in launches.items()}, iterations_traced=iters)


def _syncs_per_it(fn) -> float:
    """Synchronizing calls per iteration (torch's sync debug mode), from
    runs of k and 2k iterations: the difference drops a run's fixed cost."""
    counts = []
    for iters in (GRAPH_SYNC_ITERS, 2 * GRAPH_SYNC_ITERS):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(iters)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return (counts[1] - counts[0]) / GRAPH_SYNC_ITERS


def _state_diff(a, b) -> float:
    """The largest difference of two states' fields, relative to each
    field's largest magnitude (0.0 when bitwise equal)."""
    worst = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.equal(x, y):
            continue
        if not x.is_floating_point():
            return float("inf")
        scale = max(float(y.abs().max()), 1e-300)
        worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def graph_path(name: str, step, params, state0, kernels: tuple, syncs: int) -> dict:
    """One path GRAPH_ITERS iterations from ``state0`` through the eager
    loop and the graph runner, in the order eager, graph, graph, eager:
    all four end states and info rows equal bit for bit (else within
    GRAPH_REL_TOL); rates from the pairs; a profiled window of each (device
    ms and ops per iteration, counters against the profiler's kernel
    counts, ``kernels`` launched on every iteration); host syncs per
    iteration (``syncs``: one an eigh bucket, 0 without); capture seconds
    and each run's peak memory."""
    eager = lambda n: run_chunk(step, state0, params, 0, n)
    runner = make_chunk_runner(step, params)
    graphed = lambda n: runner(state0, 0, n)
    eager(1)  # builds every kernel, plan and handle of the path
    torch.cuda.synchronize()
    graphed(2)  # one eager iteration and the capture, then a replay
    torch.cuda.synchronize()
    capture_s = runner.capture_s
    seconds, peak, ends = {"eager": [], "graph": []}, {}, {}
    for kind in ("eager", "graph", "graph", "eager"):
        fn = eager if kind == "eager" else graphed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, rows = fn(GRAPH_ITERS)
        torch.cuda.synchronize()
        seconds[kind].append(time.perf_counter() - t0)
        peak[kind] = torch.cuda.max_memory_allocated() / 1e9
        ends.setdefault(kind, []).append((state, rows))
    ref_state, ref_rows = ends["eager"][0]
    bitwise, rel = True, 0.0
    for state, rows in ends["eager"][1:] + ends["graph"]:
        same_rows = torch.equal(rows, ref_rows)
        bitwise &= same_rows and _state_diff(state, ref_state) == 0.0
        rel = max(rel, _state_diff(state, ref_state),
                  0.0 if same_rows else float((rows - ref_rows).abs().max() / ref_rows.abs().max()))
    check(bool(torch.isfinite(ref_rows).all()), f"graphs {name}: non-finite info rows")
    check(bitwise or rel <= GRAPH_REL_TOL, f"graphs {name}: graph and eager states differ by {rel:.3e}")
    del ends
    out = dict(iterations=GRAPH_ITERS, bitwise_equal=bitwise, max_rel_diff=rel, capture_s=capture_s,
               recordings=len(runner.recordings), segments=[len(r.parts) for r in runner.recordings.values()])
    for kind, fn in (("eager", eager), ("graph", graphed)):
        ms = 1e3 * float(np.mean(seconds[kind])) / GRAPH_ITERS
        prof = _window(fn, PROFILE_ITERS, f"graphs {name} {kind}", graphed=kind == "graph")
        for k in kernels:
            check(prof["launches_per_it"][k] >= 1, f"graphs {name} {kind}: {k} launched "
                                                   f"{prof['launches_per_it'][k]} times an iteration")
        out[kind] = dict(it_per_s=[GRAPH_ITERS / t for t in seconds[kind]], ms_per_it=ms,
                         device_ms_per_it=prof["device_ms_per_it"], busy_share=prof["device_ms_per_it"] / ms,
                         device_ops_per_it=prof["device_ops_per_it"], launches_per_it=prof["launches_per_it"],
                         host_syncs_per_it=_syncs_per_it(fn), peak_mem_gb=peak[kind],
                         kernel_events=prof["kernel_events"], iterations_traced=prof["iterations_traced"])
    got, eager_syncs = out["graph"]["host_syncs_per_it"], out["eager"]["host_syncs_per_it"]
    if syncs == 0:
        check(got == 0, f"graphs {name}: {got} host syncs an iteration without an eigh bucket")
    else:  # eigh's status checks, and nothing more than the eager loop's
        check(0 < got <= eager_syncs, f"graphs {name}: {got} host syncs an iteration for {syncs} eigh "
                                      f"buckets (eager: {eager_syncs})")
    out["eigh_buckets"] = syncs
    out["graph_over_eager_it_per_s"] = float(np.mean(out["graph"]["it_per_s"]) / np.mean(out["eager"]["it_per_s"]))
    emit(f"graphs {name}", out)
    runner.free()
    return out


def graphs(standin_prob: Problem, large: Problem, quasar_prob: Problem, family: list) -> None:
    """Every main path through the graph runner and the eager loop in one
    process (``graph_path``): the stand-in f64 in ADMM and sGS (K1, K4),
    the grid with "jacobi" (K1, K4) and "auto" (an eigh segment), the large
    grid banded in K3's segments form under "jacobi" (K4) and "auto" (eigh
    segment), in K3's tile forms under "jacobi" (``in_tile_forms``), and
    packed (K2), QUASAR-500 split with "poly" (K1, the mirror kernel of the
    poly filter's one-triangle route), the stand-in in f32
    with rp_hp (K1), and the 8 batched stand-ins (eigh: one segment)."""
    admm = dict(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0)
    out = {}

    def run(name, solver, step, kernels, projection=None, state0=None):
        if state0 is None:
            state0 = solver._initial_state(*solver._initial_scaled, solver.config.sig)
        proj = solver._projection if projection is None else projection
        structure = solver.structure
        out[name] = graph_path(name, step, solver.params, state0, kernels, _eigh_buckets(structure, proj))

    solver = SDPSolver(standin_prob, SolverConfig(**admm), device="cuda")
    k4 = ("k4",) if "jacobi" in _methods(solver) else ()
    run("stand-in f64 admm", solver, _step_for(solver), ("k1",) + k4)
    run("stand-in f64 sgs", solver, _step_for(solver, switch_admm=10**9), ("k1",) + k4)
    solver = SDPSolver(standin_prob, SolverConfig(dtype="float32", **admm), device="cuda")
    _no_tf32()
    run("stand-in f32 rp_hp", solver, _step_for(solver, rp_hp=True), ("k1",))
    del solver
    solver = SDPSolver(grid_problem(), SolverConfig(projection="auto", **admm), device="cuda")
    run("grid jacobi", solver, _step_for(solver, projection="jacobi"), ("k1", "k4"), projection="jacobi")
    run("grid auto", solver, _step_for(solver), ("k1",))
    del solver
    torch.cuda.empty_cache()
    solver = SDPSolver(large, SolverConfig(projection="auto", **admm), device="cuda")
    check(solver.params.neq.mode == "banded", f"graphs large grid: {solver.params.neq.mode!r}")
    check(factor_kernel(solver.params.neq) == "k3_seg", f"graphs large grid: {type(solver.params.neq.factor).__name__}")
    run("large grid banded jacobi", solver, _step_for(solver, projection="jacobi"), ("k3_seg", "k4"),
        projection="jacobi")
    run("large grid banded auto", solver, _step_for(solver), ("k3_seg",))
    in_tile_forms(solver)
    run("large grid banded tile forms jacobi", solver, _step_for(solver, projection="jacobi"), ("k3", "k4"),
        projection="jacobi")
    del solver
    torch.cuda.empty_cache()
    solver = SDPSolver(large, SolverConfig(projection="jacobi", normal_solver="packed", **admm), device="cuda")
    run("large grid packed jacobi", solver, _step_for(solver), ("k2", "k4"))
    del solver
    torch.cuda.empty_cache()
    solver = SDPSolver(quasar_prob, SolverConfig(projection="poly", **admm), device="cuda")
    check(solver.params.neq.mode == "split", f"graphs quasar: {solver.params.neq.mode!r}")
    run("quasar-500 split poly", solver, _step_for(solver), ("k1", "sym_mirror"))
    del solver
    torch.cuda.empty_cache()
    batch = BatchedSDPSolver(family, SolverConfig(**admm))
    cfg = batch.config
    step = step_mod.make_step(stop_tol=0.0, switch_admm=0, sig_update_threshold=cfg.sig_update_threshold,
                              sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max)
    out["batched 8 stand-ins"] = graph_path("batched 8 stand-ins", step, batch.params, batch._initial_states(cfg.sig),
                                            ("k1",), _eigh_buckets(batch._base.structure, "eigh"))
    del batch
    torch.cuda.empty_cache()
    emit("graphs", {name: dict(
        graph_it_per_s=float(np.mean(o["graph"]["it_per_s"])), eager_it_per_s=float(np.mean(o["eager"]["it_per_s"])),
        graph_busy=o["graph"]["busy_share"], eager_busy=o["eager"]["busy_share"],
        graph_device_ms=o["graph"]["device_ms_per_it"], eager_device_ms=o["eager"]["device_ms_per_it"],
        graph_ops=o["graph"]["device_ops_per_it"], eager_ops=o["eager"]["device_ops_per_it"],
        graph_syncs=o["graph"]["host_syncs_per_it"], eager_syncs=o["eager"]["host_syncs_per_it"],
        bitwise=o["bitwise_equal"], capture_s=o["capture_s"], card=report["card"]) for name, o in out.items()})


# ---------------------------------------------------------------------------
# Front ends. The writers below are harness code, the exact inverses of the
# port's importers (cuadmm_tpu_torch/io/): a file they write imports back
# into the Problem it was written from (tests/test_torch_importers.py uses
# them too). Neither package has writers for these formats.

ROOT = Path(__file__).resolve().parent
FE_DIR = ROOT / "build" / "frontends"  # the phase's files; removed at its end
CERT_LP, CERT_FREE = 20, 3  # the certified SDP's LP part (1x1 blocks) and free variables
CERT_PSD = [("s", 6), ("s", 4)]
CLI_ARGS = ("--switch-admm", "0", "--check-every", "100", "--max-iter", "300", "--quiet")
CLI_REL_TOL = 1e-10  # the CLI subprocess's X_opt.txt against the in-process run
TEXT_REL_TOL = 1e-15  # a text format's values against the generator's (.mat: exact)
FE_GRID_ITERS = 200
RESUME_MAX_ITERS = 60  # tests/test_compat.py:48
SUBPROCESS_TIMEOUT_S = 300


def certified_lp_free(fmt: str, seed: int = 11):
    """A certified random SDP with an LP part (CERT_LP 1x1 blocks) and a
    free part (CERT_FREE variables), its blocks in the order ``fmt``'s
    importer makes: SeDuMi (and TXT, cuADMM .mat) free, LP, PSD; MOSEK PSD,
    LP, free; SDPA, which has no free variables, PSD and LP only."""
    lp, free = [("s", 1)] * CERT_LP, [("u", CERT_FREE)]
    blk = {"sedumi": free + lp + CERT_PSD, "mosek": CERT_PSD + lp + free, "sdpa": CERT_PSD + lp}[fmt]
    return random_certified_sdp(blk, con_num=30, seed=seed)


def _svec_layout(blk) -> tuple:
    """Per svec position: its block, and its row k >= column l in the block
    (k = l for a free variable)."""
    bid, ks, ls = [], [], []
    for b, (t, n) in enumerate(blk):
        k, l = np.tril_indices(n) if t == "s" else (np.arange(n), np.arange(n))
        bid.append(np.full(len(k), b))
        ks.append(k)
        ls.append(l)
    return np.concatenate(bid), np.concatenate(ks), np.concatenate(ls)


def _exact_split(v: np.ndarray, scale: float) -> tuple:
    """(w1, w2) with w1 * scale + w2 * scale == v exactly in floating point.
    An importer multiplies an off-diagonal entry by ``scale`` and sums the
    entries that land on one svec position, so a value that one product
    cannot reach is written as two entries (w2 is 0 where one suffices)."""
    w1 = v / scale
    w2 = (v - w1 * scale) / scale
    check(np.array_equal(w1 * scale + w2 * scale, v), "no exact two-entry split")
    return w1, w2


def write_sdpa(prob: Problem, path: Path) -> None:
    """SDPA sparse format (.dat-s; gzip when the name ends in .gz). A run of
    1x1 blocks is one diagonal (LP) block of negative size; every matrix is
    negated and an off-diagonal entry divided by sqrt(2)
    (cuadmm_tpu_torch/io/sdpa.py). Values print with 17 digits."""
    check(all(t == "s" for t, _ in prob.blk), "SDPA has no free variables")
    sizes, sdpa_blk, lp_pos = [], [], []
    for _, n in prob.blk:
        if n == 1 and sizes and sizes[-1] < 0:
            sizes[-1] -= 1
        else:
            sizes.append(-1 if n == 1 else n)
        sdpa_blk.append(len(sizes))
        lp_pos.append(-sizes[-1] if n == 1 else 0)
    bid, k, l = _svec_layout(prob.blk)
    lp = np.array([n == 1 for _, n in prob.blk])[bid]
    i = np.where(lp, np.asarray(lp_pos)[bid], k + 1)
    j = np.where(lp, i, l + 1)
    scale = np.where(k == l, -1.0, -1.0 / SQRT2)
    pos = np.concatenate([prob.C_indices, prob.At_rows]).astype(np.int64)
    matno = np.concatenate([np.zeros(len(prob.C_indices), np.int64), prob.At_cols.astype(np.int64) + 1])
    val = np.concatenate([prob.C_vals, prob.At_vals]) * scale[pos]
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(f"{prob.con_num}\n{len(sizes)}\n{' '.join(map(str, sizes))}\n")
        f.write(" ".join(f"{x:.17g}" for x in -prob.dense_b()) + "\n")
        ent = np.column_stack([matno, np.asarray(sdpa_blk)[bid[pos]], i[pos], j[pos]])
        f.writelines(f"{a} {b} {c} {d} {x:.17g}\n" for (a, b, c, d), x in zip(ent.tolist(), val.tolist()))


def write_sedumi(prob: Problem, path: Path) -> None:
    """SeDuMi .mat (A, b, c, K): a leading free block is K.f, the 1x1 blocks
    after it K.l, the other blocks K.s, each an n x n column-major section;
    an off-diagonal svec value goes to its two mirrored columns
    (cuadmm_tpu_torch/io/sedumi.py folds them back with half of sqrt(2))."""
    blk = prob.blk
    first = 1 if blk[0][0] == "u" else 0
    l_end = first
    while l_end < len(blk) and blk[l_end] == ("s", 1):
        l_end += 1
    check(all(t == "s" for t, _ in blk[first:]), "SeDuMi: one free block, first")
    square = np.array([b >= l_end for b in range(len(blk))])
    width = np.array([n * n if sq else n for (_, n), sq in zip(blk, square)])
    off = np.concatenate([[0], np.cumsum(width)[:-1]])
    size = np.array([n for _, n in blk])
    bid, k, l = _svec_layout(blk)
    col = np.where(square[bid], off[bid] + l * size[bid] + k, off[bid] + k)
    mirror = off[bid] + k * size[bid] + l
    n_cols = int(width.sum())

    def columns(pos, v):  # sedumi columns and values of svec entries
        diag = k[pos] == l[pos]
        w1, w2 = _exact_split(v[~diag], SQRT2 / 2.0)
        keep = w2 != 0
        cols = np.concatenate([col[pos[diag]], col[pos[~diag]], mirror[pos[~diag]][keep]])
        return cols, np.concatenate([v[diag], w1, w2[keep]]), diag, keep

    r = prob.At_rows.astype(np.int64)
    cols, vals, diag, keep = columns(r, prob.At_vals)
    con = prob.At_cols.astype(np.int64)
    rows = np.concatenate([con[diag], con[~diag], con[~diag][keep]])
    A = sp.csc_matrix((vals, (rows, cols)), shape=(prob.con_num, n_cols))
    c = np.zeros(n_cols)
    c_cols, c_vals, _, _ = columns(prob.C_indices.astype(np.int64), prob.C_vals)
    c[c_cols] = c_vals
    K = {"f": float(blk[0][1] if first else 0), "l": float(l_end - first),
         "s": np.array([n for _, n in blk[l_end:]], dtype=np.float64)}
    sio.savemat(path, {"A": A, "b": prob.dense_b()[:, None], "c": c[:, None], "K": K})


def write_mosek(prob: Problem, path: Path) -> None:
    """MOSEK 'prob' struct .mat: the PSD blocks as bar variables given by
    their lower triangles (subk >= subl, an off-diagonal entry standing for
    both mirrored positions), a trailing free block as scalar variables with
    infinite bounds, blc = buc = b (cuadmm_tpu_torch/io/mosek.py)."""
    blk = prob.blk
    n_scalar = blk[-1][1] if blk[-1][0] == "u" else 0
    psd = blk[:-1] if n_scalar else blk
    check(all(t == "s" for t, _ in psd), "MOSEK: PSD blocks, then one free block")
    bar_len = sum(n * (n + 1) // 2 for _, n in psd)
    bid, k, l = _svec_layout(blk)

    def triplets(pos, v):  # (index into pos, subj, subk, subl, val), 1-based
        diag = k[pos] == l[pos]
        w1, w2 = _exact_split(v[~diag], SQRT2)
        keep = w2 != 0
        idx = np.concatenate([np.nonzero(diag)[0], np.nonzero(~diag)[0], np.nonzero(~diag)[0][keep]])
        val = np.concatenate([v[diag], w1, w2[keep]])
        p = pos[idx]
        return idx, bid[p] + 1.0, k[p] + 1.0, l[p] + 1.0, val

    r = prob.At_rows.astype(np.int64)
    bar = r < bar_len
    idx, subj, subk, subl, val = triplets(r[bar], prob.At_vals[bar])
    out = {"bardim": np.array([n for _, n in psd], dtype=np.float64),
           "blc": prob.dense_b(), "buc": prob.dense_b(),
           "bara": {"subi": prob.At_cols[bar][idx] + 1.0, "subj": subj, "subk": subk,
                    "subl": subl, "val": val}}
    cpos = prob.C_indices.astype(np.int64)
    cbar = cpos < bar_len
    _, subj, subk, subl, val = triplets(cpos[cbar], prob.C_vals[cbar])
    out["barc"] = {"subj": subj, "subk": subk, "subl": subl, "val": val}
    if n_scalar:
        out["a"] = sp.csc_matrix((prob.At_vals[~bar], (prob.At_cols[~bar], r[~bar] - bar_len)),
                                 shape=(prob.con_num, n_scalar))
        out["c"] = prob.dense_C()[bar_len:]
        out["blx"] = np.full(n_scalar, -np.inf)
        out["bux"] = np.full(n_scalar, np.inf)
    sio.savemat(path, {"prob": out})


def write_admm_mat(prob: Problem, path: Path) -> None:
    """cuADMM .mat: At (vec_len x con_num, sparse), b and C as dense columns
    (cuadmm_tpu_torch/io/admm_mat.py)."""
    At = sp.csc_matrix((prob.At_vals, (prob.At_rows, prob.At_cols)), shape=(prob.vec_len, prob.con_num))
    sio.savemat(path, {"At": At, "b": prob.dense_b()[:, None], "C": prob.dense_C()[:, None]})


def problem_mismatch(got: Problem, want: Problem, rtol: float = 0.0) -> list:
    """The Problem fields (name aside) where ``got`` differs from ``want``:
    indices and structure exactly, values exactly or within ``rtol``."""
    bad = [f for f in ("blk", "con_num") if getattr(got, f) != getattr(want, f)]
    for f in ("At_rows", "At_cols", "b_indices", "C_indices"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            bad.append(f)
    for f in ("At_vals", "b_vals", "C_vals"):
        g, w = getattr(got, f), getattr(want, f)
        if g.shape != w.shape or not np.all(np.abs(g - w) <= rtol * np.abs(w)):
            bad.append(f)
    bad += [f for f in ("X0", "y0", "S0", "sig0") if getattr(got, f) is not None]
    return bad


FORMATS = {  # format: (file suffix, text?)
    "txt": ("", True), "sdpa": (".dat-s", True), "sdpa_gz": (".dat-s.gz", True),
    "sedumi": ("_sedumi.mat", False), "mosek": ("_mosek.mat", False), "admm_mat": ("_admm.mat", False),
}


def _fits(fmt: str, blk) -> bool:
    """Whether ``fmt`` holds ``blk`` in this order: SDPA has no free
    variables, SeDuMi's free block comes first and MOSEK's last."""
    free = [b for b, (t, _) in enumerate(blk) if t == "u"]
    if fmt.startswith("sdpa"):
        return not free
    if fmt == "sedumi":
        return free in ([], [0])
    if fmt == "mosek":
        return free in ([], [len(blk) - 1])
    return True


WRITERS = {"sdpa": write_sdpa, "sdpa_gz": write_sdpa, "sedumi": write_sedumi,
           "mosek": write_mosek, "admm_mat": write_admm_mat}


def write_file(prob: Problem, fmt: str, stem: Path) -> Path:
    """``prob`` as ``fmt`` at ``stem`` + the format's suffix."""
    check(_fits(fmt, prob.blk), f"{fmt} cannot hold the block order {prob.blk[:4]}...")
    path = Path(f"{stem}{FORMATS[fmt][0]}")
    if fmt == "txt":
        prob.to_txt(str(path))
    else:
        WRITERS[fmt](prob, path)
    return path


def import_file(fmt: str, path: Path, blk) -> Problem:
    """``path`` through the port's importer for ``fmt``."""
    if fmt == "txt":
        return Problem.from_txt(str(path))
    if fmt.startswith("sdpa"):
        return load_sdpa(str(path))
    if fmt == "sedumi":
        return load_sedumi_mat(str(path))
    if fmt == "mosek":
        return load_mosek_mat(str(path))
    return load_admm_mat(str(path), blk=blk)


def _file_mb(path: Path) -> float:
    files = path.iterdir() if path.is_dir() else [path]
    return sum(f.stat().st_size for f in files) / 1e6


def import_round_trip(prob: Problem, stem: Path, what: str) -> dict:
    """Write ``prob`` in every format that holds it, import each back with the port's importer, and hold every field to the
    generator's: exactly for .mat, within TEXT_REL_TOL for text. Returns
    each format's import seconds and file MB."""
    out = {}
    for fmt in filter(lambda f: _fits(f, prob.blk), FORMATS):
        path = write_file(prob, fmt, stem)
        t0 = time.perf_counter()
        got = import_file(fmt, path, prob.blk)
        seconds = time.perf_counter() - t0
        bad = problem_mismatch(got, prob, TEXT_REL_TOL if FORMATS[fmt][1] else 0.0)
        check(not bad, f"{what} from {fmt}: fields {bad} differ from the generator's")
        out[fmt] = dict(seconds=seconds, mb=_file_mb(path))
    return out


def _built_kernels() -> dict:
    return {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")}


def run_module(*args: str) -> tuple:
    """``python -m <args>`` from the checkout's root: (exit code, output,
    wall seconds). The child is killed at SUBPROCESS_TIMEOUT_S."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


class _observe_solvers:
    """Within the block, record each SDPSolver that ``cuadmm`` makes, so its
    resolved normal solver, sweeps and buckets can be gated."""

    def __enter__(self):
        self.made, self._orig = [], compat.SDPSolver
        made = self.made

        class Recording(self._orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        compat.SDPSolver = Recording
        return self.made

    def __exit__(self, *exc):
        compat.SDPSolver = self._orig


def _at(prob: Problem) -> sp.coo_matrix:
    return sp.coo_matrix((prob.At_vals, (prob.At_rows, prob.At_cols)), shape=(prob.vec_len, prob.con_num))


def frontends_cli(standin_dir: Path, standin: Problem) -> dict:
    """``python -m cuadmm_tpu_torch info`` and ``solve`` on the stand-in's
    TXT directory as subprocesses, against an in-process run."""
    rc, out, info_s = run_module("cuadmm_tpu_torch", "info", str(standin_dir))
    check(rc == 0 and f"constraints: {standin.con_num}" in out, f"cli info: rc {rc}: {out[-2000:]}")
    before = _built_kernels()
    rc, out, solve_s = run_module("cuadmm_tpu_torch", "solve", str(standin_dir), "--device", "cuda", *CLI_ARGS)
    check(rc in (0, 2), f"cli solve: exit code {rc}: {out[-2000:]}")
    check(_built_kernels() == before, "cli solve: the subprocess rebuilt a kernel")
    x_cli = txtio.read_dense_vector(str(standin_dir / "X_opt.txt"))
    check(x_cli.shape == (standin.vec_len,) and bool(np.all(np.isfinite(x_cli))), "cli solve: bad X_opt.txt")
    # The CLI's defaults for the flags not given (cuadmm_tpu_torch/cli.py).
    cfg = SolverConfig(max_iter=300, stop_tol=1e-3, sig=1.0, switch_admm=0, check_every=100, verbose=False)
    res = SDPSolver(Problem.from_txt(str(standin_dir)), cfg, device="cuda").solve()
    check(rc == (0 if res.converged else 2), f"cli solve: exit code {rc}, in-process converged={res.converged}")
    rel = float(np.max(np.abs(x_cli - res.X)) / np.max(np.abs(res.X)))
    check(rel <= CLI_REL_TOL, f"cli solve: X_opt.txt {rel:.2e} from the in-process run")
    return dict(info_wall_s=info_s, solve_wall_s=solve_s, exit_code=rc, x_rel_to_in_process=rel,
                iterations_in_process=res.iterations, converged_in_process=res.converged)


def frontends_grid_cuadmm(grid_sedumi: Path) -> tuple:
    """The grid imported from SeDuMi through ``cuadmm`` (jacobi, plain ADMM,
    stop_tol 0): gated as the grid phase gates. Returns (line, launches)."""
    prob = load_sedumi_mat(str(grid_sedumi))
    reset_counts()
    t0 = time.perf_counter()
    with _observe_solvers() as made:
        X, y, S, info = cuadmm(0, FE_GRID_ITERS, 0.0, _at(prob), prob.dense_b(), prob.dense_C(),
                               [n for _, n in prob.blk], sig=1.0, device="cuda", verbose=False,
                               check_every=100, switch_admm=0, projection="jacobi")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(COUNTS)
    (solver,) = made
    neq = solver.params.neq
    what = "front ends: grid through cuadmm"
    check(neq.mode == "precond" and neq.factor.inv_l.shape[0] == GRID_N_PAD, f"{what}: {neq.mode!r}")
    buckets = tuple((bk.n, bk.count) for bk in solver.structure.buckets)
    check(buckets == GRID_BUCKETS and set(_methods(solver)) == {"jacobi"}, f"{what}: buckets {buckets}")
    check(info["iter_num"] == FE_GRID_ITERS and len(info["errRp_arr"]) == FE_GRID_ITERS, f"{what}: iterations")
    err = info["errRp_arr"]
    finite = all(np.all(np.isfinite(a)) for a in (X, y, S, err, info["errRd_arr"], info["relgap_arr"]))
    check(finite and X.shape == (prob.vec_len,), f"{what}: non-finite output")
    check(err[-1] < err[0], f"{what}: errRp did not decrease ({err[0]} -> {err[-1]})")
    _gate_launches(solver, counts, FE_GRID_ITERS, 1, what, built=True)
    line = dict(it_per_s=FE_GRID_ITERS / info["total_time"], wall_s=wall_s, applies=neq.applies,
                launches=counts, errRp_first=float(err[0]), errRp_last=float(err[-1]))
    return line, counts


def frontends_certified() -> dict:
    """The certified SDP (PSD and LP blocks) imported from SDPA through
    ``cuadmm`` to 1e-6, then a checkpoint round trip that resumes within
    RESUME_MAX_ITERS; the same with the free part, imported from SeDuMi,
    through SDPSolver."""
    out = {}
    kw = dict(device="cuda", verbose=False, check_every=25, switch_admm=10**9)
    prob_lp, *_, opt = certified_lp_free("sdpa")
    path = FE_DIR / "certified_lp.dat-s"
    write_sdpa(prob_lp, path)
    prob = load_sdpa(str(path))
    args = (_at(prob), prob.dense_b(), prob.dense_C(), [n for _, n in prob.blk])
    X, y, S, info = cuadmm(0, 6000, 1e-6, *args, sig=1.0, **kw)
    gap = abs(info["pobj_arr"][-1] - opt) / (1 + abs(opt))
    check(info["errRp_arr"][-1] < 1e-6 and gap < 1e-4, f"certified through cuadmm: gap {gap:.2e}")
    ck = FE_DIR / "certified_lp.npz"
    save_checkpoint(str(ck), types.SimpleNamespace(X=X, y=y, S=S, sig=float(info["sig_arr"][-1])))
    kw_ck = load_checkpoint(str(ck))
    X2, _, _, info2 = cuadmm(0, 2000, 1e-6, *args, X0=kw_ck["X0"], y0=kw_ck["y0"], S0=kw_ck["S0"],
                             sig=kw_ck["sig"], **kw)
    # Stopping before max_iter with finite rows is convergence (0: at the start).
    check(info2["iter_num"] <= RESUME_MAX_ITERS and np.all(np.isfinite(info2["errRp_arr"]))
          and np.all(np.isfinite(X2)), f"certified through cuadmm: resumed in {info2['iter_num']}")
    out["cuadmm lp"] = dict(iterations=int(info["iter_num"]), rel_gap=gap, resumed_iterations=int(info2["iter_num"]))

    prob_free, *_, opt = certified_lp_free("sedumi")
    path = FE_DIR / "certified_free_sedumi.mat"
    write_sedumi(prob_free, path)
    prob = load_sedumi_mat(str(path))
    cfg = SolverConfig(verbose=False, check_every=25, switch_admm=10**9)
    solver = SDPSolver(prob, cfg, device="cuda")
    part = solver.solve(max_iter=6000, stop_tol=1e-4)
    save_checkpoint(str(FE_DIR / "part.npz"), part)
    res = solver.solve(max_iter=6000, stop_tol=1e-6)
    gates = _certified_gates(res, opt, "certified lp + free from SeDuMi")
    save_checkpoint(str(FE_DIR / "done.npz"), res)
    resumed = {}
    for name in ("done", "part"):  # each in a fresh solver
        r = SDPSolver(prob, cfg, device="cuda").solve(max_iter=6000, stop_tol=1e-6,
                                                      **load_checkpoint(str(FE_DIR / f"{name}.npz")))
        check(r.converged, f"certified lp + free: the run resumed from {name} did not converge")
        resumed[name] = r.iterations
    # From the 1e-4 checkpoint the resumed run takes about what the
    # uninterrupted run took past that point (tests/test_torch_compat.py).
    rest = res.iterations - part.iterations
    check(resumed["done"] <= RESUME_MAX_ITERS and abs(resumed["part"] - rest) <= RESUME_MAX_ITERS,
          f"certified lp + free: resumed in {resumed} (uninterrupted past 1e-4: {rest})")
    out["SDPSolver lp + free"] = dict(gates, iterations_to_1e_4=part.iterations, resumed_iterations=resumed)
    return out


def frontends_examples(standin_mosek: Path) -> dict:
    """The ported examples as subprocesses on the card, all at once."""
    ex = "cuadmm_tpu_torch.examples."
    runs = {  # name: (arguments, exit code, text the output must hold)
        "minimizer": ((ex + "minimizer", "--device", "cuda"), 0, "iterations:"),
        "maxcut_demo": ((ex + "maxcut_demo", "--device", "cuda"), 0, "chordal: Solver ended: converged"),
        "mosek_pipeline": ((ex + "mosek_pipeline", str(standin_mosek), "--device", "cuda"), 0, "pobj"),
        "mosek_pipeline, no path": ((ex + "mosek_pipeline",), 2, "needs the path"),
    }
    with ThreadPoolExecutor(len(runs)) as pool:
        done = dict(zip(runs, pool.map(lambda r: run_module(*r[0]), runs.values())))
    for name, (rc, out, _) in done.items():
        _, want_rc, want_text = runs[name]
        check(rc == want_rc and want_text in out, f"example {name}: rc {rc}: {out[-2000:]}")
    return {name: dict(exit_code=rc, wall_s=s) for name, (rc, _, s) in done.items()}


def frontends(standin: Problem) -> dict:
    """Front ends on the card: every importer at the stand-in's and the
    grid's size, the CLI as a subprocess, ``cuadmm`` on the grid through K1
    and K4, the certified SDP with checkpoints, and the examples. Returns
    the grid run's K1 and K4 launches."""
    shutil.rmtree(FE_DIR, ignore_errors=True)
    FE_DIR.mkdir(parents=True)
    try:
        grid = grid_problem()
        importers = dict(grid=import_round_trip(grid, FE_DIR / "grid", "grid"),
                         standin=import_round_trip(standin, FE_DIR / "standin", "stand-in"))
        for fmt in ("sedumi", "mosek", "sdpa"):
            prob = certified_lp_free(fmt)[0]
            import_round_trip(prob, FE_DIR / f"certified_{fmt}", f"certified ({fmt} order)")
        del grid
        cli = frontends_cli(FE_DIR / "standin", standin)
        grid_line, counts = frontends_grid_cuadmm(Path(f"{FE_DIR / 'grid'}_sedumi.mat"))
        cert = frontends_certified()
        examples = frontends_examples(Path(f"{FE_DIR / 'standin'}_mosek.mat"))
    finally:
        shutil.rmtree(FE_DIR, ignore_errors=True)
    emit("frontends", dict(card=report["card"], importers_at_grid=importers["grid"],
                           importers_at_standin=importers["standin"], cli=cli, cuadmm_grid=grid_line,
                           certified=cert, examples=examples))
    return counts


# ---------------------------------------------------------------------------
# Several devices (cuadmm_tpu_torch/parallel/). One card: one rank over
# NCCL in this process, then two ranks sharing the card over gloo (NCCL
# refuses two ranks on one GPU), spawned once for every run.

MESH_RANKS = 2
# (warm, timed) iterations; the large grid's init already ran its solves (calibration).
MESH_ITERS = dict(grid=(20, 100), large=(0, 20), quasar=(2, 10), batched=(BIG_BLOCK_WARM, BIG_BLOCK_ITERS))
MESH_TIMEOUT_S = 600
# A split bucket against the whole one: other batch sizes, the same polynomial in the same precision
# (QUASAR's one rank takes the poly filter's one-triangle route, its ranks the row-split GEMMs).
MESH_ONE_RANK_REL = 1e-9
LARGE_GRID_SLAB = {1: (67, 67, 1024, 1024), 2: (68, 34, 1024, 1024)}  # by ranks: nb a multiple of them
POLY_ALL_REDUCES = 40  # f64 schedule: 13 steps of 3 row-split products, and the last product


def mesh_one_rank_nccl(large: Problem) -> dict:
    """One rank over NCCL in this process (a world of 1 from a FileStore
    under build/): the certified SDP through normal_solver "sharded" to
    1e-6 (the certified gate), its all_reduces per normal solve and per
    run; ``dryrun_multichip(1, "nccl")``; and the large grid through
    "sharded" at full size (``rank_jobs.sharded_large``: nb 67, the whole
    18.8 GB slab on the card, NCCL's broadcasts of up to 281 MB a
    Cholesky step and 3 nb all_reduces a sweep), held by ``mesh`` to the
    banded run's errRp."""
    store = ROOT / "build" / "mesh_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh1 = make_mesh(1, "nccl")
        prob, _, _, _, opt = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
        solver = SDPSolver(prob, SolverConfig(verbose=False, check_every=25, switch_admm=10**9,
                                              normal_solver="sharded"), mesh=mesh1)
        neq = solver.params.neq
        check(neq.mode == "sharded", f"mesh nccl: resolved to {neq.mode!r}")
        rhs = aat_matvec(neq.sparse_a, torch.as_tensor(np.random.default_rng(1).standard_normal(prob.con_num),
                                                       device="cuda"))
        COUNTS.update(all_reduce=0, broadcast=0)
        resid = float(neq.residual_norm(rhs, neq.solve(rhs)))
        per_solve = {k: COUNTS[k] for k in ("all_reduce", "broadcast")}
        check(resid < PROBE_TOL["float64"], f"mesh nccl: probe residual {resid:.3e}")
        COUNTS.update(all_reduce=0, broadcast=0)
        res = solver.solve(max_iter=6000, stop_tol=1e-6)
        run = {k: COUNTS[k] for k in ("all_reduce", "broadcast")}
        gates = _certified_gates(res, opt, "mesh nccl sharded")
        dry = dryrun_multichip(1, "nccl")[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lg = rank_jobs.sharded_large(mesh1, large, *MESH_ITERS["large"])
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return dict(gates, mode=neq.mode, grid=list(neq.factor.grid.shape), applies=neq.applies, residual_norm=resid,
                collectives_per_normal_solve=per_solve, collectives_per_run=run,
                dryrun=dict(iterations=dry["iterations"], pobj=dry["pobj"], optimum=dry["optimum"],
                            tri_solve_all_reduces=dry["tri_solve_all_reduces"]),
                large=lg)


def _ranks_agree(ranks: list, what: str) -> None:
    """Every rank's X, y, S and info rows are bitwise rank 0's."""
    def arrays(r):
        return [np.asarray(r[k]) for k in ("X", "y", "S")] + [np.asarray(r["info"][f]) for f in
                                                               ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")]
    for i, r in enumerate(ranks[1:], 1):
        same = all(a.tobytes() == b.tobytes() for a, b in zip(arrays(r), arrays(ranks[0])))
        check(same, f"{what}: rank {i}'s iterate differs from rank 0's")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _large_report(lg: list, l1, rel: float, iters: int) -> dict:
    """The large grid's "sharded" runs (one a rank) for the mesh line."""
    return dict(
        iterations=iters, it_per_s=[iters / lr["seconds"] for lr in lg], errRp=lg[0]["errRp"], banded_errRp=l1.errRp,
        rel=rel, slab=lg[0]["slab_shape"], slab_gb_per_rank=lg[0]["slab_gb"], applies=lg[0]["applies"],
        eps_used=lg[0]["eps_used"], init_s=[lr["init_s"] for lr in lg],
        factorize_s=[lr["init_breakdown"]["neq.sharded_factorize"] for lr in lg],
        calibrate_s=[lr["init_breakdown"]["neq.calibrate"] for lr in lg],
        normal_solve_ms=[lr["solve_ms"] for lr in lg], collectives_per_normal_solve=lg[0]["solve_counts"],
        all_reduces_per_it=lg[0]["counts"]["all_reduce"] / iters, residual_norm=lg[0]["residual_norm"],
        methods=lg[0]["methods"], peak_mem_gb_init=[lr["peak_mem_gb_init"] for lr in lg],
        peak_mem_gb=[lr["peak_mem_gb"] for lr in lg])


def mesh(large: Problem, quasar_prob: Problem, family: list, single_errrp: list) -> dict:
    """The several-devices path on the card: ``mesh_one_rank_nccl``, then
    MESH_RANKS gloo ranks on cuda:0 in one spawn (rank_jobs.chip_mesh) for
    the grid (jacobi: K4 on every rank's share of every bucket, K1 on every
    sweep), the large grid through "sharded", QUASAR-500 with its block
    split by rows under "poly", and the batched stand-ins, each held
    against a one-rank run in this process (the grid and QUASAR to 1e-9,
    the large grid to a banded run's errRp at 1e-6, the batch to the
    batched phase's single runs at 1e-9), every rank's iterate bitwise
    equal. The NCCL rank's large grid is held to the same banded run.
    Returns the ranks' K1 and K4 launches by run."""
    nccl = mesh_one_rank_nccl(large)
    nccl_large = nccl.pop("large")
    grid = grid_problem()
    admm = dict(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0)
    # One-rank references, each run as the ranks run it.
    solver = SDPSolver(grid, SolverConfig(projection="jacobi", **admm), device="cuda")
    g1, g1_s, _ = rank_jobs.continued_run(solver, *MESH_ITERS["grid"])
    solver = SDPSolver(large, SolverConfig(projection="auto", normal_solver="banded", **admm), device="cuda")
    l1 = solver.solve(max_iter=MESH_ITERS["large"][1], stop_tol=0.0)
    solver = SDPSolver(quasar_prob, SolverConfig(projection="poly", **admm), device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    q1 = solver.solve(max_iter=MESH_ITERS["quasar"][1], stop_tol=0.0)
    torch.cuda.synchronize()
    q1_counts, q1_tri = dict(COUNTS), MESH_ITERS["quasar"][1] * _tri_products_per_it(solver)
    check(q1_counts["poly_tri_products"] == q1_tri and q1_counts["sym_mirror"] == q1_tri,
          f"mesh quasar one rank: {q1_counts['poly_tri_products']} triangle products and "
          f"{q1_counts['sym_mirror']} mirror launches, not {q1_tri}")
    del solver
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(rank_jobs.chip_mesh, MESH_RANKS, "gloo", "cuda:0",
                      args=(grid, large, quasar_prob, family, MESH_ITERS), timeout_s=MESH_TIMEOUT_S, threads=None)
    spawn_s = time.perf_counter() - t0
    for key in ("grid", "large", "quasar"):
        _ranks_agree([r[key] for r in ranks], f"mesh {key}")
    for i in range(len(family)):
        _ranks_agree([r["batched"]["results"][i] for r in ranks], f"mesh batched instance {i}")
    warm, iters = MESH_ITERS["large"]
    rel = _rel(nccl_large["errRp"], l1.errRp)
    check(nccl_large["mode"] == "sharded" and tuple(nccl_large["slab_shape"]) == LARGE_GRID_SLAB[1],
          f"mesh nccl large grid: {nccl_large['mode']} slab {nccl_large['slab_shape']}")
    check(nccl_large["residual_norm"] < PROBE_TOL["float64"],
          f"mesh nccl large grid: probe residual {nccl_large['residual_norm']:.3e}")
    _gates(types.SimpleNamespace(**{k: nccl_large[k] for k in ("errRp", "errRd", "relgap", "diverged", "info", "X")}),
           large.vec_len, "mesh nccl large grid")
    check(rel <= ERRRP_AGREE, f"mesh nccl large grid: errRp {nccl_large['errRp']!r} against banded {l1.errRp!r}")
    nccl["large grid sharded"] = _large_report([nccl_large], l1, rel, iters)
    out = dict(card=report["card"], ranks=MESH_RANKS, backend="gloo", spawn_s=spawn_s, nccl_one_rank=nccl)

    warm, iters = MESH_ITERS["grid"]
    g = [r["grid"] for r in ranks]
    rel = _rel(g[0]["errRp"], g1.errRp)
    for r, gr in enumerate(g):
        check(gr["mode"] == "precond" and gr["n_pad"] == GRID_N_PAD, f"mesh grid: {gr['mode']} n_pad {gr['n_pad']}")
        check(gr["counts"]["k4"] == iters * len(GRID_BUCKETS),
              f"mesh grid rank {r}: K4 launched {gr['counts']['k4']} times, not {iters} x {len(GRID_BUCKETS)}")
        check(gr["counts"]["k1"] == iters * gr["applies"],
              f"mesh grid rank {r}: K1 launched {gr['counts']['k1']} times, not {iters} x {gr['applies']}")
    check(rel <= MESH_ONE_RANK_REL, f"mesh grid: errRp {g[0]['errRp']!r} against one rank's {g1.errRp!r}")
    out["grid jacobi"] = dict(
        iterations=f"{warm} warm + {iters} timed", it_per_s=[iters / gr["seconds"] for gr in g],
        one_rank_it_per_s=iters / g1_s, errRp=g[0]["errRp"], one_rank_errRp=g1.errRp, rel=rel,
        local_buckets=[gr["local_buckets"] for gr in g], counts=[gr["counts"] for gr in g],
        all_reduces_per_it=g[0]["counts"]["all_reduce"] / iters, peak_mem_gb=[gr["peak_mem_gb"] for gr in g])

    warm, iters = MESH_ITERS["large"]
    lg = [r["large"] for r in ranks]
    rel = _rel(lg[0]["errRp"], l1.errRp)
    for r, lr in enumerate(lg):
        check(lr["mode"] == "sharded" and tuple(lr["slab_shape"]) == LARGE_GRID_SLAB[MESH_RANKS],
              f"mesh large grid rank {r}: {lr['mode']} slab {lr['slab_shape']}")
        check(lr["residual_norm"] < PROBE_TOL["float64"], f"mesh large grid: probe residual {lr['residual_norm']:.3e}")
    _gates(types.SimpleNamespace(**{k: lg[0][k] for k in ("errRp", "errRd", "relgap", "diverged", "info", "X")}),
           large.vec_len, "mesh large grid")
    check(rel <= ERRRP_AGREE, f"mesh large grid: errRp {lg[0]['errRp']!r} against banded {l1.errRp!r}")
    out["large grid sharded"] = _large_report(lg, l1, rel, iters)

    warm, iters = MESH_ITERS["quasar"]
    qs = [r["quasar"] for r in ranks]
    rel = _rel(qs[0]["errRp"], q1.errRp)
    for r, qr in enumerate(qs):
        check(qr["mode"] == "split" and qr["split_p"] == QUASAR_P, f"mesh quasar: {qr['mode']} p {qr['split_p']}")
        check(qr["counts"]["k1"] == iters * qr["applies"],
              f"mesh quasar rank {r}: K1 launched {qr['counts']['k1']} times, not {iters} x {qr['applies']}")
        check(qr["counts"]["all_reduce"] == iters * POLY_ALL_REDUCES,
              f"mesh quasar rank {r}: {qr['counts']['all_reduce']} all_reduces in {iters} projections")
        check(qr["counts"]["poly_tri_products"] == 0 and qr["counts"]["sym_mirror"] == 0,
              f"mesh quasar rank {r}: the row split took the one-triangle route ({qr['counts']})")
    check(rel <= MESH_ONE_RANK_REL, f"mesh quasar: errRp {qs[0]['errRp']!r} against one rank's {q1.errRp!r}")
    out["quasar poly"] = dict(
        iterations=iters, it_per_s=[iters / qr["seconds"] for qr in qs], errRp=qs[0]["errRp"],
        one_rank_errRp=q1.errRp, rel=rel, all_reduces_per_projection=qs[0]["counts"]["all_reduce"] / iters,
        one_rank_counts={k: q1_counts[k] for k in ("k1", "poly_tri_products", "sym_mirror")},
        counts=[qr["counts"] for qr in qs], peak_mem_gb=[qr["peak_mem_gb"] for qr in qs])

    warm, iters = MESH_ITERS["batched"]
    bs = [r["batched"] for r in ranks]
    rels = [_rel(res["errRp"], e) for res, e in zip(bs[0]["results"], single_errrp)]
    for r, br in enumerate(bs):
        share = br["local"][1] - br["local"][0]
        check(share == len(family) // MESH_RANKS, f"mesh batched rank {r}: instances {br['local']}")
        check(br["counts"]["k1"] == iters * br["applies"],  # K1 over the rank's share, once a sweep
              f"mesh batched rank {r}: K1 launched {br['counts']['k1']} times, not {iters} x {br['applies']}")
    for i, (res, rl) in enumerate(zip(bs[0]["results"], rels)):
        check(res["iterations"] == iters and rl <= MESH_ONE_RANK_REL,
              f"mesh batched instance {i}: errRp {res['errRp']!r} against its single run's (rel {rl:.2e})")
    out["batched"] = dict(
        instances=len(family), per_rank=[br["local"] for br in bs],
        instance_it_per_s=len(family) * iters / max(br["seconds"] for br in bs), errRp_rel_to_single=rels,
        counts=[br["counts"] for br in bs], peak_mem_gb=[br["peak_mem_gb"] for br in bs])
    emit("mesh", out)
    return dict(grid_k1=sum(gr["counts"]["k1"] for gr in g), grid_k4=sum(gr["counts"]["k4"] for gr in g),
                quasar_k1=sum(qr["counts"]["k1"] for qr in qs), batched_k1=sum(br["counts"]["k1"] for br in bs),
                quasar_one_rank_mirror=q1_counts["sym_mirror"])


def timed_phase(fn, *args):
    """Run one phase and record its wall seconds in the report."""
    t0 = time.perf_counter()
    out = fn(*args)
    report.setdefault("phase_s", {})[fn.__name__] = time.perf_counter() - t0
    return out


def main() -> None:
    kind = card()
    timed_phase(build_kernels)
    k1 = timed_phase(compare_k1)
    k4 = timed_phase(compare_k4)
    k2k3 = timed_phase(compare_tri_stream)
    k3_seg = timed_phase(compare_segments)
    mirror = timed_phase(compare_mirror)
    ell = timed_phase(compare_ell)
    prob = standin_problem()
    k1_launches = timed_phase(standin, prob)
    k4_launches = timed_phase(grid)
    large = large_grid_problem()
    tri_launches = timed_phase(large_grid, large)
    quasar_prob = quasar_500()
    timed_phase(quasar, quasar_prob)
    cap = timed_phase(grid_past_cap)
    timed_phase(limits_phase, large, cap, quasar_prob)
    del cap
    timed_phase(g22_maxcut)
    timed_phase(standin_cg, prob)
    timed_phase(certified)
    k1_f32 = timed_phase(standin_f32, prob)
    k4_f32 = timed_phase(grid_f32)
    k3_f32 = timed_phase(large_grid_f32, large)
    timed_phase(quasar_f32, quasar_prob)
    timed_phase(certified_f32)
    k1_batched, family, single_errrp = timed_phase(batched)
    timed_phase(graphs, prob, large, quasar_prob, family)
    fe = timed_phase(frontends, prob)
    ms = timed_phase(mesh, large, quasar_prob, family, single_errrp)
    del large, quasar_prob, family
    emit("phase seconds", report["phase_s"])
    k1_paths = {"stand-in f64": k1_launches, "stand-in f32": k1_f32, "batched f64": k1_batched,
                "grid through cuadmm": fe["k1"], "grid jacobi mesh 2": ms["grid_k1"],
                "quasar mesh 2": ms["quasar_k1"], "batched mesh 2": ms["batched_k1"]}
    k4_paths = {"grid jacobi f64": k4_launches, "grid jacobi f32": k4_f32, "grid through cuadmm": fe["k4"],
                "grid jacobi mesh 2": ms["grid_k4"]}
    mirror_paths = {"quasar-500 auto f64": report["quasar-500 projection=auto"]["launches"]["sym_mirror"],
                    "G22-size auto f64": report["maxcut G22-size projection=auto"]["launches"]["sym_mirror"],
                    "quasar-500 poly f32": report["quasar-500 float32 projection=poly"]["launches"]["sym_mirror"],
                    "quasar one rank (mesh reference)": ms["quasar_one_rank_mirror"]}
    ell_paths = {k: v["launches"]["ell"] for k, v in report.items()
                 if isinstance(v, dict) and isinstance(v.get("launches"), dict) and "ell" in v["launches"]}
    kernels = {"kernels": [
        dict(name="fused_spd_apply", route="cuda", source="cuadmm_tpu_torch/csrc/precond_apply.cu",
             replaces="cuadmm_tpu/ops/precond_apply.py:64", launches=sum(k1_paths.values()),
             launches_by_path=k1_paths, **k1),
        dict(name="fused_spd_apply_rhs", route="cuda", source="cuadmm_tpu_torch/csrc/precond_apply.cu",
             replaces="none (K1 over B right-hand sides)",
             launches=k1_batched + ms["batched_k1"],
             launches_by_path={"batched f64": k1_batched, "batched mesh 2": ms["batched_k1"]},
             **report["k1_rhs_main"]),
        dict(name="jacobi_eigh", route="cuda", source="cuadmm_tpu_torch/csrc/jacobi_eigh.cu",
             replaces="cuadmm_tpu/ops/jacobi.py:147", launches=sum(k4_paths.values()),
             launches_by_path=k4_paths, **k4),
        dict(name="packed_solve", route="cuda", source="cuadmm_tpu_torch/csrc/tri_stream.cu",
             replaces="cuadmm_tpu/ops/tri_stream.py:264", launches=tri_launches["k2"], **k2k3["k2"]),
        # "auto" runs the large grid's band in K3's segments form; its tile
        # forms run where the segments form is off (large_grid checks both).
        dict(name="band_solve", route="cuda", source="cuadmm_tpu_torch/csrc/tri_stream.cu",
             replaces="cuadmm_tpu/ops/tri_stream.py:584", launches=tri_launches["k3"],
             launches_by_path={"large grid f64 tile forms": tri_launches["k3"]}, **k2k3["k3"]),
        dict(name="band_segments_solve", route="cuda", source="cuadmm_tpu_torch/csrc/tri_stream.cu",
             replaces="none (K3's segments form: the JAX package streams band tiles)",
             launches=tri_launches["k3_seg"] + k3_f32,
             launches_by_path={"large grid f64": tri_launches["k3_seg"], "large grid f32": k3_f32}, **k3_seg),
        dict(name="sym_mirror", route="cuda", source="cuadmm_tpu_torch/csrc/sym_mirror.cu", replaces="none",
             launches=sum(mirror_paths.values()), launches_by_path=mirror_paths, **mirror),
        dict(name="ell_gather", route="cuda", source="cuadmm_tpu_torch/csrc/ell_products.cu",
             replaces="none (the JAX package's ELL products are XLA gathers)",
             launches=sum(ell_paths.values()), launches_by_path=ell_paths, **ell),
    ]}
    report.update(kernels)
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
