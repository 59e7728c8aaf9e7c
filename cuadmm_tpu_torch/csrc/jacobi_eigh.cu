// Batched Jacobi eigendecomposition of small symmetric matrices (K4), in
// two launch plans: "warp" (one warp a matrix, cyclic-by-rows order) and
// "cta" (one thread block a matrix, round-robin parallel order).
//
// Replaces the Pallas kernel cuadmm_tpu/ops/jacobi.py::_jacobi_kernel and
// computes what it and jacobi_eigh_jnp compute: for each (n, n) matrix of
// the batch, `sweeps` sweeps over the pairs (p, q), p < q; each pair
// applies the rotation (c, s) of _rotation (the theta == 0 45-degree case
// and the |a_pq| <= eps skip included) to rows p, q of A, then to columns
// p, q of A, then to columns p, q of V. Returns w = diag(A), unsorted, and
// V with the eigenvectors in its columns. Templated on the scalar type:
// the solver's f64 state runs the double instances, the float instances
// are the TPU kernel's own dtype. Any n >= 2 in either plan (the "cta"
// plan while its shared memory fits, see cta_bytes).
//
// Which plan runs: the caller names it (ops/jacobi.py::k4_plan picks it
// from n, the batch and the card's shared memory, with thresholds
// measured on an H100 by cuadmm_tpu_torch/k4_ab.py): "warp" for n < 6,
// and for n = 6-7 past 512 matrices, where its short chains beat a
// step's fixed cost, and where the "cta" plan's shared memory does not
// fit (f64 past n = 136, f32 past n = 190 on an H100); "cta" elsewhere,
// where one matrix's chain is the kernel's time.
//
// Bound: not the card's flops or bytes. A matrix needs sweeps * n(n-1)/2
// rotations on 6n numbers each; the matrix itself is read from and written
// to device memory once (n = 64 in f64: 12 x 2016 rotations against 32 KB
// in and 33 KB out). What bounds a plan is its chain of dependent steps
// (each rotation's (c, s) needs entries the rotations before it wrote) and
// the instructions one SM issues along it.
//
// Plan "warp": sweeps * n(n-1)/2 dependent rotations, one after another
// (cyclic-by-rows: the reference's order, so the same values as
// jacobi_eigh_ref to rounding). Design:
// - One warp owns a matrix; a CTA holds up to 4 (fewer when their shared
//   memory does not fit), so every SM interleaves several chains. Lane l
//   owns indices j = l, l + 32, ...: entries (p, j) and (q, j) of the
//   rotation and entries j of eigenvectors p and q. Nothing but the 2x2
//   block (p, q) x (p, q) is shared, so a rotation needs only warp
//   barriers (__syncwarp), no block barrier.
// - A is symmetric (the caller's contract) and kept once: entry (i, j) at
//   row min(i, j). The reference's row update and column update then give
//   the same values outside the 2x2 block, so one pass does both with half
//   the loads, stores and flops; the 2x2 block goes through both in every
//   lane's registers, and its rotated (p, q) is the upper one, a_pq of row
//   p, which _rotation reads.
// - For n <= 32 (sweeps_by_rows, one index a lane, A and V in shared
//   memory) row p of A and eigenvector p stay in registers for the
//   n - p - 1 rotations of row p, and every lane derives in registers the
//   three entries the next rotation reads (a_pp, a_qq, a_pq after this
//   one), so its (c, s) is formed while this rotation's stores issue.
//   Registers and stored entries come from the same fma helpers and agree
//   bit for bit. One warp issues every instruction of its chain, so
//   instruction count is latency here: 0.16-0.18 us a rotation on the
//   H100.
// - Past n = 32 (the plan runs there only where the "cta" plan's shared
//   memory does not fit) rotation by rotation, each lane over ceil(n / 32)
//   indices, with V in device memory (the output buffer, as V^T, each lane
//   touching only its own column, transposed in place at the end) and A
//   in shared memory while it fits, else in device memory too (a scratch
//   buffer the wrapper passes, read and written through L2 with .cg
//   accesses). Shared rows are padded to an odd stride n|1, so column
//   accesses hit distinct banks.
//
// Plan "cta": sweeps * (m - 1) dependent steps, m = n rounded up to even
// (n = 64: 756 steps, not 24,192 rotations). The round-robin order
// (ops/jacobi.py::parallel_schedule, Brent-Luk's chess-tournament order,
// which converges as cyclic-by-rows does) pairs the m indices into m/2
// disjoint rotations a step (for n odd, index n is a zero dummy row whose
// rotation |a_pq| = 0 skips exactly), every pair once a sweep. Disjoint
// rotations commute, so a step is A <- J A J^T, V <- V J^T with J their
// block-diagonal product. Design:
// - One CTA owns a matrix, V^T (m x m, rotated in pairs of columns: one
//   16-byte access for two entries in f64) and A (upper triangle, packed)
//   in shared memory. Warps of A's items each take a 2x2 block (i, j),
//   i < j, of A over step pairs i and j: rotation i on its rows, then
//   rotation j on its columns, in registers (the reference's
//   rows-then-columns order), so no barrier separates a row and a column
//   phase. Warps of V^T's items take (pair, column pair). Each item reads
//   and writes only its own entries.
// - One __syncthreads a step. The thread whose block holds entry (p', q')
//   of a next-step pair forms that rotation's (c, s) from its just-rotated
//   a_p'q' and the diagonal (which only that thread touches this step),
//   writes (c, s) into the other of two buffers and applies the next
//   step's 2x2 diagonal block at once: a pair's diagonal block is never
//   read by the blocks of its own step. Those h blocks sit at fixed
//   places (next_block) and come first, so one warp forms every rotation
//   in lockstep at one call site. (A first design that let every warp
//   form the rotations of its lanes at four call sites ran 1.7-2.3 us a
//   step at n = 32-64: issue-bound.)
// - (c, s) and the rotated diagonal come from the same rotation() as the
//   warp plan (f64 inside for both types), so the two plans differ only
//   in order. What bounds a step: at small n the rotation's f64 chain and
//   the barrier (about 0.5 us on the H100), at n = 64-128 the issue of the
//   A and V updates (1.0 us a step at 64, 3 us at 128; PERF.md).
// - One matrix a CTA: a bucket of b matrices runs b CTAs; past the card's
//   132 SMs several share an SM while their shared memory fits.
//
// Both plans:
// - No status goes to the host: a non-finite input gives non-finite output
//   (every product is formed even when s == 0, and a skipped rotation's
//   diagonal keeps 0 * a_pq, so NaN spreads), and the caller's divergence
//   guard sees it. Launch errors come back from cudaGetLastError() through
//   the C interface. No atomics: two launches on one input agree bit for
//   bit. No allocation and no synchronisation: the launch can be captured.
// - The batch-in-lanes (n, n, 128) layout of the TPU kernel is not carried
//   over: it fills the TPU's vector lanes; here the batch is the grid.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxWarps = 4;  // matrices per CTA

int g_max_smem = 0;  // the device's opt-in shared memory per block, set by init

template <typename T>
struct Eps;
template <>
struct Eps<double> {
  static constexpr double value = 1e-30;
};
template <>
struct Eps<float> {
  static constexpr float value = 1e-18f;
};

// 1 / sqrt(x) without branches: the hardware's approximation and one
// Halley step (which cubes the relative error). The library's correctly
// rounded sqrt and division carry a slow path for special operands, and
// that branch would split the rotation loop's body and keep the compiler
// from interleaving rotation r's stores with rotation r+1's (c, s). Zero
// or non-finite operands give non-finite results, which only a discarded
// case (|a_pq| <= eps) sees, or which spread as NaN as the reference's do.
__device__ __forceinline__ double rsqrt_h(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double e = fma(-x * y, y, 1.0);  // 1 - x y^2
  return fma(y * e, fma(e, 0.375, 0.5), y);
}

// Jacobi rotation (c, s) zeroing a_pq (cuadmm_tpu/ops/jacobi.py::_rotation),
// from d = a_qq - a_pp and e = 2 a_pq with r = sqrt(d^2 + e^2). _rotation's
// t = sgn(d) e / (|d| + r) gives c^2 = 1 / (1 + t^2) = (1 + |d| / r) / 2
// and s = t c = sgn(d) e / (2 r c): with y = 1 / r and z = c^2, two rsqrt
// and no division. Also the rotated diagonal, the 2x2 block's eigenvalues
// (a_pp + a_qq) / 2 -+ g r / 2 (g = sgn(d), or sgn(a_pq) in the 45-degree
// case; a_pp - t a_pq in exact arithmetic), which is ready after the first
// rsqrt, so the next rotation's a_pp does not wait for (c, s). Formed in
// f64 for both types: the f32 instance rounds c and s once at the end, so
// c^2 + s^2 carries no bias into the ~12 (n-1) rotations that touch each
// row (a biased f32 rsqrt drifted 7.6e-5 relative at n = 45, against the
// 5e-5 tolerance).
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s, T& dpp, T& dqq) {
  const bool safe = fabs(apq) > Eps<T>::value;
  const double d = static_cast<double>(aqq) - static_cast<double>(app);
  const double e = 2.0 * static_cast<double>(apq);
  const double x = fma(d, d, e * e);
  const double y = rsqrt_h(x);
  const double g = d > 0.0 ? 0.5 : (d < 0.0 ? -0.5 : (e < 0.0 ? -0.5 : 0.5));
  const double mean = 0.5 * (static_cast<double>(app) + static_cast<double>(aqq));
  const double half_r = g * (x * y);
  // Skipped (|a_pq| <= eps, or NaN): the reference's products with s = 0
  // leave a_pp, but 0 * NaN still makes it NaN.
  dpp = safe ? static_cast<T>(mean - half_r) : app + T(0) * apq;
  dqq = safe ? static_cast<T>(mean + half_r) : aqq + T(0) * apq;
  const double z = fma(0.5 * fabs(d), y, 0.5);
  const double wz = rsqrt_h(z);
  const double half = 0.70710678118654752;  // theta == 0: 45-degree rotation
  const double cc = d == 0.0 ? half : z * wz;
  const double ss = d == 0.0 ? half : (d < 0.0 ? -0.5 : 0.5) * e * y * wz;
  c = safe ? static_cast<T>(cc) : T(1);
  s = safe ? static_cast<T>(ss) : T(0);
}

// The two halves of a rotation, x' = c x - s y and y' = s x + c y, as one
// fixed sequence of operations wherever they are formed.
template <typename T>
__device__ __forceinline__ T rot_lo(T c, T s, T x, T y) {
  return fma(c, x, -(s * y));
}
template <typename T>
__device__ __forceinline__ T rot_hi(T c, T s, T x, T y) {
  return fma(s, x, c * y);
}

// Accesses to A or V: shared memory, or device memory through L2 only (the
// lanes of a warp exchange entries between rotations).
template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}
template <bool kShared, typename T>
__device__ __forceinline__ void st(T* p, T x) {
  if constexpr (kShared) {
    *p = x;
  } else {
    __stcg(p, x);
  }
}

// Entry (i, j) of the symmetric A, kept once, at row min(i, j).
template <typename T>
__device__ __forceinline__ T* sym(T* a, int lda, int i, int j) {
  return i < j ? a + i * lda + j : a + j * lda + i;
}

// Rotation (p, q, c, s) on index j's entries of A, (p, j) and (q, j), and
// of eigenvectors p and q. For j = p or q those are entries of the 2x2
// block, whose rotated values the caller passes: the lanes owning p and q
// store the block, and (p, q), which both store, gets the same value.
template <bool kASh, bool kVSh, typename T>
__device__ __forceinline__ void update(T* a, int lda, T* vt, int ldv, int p, int q, int j, T c, T s,
                                       T fpp, T fpq, T fqq) {
  T* at_p = sym(a, lda, p, j);
  T* at_q = sym(a, lda, q, j);
  const T xp = ld<kASh>(at_p), xq = ld<kASh>(at_q);
  const T vp = ld<kVSh>(vt + p * ldv + j), vq = ld<kVSh>(vt + q * ldv + j);
  const bool jp = j == p, jq = j == q;
  st<kASh>(at_p, jp ? fpp : (jq ? fpq : rot_lo(c, s, xp, xq)));
  st<kASh>(at_q, jp ? fpq : (jq ? fqq : rot_hi(c, s, xp, xq)));
  st<kVSh>(vt + p * ldv + j, rot_lo(c, s, vp, vq));
  st<kVSh>(vt + q * ldv + j, rot_hi(c, s, vp, vq));
}

// The sweeps with row p of A and eigenvector p in registers: in the
// cyclic-by-rows order p stays fixed for n - p - 1 rotations, so lane l
// keeps (p, j) and V(p, j) for its kJ indices j across them and writes them
// back when p moves on. The 2x2 inputs of each rotation are the previous
// one's registers; (p, q+1) comes from its owner's register by a shuffle.
// Per rotation and index: one load and one store each of (q, j) and
// V(q, j), the load of V one rotation ahead. Lanes past n repeat lane
// n-1's work, storing the same values. Launched with kJ = 1 only (n <=
// 32); the same body with scalars in place of the kJ arrays compiles to
// other code, which ran 8-11% slower at n = 3-5 in f64 on the H100
// (k4_ab.py, parent against change).
template <typename T, int kJ, bool kASh, bool kVSh>
__device__ __forceinline__ void sweeps_by_rows(T* a, int lda, T* vt, int ldv, int n, int sweeps) {
  const int lane = threadIdx.x & 31;
  int js[kJ];
#pragma unroll
  for (int t = 0; t < kJ; ++t) js[t] = min(lane + 32 * t, n - 1);
  T rp[kJ], vp[kJ], vq[kJ];
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < n - 1; ++p) {
#pragma unroll
      for (int t = 0; t < kJ; ++t) {
        rp[t] = ld<kASh>(sym(a, lda, p, js[t]));
        vp[t] = ld<kVSh>(vt + p * ldv + js[t]);
        vq[t] = ld<kVSh>(vt + (p + 1) * ldv + js[t]);
      }
      T pp = ld<kASh>(a + p * lda + p), pq = ld<kASh>(a + p * lda + p + 1);
      T qq = ld<kASh>(a + (p + 1) * lda + p + 1);
      T c, s, fpp, fqq;
      rotation(pp, qq, pq, c, s, fpp, fqq);
      for (int q = p + 1; q < n; ++q) {
        // What rotation (p, q+1) reads besides this rotation's results:
        // (q+1, q+1), (q, q+1), and (p, q+1) from its owner's register.
        const int q2 = q + 1 < n ? q + 1 : q;
        const T x2 = ld<kASh>(a + q * lda + q2), d2 = ld<kASh>(a + q2 * lda + q2);
        T own = rp[0];
#pragma unroll
        for (int t = 1; t < kJ; ++t) own = (q2 >> 5) == t ? rp[t] : own;
        const T x1 = __shfl_sync(0xffffffffu, own, q2 & 31);
        // Eigenvector q+1, which this rotation leaves alone, one rotation
        // ahead (V may be in device memory).
        T vq2[kJ];
#pragma unroll
        for (int t = 0; t < kJ; ++t) vq2[t] = ld<kVSh>(vt + q2 * ldv + js[t]);
        __syncwarp();  // every lane has read before any lane stores

        // Rotation (p, q) on the 2x2 block (symmetric: a_qp is a_pq): its
        // rotated (p, q), rows then columns; the diagonal came with (c, s).
        const T fpq = rot_hi(c, s, rot_lo(c, s, pp, pq), rot_lo(c, s, pq, qq));
        // Rotation (p, q+1): (p, p) is fpp, (q+1, q+1) untouched, (p, q+1)
        // rotated with (q, q+1).
        const T napq = rot_lo(c, s, x1, x2);
        T c2, s2, fpp2, fqq2;
        rotation(fpp, d2, napq, c2, s2, fpp2, fqq2);

        // Rotation (p, q) on each lane's entries; (p, j) stays in rp.
#pragma unroll
        for (int t = 0; t < kJ; ++t) {
          const int j = js[t];
          T* at_q = sym(a, lda, q, j);
          const T aq = ld<kASh>(at_q);
          const bool jp = j == p, jq = j == q;
          st<kASh>(at_q, jp ? fpq : (jq ? fqq : rot_hi(c, s, rp[t], aq)));
          rp[t] = jp ? fpp : (jq ? fpq : rot_lo(c, s, rp[t], aq));
          st<kVSh>(vt + q * ldv + j, rot_hi(c, s, vp[t], vq[t]));
          vp[t] = rot_lo(c, s, vp[t], vq[t]);
          vq[t] = vq2[t];
        }
        __syncwarp();  // rotation (p, q)'s stores are seen by every lane
        pp = fpp;
        pq = napq;
        qq = d2;
        fpp = fpp2;
        fqq = fqq2;
        c = c2;
        s = s2;
      }
#pragma unroll
      for (int t = 0; t < kJ; ++t) {
        st<kASh>(sym(a, lda, p, js[t]), rp[t]);
        st<kVSh>(vt + p * ldv + js[t], vp[t]);
      }
      __syncwarp();
    }
  }
}

// kJ: indices per lane known at compile time (1 for n <= 32), run by
// sweeps_by_rows, whose loop body is one basic block; 0 for the plain
// loop below (n > 32). kASh / kVSh: A / V in shared memory.
template <typename T, int kJ, bool kASh, bool kVSh>
__global__ void __launch_bounds__(kMaxWarps * 32)
    jacobi_eigh_kernel(const T* __restrict__ mats, T* __restrict__ w, T* __restrict__ v,
                       T* __restrict__ work, int batch, int n, int sweeps, int warps) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mat = blockIdx.x * warps + warp;
  if (mat >= batch) return;  // the whole warp: no block barrier follows
  const size_t nn = static_cast<size_t>(n) * n;
  const int lds = n | 1;
  const size_t per_mat = (kASh ? static_cast<size_t>(n) * lds : 0) +
                         (kVSh ? static_cast<size_t>(n) * lds : 0);
  T* sm = reinterpret_cast<T*>(smem_raw) + warp * per_mat;
  const int lda = kASh ? lds : n;
  const int ldv = kVSh ? lds : n;
  T* a = kASh ? sm : work + mat * nn;
  T* vt = kVSh ? sm + (kASh ? static_cast<size_t>(n) * lds : 0) : v + mat * nn;  // vt[i][j]: entry j of eigenvector i

  const T* src = mats + mat * nn;
  for (int k = lane; k < n * n; k += 32) {
    const int i = k / n, j = k - i * n;
    st<kASh>(a + i * lda + j, src[k]);
    st<kVSh>(vt + i * ldv + j, i == j ? T(1) : T(0));
  }
  __syncwarp();

  if constexpr (kJ > 0) {
    sweeps_by_rows<T, kJ, kASh, kVSh>(a, lda, vt, ldv, n, sweeps);
  } else {  // n > 32: rotation by rotation, each lane over ceil(n / 32) indices
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      for (int p = 0; p < n - 1; ++p) {
        for (int q = p + 1; q < n; ++q) {
          const T pp = ld<kASh>(a + p * lda + p), pq = ld<kASh>(a + p * lda + q);
          const T qq = ld<kASh>(a + q * lda + q);
          __syncwarp();  // every lane has read before any lane stores
          T c, s, fpp, fqq;
          rotation(pp, qq, pq, c, s, fpp, fqq);
          const T fpq = rot_hi(c, s, rot_lo(c, s, pp, pq), rot_lo(c, s, pq, qq));
          for (int j = lane; j < n; j += 32) {
            update<kASh, kVSh>(a, lda, vt, ldv, p, q, j, c, s, fpp, fpq, fqq);
          }
          __syncwarp();  // rotation (p, q)'s stores are seen by every lane
        }
      }
    }
  }

  for (int i = lane; i < n; i += 32) w[static_cast<size_t>(mat) * n + i] = ld<kASh>(a + i * lda + i);
  T* dst = v + mat * nn;
  if constexpr (kVSh) {
    for (int k = lane; k < n * n; k += 32) {
      const int j = k / n, i = k - j * n;
      dst[k] = vt[i * ldv + j];
    }
  } else {  // V^T was built in dst itself: transpose it in place
    __syncwarp();
    for (int k = lane; k < n * n; k += 32) {
      const int i = k / n, j = k - i * n;
      if (i < j) {
        const T x = __ldcg(dst + k), y = __ldcg(dst + j * n + i);
        dst[k] = y;
        dst[j * n + i] = x;
      }
    }
  }
}

// Shared memory of one matrix: A, and V too when ``with_v``.
template <typename T>
size_t mat_bytes(int n, bool with_a, bool with_v) {
  return (static_cast<size_t>(with_a) + with_v) * static_cast<size_t>(n) * (n | 1) * sizeof(T);
}

template <typename T, int kJ, bool kASh, bool kVSh>
int run(const T* mats, T* w, T* v, T* work, int batch, int n, int sweeps, cudaStream_t st) {
  const size_t per = mat_bytes<T>(n, kASh, kVSh);
  int warps = kMaxWarps;
  if (per > 0) {
    warps = static_cast<int>(static_cast<size_t>(g_max_smem) / per);
    warps = warps < kMaxWarps ? warps : kMaxWarps;
  }
  if (warps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > batch) warps = batch;
  const int grid = (batch + warps - 1) / warps;
  jacobi_eigh_kernel<T, kJ, kASh, kVSh><<<grid, 32 * warps, warps * per, st>>>(
      mats, w, v, work, batch, n, sweeps, warps);
  return static_cast<int>(cudaGetLastError());
}

// Where A and V live for this n (see the memory plan above).
template <typename T>
void memory_plan(int n, bool& a_shared, bool& v_shared) {
  const size_t limit = static_cast<size_t>(g_max_smem);
  v_shared = n <= 32 && mat_bytes<T>(n, true, true) <= limit;
  a_shared = mat_bytes<T>(n, true, false) <= limit;
}

template <typename T>
int launch(const T* mats, T* w, T* v, T* work, int batch, int n, int sweeps, void* stream) {
  if (batch <= 0 || n < 2 || sweeps < 0 || g_max_smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool a_sh, v_sh;
  memory_plan<T>(n, a_sh, v_sh);
  if (!a_sh && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (v_sh) return run<T, 1, true, true>(mats, w, v, work, batch, n, sweeps, st);
  if (a_sh) return run<T, 0, true, false>(mats, w, v, work, batch, n, sweeps, st);
  return run<T, 0, false, false>(mats, w, v, work, batch, n, sweeps, st);
}

// ---- Plan "cta": one CTA a matrix, round-robin parallel order ----

// Threads: warps of A's block items, then warps of V^T's items, sized
// for kCtaBlockItems / kCtaVItems items a thread a step and at most
// kCtaThreads / 2 threads each: of the splits tried on an H100, the one
// that ran the grid's 32x49 bucket fastest (the tightest of K4's targets
// against eigh).
constexpr int kCtaThreads = 1024;
constexpr int kCtaBlockItems = 1;
constexpr int kCtaVItems = 4;
constexpr int kCtaMaxN = 254;  // block table entries are bytes: m/2 <= 127

// Shared memory of one "cta" CTA, with m = n rounded up to even and
// h = m/2: V^T as m rows of m (row and column m-1 the dummy's for n odd;
// first, so that its column pairs are 16-byte aligned), A's upper
// triangle packed (m(m+1)/2), two buffers of c and s by index (4m), and
// the table of A's block items (i, j), two bytes each (cta_blocks).
// ops/jacobi.py::cta_smem_bytes is the same formula.
__host__ __device__ __forceinline__ int cta_blocks(int h) { return h == 1 ? 1 : h * (h - 1) / 2; }

template <typename T>
size_t cta_bytes(int n) {
  const size_t m = n + (n & 1);
  return (m * m + m * (m + 1) / 2 + 4 * m) * sizeof(T) + 2 * static_cast<size_t>(cta_blocks(static_cast<int>(m / 2)));
}

// Offset of entry (i, j), i <= j, in the packed upper triangle of order m.
__device__ __forceinline__ int tri(int i, int j, int m) { return ((i * (2 * m - i - 1)) >> 1) + j; }
__device__ __forceinline__ int sym_tri(int i, int j, int m) { return tri(min(i, j), max(i, j), m); }

// Pair k of step r over m indices, m1 = m - 1 (ops/jacobi.py::
// parallel_schedule): (r, m1) for k = 0, else (r + k, r - k) mod m1;
// p < q.
__device__ __forceinline__ void slot(int r, int k, int m1, int& p, int& q) {
  int x = r + k, y = r - k;
  x = x >= m1 ? x - m1 : x;
  y = y < 0 ? y + m1 : y;
  p = k == 0 ? r : min(x, y);
  q = k == 0 ? m1 : max(x, y);
}

// Index a's partner in step r: 2r - a mod m1, r with m1.
__device__ __forceinline__ int partner(int r, int a, int m1) {
  int b = 2 * r - a;
  b = b < 0 ? b + m1 : (b >= m1 ? b - m1 : b);
  b = a == r ? m1 : b;
  return a == m1 ? r : b;
}

// The blocks (i, j) of pairs i < j of a step that hold the next step's
// pairs: next pair 0 = (r+1, m1) has r+1 in pair 1 and m1 in pair 0, next
// pair k = (r+1+k, r+1-k) has its indices in pairs k+1 and k-1, and the
// last, k = h-1, in pairs h-1 and h-2 (r+1+k wraps to r-(h-1)). So
// (0, 1), (j, j+2) for j < h-2, and (h-2, h-1): h blocks (one for h = 2),
// each holding one next pair (both for h = 2); for h = 1 (n = 2) the
// pair's own block (0, 0). ops/jacobi.py's tests check this against
// parallel_schedule.
__device__ __forceinline__ bool next_block(int i, int j, int h) {
  return (i == 0 && j == 1) || j == i + 2 || (i == h - 2 && j == h - 1);
}

// The rotation of pair (x, y) (either order) whose a_pq is ``apq``: its
// (c, s) into ``cs`` at the smaller index (c at p, s at m + p), and its
// 2x2 diagonal block applied to A.
template <typename T>
__device__ __forceinline__ void start_rotation(T* a, T* cs, int m, int x, int y, T apq) {
  const int p = min(x, y), q = max(x, y);
  T* ap = a + tri(p, p, m);
  T* aq = a + tri(q, q, m);
  const T pp = *ap, qq = *aq;
  T c, s, fpp, fqq;
  rotation(pp, qq, apq, c, s, fpp, fqq);
  cs[p] = c;
  cs[m + p] = s;
  *ap = fpp;
  *aq = fqq;
  a[tri(p, q, m)] = rot_hi(c, s, rot_lo(c, s, pp, apq), rot_lo(c, s, apq, qq));
}

template <typename T>
struct Pair;  // two entries of a V^T row, loaded and stored as one
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// Threads of A's block items (a multiple of 32), then of V^T's items (a
// pair of rows at two adjacent columns: h * m/2 items).
__host__ __device__ __forceinline__ int cta_a_threads(int n) {
  const int h = (n + (n & 1)) / 2;
  return min((cta_blocks(h) + 32 * kCtaBlockItems - 1) / (32 * kCtaBlockItems) * 32, kCtaThreads / 2);
}
__host__ __device__ __forceinline__ int cta_v_threads(int n) {
  const int h = (n + (n & 1)) / 2;
  return min((h * h + 32 * kCtaVItems - 1) / (32 * kCtaVItems) * 32, kCtaThreads / 2);
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads, 1)
    jacobi_cta_kernel(const T* __restrict__ mats, T* __restrict__ w, T* __restrict__ v, int n, int sweeps) {
  using P2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char cta_smem[];
  const int m = n + (n & 1), m1 = m - 1, h = m / 2;
  const int nblk = cta_blocks(h), nnext = h <= 2 ? 1 : h;
  T* vt = reinterpret_cast<T*>(cta_smem);  // vt[i * m + j]: entry j of eigenvector i
  T* a = vt + m * m;
  T* cs = a + m * (m + 1) / 2;  // two buffers of 2m: c, then s, by index
  unsigned char* bij = reinterpret_cast<unsigned char*>(cs + 4 * m);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* src = mats + blockIdx.x * nn;

  for (int k = tid; k < n * n; k += nt) {
    const int i = k / n, j = k - i * n;
    if (i <= j) a[tri(i, j, m)] = src[k];
  }
  if (m != n) {  // the dummy index n: a zero row and column
    for (int i = tid; i < m; i += nt) a[tri(i, n, m)] = T(0);
  }
  for (int k = tid; k < m * m; k += nt) {
    const int i = k / m, j = k - i * m;
    vt[k] = i == j && i < n ? T(1) : T(0);
  }
  if (tid == 0) {  // the next step's pair blocks first (one warp forms every rotation), then the rest
    int k = 0;
    if (h == 1) {
      bij[0] = bij[1] = 0;
    } else {
      for (int i = 0; i < h; ++i) {
        for (int j = i + 1; j < h; ++j) {
          if (next_block(i, j, h)) {
            bij[2 * k] = static_cast<unsigned char>(i);
            bij[2 * k + 1] = static_cast<unsigned char>(j);
            ++k;
          }
        }
      }
      for (int i = 0; i < h; ++i) {
        for (int j = i + 1; j < h; ++j) {
          if (!next_block(i, j, h)) {
            bij[2 * k] = static_cast<unsigned char>(i);
            bij[2 * k + 1] = static_cast<unsigned char>(j);
            ++k;
          }
        }
      }
    }
  }
  __syncthreads();

  const int total = sweeps * m1;
  if (total > 0) {  // step 0's rotations, from A as given
    for (int k = tid; k < h; k += nt) {
      int p, q;
      slot(0, k, m1, p, q);
      start_rotation(a, cs, m, p, q, a[tri(p, q, m)]);
    }
  }
  __syncthreads();

  // Warps [0, na) take A's blocks, the rest V^T's items; a V thread walks
  // its items (pair k, column pair c2) without a division.
  const int na = cta_a_threads(n), nvt = nt - na, vid = tid - na;
  const int v_dk = nvt / h, v_dc = nvt - v_dk * h;
  int r = 0;
  for (int t = 0; t < total; ++t) {
    const int rn = r + 1 == m1 ? 0 : r + 1;
    const bool more = t + 1 < total;
    const T* cur = cs + (t & 1) * 2 * m;
    T* nxt = cs + ((t + 1) & 1) * 2 * m;
    if (tid < na) {
      for (int k = tid; k < nblk; k += na) {
        const int i = bij[2 * k], j = bij[2 * k + 1];
        int pi, qi, pj, qj;
        slot(r, i, m1, pi, qi);
        slot(r, j, m1, pj, qj);
        T z00 = T(0), z01, z10 = T(0), z11 = T(0);
        if (i != j) {
          T* e00 = a + sym_tri(pi, pj, m);
          T* e01 = a + sym_tri(pi, qj, m);
          T* e10 = a + sym_tri(qi, pj, m);
          T* e11 = a + sym_tri(qi, qj, m);
          const T x00 = *e00, x01 = *e01, x10 = *e10, x11 = *e11;
          const T ci = cur[pi], si = cur[m + pi], cj = cur[pj], sj = cur[m + pj];
          // Rows by rotation i, then columns by rotation j.
          const T y00 = rot_lo(ci, si, x00, x10), y10 = rot_hi(ci, si, x00, x10);
          const T y01 = rot_lo(ci, si, x01, x11), y11 = rot_hi(ci, si, x01, x11);
          z00 = rot_lo(cj, sj, y00, y01);
          z01 = rot_hi(cj, sj, y00, y01);
          z10 = rot_lo(cj, sj, y10, y11);
          z11 = rot_hi(cj, sj, y10, y11);
          *e00 = z00;
          *e01 = z01;
          *e10 = z10;
          *e11 = z11;
        } else {  // n = 2: the pair's own 2x2 block, already rotated; (pi, qi) is entry 01
          z01 = a[tri(pi, qi, m)];
        }
        if (more && k < nnext) {
          // This block's next-step pairs, each started at one call site,
          // so the warp of these blocks forms them together.
          const int ppi = partner(rn, pi, m1), pqi = partner(rn, qi, m1);
          unsigned hits = (ppi == pj ? 1u : 0u) | (ppi == qj ? 2u : 0u);
          if (i != j) hits |= (pqi == pj ? 4u : 0u) | (pqi == qj ? 8u : 0u);
          while (hits) {
            const int e = __ffs(hits) - 1;
            hits &= hits - 1;
            const T val = e == 0 ? z00 : (e == 1 ? z01 : (e == 2 ? z10 : z11));
            start_rotation(a, nxt, m, e < 2 ? pi : qi, (e & 1) ? qj : pj, val);
          }
        }
      }
    } else {
      int k = vid / h, c2 = vid - (vid / h) * h;
#pragma unroll 4
      for (int it = vid; it < h * h; it += nvt) {
        int p, q;
        slot(r, k, m1, p, q);
        const T c = cur[p], s = cur[m + p];
        P2* vp = reinterpret_cast<P2*>(vt + p * m) + c2;
        P2* vq = reinterpret_cast<P2*>(vt + q * m) + c2;
        const P2 xp = *vp, xq = *vq;
        P2 yp, yq;
        yp.x = rot_lo(c, s, xp.x, xq.x);
        yp.y = rot_lo(c, s, xp.y, xq.y);
        yq.x = rot_hi(c, s, xp.x, xq.x);
        yq.y = rot_hi(c, s, xp.y, xq.y);
        *vp = yp;
        *vq = yq;
        k += v_dk;
        c2 += v_dc;
        if (c2 >= h) {
          c2 -= h;
          ++k;
        }
      }
    }
    __syncthreads();
    r = rn;
  }

  for (int i = tid; i < n; i += nt) w[blockIdx.x * static_cast<size_t>(n) + i] = a[tri(i, i, m)];
  T* dst = v + blockIdx.x * nn;
  for (int k = tid; k < n * n; k += nt) {
    const int i = k / n, j = k - i * n;
    dst[k] = vt[j * m + i];
  }
}

template <typename T>
int launch_cta(const T* mats, T* w, T* v, int batch, int n, int sweeps, cudaStream_t st) {
  const size_t bytes = cta_bytes<T>(n);
  const int threads = cta_a_threads(n) + cta_v_threads(n);
  if (n > kCtaMaxN || bytes > static_cast<size_t>(g_max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jacobi_cta_kernel<T><<<batch, threads, bytes, st>>>(mats, w, v, n, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kJ, bool kASh, bool kVSh>
int allow_smem(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(jacobi_eigh_kernel<T, kJ, kASh, kVSh>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int allow_all(int bytes) {
  int err = allow_smem<T, 1, true, true>(bytes);
  if (!err) err = allow_smem<T, 0, true, false>(bytes);
  if (!err) {
    err = static_cast<int>(cudaFuncSetAttribute(jacobi_cta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                bytes));
  }
  return err;
}

// w (batch, n) and v (batch, n, n) from mats (batch, n, n), all contiguous
// and of one type, in plan 0 ("warp") or 1 ("cta"); for "warp", work holds
// batch * cuadmm_jacobi_eigh_work_elems(n) entries ("cta" takes none).
// Launches on ``stream`` without synchronizing and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that cannot run
// (for "cta": n past 254 or its shared memory past the card's).
template <typename T>
int launch_plan(const T* mats, T* w, T* v, T* work, int batch, int n, int sweeps, int plan, void* stream) {
  if (plan == 0) return launch<T>(mats, w, v, work, batch, n, sweeps, stream);
  if (plan != 1 || batch <= 0 || n < 2 || sweeps < 0 || g_max_smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cta<T>(mats, w, v, batch, n, sweeps, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Lets every instance take the current device's opt-in shared memory per
// block. Call once per device, with that device current, before the first
// launch there.
int cuadmm_jacobi_eigh_init(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  g_max_smem = bytes;
  const int e = allow_all<double>(bytes);
  return e != 0 ? e : allow_all<float>(bytes);
}

// Scratch entries per matrix that the launch needs in ``work``: n * n when
// A of that size streams from device memory, else 0 (``work`` may be null).
int cuadmm_jacobi_eigh_work_elems(int n, int elem_bytes) {
  bool a_sh, v_sh;
  if (elem_bytes == 8) {
    memory_plan<double>(n, a_sh, v_sh);
  } else {
    memory_plan<float>(n, a_sh, v_sh);
  }
  return a_sh ? 0 : n * n;
}

// The opt-in shared memory per block that cuadmm_jacobi_eigh_init read
// (0 before it ran): what the "cta" plan's cta_bytes must fit.
int cuadmm_jacobi_eigh_max_smem(void) { return g_max_smem; }

// See launch_plan.
int cuadmm_jacobi_eigh_f64(const double* mats, double* w, double* v, double* work, int batch, int n,
                           int sweeps, int plan, void* stream) {
  return launch_plan<double>(mats, w, v, work, batch, n, sweeps, plan, stream);
}

int cuadmm_jacobi_eigh_f32(const float* mats, float* w, float* v, float* work, int batch, int n,
                           int sweeps, int plan, void* stream) {
  return launch_plan<float>(mats, w, v, work, batch, n, sweeps, plan, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
