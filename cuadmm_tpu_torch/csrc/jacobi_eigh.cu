// Batched cyclic-by-rows Jacobi eigendecomposition of small symmetric
// matrices (K4), one warp per matrix.
//
// Replaces the Pallas kernel cuadmm_tpu/ops/jacobi.py::_jacobi_kernel and
// computes what it and jacobi_eigh_jnp compute: for each (n, n) matrix of
// the batch, `sweeps` sweeps over the pairs (p, q), p < q, in cyclic-by-rows
// order; each pair applies the rotation (c, s) of _rotation (the theta == 0
// 45-degree case and the |a_pq| <= eps skip included) to rows p, q of A,
// then to columns p, q of A, then to columns p, q of V. Returns w = diag(A),
// unsorted, and V with the eigenvectors in its columns. Templated on the
// scalar type: the solver's f64 state runs the double instance, the float
// instance is the TPU kernel's own dtype. Any n >= 2.
//
// Bound: latency. A matrix needs sweeps * n(n-1)/2 rotations, each of which
// depends on the one before, and each touches only 6n numbers; the matrix
// itself is read from and written to device memory once (n = 64 in f64:
// 12 x 2016 rotations against 32 KB in and 33 KB out). So what matters is
// a short critical path per rotation and enough matrices in flight.
//
// Design:
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
// - For n <= 128 (sweeps_by_rows) row p of A and eigenvector p stay in
//   registers for the n - p - 1 rotations of row p, and every lane derives
//   in registers the three entries the next rotation reads (a_pp, a_qq,
//   a_pq after this one), so its (c, s) is formed while this rotation's
//   stores issue. Registers and stored entries come from the same fma
//   helpers and agree bit for bit. One warp issues every instruction of
//   its chain, so instruction count is latency here.
// - (c, s) from d = a_qq - a_pp, e = 2 a_pq with two rsqrt, branch-free,
//   in f64, equal in exact arithmetic to _rotation's; the rotated diagonal
//   from the 2x2 block's eigenvalues (see rotation()).
// - Memory plan per matrix: A and V in shared memory while both fit the
//   CTA's budget and n <= 128; then V in device memory (the output
//   buffer, as V^T, each lane touching only its own column, transposed in
//   place at the end); past A's budget A as well (a scratch buffer the
//   wrapper passes, read and written through L2 with .cg accesses). Shared
//   rows are padded to an odd stride n|1, so column accesses hit distinct
//   banks.
// - No status goes to the host: a non-finite input gives non-finite output
//   (every product is formed even when s == 0, and a skipped rotation's
//   diagonal keeps 0 * a_pq, so NaN spreads), and the caller's divergence
//   guard sees it. Launch errors come back from
//   cudaGetLastError() through the C interface.
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
// n-1's work, storing the same values.
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

// kJ: indices per lane known at compile time (ceil(n / 32) for n <= 128),
// run by sweeps_by_rows, whose loop body is one basic block; 0 for the
// plain loop below (n > 128, off the solver's usual block sizes). kASh /
// kVSh: A / V in shared memory.
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
  } else {  // n > 128: rotation by rotation, each lane over ceil(n / 32) indices
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
void plan(int n, bool& a_shared, bool& v_shared) {
  const size_t limit = static_cast<size_t>(g_max_smem);
  v_shared = n <= 128 && mat_bytes<T>(n, true, true) <= limit;
  a_shared = mat_bytes<T>(n, true, false) <= limit;
}

template <typename T>
int launch(const T* mats, T* w, T* v, T* work, int batch, int n, int sweeps, void* stream) {
  if (batch <= 0 || n < 2 || sweeps < 0 || g_max_smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool a_sh, v_sh;
  plan<T>(n, a_sh, v_sh);
  if (!a_sh && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // sweeps_by_rows needs the exact index count: a lane's index clamped to
  // n - 1 must not also be another slot's, or it is rotated twice.
  if (v_sh && n <= 32) return run<T, 1, true, true>(mats, w, v, work, batch, n, sweeps, st);
  if (v_sh && n <= 64) return run<T, 2, true, true>(mats, w, v, work, batch, n, sweeps, st);
  if (v_sh && n <= 96) return run<T, 3, true, true>(mats, w, v, work, batch, n, sweeps, st);
  if (v_sh) return run<T, 4, true, true>(mats, w, v, work, batch, n, sweeps, st);
  if (a_sh && n > 96 && n <= 128) return run<T, 4, true, false>(mats, w, v, work, batch, n, sweeps, st);
  if (a_sh) return run<T, 0, true, false>(mats, w, v, work, batch, n, sweeps, st);
  return run<T, 0, false, false>(mats, w, v, work, batch, n, sweeps, st);
}

template <typename T, int kJ, bool kASh, bool kVSh>
int allow_smem(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(jacobi_eigh_kernel<T, kJ, kASh, kVSh>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int allow_all(int bytes) {
  int err = allow_smem<T, 1, true, true>(bytes);
  if (!err) err = allow_smem<T, 2, true, true>(bytes);
  if (!err) err = allow_smem<T, 3, true, true>(bytes);
  if (!err) err = allow_smem<T, 4, true, true>(bytes);
  if (!err) err = allow_smem<T, 4, true, false>(bytes);
  if (!err) err = allow_smem<T, 0, true, false>(bytes);
  if (!err) err = allow_smem<T, 0, false, false>(bytes);
  return err;
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
    plan<double>(n, a_sh, v_sh);
  } else {
    plan<float>(n, a_sh, v_sh);
  }
  return a_sh ? 0 : n * n;
}

// w (batch, n) and v (batch, n, n) from mats (batch, n, n), all contiguous
// and of one type; work holds batch * cuadmm_jacobi_eigh_work_elems(n)
// entries. Launches on ``stream`` without synchronizing and returns
// cudaGetLastError().
int cuadmm_jacobi_eigh_f64(const double* mats, double* w, double* v, double* work, int batch, int n,
                           int sweeps, void* stream) {
  return launch<double>(mats, w, v, work, batch, n, sweeps, stream);
}

int cuadmm_jacobi_eigh_f32(const float* mats, float* w, float* v, float* work, int batch, int n,
                           int sweeps, void* stream) {
  return launch<float>(mats, w, v, work, batch, n, sweeps, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
