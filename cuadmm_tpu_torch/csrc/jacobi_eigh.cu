// Batched cyclic-by-rows Jacobi eigendecomposition of small symmetric
// matrices (K4).
//
// Replaces the Pallas kernel cuadmm_tpu/ops/jacobi.py::_jacobi_kernel and
// computes what it and jacobi_eigh_jnp compute: for each (n, n) matrix of
// the batch, `sweeps` sweeps over the pairs (p, q), p < q, in cyclic-by-rows
// order; each pair applies the rotation (c, s) of _rotation (the theta == 0
// 45-degree case and the |a_pq| <= eps skip included) to rows p, q of A,
// then to columns p, q of A, then to columns p, q of V. Returns w = diag(A),
// unsorted, and V with the eigenvectors in its columns. Templated on the
// scalar type: the solver's f64 state runs the double instance, the float
// instance is the TPU kernel's own dtype. 2 <= n <= 64.
//
// Bound: latency. A matrix needs sweeps * n(n-1)/2 rotations, each of which
// depends on the one before, and each touches only 6n numbers; the matrix
// itself is read from and written to device memory once (n = 64 in f64:
// 12 x 2016 rotations against 32 KB in and 33 KB out). So what matters is
// a short critical path per rotation and enough matrices in flight to fill
// the 132 SMs, not bytes.
//
// Design:
// - One CTA per matrix. A and V live in shared memory for the whole
//   decomposition (2 n (n|1) scalars: 66,560 bytes at n = 64 in f64, which
//   needs the dynamic shared-memory attribute set by the init function).
// - 32 threads for n <= 32, 64 for n <= 64: thread j owns index j of the
//   row update (a[p][j], a[q][j]), of the column update (a[j][p], a[j][q])
//   and of the V update (v[j][p], v[j][q]). Every element is written by
//   one thread, so the three phases need no atomics, only a barrier each.
// - Every thread forms (c, s) from a_pp, a_qq, a_pq itself (a shared-memory
//   broadcast read), which saves the barrier a broadcast of (c, s) would
//   need; the values are the same in every thread.
// - Rows are padded to an odd stride n|1, so the column phase, where thread
//   i reads a[i][p], hits distinct banks.
// - No status goes to the host: a non-finite input gives non-finite output
//   (every product is formed even when s == 0, so NaN spreads), and the
//   caller's divergence guard sees it. Launch errors come back from
//   cudaGetLastError() through the C interface.
// - The batch-in-lanes (n, n, 128) layout of the TPU kernel is not carried
//   over: it fills the TPU's vector lanes; here the batch is the grid.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxN = 64;

__host__ __device__ constexpr int padded_ld(int n) { return n | 1; }

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

// Jacobi rotation (c, s) zeroing a_pq (cuadmm_tpu/ops/jacobi.py::_rotation).
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const T one = T(1), zero = T(0);
  const bool safe = fabs(apq) > Eps<T>::value;
  const T denom = safe ? T(2) * apq : one;
  const T theta = (aqq - app) / denom;
  const T sgn = theta > zero ? one : (theta < zero ? -one : zero);
  T t = sgn / (fabs(theta) + sqrt(one + theta * theta));
  if (theta == zero) t = one;  // 45-degree rotation
  const T cc = one / sqrt(one + t * t);
  c = safe ? cc : one;
  s = safe ? t * cc : zero;
}

template <typename T>
__global__ void __launch_bounds__(64)
    jacobi_eigh_kernel(const T* __restrict__ mats, T* __restrict__ w, T* __restrict__ v, int n,
                       int sweeps) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = padded_ld(n);
  T* a = reinterpret_cast<T*>(smem_raw);
  T* vc = a + n * ld;  // vc[j * ld + i] = component j of eigenvector i
  const size_t nn = static_cast<size_t>(n) * n;
  const T* src = mats + blockIdx.x * nn;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int k = tid; k < n * n; k += nt) {
    const int i = k / n, j = k - i * n;
    a[i * ld + j] = src[k];
    vc[i * ld + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        T c, s;
        rotation(a[p * ld + p], a[q * ld + q], a[p * ld + q], c, s);
        __syncthreads();  // every thread has read a_pp, a_qq, a_pq
        for (int j = tid; j < n; j += nt) {
          const T rp = a[p * ld + j], rq = a[q * ld + j];
          a[p * ld + j] = c * rp - s * rq;
          a[q * ld + j] = s * rp + c * rq;
          const T vp = vc[j * ld + p], vq = vc[j * ld + q];
          vc[j * ld + p] = c * vp - s * vq;
          vc[j * ld + q] = s * vp + c * vq;
        }
        __syncthreads();  // rows p, q are final before the column update
        for (int i = tid; i < n; i += nt) {
          const T cp = a[i * ld + p], cq = a[i * ld + q];
          a[i * ld + p] = c * cp - s * cq;
          a[i * ld + q] = s * cp + c * cq;
        }
        __syncthreads();  // the next rotation reads the updated diagonal
      }
    }
  }

  T* dst = v + blockIdx.x * nn;
  for (int k = tid; k < n * n; k += nt) {
    const int i = k / n, j = k - i * n;
    dst[k] = vc[i * ld + j];
  }
  for (int i = tid; i < n; i += nt) w[static_cast<size_t>(blockIdx.x) * n + i] = a[i * ld + i];
}

template <typename T>
size_t smem_bytes(int n) {
  return 2 * static_cast<size_t>(n) * padded_ld(n) * sizeof(T);
}

template <typename T>
int set_smem_attribute() {
  return static_cast<int>(cudaFuncSetAttribute(jacobi_eigh_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes<T>(kMaxN))));
}

template <typename T>
int launch(const T* mats, T* w, T* v, int batch, int n, int sweeps, void* stream) {
  if (batch <= 0 || n < 2 || n > kMaxN || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n <= 32 ? 32 : 64;
  jacobi_eigh_kernel<T><<<batch, threads, smem_bytes<T>(n), static_cast<cudaStream_t>(stream)>>>(
      mats, w, v, n, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lets both instances take the dynamic shared memory of n = 64. Call once
// per device, with that device current, before the first launch there.
int cuadmm_jacobi_eigh_init(void) {
  const int err = set_smem_attribute<double>();
  return err != 0 ? err : set_smem_attribute<float>();
}

// w (batch, n) and v (batch, n, n) from mats (batch, n, n), all contiguous
// and of one type. Launches on ``stream`` without synchronizing and returns
// cudaGetLastError().
int cuadmm_jacobi_eigh_f64(const double* mats, double* w, double* v, int batch, int n, int sweeps,
                           void* stream) {
  return launch<double>(mats, w, v, batch, n, sweeps, stream);
}

int cuadmm_jacobi_eigh_f32(const float* mats, float* w, float* v, int batch, int n, int sweeps,
                           void* stream) {
  return launch<float>(mats, w, v, batch, n, sweeps, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
