// Bucketed-ELL products of the constraint matrix (cuadmm_tpu_torch/ops/
// sparse.py): out = T x for one direction T of A (A x, A^T y, or a half of
// the composed AA^T y), every bucket of the table in one launch, for up to
// a batch's instances at once.
//
// Replaces no TPU kernel: the JAX package leaves these gathers to XLA
// (cuadmm_tpu/ops/sparse.py::_ell_matvec), and the port's plain version is
// the same chain of torch ops: a cat that appends the padding zero to x,
// a materialised gather, a product and a row sum a bucket, a cat of the
// bucket sums and a placement gather, each through device memory. That is
// 11 to 17 device ops a product.
//
// Bound. At G11's size (18,692 constraints, 113,152 pool slots, 36,584
// entries) the bytes take a few microseconds at 3.35 TB/s: launch latency
// bounds it, and the design answers with one launch a product (two where
// the output is mostly zero: a fill, then this kernel's scatter). At
// QUASAR-500's (756,501 constraints, 4,016,016 pool slots, 1.5 M entries)
// bytes bound it: the placement map, the tables and the output each once,
// x gathered from L2. The design reads each once and keeps every partial
// sum in registers: nothing is materialised.
//
// Design. One thread an output element e, which names a row of the
// concatenated buckets: row = src[e] (out_perm, or out_src where dst =
// out_pos places it), or row = e (the composed AA^T's compact sums). A row
// past the last bucket (out_perm's sentinel) sums to zero. The thread finds
// the row's bucket among the descriptors, passed by value (kernel
// parameters: nothing to upload, and a CUDA graph keeps them), and sums
// the row in index order; an index equal to in_len is padding and is
// skipped, so x needs no appended zero. A row of WIDE entries or more (the
// trace constraint's 2,048 in QUASAR-500, a diagonal slot 512 constraints
// share) is summed by the whole block: the block takes its wide rows one
// after another, each thread a strided share in order, then a xor-shuffle
// tree in each warp and the warps' sums in order. A thread alone would take
// a chain of 2,048 dependent loads (index, then x); a warp, with its loads
// batched, needs registers that halve the occupancy of the narrow rows,
// which are most of the work. Every sum runs in a fixed order: the result
// is the same bits on every launch and graph replay, and the sums use no
// atomics. Each output element is written once.
//
// Instances. x is (n_lead, in_len) and out (n_lead, out_len), row-major. A
// thread serves NB instances (1, 2, 4 or 8, grid.y over groups of NB), so
// a row's indices and values are read once for all of them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_BUCKETS = 32;  // power-of-two widths of a row
constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WIDE = 32;  // rows this wide or wider take a warp
constexpr unsigned FULL = 0xffffffffu;

struct Buckets {
  long long row_off[MAX_BUCKETS + 1];  // first row of each bucket among the concatenated rows; the total last
  const long long* idx[MAX_BUCKETS];   // (rows, width) row-major gather indices into x, in_len = padding
  const void* val[MAX_BUCKETS];        // (rows, width) values, T
  int width[MAX_BUCKETS];
  int n;
};

// acc[i] += the entries k = begin, begin + step, ... < end of one row
// against instance i's x, in that order.
template <typename T, int NB>
__device__ __forceinline__ void sum_entries(const long long* ip, const T* vp, int begin, int end, int step,
                                            const T* xb, long long in_len, int ni, T* acc) {
  const unsigned long long n_in = static_cast<unsigned long long>(in_len);
  for (int k = begin; k < end; k += step) {
    const long long j = __ldg(ip + k);
    if (static_cast<unsigned long long>(j) < n_in) {  // index in_len: padding
      const T v = __ldg(vp + k);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (i < ni) acc[i] = fma(v, __ldg(xb + i * in_len + j), acc[i]);
    }
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
    ell_gather_kernel(const Buckets bk, const T* __restrict__ x, long long in_len, int n_lead,
                      const long long* __restrict__ src, const long long* __restrict__ dst, long long n_elem,
                      T* __restrict__ out, long long out_len) {
  __shared__ int n_wide;
  __shared__ int wide[THREADS];  // the threads whose rows are wide
  __shared__ const long long* row_idx[THREADS];
  __shared__ const T* row_val[THREADS];
  __shared__ int row_w[THREADS];
  __shared__ T warp_sum[THREADS / WARP][NB];

  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
  const int i0 = blockIdx.y * NB;
  const int ni = min(NB, n_lead - i0);
  const T* xb = x + static_cast<long long>(i0) * in_len;
  if (threadIdx.x == 0) n_wide = 0;

  long long row = -1, at = e;
  if (e < n_elem) {
    row = src != nullptr ? src[e] : e;
    if (dst != nullptr) at = dst[e];
  }
  const long long* ip = nullptr;
  const T* vp = nullptr;
  int w = 0;
#pragma unroll
  for (int k = 0; k < MAX_BUCKETS; ++k) {
    if (k < bk.n && row >= bk.row_off[k] && row < bk.row_off[k + 1]) {
      const long long r = row - bk.row_off[k];
      w = bk.width[k];
      ip = bk.idx[k] + r * w;
      vp = static_cast<const T*>(bk.val[k]) + r * w;
    }
  }

  T acc[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i] = T(0);
  const bool is_wide = w >= WIDE;
  __syncthreads();  // n_wide is 0
  if (is_wide) {
    wide[atomicAdd(&n_wide, 1)] = threadIdx.x;  // the list's order changes no sum
    row_idx[threadIdx.x] = ip;
    row_val[threadIdx.x] = vp;
    row_w[threadIdx.x] = w;
  } else {
    sum_entries<T, NB>(ip, vp, 0, w, 1, xb, in_len, ni, acc);
  }
  __syncthreads();

  // The block's wide rows, one after another: each thread a strided share
  // in order, a xor tree in each warp (the same bits in every lane), then
  // the warps' sums in warp order.
  for (int q = 0; q < n_wide; ++q) {
    const int owner = wide[q];
    T part[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) part[i] = T(0);
    sum_entries<T, NB>(row_idx[owner], row_val[owner], threadIdx.x, row_w[owner], THREADS, xb, in_len, ni, part);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
#pragma unroll
      for (int d = WARP / 2; d > 0; d >>= 1) part[i] += __shfl_xor_sync(FULL, part[i], d);
      if (lane == 0) warp_sum[warp][i] = part[i];
    }
    __syncthreads();
    if (threadIdx.x == owner) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        acc[i] = warp_sum[0][i];
        for (int m = 1; m < THREADS / WARP; ++m) acc[i] += warp_sum[m][i];
      }
    }
    __syncthreads();  // warp_sum is read before the next row writes it
  }

  if (e < n_elem) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < ni) out[static_cast<long long>(i0 + i) * out_len + at] = acc[i];
  }
}

template <typename T, int NB>
int launch_nb(const Buckets& bk, const T* x, long long in_len, int n_lead, const long long* src,
              const long long* dst, long long n_elem, T* out, long long out_len, cudaStream_t stream) {
  const long long blocks = (n_elem + THREADS - 1) / THREADS;
  const long long groups = (n_lead + NB - 1) / NB;
  if (blocks > 0x7fffffffLL || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ell_gather_kernel<T, NB><<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)), THREADS, 0,
                             stream>>>(bk, x, in_len, n_lead, src, dst, n_elem, out, out_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const long long* desc, int nb, const T* x, long long in_len, int n_lead, const long long* src,
           const long long* dst, long long n_elem, T* out, long long out_len, void* stream) {
  if (nb < 0 || nb > MAX_BUCKETS || n_lead < 1 || n_elem < 1 || in_len < 0 || out_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Buckets bk{};
  bk.n = nb;
  for (int k = 0; k <= nb; ++k) bk.row_off[k] = desc[k];
  for (int k = 0; k < nb; ++k) {
    bk.idx[k] = reinterpret_cast<const long long*>(desc[nb + 1 + k]);
    bk.val[k] = reinterpret_cast<const void*>(desc[2 * nb + 1 + k]);
    bk.width[k] = static_cast<int>(desc[3 * nb + 1 + k]);
  }
  for (int k = nb; k < MAX_BUCKETS; ++k) bk.row_off[k + 1] = bk.row_off[nb];
  auto s = static_cast<cudaStream_t>(stream);
  if (n_lead == 1) return launch_nb<T, 1>(bk, x, in_len, n_lead, src, dst, n_elem, out, out_len, s);
  if (n_lead == 2) return launch_nb<T, 2>(bk, x, in_len, n_lead, src, dst, n_elem, out, out_len, s);
  if (n_lead <= 4) return launch_nb<T, 4>(bk, x, in_len, n_lead, src, dst, n_elem, out, out_len, s);
  return launch_nb<T, 8>(bk, x, in_len, n_lead, src, dst, n_elem, out, out_len, s);
}

}  // namespace

extern "C" {

// out[i, at(e)] = sum over row(e) of val * x[i, idx] for e < n_elem and
// instances i < n_lead, as set out above. ``desc`` is a host array of
// 4 nb + 1 int64: the nb + 1 row offsets, then the nb index pointers, the
// nb value pointers and the nb widths. ``src`` null: row(e) = e; ``dst``
// null: at(e) = e. Returns the launch's cudaError_t.
int cuadmm_ell_gather_f64(const long long* desc, int nb, const double* x, long long in_len, int n_lead,
                          const long long* src, const long long* dst, long long n_elem, double* out,
                          long long out_len, void* stream) {
  return launch<double>(desc, nb, x, in_len, n_lead, src, dst, n_elem, out, out_len, stream);
}

int cuadmm_ell_gather_f32(const long long* desc, int nb, const float* x, long long in_len, int n_lead,
                          const long long* src, const long long* dst, long long n_elem, float* out,
                          long long out_len, void* stream) {
  return launch<float>(desc, nb, x, in_len, n_lead, src, dst, n_elem, out, out_len, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
