// Fused preconditioner application y = M^T (M r) in one pass over M (K1).
//
// Replaces the Pallas kernel cuadmm_tpu/ops/precond_apply.py::_kernel.
// M = inv(L) is the zero-padded f32 inverse of the Cholesky factor of the
// regularized AA^T, square n_pad x n_pad with n_pad a multiple of 128 and
// at most 32768. Every refinement sweep of the precond normal solver
// applies it once.
//
// Bound: HBM bytes. The kernel does 4 flops per element of M and must read
// all 4 * n_pad^2 bytes of it (1.18 GB at n_pad = 17152) against 3.35 TB/s;
// r and y are 1/n_pad of that. So the only thing that matters is reading M
// from device memory once, at full width, with enough bytes in flight.
//
// Design:
// - One persistent CTA per SM walks rows b, b + grid, b + 2*grid, ...
// - r lives in shared memory (4 * n_pad bytes, 128 KB at n_pad = 32768).
// - Each thread owns the float4 columns q = tid + k * 1024, k < 8, and
//   keeps its slice of the CTA's y-partial in registers (32 floats).
// - For each row: coalesced float4 loads from HBM give the thread's share of
//   t_i = M[i,:] . r, a block reduction gives t_i, then the same row is read
//   again and t_i * M[i,:] is added to the partial. The second read hits L2:
//   the CTAs together hold at most grid * 128 KB (17 MB) of rows between the
//   two reads, well inside the 50 MB L2, so M still leaves HBM once. Keeping
//   the row in registers instead would need 64 more registers a thread at
//   n_pad = 32768, past the 64 that 1024 threads may have.
// - Each CTA writes its partial to scratch (grid, n_pad); a second kernel
//   sums the partials per column in a fixed order, so y is deterministic.
// - Full f32 FMA on the CUDA cores; no TF32, no tensor cores.
//
// Budget at n_pad = 32768: 128 KB dynamic + 256 B static shared memory of
// the 227 KB a CTA may use; __launch_bounds__(1024, 1) caps registers at 64.
// Larger n_pad is rejected (the wrapper raises before the launch).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNPad = 32768;
constexpr int kVecPerThread = kMaxNPad / 4 / kThreads;  // float4 columns a thread owns

static_assert(kWarps == 32, "the block reduction reads one warp partial per lane");

// Second read of a row: volatile so it is not merged with the first read
// (which would keep the row in registers), cache-streaming since the row is
// not needed again.
__device__ __forceinline__ float4 reread_streaming(const float4* p) {
  float4 v;
  asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Sum of v over the block, returned to every thread. The shuffle trees run
// in a fixed order, so the result is deterministic. ``buf`` alternates
// between two halves per row, so one barrier per row suffices: a warp can
// only rewrite a half after every warp passed the barrier of the row between.
__device__ __forceinline__ float block_sum(float v, float* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = buf[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_spd_apply_kernel(const float* __restrict__ m, const float* __restrict__ r,
                           float* __restrict__ partial, int n_pad) {
  extern __shared__ float4 r_s[];
  __shared__ float warp_buf[2][kWarps];
  const int n4 = n_pad >> 2;
  const float4* r4 = reinterpret_cast<const float4*>(r);
  for (int q = threadIdx.x; q < n4; q += kThreads) r_s[q] = r4[q];
  __syncthreads();

  float4 acc[kVecPerThread];
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  int half = 0;
  for (int row = blockIdx.x; row < n_pad; row += gridDim.x) {
    const float4* mrow = reinterpret_cast<const float4*>(m + static_cast<size_t>(row) * n_pad);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < n4) {
        const float4 a = __ldg(mrow + q);
        const float4 b = r_s[q];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
    }
    const float t = block_sum(dot, warp_buf[half]);
    half ^= 1;
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < n4) {
        const float4 a = reread_streaming(mrow + q);
        acc[k].x = fmaf(t, a.x, acc[k].x);
        acc[k].y = fmaf(t, a.y, acc[k].y);
        acc[k].z = fmaf(t, a.z, acc[k].z);
        acc[k].w = fmaf(t, a.w, acc[k].w);
      }
    }
  }

  float4* out = reinterpret_cast<float4*>(partial + static_cast<size_t>(blockIdx.x) * n_pad);
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q < n4) out[q] = acc[k];
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ y,
                                    int n_pad, int grid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  float s = 0.f;
  for (int b = 0; b < grid; ++b) s += partial[static_cast<size_t>(b) * n_pad + j];
  y[j] = s;
}

}  // namespace

extern "C" {

// Lets the kernel take the dynamic shared memory of the largest n_pad. Call
// once per device, with that device current, before the first launch there.
int cuadmm_fused_spd_apply_init(void) {
  return static_cast<int>(cudaFuncSetAttribute(fused_spd_apply_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(kMaxNPad * sizeof(float))));
}

// y = m^T (m r) for m (n_pad, n_pad), r and y (n_pad,), all f32, contiguous
// and 16-byte aligned; partial is (grid, n_pad) scratch. Launches on
// ``stream`` without synchronizing and returns cudaGetLastError().
int cuadmm_fused_spd_apply(const float* m, const float* r, float* partial, float* y, int n_pad,
                           int grid, void* stream) {
  if (n_pad <= 0 || n_pad % 128 != 0 || n_pad > kMaxNPad || grid <= 0 || grid > n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n_pad) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_spd_apply_kernel<<<grid, kThreads, smem, s>>>(m, r, partial, n_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(n_pad + 255) / 256, 256, 0, s>>>(partial, y, n_pad, grid);
  return static_cast<int>(cudaGetLastError());
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
