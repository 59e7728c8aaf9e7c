// Streaming block-triangular solves y = (L L^T)^{-1} r over B x B f32 tiles
// (K2 and K3).
//
// Replaces the Pallas kernels of cuadmm_tpu/ops/tri_stream.py:
//   K2  packed_solve: _fwd_kernel + _bwd_kernel (packed lower triangle);
//   K3  band_solve:   _fwd_band_kernel + _bwd_kernel (block band).
// One source serves both layouts: the wrapper (ops/tri_stream.py) turns the
// JAX package's order/row/col/first tables into step tables, and the two
// entry points below walk them. A forward step solves block row i of
// L x = r; a backward step solves block column i of L^T y = x. Each step has
// a list of off-diagonal tiles (in table order), each with the block of the
// already solved vector it reads, and one diagonal tile, which holds
// inv(L_ii): the diagonal solve is a matvec.
//
// Bound. Every tile is read once per sweep. K2 at the 68k-constraint grid's
// packed layout (nb 67, T 2,278 tiles of 4 MB) reads 9.55 GB per sweep, so
// it is bound by HBM bytes (19.1 GB per solve, >= 5.7 ms at 3.35 TB/s).
// K3 at the same problem's band (nb 67, nbw 1) reads 0.56 GB per sweep, but
// its steps form a chain of nb dependent steps per sweep: there it is bound
// by the latency of each step, not by bytes.
//
// Design (a): two launches per step, queued from the host in one C call
// per sweep (the TPU grid runs in order; CUDA blocks do not, so the step
// chain is kept by stream order).
// - offdiag_kernel: every off-diagonal tile of the step is cut into 128
//   output slabs of 8 entries (rows forward, columns backward) times
//   `split` contraction ranges, one CTA each, so even a step with one tile
//   fills the card (split grows until the grid has 2 CTAs per SM). Each CTA
//   writes its partial product to scratch; no float atomics.
// - diag_kernel: each of 128 CTAs sums the step's partials from scratch in
//   table order (the same order in every CTA, so the result is
//   deterministic and identical across CTAs), keeps the block's residual in
//   shared memory, and writes its 8-entry slab of inv(L_ii) acc (forward)
//   or inv(L_ii)^T acc (backward). One CTA reading the 4 MB diagonal tile
//   would make every step of the chain slow.
// - Forward products read rows: a warp per row, float4 loads along it.
//   Backward products (tile^T v) read columns: lanes map to 8 adjacent
//   columns of 4 rows, so each row segment is one full 32-byte sector.
// - x, y and the partials stay in global memory (x alone is 274 KB at
//   n_pad 68,608, more than a CTA's shared memory) and live in the 50 MB
//   L2; tiles stream through with cache-streaming loads.
// - Full f32 FMA on the CUDA cores; no TF32, no tensor cores.
// A persistent single launch per sweep with per-step flags, TMA and CUDA
// graphs are later work.
//
// Constraints (the wrapper raises before the launch): 128 <= B <= 1024,
// B % 128 == 0, all pointers 16-byte aligned.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 8;  // output entries per CTA
constexpr int kMaxBlock = 1024;

static_assert(kWarps == kSlab, "forward products give each warp one row of the slab");

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// sum_{c in [k0, k0+K)} tile[a, c] * v[c] for row a; every lane gets it.
__device__ __forceinline__ float row_dot(const float* __restrict__ tile, const float* v, int B,
                                         int a, int k0, int K) {
  const int lane = threadIdx.x & 31;
  const float4* row = reinterpret_cast<const float4*>(tile + static_cast<size_t>(a) * B + k0);
  const float4* v4 = reinterpret_cast<const float4*>(v + k0);
  float s = 0.f;
#pragma unroll 4
  for (int q = lane; q < (K >> 2); q += 32) {
    const float4 t = __ldcs(row + q);
    const float4 x = v4[q];
    s = fmaf(t.x, x.x, s);
    s = fmaf(t.y, x.y, s);
    s = fmaf(t.z, x.z, s);
    s = fmaf(t.w, x.w, s);
  }
  return warp_sum(s);
}

// sum_{a in [k0, k0+K)} tile[a, b0 + t] * v[a] for t < kSlab, returned to
// thread t of the CTA. Lane l reads column b0 + (l & 7) of row 4*w + (l >> 3)
// (+ 32 per step); the eight warps' sums are added in warp order.
__device__ __forceinline__ float col_dot(const float* __restrict__ tile, const float* v, int B,
                                         int b0, int k0, int K, float* red) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* col = tile + b0 + (lane & 7);
  float s = 0.f;
#pragma unroll 8
  for (int a = k0 + (lane >> 3) + 4 * w; a < k0 + K; a += 4 * kWarps) {
    s = fmaf(__ldcs(col + static_cast<size_t>(a) * B), v[a], s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  if (lane < kSlab) red[w * kSlab + lane] = s;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < kSlab) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += red[k * kSlab + threadIdx.x];
  }
  return t;
}

// Partial products of one step's off-diagonal tiles: blockIdx.y is the
// tile's place in the step's list, blockIdx.x = slab * split + part.
// partial[(slot * split + part) * B + e] = sum over the part's contraction
// range of tile (fwd) or tile^T (bwd) times the solved block it reads.
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
    offdiag_kernel(const float* __restrict__ tiles, const float* __restrict__ solved,
                   const int* __restrict__ off_tile, const int* __restrict__ off_blk,
                   float* __restrict__ partial, int B, int split) {
  __shared__ float red[kWarps * kSlab];
  const int slot = blockIdx.y;
  const int slab = blockIdx.x / split;
  const int part = blockIdx.x - slab * split;
  const int K = B / split;
  const float* tile = tiles + static_cast<size_t>(off_tile[slot]) * B * B;
  const float* v = solved + static_cast<size_t>(off_blk[slot]) * B;
  float* out = partial + (static_cast<size_t>(slot) * split + part) * B + slab * kSlab;
  if (!kTrans) {
    const float s = row_dot(tile, v, B, slab * kSlab + (threadIdx.x >> 5), part * K, K);
    if ((threadIdx.x & 31) == 0) out[threadIdx.x >> 5] = s;
  } else {
    const float s = col_dot(tile, v, B, slab * kSlab, part * K, K, red);
    if (threadIdx.x < kSlab) out[threadIdx.x] = s;
  }
}

// The step's diagonal solve: acc = rhs_blk - sum of the n_part partials
// (in order), then slab blockIdx.x of inv(L_ii) acc (fwd) or
// inv(L_ii)^T acc (bwd) into out_blk.
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
    diag_kernel(const float* __restrict__ tiles, int diag_tile, const float* __restrict__ rhs_blk,
                const float* __restrict__ partial, int n_part, float* __restrict__ out_blk, int B) {
  __shared__ float4 acc4[kMaxBlock / 4];
  __shared__ float red[kWarps * kSlab];
  float* acc = reinterpret_cast<float*>(acc4);
  for (int c = threadIdx.x; c < B; c += kThreads) {
    float s = rhs_blk[c];
    for (int p = 0; p < n_part; ++p) s -= partial[static_cast<size_t>(p) * B + c];
    acc[c] = s;
  }
  __syncthreads();
  const float* tile = tiles + static_cast<size_t>(diag_tile) * B * B;
  const int e0 = blockIdx.x * kSlab;
  if (!kTrans) {
    const float s = row_dot(tile, acc, B, e0 + (threadIdx.x >> 5), 0, B);
    if ((threadIdx.x & 31) == 0) out_blk[e0 + (threadIdx.x >> 5)] = s;
  } else {
    const float s = col_dot(tile, acc, B, e0, 0, B, red);
    if (threadIdx.x < kSlab) out_blk[e0 + threadIdx.x] = s;
  }
}

// One sweep. Step s solves block step_blk[s]: its off-diagonal tiles are
// off_tile[off_start[s] .. off_start[s+1]) (device), each reading solved
// block off_blk[...] (device); its diagonal tile is diag_tile[s]. The host
// arrays step_blk, diag_tile and off_start are read here, on the host.
template <bool kTrans>
int sweep(const float* tiles, int B, int n_steps, const int* step_blk, const int* diag_tile,
          const int* off_start, const int* off_tile, const int* off_blk, const float* rhs,
          float* out, float* partial, int target_ctas, void* stream) {
  if (B < 128 || B > kMaxBlock || B % 128 != 0 || n_steps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slabs = B / kSlab;
  const int max_split = B / 128;
  for (int s = 0; s < n_steps; ++s) {
    const int cnt = off_start[s + 1] - off_start[s];
    int split = 1;
    if (cnt > 0) {
      while (2 * split <= max_split && cnt * slabs * split < target_ctas) split *= 2;
      const dim3 grid(slabs * split, cnt);
      offdiag_kernel<kTrans><<<grid, kThreads, 0, st>>>(
          tiles, out, off_tile + off_start[s], off_blk + off_start[s], partial, B, split);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t blk = static_cast<size_t>(step_blk[s]) * B;
    diag_kernel<kTrans><<<slabs, kThreads, 0, st>>>(tiles, diag_tile[s], rhs + blk, partial,
                                                    cnt * split, out + blk, B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Forward sweep L x = r (rhs = r, out = x). partial holds at least
// max(off_start[s+1] - off_start[s]) * (B / 128) * B floats. Launches on
// ``stream`` without synchronizing; returns the first cudaGetLastError().
int cuadmm_tri_stream_fwd(const float* tiles, int B, int n_steps, const int* step_blk,
                          const int* diag_tile, const int* off_start, const int* off_tile,
                          const int* off_blk, const float* rhs, float* out, float* partial,
                          int target_ctas, void* stream) {
  return sweep<false>(tiles, B, n_steps, step_blk, diag_tile, off_start, off_tile, off_blk, rhs,
                      out, partial, target_ctas, stream);
}

// Backward sweep L^T y = x (rhs = x, out = y), the same contract.
int cuadmm_tri_stream_bwd(const float* tiles, int B, int n_steps, const int* step_blk,
                          const int* diag_tile, const int* off_start, const int* off_tile,
                          const int* off_blk, const float* rhs, float* out, float* partial,
                          int target_ctas, void* stream) {
  return sweep<true>(tiles, B, n_steps, step_blk, diag_tile, off_start, off_tile, off_blk, rhs,
                     out, partial, target_ctas, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
