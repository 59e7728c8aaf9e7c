// The mirror pass of the poly filter's one-triangle route
// (cuadmm_tpu_torch/ops/polyfilter.py, ops/sym_products.py): from the
// upper triangle of a row-major n x n matrix T, where cuBLAS's syrk and
// syrkx left a symmetric product, write the full symmetric matrix
//
//   out = mul * (T + add_coef * W) + shift * I,   mul = alpha * (*scale),
//
// W an optional second matrix (its upper triangle too) and scale an
// optional device scalar. So one pass both restores the full matrix that
// the next product reads and folds the polynomial's remaining terms into
// it: P = c A^2 + b A + a I from the triangle of c A^2 and A, and the
// projection's 0.5 s (Z Y0 + Y0) with s on the device.
//
// Replaces no TPU kernel: the JAX filter's products are XLA GEMMs on the
// full square and its symmetrization an XLA elementwise pass. It was added
// because the triangle products leave the lower half unwritten.
//
// Bound: bytes. It reads the upper triangle (with W, two of them) and
// writes the square once: at n = 2004 in f64 16 + 32 MB, 14 us at
// 3.35 TB/s (W: 64 MB, 19 us). Design: one CTA of 32 x 8 threads a
// 32 x 32 tile pair (I, J), I <= J, over a 1-D grid of nt (nt + 1) / 2
// CTAs. It loads tile (I, J) with each warp on one row (256 contiguous
// bytes in f64), applies the fold in registers, stages the tile in shared
// memory (one column of padding: the transposed read is free of bank
// conflicts beyond f64's two phases), and writes tile (I, J) and, read
// transposed, tile (J, I), both a row a warp. Each CTA reads and writes
// only its own two tiles, and a diagonal tile is read whole before it is
// written, so ``out`` may be ``T`` (in place); W must not alias ``out``.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // threadIdx.y; each thread handles TILE / ROWS rows

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
    sym_mirror_kernel(const T* t, const T* add, T add_coef, const T* scale, T alpha, T shift, T* out,
                      int n) {
  __shared__ T tile[TILE][TILE + 1];
  // Linear index k over the pairs I <= J, ordered by J: k = J (J + 1) / 2 + I.
  const long long k = blockIdx.x;
  int bj = static_cast<int>((sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(bj) * (bj + 1) / 2 > k) --bj;
  while (static_cast<long long>(bj + 1) * (bj + 2) / 2 <= k) ++bj;
  const int bi = static_cast<int>(k - static_cast<long long>(bj) * (bj + 1) / 2);
  const int r0 = bi * TILE, c0 = bj * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const T mul = scale != nullptr ? alpha * scale[0] : alpha;

#pragma unroll
  for (int q = 0; q < TILE / ROWS; ++q) {
    const int r = r0 + ty + q * ROWS, c = c0 + tx;
    T v = T(0);
    if (r < n && c < n && r <= c) {  // the upper triangle only
      const size_t at = static_cast<size_t>(r) * n + c;
      v = t[at];
      if (add != nullptr) v = fma(add_coef, add[at], v);
      v *= mul;
      if (r == c) v += shift;
    }
    tile[ty + q * ROWS][tx] = v;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < TILE / ROWS; ++q) {
    const int rl = ty + q * ROWS;
    const int r = r0 + rl, c = c0 + tx;
    if (r < n && c < n) {
      // Below the diagonal of a diagonal tile: the mirrored entry.
      out[static_cast<size_t>(r) * n + c] = r <= c ? tile[rl][tx] : tile[tx][rl];
    }
  }
  if (bi == bj) return;
#pragma unroll
  for (int q = 0; q < TILE / ROWS; ++q) {
    const int rl = ty + q * ROWS;
    const int r = c0 + rl, c = r0 + tx;  // tile (J, I): entry (r, c) is (c, r) of tile (I, J)
    if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = tile[tx][rl];
  }
}

template <typename T>
int launch(const T* t, const T* add, T add_coef, const T* scale, T alpha, T shift, T* out, int n,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = (n + TILE - 1) / TILE;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sym_mirror_kernel<T><<<static_cast<unsigned>(pairs), dim3(TILE, ROWS), 0,
                         static_cast<cudaStream_t>(stream)>>>(t, add, add_coef, scale, alpha, shift, out,
                                                              n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = alpha * (*scale) * (T + add_coef * W) + shift * I from the upper
// triangles of T and W (row-major, n x n, contiguous); ``add`` and
// ``scale`` may be null (no W; a scale of 1). Returns the launch's
// cudaError_t.
int cuadmm_sym_mirror_f64(const double* t, const double* add, double add_coef, const double* scale,
                          double alpha, double shift, double* out, int n, void* stream) {
  return launch<double>(t, add, add_coef, scale, alpha, shift, out, n, stream);
}

int cuadmm_sym_mirror_f32(const float* t, const float* add, float add_coef, const float* scale,
                          float alpha, float shift, float* out, int n, void* stream) {
  return launch<float>(t, add, add_coef, scale, alpha, shift, out, n, stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
