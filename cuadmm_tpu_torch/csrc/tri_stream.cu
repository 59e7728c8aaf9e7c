// Streaming block-triangular solves y = (L L^T)^{-1} r over B x B f32 tiles
// (K2 and K3), one persistent launch per sweep.
//
// Replaces the Pallas kernels of cuadmm_tpu/ops/tri_stream.py:
//   K2  packed_solve: _fwd_kernel + _bwd_kernel (packed lower triangle);
//   K3  band_solve:   _fwd_band_kernel + _bwd_kernel (block band).
// One source serves both layouts: the wrapper (ops/tri_stream.py) turns the
// JAX package's order/row/col/first tables into a work table per sweep,
// and the two entry points below walk it. A forward step solves block row
// i of L x = r; a backward step solves block column i of L^T y = x. Each
// step has a list of off-diagonal tiles (in table order), each with the
// block of the already solved vector it reads, and one diagonal tile,
// which holds inv(L_ii): the diagonal solve is a matvec.
//
// Bound. Every tile is read once per sweep. K2 at the 68k-constraint grid's
// packed layout (nb 67, T 2,278 tiles of 4 MB) reads 9.55 GB per sweep, so
// it is bound by HBM bytes. K3 at the same problem's band (nb 67, nbw 1)
// reads 0.56 GB per sweep, but its steps form a chain of nb dependent
// steps per sweep: there it is bound by the latency of each link.
//
// Design (b): one cooperative launch per sweep, no host loop.
// - Work items, in step order: each off-diagonal tile of a step is cut
//   into B/8 output slabs of 8 entries (rows forward, columns backward),
//   then come the step's B/8 diagonal slabs. CTA c takes items c, c + G,
//   c + 2G, ... (G = gridDim.x), so every item it waits for comes earlier
//   in the table. The grid is at most the co-resident capacity and the
//   launch is cooperative, so a grid that could not be co-resident fails to
//   launch instead of hanging; with all CTAs resident the earliest
//   unfinished item can always run, and the sweep cannot deadlock.
// - Tagged data instead of per-step counters: every entry of the solved
//   vector and of the partial rows is written once per sweep as one 64-bit
//   word {value, epoch} (a relaxed store, atomic as a whole), and a
//   consumer spins on the words it needs until each carries the sweep's
//   epoch. No counter, no fence, no atomic: the data comes with its signal
//   in one L2 round trip, where a counter costs the producer a fence and an
//   atomic and the consumer a second load after the acquire.
//   The epoch lives in one device word beside the scratch: every CTA reads
//   it at entry, and ``epoch_bump_kernel``, one thread launched after each
//   sweep on the same stream, advances it (wrapping past 0, the scratch's
//   initial tag). So the scratch needs no reset between solves, and a sweep
//   captured into a CUDA graph takes a new epoch on every replay: a host
//   counter passed by value would be frozen at capture, and the second
//   replay would accept the first one's words without waiting.
// - Bytes off the chain: as soon as a CTA finishes an item it copies the
//   tile slab (8 x B floats, 32 KB at B = 1024) of its next one into shared
//   memory with cp.async, and a diagonal item's rhs block (written before
//   the launch) with it. With five CTAs per SM a CTA's items lie about
//   2.6 steps apart on the grid's band (256 items a step, 660 CTAs), so the
//   copy runs that far ahead of the chain.
// - Diagonal items sum the step's partials in table order (the same order
//   in every CTA: deterministic, identical across CTAs, no float atomics)
//   into the block's residual in shared memory, then apply their slab of
//   inv(L_ii) (forward) or inv(L_ii)^T (backward).
// - Forward products read rows: a warp per row, float4 along it. Backward
//   products (tile^T v) read columns: the slab is B rows of 8 columns, one
//   32-byte sector each, and lanes map to 8 columns of 4 rows.
// - The solved vector and the partials stay in global memory (x alone is
//   274 KB at n_pad 68,608, more than a CTA's shared memory) and live in
//   the 50 MB L2; tagged words go through L2 (relaxed, gpu scope).
// - Full f32 FMA on the CUDA cores; no TF32, no tensor cores.
// One solve per scratch set may be in flight at a time (the wrapper keeps
// one set per layout and device, and the solver uses one stream).
//
// Constraints (the wrapper raises before the launch): 128 <= B <= 1024,
// B % 128 == 0, all pointers 16-byte aligned.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 8;  // output entries per item
constexpr int kMaxBlock = 1024;
constexpr int kStepInts = 3;      // solved block, first partial row, partial rows
constexpr int kCtasPerSm = 5;  // the occupancy the register budget is set for
constexpr long long kMaxSpins = 1ll << 26;  // polls of one word: seconds, far past any real wait

static_assert(kWarps == kSlab, "forward products give each warp one row of the slab");

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void put_tagged(unsigned long long* p, float v, unsigned epoch) {
  const unsigned long long word = (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long get_word(const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(word) : "l"(p) : "memory");
  return word;
}

// The value of tagged word *p, given a load of it (``word``), once it
// carries ``epoch``: callers issue their loads together and settle them
// after. A wait never lasts seconds; one that does means a broken table or
// epoch, and the trap reports it as a launch failure.
__device__ __forceinline__ float settle(const unsigned long long* p, unsigned long long word,
                                        unsigned epoch) {
  for (long long spins = 0; static_cast<unsigned>(word >> 32) != epoch; ++spins) {
    if (spins > kMaxSpins) __trap();
    __nanosleep(32);
    word = get_word(p);
  }
  return __uint_as_float(static_cast<unsigned>(word));
}

// Shared memory of one CTA: the slab (8 x B), the residual (B), the solved
// block an off-diagonal item reads (B), the backward reduction (kWarps x
// kSlab).
size_t smem_bytes(int B) {
  return (static_cast<size_t>(kSlab) * B + 2 * B + kWarps * kSlab) * sizeof(float);
}

// Copy item ``item``'s slab of its tile into ``slab``: rows e0.. forward
// (slab[r][c]), columns e0.. backward (slab[a][c]); for a diagonal item
// also the rhs block of the block it solves into ``acc``.
template <bool kTrans>
__device__ __forceinline__ void prefetch(const float* tiles, int B, const float* rhs, const int* steps,
                                         int4 item, float* slab, float* acc) {
  constexpr int kCopiers = kThreads;
  const int me = threadIdx.x;
  const float* t = tiles + static_cast<size_t>(item.x) * B * B;
  const int e0 = item.z * kSlab;
  if (!kTrans) {
    const int q4 = B >> 2;
    for (int ch = me; ch < kSlab * q4; ch += kCopiers) {
      const int r = ch / q4, c4 = ch - r * q4;
      cp_async16(slab + r * B + 4 * c4, t + static_cast<size_t>(e0 + r) * B + 4 * c4);
    }
  } else {
    for (int ch = me; ch < 2 * B; ch += kCopiers) {
      const int a = ch >> 1, h = ch & 1;
      cp_async16(slab + a * kSlab + 4 * h, t + static_cast<size_t>(a) * B + e0 + 4 * h);
    }
  }
  if (item.w < 0) {
    const float* r = rhs + static_cast<size_t>(__ldg(steps + item.y * kStepInts)) * B;
    for (int c4 = me; c4 < (B >> 2); c4 += kCopiers) cp_async16(acc + 4 * c4, r + 4 * c4);
  }
}

// items (n_items): tile, step, slab, partial row (-1: a diagonal item);
// row_blk[partial row]: the solved block that row's tile reads. solved
// (n_pad) and parts (partial rows x B) hold tagged words.
template <bool kTrans>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    tri_sweep_kernel(const float* __restrict__ tiles, int B, const int4* __restrict__ items,
                     int n_items, const int* __restrict__ steps, const int* __restrict__ row_blk,
                     const float* __restrict__ rhs, float* __restrict__ out,
                     unsigned long long* solved, unsigned long long* parts,
                     const unsigned* __restrict__ epoch_word) {
  extern __shared__ float4 smem4[];
  const unsigned epoch = *epoch_word;  // fixed for the sweep: the bump runs after it
  float* slab = reinterpret_cast<float*>(smem4);
  float* acc = slab + kSlab * B;
  float* vin = acc + B;  // the solved block an off-diagonal item reads
  float* red = vin + B;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  int it = blockIdx.x;
  if (it < n_items) prefetch<kTrans>(tiles, B, rhs, steps, __ldg(items + it), slab, acc);
  for (; it < n_items; it += gridDim.x) {
    const int4 item = __ldg(items + it);
    const int step = item.y, e0 = item.z * kSlab, prow = item.w;
    const bool diag = prow < 0;
    const int* st = steps + step * kStepInts;
    const int blk = __ldg(st);

    // 2. What the item reads, as it arrives: the solved block (off-diagonal)
    // or the step's partials, summed in table order into the residual
    // (diagonal).
    // Thread 0 alone waits for the word the step's last item writes (its
    // last slab's last entry); the CTA then reads the rest, which by then
    // has almost always landed. (Every thread polling its own words made
    // the ~400 waiting CTAs flood L2 and slow the items that run.)
    const float* v;
    constexpr int kPer = kMaxBlock / kThreads, kBatch = 4;
    const int p0 = __ldg(st + 1), np = __ldg(st + 2);
    const unsigned long long* src =
        diag ? parts + static_cast<size_t>(p0) * B : solved + static_cast<size_t>(__ldg(row_blk + prow)) * B;
    if (tid == 0 && (!diag || np > 0)) {
      const unsigned long long* last = src + (diag ? static_cast<size_t>(np) * B : B) - 1;
      settle(last, get_word(last), epoch);
    }
    cp_async_wait_all();
    __syncthreads();
    if (diag) {
      for (int c = tid; c < B; c += kThreads) {
        const unsigned long long* col = src + c;
        float s = acc[c];
        for (int pb = 0; pb < np; pb += kBatch) {
          unsigned long long wd[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (pb + j < np) wd[j] = get_word(col + static_cast<size_t>(pb + j) * B);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (pb + j < np) s -= settle(col + static_cast<size_t>(pb + j) * B, wd[j], epoch);
          }
        }
        acc[c] = s;
      }
      v = acc;
    } else {
      unsigned long long wd[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (tid + j * kThreads < B) wd[j] = get_word(src + tid + j * kThreads);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tid + j * kThreads;
        if (c < B) vin[c] = settle(src + c, wd[j], epoch);
      }
      v = vin;
    }
    __syncthreads();

    // 3. The product of the slab with v; its 8 entries go out tagged.
    float r = 0.f;
    if (!kTrans) {
      const float4* row = reinterpret_cast<const float4*>(slab + w * B);
      const float4* v4 = reinterpret_cast<const float4*>(v);
      float s = 0.f;
#pragma unroll 4
      for (int q = lane; q < (B >> 2); q += 32) {
        const float4 a = row[q], x = v4[q];
        s = fmaf(a.x, x.x, s);
        s = fmaf(a.y, x.y, s);
        s = fmaf(a.z, x.z, s);
        s = fmaf(a.w, x.w, s);
      }
      r = warp_sum(s);
    } else {
      const int c = lane & 7;
      float s = 0.f;
#pragma unroll 8
      for (int a = (lane >> 3) + 4 * w; a < B; a += 4 * kWarps) s = fmaf(slab[a * kSlab + c], v[a], s);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < kSlab) red[w * kSlab + lane] = s;
      __syncthreads();
      if (tid < kSlab) {
#pragma unroll
        for (int j = 0; j < kWarps; ++j) r += red[j * kSlab + tid];
      }
    }
    // Entry i of the slab: warp i's lane 0 forward, thread i backward.
    const int i = kTrans ? tid : w;
    if (kTrans ? tid < kSlab : lane == 0) {
      if (diag) {
        const size_t at = static_cast<size_t>(blk) * B + e0 + i;
        __stcg(out + at, r);
        put_tagged(solved + at, r, epoch);
      } else {
        put_tagged(parts + static_cast<size_t>(prow) * B + e0 + i, r, epoch);
      }
    }
    // 4. The buffers are free: the next item's copies start now.
    __syncthreads();

    const int next = it + static_cast<int>(gridDim.x);
    if (next < n_items) prefetch<kTrans>(tiles, B, rhs, steps, __ldg(items + next), slab, acc);
  }
}

// Advance the sweep epoch by one, skipping 0 (the tag of fresh scratch).
__global__ void epoch_bump_kernel(unsigned* epoch_word) {
  const unsigned next = *epoch_word + 1u;
  *epoch_word = next != 0u ? next : 1u;
}

template <bool kTrans>
int capacity(int B, int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_sweep_kernel<kTrans>, kThreads,
                                                        smem_bytes(B));
  }
  *ctas = per_sm * sms;
  return static_cast<int>(err);
}

template <bool kTrans>
int sweep(const float* tiles, int B, const int* items, int n_items, const int* steps,
          const int* row_blk, const float* rhs, float* out, void* solved, void* parts,
          unsigned* epoch, int ctas, void* stream) {
  if (B < 128 || B > kMaxBlock || B % 128 != 0 || n_items <= 0 || ctas <= 0 || epoch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int4* items4 = reinterpret_cast<const int4*>(items);
  auto* solved_w = static_cast<unsigned long long*>(solved);
  auto* parts_w = static_cast<unsigned long long*>(parts);
  const unsigned* epoch_r = epoch;
  void* args[] = {&tiles, &B,   &items4, &n_items,  &steps,   &row_blk,
                  &rhs,   &out, &solved_w, &parts_w, &epoch_r};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tri_sweep_kernel<kTrans>),
                                                dim3(ctas), dim3(kThreads), args, smem_bytes(B), s);
  cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  if (err != cudaSuccess || last != cudaSuccess) return static_cast<int>(err != cudaSuccess ? err : last);
  // Only a sweep that launched spends its epoch.
  epoch_bump_kernel<<<1, 1, 0, s>>>(epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The CTAs of one sweep that can be resident at once on the current device
// (the smaller of the two sweeps' capacities) at block size B.
int cuadmm_tri_stream_capacity(int B, int* ctas) {
  int fwd = 0, bwd = 0;
  int err = capacity<false>(B, &fwd);
  if (err == 0) err = capacity<true>(B, &bwd);
  *ctas = fwd < bwd ? fwd : bwd;
  return err;
}

// Forward sweep L x = r (rhs = r, out = x) over the work table on the
// device: ``items`` (n_items x 4 ints), ``steps`` (nb x 3 ints) and
// ``row_blk`` (one int per partial row). ``solved`` (n_pad) and ``parts``
// (partial rows x B) are 64-bit scratch words whose tags differ from the
// device word ``*epoch`` (zero, or an earlier sweep's). ``ctas`` CTAs are
// launched cooperatively on ``stream`` without synchronizing, then one
// thread that advances ``*epoch``; returns the first launch error.
int cuadmm_tri_stream_fwd(const float* tiles, int B, const int* items, int n_items,
                          const int* steps, const int* row_blk, const float* rhs, float* out,
                          void* solved, void* parts, unsigned* epoch, int ctas, void* stream) {
  return sweep<false>(tiles, B, items, n_items, steps, row_blk, rhs, out, solved, parts, epoch, ctas,
                      stream);
}

// Backward sweep L^T y = x (rhs = x, out = y), the same contract.
int cuadmm_tri_stream_bwd(const float* tiles, int B, const int* items, int n_items,
                          const int* steps, const int* row_blk, const float* rhs, float* out,
                          void* solved, void* parts, unsigned* epoch, int ctas, void* stream) {
  return sweep<true>(tiles, B, items, n_items, steps, row_blk, rhs, out, solved, parts, epoch, ctas,
                     stream);
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
