// Streaming block-triangular solves y = (L L^T)^{-1} r over B x B f32 tiles
// (K2 and K3), one persistent launch per sweep.
//
// Replaces the Pallas kernels of cuadmm_tpu/ops/tri_stream.py:
//   K2  packed_solve: _fwd_kernel + _bwd_kernel (packed lower triangle);
//   K3  band_solve:   _fwd_band_kernel + _bwd_kernel (block band).
// The wrapper (ops/tri_stream.py) turns the JAX package's order/row/col/
// first tables into work tables per sweep, and the entry points below walk
// them. A forward step solves block row i of L x = r; a backward step
// solves block column i of L^T y = x. Diagonal tiles hold inv(L_ii), so a
// diagonal solve is a matvec. Two forms:
//
// - The two-hop form (tri_sweep_kernel; K2, and K3 on bands wider than
//   NBW_CHAIN = 4): x_i = inv(L_ii) (r_i - sum_j L_ij x_j), as the TPU
//   kernels compute it. A step is two dependent hops: the off-diagonal
//   items wait for x_j and write partial rows, then the diagonal items wait
//   for every partial, sum them and apply inv(L_ii).
// - The one-hop form (chain_sweep_kernel; K3 at nbw <= 4 where W and Ut
//   fit the card beside the band, limits.band_form), re-associated:
//     forward   x_i = inv(L_ii) r_i   - sum_{j=i-nbw}^{i-1} W_ij x_j,
//     backward  y_i = inv(L_ii)^T x_i - sum_{j=i+1}^{i+nbw} Ut_ij y_j,
//   W_ij = inv(L_ii) L_ij, Ut_ij = (L_ji inv(L_ii))^T, formed once per
//   factor in f64 and rounded once (tri_stream.band_chain). A step waits
//   on one hop: the diagonal term needs no solved block (r and x are
//   complete before the sweep), and only the newest block x_{i-1} (y_{i+1})
//   is on the chain. The partial rows and the diagonal sum disappear.
//
// Bound. Every tile is read once per sweep in either form (the one-hop
// form reads inv(L_ii) and the W row, or inv(L_ii) and the Ut column,
// instead of inv(L_ii) and the L row or column). K2 at the 68k-constraint
// grid's packed layout (nb 67, T 2,278 tiles of 4 MB) reads 9.55 GB per
// sweep: bound by HBM bytes. K3 at the same problem's band (nb 67, nbw 1,
// B 1024) reads 0.56 GB per sweep, 8.4 MB a step: 2.5 us a step at 3.35
// TB/s, against a chain of nb dependent steps.
//
// What the timeline showed (k3_ab.py --timeline, %globaltimer stamps at
// each item's wait, data and write, that grid band at B 1024; PERF.md
// §6): the two-hop form took 6.2 us a forward step, two hops of about
// 3.1 us: the producers' writes spread over 0.8-1.3 us (128 of them), and
// a consumer had its slab and all its words 1.5-2.1 us after thread 0 saw
// the last one (a second L2 trip, and slab copies not yet landed). The
// one-hop form takes 3.5 us a step: a 1.1 us spread of its 64 producers,
// 1.0 us from the last write to the first consumer seeing it, 0.2 us to
// the slab and all words. So the hop's latency, not the bytes, sets the
// two-hop form's step; the one-hop form halves the hops, keeps the bytes
// off the chain and nears the bytes' 2.5 us.
//
// Design, both forms: one cooperative launch per sweep, no host loop.
// - CTA c takes work items c, c + G, c + 2G, ... (G = gridDim.x), and every
//   item it waits for comes earlier in the table. The grid is at most the
//   co-resident capacity and the launch is cooperative, so a grid that
//   could not be co-resident fails to launch instead of hanging; with all
//   CTAs resident the earliest unfinished item can always run, and the
//   sweep cannot deadlock.
// - Tagged data instead of per-step counters: every entry of the solved
//   vector (and of the two-hop form's partial rows) is written once per
//   sweep as one 64-bit word {value, epoch} (a relaxed store, atomic as a
//   whole), and a consumer spins on the words it needs until each carries
//   the sweep's epoch: the data comes with its signal in one L2 round trip.
//   The epoch lives in one device word beside the scratch: every CTA reads
//   it at entry, and ``epoch_bump_kernel``, one thread launched after each
//   sweep on the same stream, advances it (wrapping past 0, the scratch's
//   initial tag). So the scratch needs no reset between solves, and a sweep
//   captured into a CUDA graph takes a new epoch on every replay.
// - Deterministic: every sum runs in the tables' fixed order, no float
//   atomics. Full f32 FMA on the CUDA cores; no TF32, no tensor cores.
// - The solved vector stays in global memory (274 KB at n_pad 68,608, more
//   than a CTA's shared memory) and lives in the 50 MB L2.
// Two-hop form: each off-diagonal tile of a step is cut into B/8 output
// slabs of 8 entries (rows forward, columns backward), then come the
// step's B/8 diagonal slabs; a CTA copies its next item's slab (32 KB at B
// 1024) with cp.async as soon as it finishes an item (five CTAs an SM);
// thread 0 waits for the step's last word before the CTA reads the rest.
// One-hop form: an item is 16 output entries of a step (B/16 items a step:
// fan-in 64 at B 1024, where the two-hop form's is 128); its slabs (the
// diagonal tile's first, then its W or Ut tiles', the newest block last)
// stream through a ring of as many 16 x B slab buffers as shared memory
// holds (3 at B 1024, 7 at 512, 8 at 256; one CTA an SM), refilled as soon
// as one is consumed, so the bytes run two steps ahead of the chain; for
// the newest block thread 0 spins (no backoff) on its last word, then
// every thread loads its own words. Backward, inv(L_ii)'s columns are read
// as a column slab and Ut's rows as row slabs (Ut is stored transposed).
// One solve per scratch set may be in flight at a time (the wrapper keeps
// one set per layout and device, and the solver uses one stream).
//
// Constraints (the wrapper raises before the launch): 128 <= B <= 1024,
// B % 128 == 0, all pointers 16-byte aligned.
//
// The segments form (chain_sweep_kernel_segments; K3 on bands whose RCM
// order falls apart into short independent segments, ops/tri_stream.py's
// SegmentBand; replaces no TPU kernel: the JAX package streams tiles
// whatever the band holds). The factor of a block-diagonal matrix is
// block-diagonal, so L x = r and L^T y = x fall apart into one short chain
// a segment. The tiles are gone: the band's rows are held compactly, N x
// (bw + 1) f32 with 1 / L_ii last (G50: about 139,192 x 5, 2.79 MB with
// its padding, against 1.14 GB of tiles), and one launch solves both ways.
// Bound. The bytes (the band, r and y once: 3.9 MB at G50, 1.2 us at
// 3.35 TB/s) are not what bounds it: a launch, a few dependent memory
// trips and the longest segment's chain of dependent rows are (30 rows
// each way at G50). So the bytes are kept off the chain:
// - a CTA owns a chunk of whole segments (at most kSegThreads of them and
//   about 256 rows: more CTAs, less staging each), which its threads first
//   stage into shared memory with every load in flight at once: the
//   band's rows in one coalesced stream (stored column by column), r's
//   entries gathered through the order (in f64), the order itself;
// - a chunk is laid out position-major, row j of its t-th segment at j T +
//   t, so at each step of their chains a warp's threads touch neighbouring
//   words (a first layout, each segment's rows together, cost G50 21.6 us
//   a solve on an H100 in bank conflicts; this one 8.1);
// - each thread substitutes its own segment forward and backward in f64,
//   the last bw solved entries in registers (``win``, the widest band a
//   template holds), so only the newest one is on the chain;
// - the CTA writes y through the order in r's dtype.
// No cooperative launch, no tagged scratch, no epoch: chunks share
// nothing. The segments come longest first, so a warp's 32 chains have
// near lengths. Deterministic: fixed order, no atomics.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Timeline stamps (%globaltimer_lo, ns) for k3_ab.py's measurement of the
// hop. Only a build with -DCUADMM_TRI_STAMPS (k3_ab.py builds it under its
// own library name) records them; in the build that ships and is timed the
// macro is empty and the kernels compile as if it were not there.
#ifdef CUADMM_TRI_STAMPS
// Per work item: 0 start, 1 wait for the newest data begun, 2 thread 0 saw
// its words, 3 slab and data ready in the CTA, 4 written.
constexpr int kStamps = 5;
__device__ unsigned* g_stamps[2];  // forward, backward: kStamps words an item
#define TRI_STAMP(trans, it, k)                                            \
  do {                                                                     \
    if (threadIdx.x == 0 && g_stamps[trans] != nullptr) {                  \
      unsigned t_;                                                         \
      asm volatile("mov.u32 %0, %%globaltimer_lo;" : "=r"(t_)::"memory"); \
      g_stamps[trans][kStamps * static_cast<size_t>(it) + (k)] = t_;       \
    }                                                                      \
  } while (0)
#else
#define TRI_STAMP(trans, it, k) \
  do {                          \
  } while (0)
#endif

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

// settle() without the backoff between polls: the one-hop form spins.
__device__ __forceinline__ float settle_spin(const unsigned long long* p, unsigned long long word,
                                             unsigned epoch) {
  for (long long spins = 0; static_cast<unsigned>(word >> 32) != epoch; ++spins) {
    if (spins > kMaxSpins) __trap();
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
    TRI_STAMP(kTrans, it, 0);
    TRI_STAMP(kTrans, it, 1);
    if (tid == 0 && (!diag || np > 0)) {
      const unsigned long long* last = src + (diag ? static_cast<size_t>(np) * B : B) - 1;
      settle(last, get_word(last), epoch);
    }
    TRI_STAMP(kTrans, it, 2);
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
    TRI_STAMP(kTrans, it, 3);

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
    TRI_STAMP(kTrans, it, 4);
    // 4. The buffers are free: the next item's copies start now.
    __syncthreads();

    const int next = it + static_cast<int>(gridDim.x);
    if (next < n_items) prefetch<kTrans>(tiles, B, rhs, steps, __ldg(items + next), slab, acc);
  }
}

// ---------------------------------------------------------------------------
// The one-hop form (narrow bands): x_i = inv(L_ii) r_i - sum_j W_ij x_j
// forward, y_i = inv(L_ii)^T x_i - sum_j Ut_ij y_j backward, W and Ut
// (``chain``) formed once per factor by the wrapper's caller. Work item it
// = step it / P, output slab (it % P) * kS.. of kS entries (P = B / kS).
// An item's tile slabs (its diagonal tile's, then its chain tiles' in table
// order, the newest solved block last) stream through a ring of ``stages``
// slab buffers that the CTA refills as soon as one is consumed.

constexpr int kMaxStages = 8;
constexpr int kS = 16;  // output entries per one-hop item

static_assert(kS % kWarps == 0 && 32 % kS == 0, "the one-hop products split a slab over the warps and lanes");

// Shared memory of the one-hop kernel: the ring, the solved block read
// (B), the item's accumulator (kS), the backward reduction (kWarps x kS).
size_t chain_smem_bytes(int B, int stages) {
  return (static_cast<size_t>(stages) * kS * B + B + kS + kWarps * kS) * sizeof(float);
}

// cp.async.wait_group takes an immediate: at most n groups left pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// A position in the CTA's sequence of tile slabs: item ``it``, slab ``pos``
// of it (0: the diagonal tile, 1..n_off: the chain tiles).
struct Cursor {
  int it, pos;
};

// One-hop tables: steps (nb x 4 ints) block solved, diagonal tile, first
// and count of its chain entries; offs (2 ints an entry) chain tile and
// the solved block it multiplies.
__device__ __forceinline__ void advance(Cursor& c, const int4* steps, int per_step, int stride) {
  const int n_off = __ldg(&steps[c.it / per_step].w);
  if (++c.pos > n_off) {
    c.pos = 0;
    c.it += stride;
  }
}

// Copy slab ``c`` into ``buf``: rows e0.. of the tile (a chain tile, or the
// diagonal tile forward), or columns e0.. of inv(L_ii) backward (buf[a][j]).
template <bool kTrans>
__device__ __forceinline__ void load_slab(const float* tiles, const float* chain, int B, const int4* steps,
                                          const int2* offs, int per_step, Cursor c, float* buf) {
  const int4 st = __ldg(steps + c.it / per_step);
  const int e0 = (c.it % per_step) * kS;
  const float* t = c.pos == 0 ? tiles + static_cast<size_t>(st.y) * B * B
                              : chain + static_cast<size_t>(__ldg(&offs[st.z + c.pos - 1].x)) * B * B;
  if (kTrans && c.pos == 0) {
    constexpr int q = kS / 4;
    for (int ch = threadIdx.x; ch < B * q; ch += kThreads) {
      const int a = ch / q, h = ch - a * q;
      cp_async16(buf + a * kS + 4 * h, t + static_cast<size_t>(a) * B + e0 + 4 * h);
    }
  } else {
    const float* src = t + static_cast<size_t>(e0) * B;
    for (int ch = threadIdx.x; ch < kS * B / 4; ch += kThreads) cp_async16(buf + 4 * ch, src + 4 * ch);
  }
}

template <bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
    chain_sweep_kernel(const float* __restrict__ tiles, const float* __restrict__ chain, int B, int nb,
                       int stages, const int4* __restrict__ steps, const int2* __restrict__ offs,
                       const float* __restrict__ rhs, float* __restrict__ out, unsigned long long* solved,
                       const unsigned* __restrict__ epoch_word) {
  constexpr int kR = kS / kWarps;  // rows of a slab each warp takes (forward products)
  extern __shared__ float4 smem4[];
  const unsigned epoch = *epoch_word;
  float* ring = reinterpret_cast<float*>(smem4);
  float* vin = ring + static_cast<size_t>(stages) * kS * B;
  float* acc = vin + B;
  float* red = acc + kS;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per_step = B / kS, n_items = nb * per_step, G = gridDim.x;

  // Prologue: one commit group a stage, empty past the CTA's last slab, so
  // that exactly stages - 1 groups are younger than the one consumed next.
  Cursor load{static_cast<int>(blockIdx.x), 0};
  for (int s = 0; s < stages; ++s) {
    if (load.it < n_items) {
      load_slab<kTrans>(tiles, chain, B, steps, offs, per_step, load, ring + static_cast<size_t>(s) * kS * B);
      advance(load, steps, per_step, G);
    }
    cp_async_commit();
  }

  int k = 0;  // slabs consumed
  for (Cursor c{static_cast<int>(blockIdx.x), 0}; c.it < n_items; ++k) {
    const int4 st = __ldg(steps + c.it / per_step);
    const int blk = st.x, e0 = (c.it % per_step) * kS, n_off = st.w;
    const bool last = c.pos == n_off;
    const float* buf = ring + static_cast<size_t>(k % stages) * kS * B;
    if (c.pos == 0) TRI_STAMP(kTrans, c.it, 0);

    // What the slab multiplies: the rhs block (complete before the sweep)
    // for the diagonal tile, else a solved block, every thread settling
    // its own tagged words into vin.
    const float* v;
    if (c.pos == 0) {
      v = rhs + static_cast<size_t>(blk) * B;
    } else {
      const int rb = __ldg(&offs[st.z + c.pos - 1].y);
      const unsigned long long* src = solved + static_cast<size_t>(rb) * B;
      if (last) {  // thread 0 waits for the newest block's last word before the CTA loads the rest
        TRI_STAMP(kTrans, c.it, 1);
        if (tid == 0) settle_spin(src + B - 1, get_word(src + B - 1), epoch);
        __syncthreads();
      }
      constexpr int kPer = kMaxBlock / kThreads;
      unsigned long long wd[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (tid + j * kThreads < B) wd[j] = get_word(src + tid + j * kThreads);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int cc = tid + j * kThreads;
        if (cc < B) vin[cc] = settle_spin(src + cc, wd[j], epoch);
      }
      if (last) TRI_STAMP(kTrans, c.it, 2);
      v = vin;
    }
    cp_async_wait_pending(stages - 1);
    __syncthreads();
    if (last) TRI_STAMP(kTrans, c.it, 3);

    if (kTrans && c.pos == 0) {
      // inv(L_ii)^T x_i: the slab is B rows of kS columns; the lanes of a
      // warp take kS columns of 32 / kS rows.
      constexpr int kL = 32 / kS;
      const int col = lane % kS;
      float s = 0.f;
#pragma unroll 8
      for (int a = lane / kS + kL * w; a < B; a += kL * kWarps) s = fmaf(buf[a * kS + col], __ldg(v + a), s);
#pragma unroll
      for (int off = kS; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < kS) red[w * kS + col] = s;
      __syncthreads();
      if (tid < kS) {
        float r = 0.f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) r += red[j * kS + tid];
        acc[tid] = r;
        if (last) {
          const size_t at = static_cast<size_t>(blk) * B + e0 + tid;
          __stcg(out + at, r);
          put_tagged(solved + at, r, epoch);
        }
      }
    } else {
      // Rows w, w + 8, ... of the slab against v, a warp a row, float4
      // along it.
      float s[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) s[j] = 0.f;
      const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 4
      for (int q = lane; q < (B >> 2); q += 32) {
        const float4 x = v4[q];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const float4 a = reinterpret_cast<const float4*>(buf + (w + kWarps * j) * B)[q];
          s[j] = fmaf(a.x, x.x, s[j]);
          s[j] = fmaf(a.y, x.y, s[j]);
          s[j] = fmaf(a.z, x.z, s[j]);
          s[j] = fmaf(a.w, x.w, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float d = warp_sum(s[j]);
        if (lane == 0) {
          const int row = w + kWarps * j;
          const float r = c.pos == 0 ? d : acc[row] - d;
          acc[row] = r;
          if (last) {
            const size_t at = static_cast<size_t>(blk) * B + e0 + row;
            __stcg(out + at, r);
            put_tagged(solved + at, r, epoch);
          }
        }
      }
    }
    if (last) TRI_STAMP(kTrans, c.it, 4);
    // The slab's buffer and vin are free: refill the buffer with the slab
    // ``stages`` ahead.
    __syncthreads();
    if (load.it < n_items) {
      load_slab<kTrans>(tiles, chain, B, steps, offs, per_step, load,
                            ring + static_cast<size_t>(k % stages) * kS * B);
      advance(load, steps, per_step, G);
    }
    cp_async_commit();
    advance(c, steps, per_step, G);
  }
  cp_async_wait_pending(0);
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

// The attribute is the kernel's, not a block size's: it is set to the
// card's most (every plan's size fits under it), so that planning another
// block never lowers it under an earlier plan's.
template <bool kTrans>
cudaError_t chain_attr(int optin) {
  return cudaFuncSetAttribute(chain_sweep_kernel<kTrans>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

// The one-hop kernel's ring depth at block B (as many slab buffers as the
// card's shared memory a block holds, at most kMaxStages) and the CTAs of
// one sweep that can be resident at once (both sweeps' smaller count).
int chain_plan(int B, int* stages, int* ctas) {
  int dev = 0, optin = 0, sms = 0, fwd = 0, bwd = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t slab = static_cast<size_t>(kS) * B * sizeof(float);
  const size_t rest = chain_smem_bytes(B, 0);
  int st = optin > static_cast<int>(rest) ? static_cast<int>((optin - rest) / slab) : 0;
  st = st < kMaxStages ? st : kMaxStages;
  if (st < 2) return static_cast<int>(cudaErrorInvalidValue);
  err = chain_attr<false>(optin);
  if (err == cudaSuccess) err = chain_attr<true>(optin);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fwd, chain_sweep_kernel<false>, kThreads,
                                                        chain_smem_bytes(B, st));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bwd, chain_sweep_kernel<true>, kThreads,
                                                        chain_smem_bytes(B, st));
  }
  *stages = st;
  *ctas = (fwd < bwd ? fwd : bwd) * sms;
  return static_cast<int>(err);
}

template <bool kTrans>
int chain_sweep(const float* tiles, const float* chain, int B, int nb, int stages, const int* steps,
                const int* offs, const float* rhs, float* out, void* solved, unsigned* epoch, int ctas,
                void* stream) {
  if (B < 128 || B > kMaxBlock || B % 128 != 0 || nb <= 0 || ctas <= 0 || stages < 2 || stages > kMaxStages ||
      epoch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int4* steps4 = reinterpret_cast<const int4*>(steps);
  const int2* offs2 = reinterpret_cast<const int2*>(offs);
  auto* solved_w = static_cast<unsigned long long*>(solved);
  const unsigned* epoch_r = epoch;
  void* args[] = {&tiles, &chain, &B, &nb, &stages, &steps4, &offs2, &rhs, &out, &solved_w, &epoch_r};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_sweep_kernel<kTrans>),
                                                dim3(ctas), dim3(kThreads), args, chain_smem_bytes(B, stages), s);
  cudaError_t last = cudaGetLastError();
  if (err != cudaSuccess || last != cudaSuccess) return static_cast<int>(err != cudaSuccess ? err : last);
  epoch_bump_kernel<<<1, 1, 0, s>>>(epoch);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The segments form. chunks (C + 1 int2): each CTA's first segment and first
// row, then (S, N); seg_len (S ints): each segment's rows, longest first;
// order (N ints): the solver row of each row, -1 on padding; band (N x
// (bw + 1) f32): row q's entries L[q, q-bw..q-1], zero before its segment,
// then 1 / L[q, q]. A chunk of T segments, the longest M rows, holds M T
// rows position-major: row j of its segment t at its first row + j T + t.

constexpr int kSegThreads = 128;
constexpr size_t kSegSmem = 48 * 1024;

// W: the widest band the thread's window holds (bw <= W), so the window of
// the last W solved entries lives in registers.
template <typename T, int W>
__global__ void __launch_bounds__(kSegThreads)
    chain_sweep_kernel_segments(const float* __restrict__ band, int bw, const int* __restrict__ seg_len,
                                const int2* __restrict__ chunks, const int* __restrict__ order,
                                const T* __restrict__ r, T* __restrict__ y) {
  extern __shared__ double seg_smem[];
  const int2 c0 = __ldg(chunks + blockIdx.x), c1 = __ldg(chunks + blockIdx.x + 1);
  const int segs = c1.x - c0.x, q0 = c0.y, rows = c1.y - c0.y;
  const int w = bw + 1;
  double* x = seg_smem;  // the chunk's r, then x, then y
  float* l = reinterpret_cast<float*>(x + rows);  // the chunk's band entries, column-major: l[k rows + i]
  int* o = reinterpret_cast<int*>(l + static_cast<size_t>(w) * rows);  // the chunk's order
  const int tid = threadIdx.x;
  const int m = tid < segs ? __ldg(seg_len + c0.x + tid) : 0;

  // Staging: every load of the chunk in flight at once.
  const float* src = band + static_cast<size_t>(q0) * w;
  for (int e = tid; e < rows * w; e += kSegThreads) {
    const int i = e / w;
    l[(e - i * w) * rows + i] = __ldg(src + e);
  }
  for (int i = tid; i < rows; i += kSegThreads) {
    const int at = __ldg(order + q0 + i);
    o[i] = at;
    x[i] = at >= 0 ? static_cast<double>(__ldg(r + at)) : 0.0;
  }
  __syncthreads();

  // Thread t's segment, forward then backward, its newest W solved entries
  // in ``win`` (newest first; zero before the segment's first row and past
  // its last, where the band's entries are zero too). A row's terms are
  // taken oldest first, so the shared-memory loads and all but the newest
  // term do not wait on the row before. (Summing the older terms of row j
  // + 1 while row j is solved made G50's solve slower on an H100, 12.6 us
  // against 8.1: PERF.md §6.)
  if (tid < segs) {
    double win[W];
#pragma unroll
    for (int k = 0; k < W; ++k) win[k] = 0.0;
    for (int j = 0, i = tid; j < m; ++j, i += segs) {
      double acc = x[i];
#pragma unroll
      for (int k = W; k >= 1; --k) {
        if (k <= bw) acc = fma(-static_cast<double>(l[(bw - k) * rows + i]), win[k - 1], acc);
      }
      const double v = acc * static_cast<double>(l[bw * rows + i]);
#pragma unroll
      for (int k = W - 1; k >= 1; --k) win[k] = win[k - 1];
      win[0] = v;
      x[i] = v;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) win[k] = 0.0;
    for (int j = m - 1, i = tid + (m - 1) * segs; j >= 0; --j, i -= segs) {
      double acc = x[i];
#pragma unroll
      for (int k = W; k >= 1; --k) {
        if (k <= bw && j + k < m) acc = fma(-static_cast<double>(l[(bw - k) * rows + i + k * segs]), win[k - 1], acc);
      }
      const double v = acc * static_cast<double>(l[bw * rows + i]);
#pragma unroll
      for (int k = W - 1; k >= 1; --k) win[k] = win[k - 1];
      win[0] = v;
      x[i] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows; i += kSegThreads) {
    if (o[i] >= 0) y[o[i]] = static_cast<T>(x[i]);
  }
}

template <typename T, int W>
cudaError_t segments_launch(const float* band, int bw, const int* seg_len, const int2* chunks, int n_chunks,
                            const int* order, const void* r, void* y, size_t smem, cudaStream_t stream) {
  chain_sweep_kernel_segments<T, W><<<n_chunks, kSegThreads, smem, stream>>>(
      band, bw, seg_len, chunks, order, static_cast<const T*>(r), static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
int segments_solve(const float* band, int bw, const int* seg_len, const int* chunks, int n_chunks,
                   const int* order, const void* r, void* y, int rows, void* stream) {
  const size_t smem = static_cast<size_t>(rows) * (sizeof(double) + sizeof(float) * (bw + 1) + sizeof(int));
  if (bw < 0 || bw > 16 || n_chunks <= 0 || rows <= 0 || smem > kSegSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int2* c = reinterpret_cast<const int2*>(chunks);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bw <= 1) err = segments_launch<T, 1>(band, bw, seg_len, c, n_chunks, order, r, y, smem, s);
  else if (bw <= 2) err = segments_launch<T, 2>(band, bw, seg_len, c, n_chunks, order, r, y, smem, s);
  else if (bw <= 4) err = segments_launch<T, 4>(band, bw, seg_len, c, n_chunks, order, r, y, smem, s);
  else if (bw <= 8) err = segments_launch<T, 8>(band, bw, seg_len, c, n_chunks, order, r, y, smem, s);
  else err = segments_launch<T, 16>(band, bw, seg_len, c, n_chunks, order, r, y, smem, s);
  return static_cast<int>(err);
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

// The one-hop form's plan at block B: its ring depth and co-resident CTAs
// (see chain_plan).
int cuadmm_tri_chain_plan(int B, int* stages, int* ctas) { return chain_plan(B, stages, ctas); }

// One-hop forward sweep (rhs = r, out = x) over ``tiles`` (the band; its
// diagonal tiles inverted) and ``chain`` (W then Ut), driven by ``steps``
// (nb x 4 ints: block, diagonal tile, first chain entry, chain entries)
// and ``offs`` (2 ints an entry: chain tile, solved block read), with
// ``stages`` ring buffers from cuadmm_tri_chain_plan. ``solved`` and
// ``epoch`` as for the two-hop sweeps.
int cuadmm_tri_chain_fwd(const float* tiles, const float* chain, int B, int nb, int stages, const int* steps,
                         const int* offs, const float* rhs, float* out, void* solved, unsigned* epoch, int ctas,
                         void* stream) {
  return chain_sweep<false>(tiles, chain, B, nb, stages, steps, offs, rhs, out, solved, epoch, ctas, stream);
}

// One-hop backward sweep (rhs = x, out = y), the same contract.
int cuadmm_tri_chain_bwd(const float* tiles, const float* chain, int B, int nb, int stages, const int* steps,
                         const int* offs, const float* rhs, float* out, void* solved, unsigned* epoch, int ctas,
                         void* stream) {
  return chain_sweep<true>(tiles, chain, B, nb, stages, steps, offs, rhs, out, solved, epoch, ctas, stream);
}

// The segments form's solve (forward and backward in one launch) of r into
// y, both in the solver's order and f64 (``f64`` 1) or f32 (0), over the
// tables above (bandwidth at most 16), ``n_chunks`` CTAs on ``stream``
// without synchronizing; ``rows`` is the most rows a chunk holds (its
// shared memory, at most 48 KB). Returns the launch error.
int cuadmm_tri_segments(const float* band, int bw, const int* seg_len, const int* chunks, int n_chunks,
                        const int* order, const void* r, void* y, int f64, int rows, void* stream) {
  return f64 ? segments_solve<double>(band, bw, seg_len, chunks, n_chunks, order, r, y, rows, stream)
             : segments_solve<float>(band, bw, seg_len, chunks, n_chunks, order, r, y, rows, stream);
}

#ifdef CUADMM_TRI_STAMPS
// Where the next sweeps record their stamps (kStamps words an item; null:
// none).
int cuadmm_tri_stream_set_stamps(unsigned* fwd, unsigned* bwd) {
  unsigned* both[2] = {fwd, bwd};
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, both, sizeof(both)));
}
#endif

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
