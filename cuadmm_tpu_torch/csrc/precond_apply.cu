// Fused preconditioner application y = M^T (M r) in one pass over the lower
// triangle of M (K1).
//
// Replaces the Pallas kernel cuadmm_tpu/ops/precond_apply.py::_kernel.
// M = inv(L) is the zero-padded f32 inverse of the Cholesky factor of the
// regularized AA^T: lower triangular, stored as a row-major square
// n_pad x n_pad, n_pad a multiple of 128. Every refinement sweep of the
// precond normal solver (and of split's coupled prefix) applies it once.
//
// Bound: HBM bytes. Row i of M holds i + 1 entries that count, so the least
// work is the triangle, 4 n_pad (n_pad + 1) / 2 bytes (3.95 GB at n_pad =
// 44,416: 1.18 ms at 3.35 TB/s), at 4 flops an entry. The strict upper
// triangle is never read: half of the square is zeros, and a caller may
// leave anything there. What matters is reading the triangle once, at full
// width, with enough bytes in flight at every n_pad.
//
// The coupling: t_i = M[i, :] . r needs all of row i before t_i M[i, :] can
// be added to y, so a row is read, reduced, and used again. Design:
//
// - Thread-block clusters of C = 1, 2, 4, 8 or 16 CTAs, one CTA of 512
//   threads an SM (the launch plan in ops/precond_apply.py picks C, the rows
//   per step R, the stages S and the cluster count K). Member m of a cluster
//   owns the 128-column chunks c = m (mod C), dealt cyclically, so every
//   member has an equal share of every row's triangle within one chunk.
//   Thread t of a member always handles the member's float4 slots t,
//   t + 512, ...: it keeps r and its y-partial there in registers (at most
//   10 float4 each), so shared memory holds only row stages, and the cap on
//   n_pad grows with C (303,104 at C = 16, a 367 GB square, past what any
//   card holds).
// - Rows go in panels of R; panel p is paired with panel P - 1 - p and the
//   pairs are dealt to the K clusters in turn, so every cluster has the same
//   number of steps and the same triangle work within one pair: static, so
//   the result is bitwise repeatable. (Contiguous row ranges of equal work
//   give the first cluster a thousand short rows, each a step of fixed
//   latency.)
// - Loads: a ring of S stages of R row slices in shared memory. Each thread
//   copies its own float4s of step s + S - 2 with cp.async (16 bytes each)
//   before it waits for step s's, so S - 2 steps are in flight while step s
//   is used and step s - 1 waits for its t. A thread only reads back what it
//   copied, so waiting on its own copy groups is enough. In the chunks that
//   hold the diagonal a copy reads only the entries left of it (cp.async's
//   source size) and zero-fills the rest. (TMA would copy a whole 512-byte
//   chunk row a request, but cannot stop at the diagonal, and the slots a
//   thread copies are the ones it consumes, which needs no mbarrier.)
// - No barrier a step: each warp reduces its R partial dots by shuffles and
//   pushes them with st.async into every member's inbox, counted on that
//   member's mbarrier. Step s's t is taken after step s + 1's first pass, so
//   the exchange overlaps it. Every warp sums the C x 16 partials in the
//   same fixed order (lane subsets, then a shuffle tree), so t is the same
//   in every warp of every member. (A cluster barrier a step, with its
//   release semantics, waited for each thread's copies in flight and so
//   emptied the ring every step.) Pass 2 adds t_i M[i, slot] to the
//   thread's y registers: no atomics.
// - A step's bookkeeping is shifts and adds (C is a power of two, stage
//   indices wrap), and a warp skips the slots a step does not reach: all 16
//   warps repeat it every step, and with divisions it cost as much as the
//   copies.
// - Each cluster writes its y-partial; a second kernel sums the K
//   partials per column in a fixed order.
// - Full f32 FMA on the CUDA cores; no TF32, no tensor cores (a
//   matrix-vector product has no reuse for them). Offsets are 64-bit.
//
// K1 over B right-hand sides, fused_spd_apply_kernel_rhs<R, BT>: Y[b] =
// M^T (M R[b]) for b < nb <= B = 2 BT (2, 4 or 8) in one pass over the
// triangle, for a batch of instances that share M (the batched solver's
// sweeps). It replaces no TPU kernel: the JAX package's _kernel serves one
// right-hand side, and its batch calls it once an instance. Bound: still the
// triangle's bytes, read once for all B (0.2117 ms at n_pad 18,816 on an
// H100); the flops, 4 B an entry, take 0.085 ms at B = 8 on the CUDA cores,
// so issue slots, not the FMA pipe, are what the design has to spare. As
// built it does not reach that bound: 0.83 ms there, 26% (8 one-RHS
// launches take 2.07 ms). Its time falls with the number of SMs it runs
// on, not with bytes: each step's phases (copies, the CTA barrier, the
// exchange, the two passes) run one after another in every warp, at 2.5
// warps an SM sub-partition, so the SM waits more than it issues.
//
// - Registers: a column needs r and y for each of its B right-hand sides.
//   One thread keeping both for B = 8 over the one-RHS kernel's ten slots
//   would need 640 registers. Here a CTA has two groups of at most 5 warps
//   (320 threads, 168 registers each: three warps share an SM
//   sub-partition's 64 KB); both groups cover the same
//   columns, group g the right-hand sides g BT .. g BT + BT - 1, and a
//   thread keeps r and y of its BT for 16 / BT float4 slots (128
//   registers). The clusters are larger to match: at n_pad 18,816, B = 8,
//   C = 8 and each member owns 18 or 19 chunks.
// - Both groups read the same row stages, so the stages are shared: group g
//   copies rows g, g + 2, ... of a step (cp.async at each thread's own
//   slots, stopping at the diagonal as above), and one __syncthreads a step
//   makes them visible to both. That barrier waits for no copy in flight
//   (the ring still holds S - 2 steps in flight), and it also closes the
//   CTA's partial sums of the step before.
// - A warp's R x BT partial dots are reduced by a transpose-reduce (a
//   reduce-scatter butterfly): log2(R BT) shuffle levels, each halving the
//   values a lane holds, leave lane l with the warp's sum of value l; R BT
//   separate trees would take 5 shuffles each. Lane l stores it for its
//   warp; after the barrier the CTA's sums (a fixed order over the group's
//   warps) go with st.async into every member's inbox, counted on its
//   mbarrier as in the one-RHS kernel, and a step later every warp sums the
//   C members' values in member order. The exchange of step s overlaps the
//   first pass of step s + 1. Every sum has a fixed order, so the result is
//   bitwise repeatable.
// - Each cluster writes its nb y-partials, and sum_partials_kernel sums
//   the K clusters' partials of all nb rows in one launch. Fewer, larger
//   clusters (K = 15 at C = 8 on an H100) keep the scratch at K nb n_pad
//   floats, about the one-RHS launch's K n_pad at K = 132.
// - ops/precond_apply.py's plan serves any B in groups: launches of the
//   largest B that fits n_pad, then the rest (one column left over goes to
//   the one-RHS kernel, another remainder to the next B up, its spare
//   columns zero).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;          // columns per chunk
constexpr int kChunk4 = kChunk / 4;  // float4 per chunk row: one per lane of a warp
constexpr int kMaxCluster = 16;      // past 8 a non-portable cluster size
constexpr int kMaxSmem = 444 * kChunk * 4;  // 222 KB: with the 4 KB inbox, the 227 KB a CTA may use
constexpr int kMaxStages = 8;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Copy the first ``bytes`` (0, 4, 8, 12 or 16) of the float4 at src into
// dst and zero the rest; nothing past ``bytes`` is read.
__device__ __forceinline__ void copy16(float4* dst, const float4* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Float4 slots a thread keeps r and y for at R rows a step (the plan sizes
// slices to fit): ten at one row, fewer where more rows' stages share the
// shared memory.
template <int R>
__host__ __device__ constexpr int slots_per_thread() {
  return R >= 4 ? 2 : (R == 2 ? 4 : 10);
}

// Wait until at most n (1..7) of this thread's copy groups are pending.
__device__ __forceinline__ void copy_wait_n(int n) {
  switch (n) {
    case 1: copy_wait<1>(); break;
    case 2: copy_wait<2>(); break;
    case 3: copy_wait<3>(); break;
    case 4: copy_wait<4>(); break;
    case 5: copy_wait<5>(); break;
    case 6: copy_wait<6>(); break;
    default: copy_wait<7>(); break;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in cluster member ``rank``.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v at a peer's address and count its 4 bytes on the peer's mbarrier.
__device__ __forceinline__ void push(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// R rows a step, ``n_stages`` stages. Shared memory: stages [S][R], each
// ``cap`` float4 (the largest member's slot count).
//
// Thread tid's slots are u = tid + 512 j, j < kVec; slot u is float4 column
// (member + (u / 32) C) * 32 + u % 32, so the thread's columns are
// q0 + j * 512 C with q0 = (member + warp C) * 32 + lane, and a warp's 32
// lanes share each j's chunk: whether slot j is in a step is warp-uniform.
// Everything a step recomputes is shifts and adds: C is a power of two.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    fused_spd_apply_kernel(const float* __restrict__ m, const float* __restrict__ r,
                           float* __restrict__ partial, int n_pad, int cap, int n_stages) {
  constexpr int kVec = slots_per_thread<R>();
  extern __shared__ float4 stages[];
  // Every warp of every member pushes its R partials of step s here, in
  // half s % 2, and counts them on bar[s % 2].
  __shared__ float inbox[2][32 * kWarps];  // C x 16 warps x R <= 512 partials
  __shared__ alignas(8) unsigned long long bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int log_c = __ffs(C) - 1;
  const int member = static_cast<int>(cluster.block_rank());
  const int K = gridDim.x >> log_c, k = blockIdx.x >> log_c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n4 = n_pad / 4;
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const int panels = n_pad / R, pairs = panels / 2;
  const int steps = pairs > k ? 2 * ((pairs - 1 - k) / K + 1) : 0;
  const int inbox_bytes = (C * kWarps * R) << 2;
  const int q0 = ((member + (warp << log_c)) << 5) + lane;  // the thread's first float4 column
  const int stride = kThreads << log_c;                      // float4 columns between its slots
  const float4* m_col = reinterpret_cast<const float4*>(m) + q0;

  // The member's slots through chunk c, and a step's first row.
  auto slots_through = [&](int c) { return c >= member ? (((c - member) >> log_c) + 1) << 5 : 0; };
  auto first_row = [&](int s) {
    const int p = k + (s >> 1) * K;
    return ((s & 1) ? panels - 1 - p : p) * R;
  };
  // How many of the thread's slots (j = 0, 1, ...) a step of ``slots`` holds.
  auto active = [&](int slots) { return slots > tid ? ((slots - tid - 1) >> 9) + 1 : 0; };

  // Queue step s's copies (each thread its own slots) as one group into
  // stage ``st``; an empty group past the last step keeps the wait counts
  // uniform.
  auto issue = [&](int s, float4* st) {
    if (s < steps) {
      const int row0 = first_row(s);
      const int nj = active(slots_through((row0 + R - 1) >> 7));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = row0 + i;
        const float4* src = m_col + static_cast<int64_t>(row) * n4;
        float4* dst = st + i * cap + tid;
        // Entries of the thread's float4 on or left of the diagonal, at j = 0.
        const int left0 = row + 1 - 4 * q0;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (j >= nj) break;
          const int left = left0 - 4 * j * stride;
          const int bytes = min(max(left, 0), 4) << 2;
          copy16(dst + j * kThreads, src + static_cast<int64_t>(j) * stride, bytes);
        }
      }
    }
    copy_commit();
  };

  float4 rv[kVec], yv[kVec];
  // Pass 2 of a step: y += t_i M[i, slot].
  auto accumulate = [&](const float4* st, int nj, const float* t) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = st[i * cap + tid + j * kThreads];
        yv[j].x = fmaf(t[i], a.x, yv[j].x);
        yv[j].y = fmaf(t[i], a.y, yv[j].y);
        yv[j].z = fmaf(t[i], a.z, yv[j].z);
        yv[j].w = fmaf(t[i], a.w, yv[j].w);
      }
    }
  };
  // t of step s: wait for every warp's partials, then sum them in a fixed
  // order (each lane a fixed subset, then a shuffle tree), the same in
  // every warp of every member.
  auto receive = [&](int s, float* t) {
    bar_wait(smem_addr(&bar[s & 1]), (s >> 1) & 1);
    const float* in = inbox[s & 1];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sum = 0.f;
      for (int e = lane; e < (C << 4); e += 32) sum += in[e * R + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      t[i] = sum;
    }
  };

  // The ring holds step s - 1 (pass 2 still to come), s, and S - 2 steps in
  // flight. Stage indices advance by one a step, wrapping at S. The first
  // copies go out before r is loaded and the cluster meets.
  auto next = [&](int i) { return i + 1 == n_stages ? 0 : i + 1; };
  int st_issue = 0;
  for (int s = 0; s < n_stages - 2; ++s) {
    issue(s, stages + st_issue * R * cap);
    st_issue = next(st_issue);
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int total = active(slots_through(n_pad / kChunk - 1));
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    rv[j] = j < total ? __ldg(r4 + q0 + j * stride) : zero4();
    yv[j] = zero4();
  }
  cluster.sync();  // every member's mbarriers are set up before anyone pushes
  int st_cur = 0, st_prev = 0, nj_prev = 0;
  for (int s = 0; s < steps; ++s) {
    issue(s + n_stages - 2, stages + st_issue * R * cap);
    st_issue = next(st_issue);
    copy_wait_n(n_stages - 2);  // this thread's copies of step s have landed
    const float4* st = stages + st_cur * R * cap;
    const int nj = active(slots_through((first_row(s) + R - 1) >> 7));

    // Pass 1: the warp's partial dots of the R rows with r.
    float dot[R];
#pragma unroll
    for (int i = 0; i < R; ++i) dot[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int i = 0; i < R; ++i) dot[i] = dot4(st[i * cap + tid + j * kThreads], rv[j], dot[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
    }

    // Step s - 1 while step s's partials travel: its t, then pass 2. Its
    // inbox half is free again once every warp of every member has read it,
    // which each does before it pushes step s (below), so no push of step
    // s + 1 can reach it early.
    if (s > 0) {
      float t[R];
      receive(s - 1, t);
      accumulate(stages + st_prev * R * cap, nj_prev, t);
    }
    // Lane l pushes row l % R's partial to member l / R.
    if (lane < (R << log_c)) {
      const int p = lane / R, i = lane % R;
      float v = dot[0];
#pragma unroll
      for (int ii = 1; ii < R; ++ii) v = i == ii ? dot[ii] : v;
      const unsigned slot = smem_addr(&inbox[s & 1][(((member << 4) + warp) * R) + i]);
      push(peer_addr(slot, p), v, peer_addr(smem_addr(&bar[s & 1]), p));
    }
    if (tid == 0) bar_expect(smem_addr(&bar[s & 1]), inbox_bytes);
    st_prev = st_cur;
    nj_prev = nj;
    st_cur = next(st_cur);
  }
  if (steps > 0) {
    float t[R];
    receive(steps - 1, t);
    accumulate(stages + st_prev * R * cap, nj_prev, t);
  }
  copy_wait<0>();

  float4* out = reinterpret_cast<float4*>(partial + static_cast<int64_t>(k) * n_pad) + q0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (j < total) out[j * stride] = yv[j];
  }
  // No member exits while a peer may still push to it.
  cluster.sync();
}

// y[j] = the sum over the clusters' partials, in a fixed order: thread
// (x, g) of a block sums partials g, g + 8, ... of column 32 b + x, then
// lane g = 0 adds the 8 sums in order.
constexpr int kSumCols = 32, kSumGroups = 8;
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ y, int n_pad,
                                    int clusters) {
  __shared__ float part[kSumGroups][kSumCols];
  const int x = threadIdx.x, g = threadIdx.y;
  const int j = blockIdx.x * kSumCols + x;
  float s = 0.f;
  for (int k = g; k < clusters; k += kSumGroups) s += partial[static_cast<int64_t>(k) * n_pad + j];
  part[g][x] = s;
  __syncthreads();
  if (g == 0) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kSumGroups; ++i) sum += part[i][x];
    y[j] = sum;
  }
}

// ---- K1 over B right-hand sides (the note at the top) ----

constexpr int kGroups = 2;          // right-hand-side groups of a CTA
constexpr int kGroupWarps = 5;      // warps a group at most
constexpr int kThreadsRhs = kGroups * kGroupWarps * 32;
constexpr int kMaxSmemRhs = 432 * kChunk * 4;  // 216 KB: with the 10.5 KB of sums, inbox and mbarriers, within 227 KB

// Float4 slots a thread keeps r and y for, at BT right-hand sides a thread:
// 16 float4 of each.
template <int BT>
__host__ __device__ constexpr int slots_rhs() {
  return 16 / BT;
}

// Lane l ends with the warp's sum of x[l % V] (V a power of two <= 32): at
// level H a lane keeps the half of its values that its bit H selects and
// adds its partner's copies of them; past the values' bits, plain sums.
// Each level is its own instance, so every index into x is a constant and
// x stays in registers.
template <int V, int H>
__device__ __forceinline__ void scatter_level(float (&x)[V], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int e = 0; e < H; ++e) {
      const float send = up ? x[e] : x[e + H];
      const float keep = up ? x[e + H] : x[e];
      x[e] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    scatter_level<V, H / 2>(x, lane);
  }
}

template <int V>
__device__ __forceinline__ float reduce_scatter(float (&x)[V], int lane) {
  scatter_level<V, V / 2>(x, lane);
  float v = x[0];
#pragma unroll
  for (int o = V; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// R rows a step, BT right-hand sides a thread, 2 BT a CTA (nb of them
// real: the rest read as zero and are not written). blockDim.x = 64 Wg:
// warps 0..Wg-1 are group 0, Wg..2Wg-1 group 1. Thread (g, wl, lane)'s
// slots are j < 16 / BT at member-local chunk wl + j Wg, float4 column
// (member + (wl + j Wg) C) * 32 + lane; a stage row holds the member's
// chunks in local order, ``cap`` float4.
template <int R, int BT>
__global__ void __launch_bounds__(kThreadsRhs, 1)
    fused_spd_apply_kernel_rhs(const float* __restrict__ m, const float* __restrict__ r,
                               float* __restrict__ partial, int n_pad, int nb, int cap, int n_stages) {
  constexpr int kVec = slots_rhs<BT>();
  constexpr int V = R * BT;  // sums a warp reduces a step, value i BT + b for row i, right-hand side b
  static_assert(V <= 32 && R % kGroups == 0, "one value a lane; rows split between the groups");
  extern __shared__ float4 stages[];
  __shared__ float part[2][kGroups * kGroupWarps][32];     // each warp's V sums of step s, half s % 2
  __shared__ float inbox[2][kMaxCluster][kGroups * 32];    // each member's CTA sums of step s (group, value)
  __shared__ alignas(8) unsigned long long bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int log_c = __ffs(C) - 1;
  const int member = static_cast<int>(cluster.block_rank());
  const int K = gridDim.x >> log_c, k = blockIdx.x >> log_c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Wg = blockDim.x >> 6, W = 2 * Wg;
  const int g = warp >= Wg ? 1 : 0, wl = warp - g * Wg;
  const int tg = (wl << 5) + lane;  // the thread's index in its group's stage row
  const int64_t n4 = n_pad / 4;
  const int panels = n_pad / R, pairs = panels / 2;
  const int steps = pairs > k ? 2 * ((pairs - 1 - k) / K + 1) : 0;
  const int inbox_bytes = (C * kGroups * V) << 2;
  const int q0 = ((member + (wl << log_c)) << 5) + lane;  // the thread's first float4 column
  const int stride = (Wg << log_c) << 5;                   // float4 columns between its slots
  const int sstride = Wg << 5;                              // and between them in a stage row
  const float4* m_col = reinterpret_cast<const float4*>(m) + q0;

  // The member's local chunks through chunk c, a step's first row, and how
  // many of the thread's slots lie in ``lc`` local chunks.
  auto local_through = [&](int c) { return c >= member ? ((c - member) >> log_c) + 1 : 0; };
  auto first_row = [&](int s) {
    const int p = k + (s >> 1) * K;
    return ((s & 1) ? panels - 1 - p : p) * R;
  };
  auto active = [&](int lc) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) n += wl + j * Wg < lc ? 1 : 0;
    return n;
  };

  // Group g queues rows g, g + 2, ... of step s at its slots as one copy
  // group into stage ``st``; an empty group past the last step keeps the
  // wait counts uniform.
  auto issue = [&](int s, float4* st) {
    if (s < steps) {
      const int row0 = first_row(s);
      const int nj = active(local_through((row0 + R - 1) >> 7));
#pragma unroll
      for (int ii = 0; ii < R / kGroups; ++ii) {
        const int i = kGroups * ii + g;
        const int row = row0 + i;
        const float4* src = m_col + static_cast<int64_t>(row) * n4;
        float4* dst = st + i * cap + tg;
        const int left0 = row + 1 - 4 * q0;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (j >= nj) break;
          const int left = left0 - 4 * j * stride;
          const int bytes = min(max(left, 0), 4) << 2;
          copy16(dst + j * sstride, src + static_cast<int64_t>(j) * stride, bytes);
        }
      }
    }
    copy_commit();
  };

  float4 rv[kVec][BT], yv[kVec][BT];
  // Pass 2 of a step: y_b += t_{i,b} M[i, slot].
  auto accumulate = [&](const float4* st, int nj, const float (&t)[V]) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = st[i * cap + tg + j * sstride];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float ti = t[i * BT + b];
          yv[j][b].x = fmaf(ti, a.x, yv[j][b].x);
          yv[j][b].y = fmaf(ti, a.y, yv[j][b].y);
          yv[j][b].z = fmaf(ti, a.z, yv[j][b].z);
          yv[j][b].w = fmaf(ti, a.w, yv[j][b].w);
        }
      }
    }
  };
  // The CTA's sums of step s (each group's warps in order) into every
  // member's inbox: job = (member p, group gg), dealt to the warps in turn.
  auto push_all = [&](int s) {
    const int h = s & 1;
    for (int job = warp; job < kGroups * C; job += W) {
      const int p = job >> 1, gg = job & 1;
      if (lane < V) {
        float sum = 0.f;
        for (int w = 0; w < Wg; ++w) sum += part[h][gg * Wg + w][lane];
        const unsigned slot = smem_addr(&inbox[h][member][gg * V + lane]);
        push(peer_addr(slot, p), sum, peer_addr(smem_addr(&bar[h]), p));
      }
    }
    if (tid == 0) bar_expect(smem_addr(&bar[h]), inbox_bytes);
  };
  // t of step s: wait for every member's sums, add them in member order
  // (lane l value l % V of the thread's group), then hand each lane all V.
  auto receive = [&](int s, float (&t)[V]) {
    bar_wait(smem_addr(&bar[s & 1]), (s >> 1) & 1);
    const float* in = &inbox[s & 1][0][g * V + (lane & (V - 1))];
    float sum = 0.f;
    for (int p = 0; p < C; ++p) sum += in[p * kGroups * 32];
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = __shfl_sync(0xffffffffu, sum, v);
  };

  // The ring holds step s - 1 (pass 2 still to come), s, and S - 2 steps in
  // flight; step s + S - 2 is queued after the step's barrier, into the
  // stage of step s - 2, which every warp has finished with by then.
  auto next = [&](int i) { return i + 1 == n_stages ? 0 : i + 1; };
  int st_issue = 0;
  for (int s = 0; s < n_stages - 2; ++s) {
    issue(s, stages + st_issue * R * cap);
    st_issue = next(st_issue);
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int total = active(local_through(n_pad / kChunk - 1));
  const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int rhs = g * BT + b;
      rv[j][b] = j < total && rhs < nb ? __ldg(r4 + rhs * n4 + q0 + static_cast<int64_t>(j) * stride) : zero4();
      yv[j][b] = zero4();
    }
  }
  cluster.sync();  // every member's mbarriers are set up before anyone pushes
  int st_cur = 0, st_prev = 0, nj_prev = 0;
  for (int s = 0; s < steps; ++s) {
    if (n_stages == 3) {
      copy_wait<0>();
    } else {
      copy_wait_n(n_stages - 3);  // this thread's copies of step s have landed
    }
    __syncthreads();  // everyone's copies of step s, and every warp's sums of step s - 1
    issue(s + n_stages - 2, stages + st_issue * R * cap);
    st_issue = next(st_issue);
    if (s > 0) push_all(s - 1);
    const float4* st = stages + st_cur * R * cap;
    const int nj = active(local_through((first_row(s) + R - 1) >> 7));

    // Pass 1: the warp's partial dots of the R rows with its BT r's.
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = st[i * cap + tg + j * sstride];
#pragma unroll
        for (int b = 0; b < BT; ++b) x[i * BT + b] = dot4(a, rv[j][b], x[i * BT + b]);
      }
    }
    const float sum = reduce_scatter<V>(x, lane);
    if (lane < V) part[s & 1][warp][lane] = sum;

    // Step s - 1 while step s - 1's sums travel between the members.
    if (s > 0) {
      float t[V];
      receive(s - 1, t);
      accumulate(stages + st_prev * R * cap, nj_prev, t);
    }
    st_prev = st_cur;
    nj_prev = nj;
    st_cur = next(st_cur);
  }
  if (steps > 0) {
    __syncthreads();
    push_all(steps - 1);
    float t[V];
    receive(steps - 1, t);
    accumulate(stages + st_prev * R * cap, nj_prev, t);
  }
  copy_wait<0>();

#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const int rhs = g * BT + b;
    if (rhs >= nb) continue;
    float4* out = reinterpret_cast<float4*>(partial + (static_cast<int64_t>(k) * nb + rhs) * n_pad) + q0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j < total) out[static_cast<int64_t>(j) * stride] = yv[j][b];
    }
  }
  // No member exits while a peer may still push to it.
  cluster.sync();
}

template <int R, int BT>
void* rhs_kernel_of() {
  return reinterpret_cast<void*>(fused_spd_apply_kernel_rhs<R, BT>);
}

// The B kernel for ``rows`` a step and ``rhs`` (2, 4, 8) right-hand sides.
void* rhs_kernel_for(int rows, int rhs) {
  switch (rhs * 16 + rows) {
    case 2 * 16 + 2: return rhs_kernel_of<2, 1>();
    case 2 * 16 + 4: return rhs_kernel_of<4, 1>();
    case 2 * 16 + 8: return rhs_kernel_of<8, 1>();
    case 4 * 16 + 2: return rhs_kernel_of<2, 2>();
    case 4 * 16 + 4: return rhs_kernel_of<4, 2>();
    case 4 * 16 + 8: return rhs_kernel_of<8, 2>();
    case 8 * 16 + 2: return rhs_kernel_of<2, 4>();
    case 8 * 16 + 4: return rhs_kernel_of<4, 4>();
    case 8 * 16 + 8: return rhs_kernel_of<8, 4>();
    default: return nullptr;
  }
}

int rhs_slots_for(int rhs) {
  return rhs == 2 ? slots_rhs<1>() : (rhs == 4 ? slots_rhs<2>() : slots_rhs<4>());
}

template <int R>
void* kernel_of() {
  return reinterpret_cast<void*>(fused_spd_apply_kernel<R>);
}

int vec_for(int rows) {
  switch (rows) {
    case 1: return slots_per_thread<1>();
    case 2: return slots_per_thread<2>();
    case 4: return slots_per_thread<4>();
    default: return slots_per_thread<8>();
  }
}

void* kernel_for(int rows) {
  switch (rows) {
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 4: return kernel_of<4>();
    case 8: return kernel_of<8>();
    default: return nullptr;
  }
}

cudaLaunchConfig_t config_for(int cluster, int clusters, int smem, cudaStream_t s, cudaLaunchAttribute* attr,
                              int threads = kThreads) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

// Lets every instance take the largest shared memory and clusters of 16.
// Call once per device, with that device current, before the first launch
// or query there.
int cuadmm_fused_spd_apply_init(void) {
  for (int rows : {1, 2, 4, 8}) {
    const void* f = kernel_for(rows);
    cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int rhs : {2, 4, 8}) {
    for (int rows : {2, 4, 8}) {
      const void* f = rhs_kernel_for(rows, rhs);
      cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemRhs);
      if (err == cudaSuccess) err = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

// Clusters of ``cluster`` CTAs with ``smem`` bytes of shared memory each,
// at ``rows`` a step, that the current device holds at once.
int cuadmm_fused_spd_apply_resident_clusters(int cluster, int rows, int smem, int* out) {
  const void* f = kernel_for(rows);
  if (f == nullptr || cluster < 1 || cluster > kMaxCluster || smem <= 0 || smem > kMaxSmem || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = config_for(cluster, 1, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, f, &config));
}

// y = m^T (m r) for lower-triangular m (n_pad, n_pad) (its strict upper
// triangle is never read), r and y (n_pad,), all f32, contiguous and
// 16-byte aligned; partial is (clusters, n_pad) scratch. ``rows`` (1, 2, 4,
// 8) a step, ``cluster`` (1, 2, 4, 8, 16) CTAs a cluster, rows * cluster
// <= 32, ``stages`` (3..8) ring stages, ``smem`` = stages x rows x the
// largest member's row slice, which must fit its threads' registers
// (slots_per_thread). Launches on ``stream`` without synchronizing and
// returns cudaGetLastError().
int cuadmm_fused_spd_apply(const float* m, const float* r, float* partial, float* y, int n_pad, int cluster,
                           int clusters, int rows, int stages, int smem, void* stream) {
  const bool cluster_ok = cluster > 0 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
  const void* f = kernel_for(rows);
  if (n_pad <= 0 || n_pad % kChunk != 0 || !cluster_ok || f == nullptr || rows * cluster > 32 ||
      clusters <= 0 || stages < 2 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cap = (n_pad / kChunk + cluster - 1) / cluster * kChunk4;  // float4 slots of the largest member
  if (cap > vec_for(rows) * kThreads || smem != stages * rows * cap * 16 || smem > kMaxSmem || stages < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = config_for(cluster, clusters, smem, s, &attr);
  void* args[] = {&m, &r, &partial, &n_pad, &cap, &stages};
  cudaError_t err = cudaLaunchKernelExC(&config, f, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<n_pad / kSumCols, dim3(kSumCols, kSumGroups), 0, s>>>(partial, y, n_pad, clusters);
  return static_cast<int>(cudaGetLastError());
}

// As cuadmm_fused_spd_apply_resident_clusters, for the B kernel at ``rhs``
// right-hand sides and ``warps`` warps a group (CTAs of 64 x warps threads).
int cuadmm_fused_spd_apply_rhs_resident_clusters(int cluster, int rows, int rhs, int warps, int smem, int* out) {
  const void* f = rhs_kernel_for(rows, rhs);
  if (f == nullptr || cluster < 1 || cluster > kMaxCluster || warps < 1 || warps > kGroupWarps || smem <= 0 ||
      smem > kMaxSmemRhs || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = config_for(cluster, 1, smem, nullptr, &attr, kGroups * 32 * warps);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, f, &config));
}

// Y[b] = m^T (m R[b]) for b < nb: R and Y (nb, n_pad), row-major, f32,
// contiguous and 16-byte aligned, m as for cuadmm_fused_spd_apply; partial
// is (clusters, nb, n_pad) scratch. ``rhs`` (2, 4, 8; nb <= rhs) the
// kernel's right-hand sides, ``rows`` (2, 4, 8; rows x rhs / 2 <= 32) a
// step, ``cluster`` (1..16, a power of two) CTAs of ``warps`` (1..5) warps
// a group, whose warps x 16 / (rhs / 2) slots must cover the largest
// member's chunks; ``stages`` (3..8) and ``smem`` as for
// cuadmm_fused_spd_apply. One launch of the B kernel, one of
// sum_partials_kernel over all nb rows; returns cudaGetLastError().
int cuadmm_fused_spd_apply_rhs(const float* m, const float* r, float* partial, float* y, int n_pad, int nb,
                               int rhs, int cluster, int clusters, int rows, int warps, int stages, int smem,
                               void* stream) {
  const bool cluster_ok = cluster > 0 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
  const void* f = rhs_kernel_for(rows, rhs);
  if (n_pad <= 0 || n_pad % kChunk != 0 || !cluster_ok || f == nullptr || nb < 1 || nb > rhs || clusters <= 0 ||
      warps < 1 || warps > kGroupWarps || stages < 3 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (n_pad / kChunk + cluster - 1) / cluster;  // the largest member's
  int cap = chunks * kChunk4;
  if (chunks > warps * rhs_slots_for(rhs) || smem != stages * rows * cap * 16 || smem > kMaxSmemRhs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = config_for(cluster, clusters, smem, s, &attr, kGroups * 32 * warps);
  void* args[] = {&m, &r, &partial, &n_pad, &nb, &cap, &stages};
  cudaError_t err = cudaLaunchKernelExC(&config, f, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = nb * n_pad;
  sum_partials_kernel<<<n / kSumCols, dim3(kSumCols, kSumGroups), 0, s>>>(partial, y, n, clusters);
  return static_cast<int>(cudaGetLastError());
}

const char* cuadmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
