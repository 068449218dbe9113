// Max-min water-filling for Hopper (sm_90a), one thread block per solve or,
// past one block's shared memory, one thread-block cluster per solve; and
// the sim's ordered segment sum.
//
// Replaces the TPU kernel kernels/waterfill/waterfill.py::_waterfill_kernel
// of the reference package (launched by waterfill_8x), and on the sim's
// default path its f64 twin kernels/waterfill/ref.py::masked_maxmin_rates.
//
// What bounds it on this card: not bytes (a solve reads a few kB) and not
// arithmetic (a few hundred flops per connection). It is the chain of
// dependent f64 adds that bitwise parity forces: in every live round each
// VM/edge budget loses 0 + r_i0 + r_i1 + ... of its newly fixed rates, in
// ascending connection order, as jax.ops.segment_sum and numpy's bincount
// add them. A segment's sum cannot be split or reassociated, so the
// longest segment's chain (the edge, which may hold every lane) sets the
// time of a round; launch latency comes on top, once per solve.
//
// What the design does about it:
//   * the solve's state lives in shared memory for the whole solve: caps,
//     rates and a state byte per lane (17 bytes at f64), budgets, fair
//     shares and unfixed counts per segment, and each warp's run of new
//     rates (24.75 KB at f64), so one block takes ~12,100 lanes. The lanes'
//     segment ids and the CSR lists stay in device memory and are read
//     through L1, which holds them at the sims' sizes: staging them in
//     shared memory measured no faster;
//   * each segment's unfixed count is set once and then loses the lanes
//     fixed in it (integers, exact), and the new fair share bud / cnt is
//     computed where the budget moves, so no round recounts;
//   * three barriers a round: (A) a lane pass computes share, cap-hit and
//     minimum, reduced in one combined step (each unfixed lane parks its
//     share in its rate slot until it is fixed); (B) each thread fixes its
//     own lanes and marks them new; (C) the segment pass;
//   * in (C) every segment takes a warp, from a counter, edges first (the
//     edge may hold every lane, so it starts first and the VMs' segments
//     fill the other warps: twelve warps, so that the sim's 40 VM segments
//     come to about four a warp). The warp walks the segment's list 32
//     lanes a step, with the next steps' ids and lane states loaded ahead,
//     and compacts the nonzero new rates in lane order (__ballot_sync +
//     __popc) into its run in shared memory; lane 0 folds the run with the
//     next eight loads issued before each eight adds, so the chain waits
//     on one f64 add per nonzero term. Skipping zeros is exact: the fold
//     starts at +0.0 and every term is >= +0.0, so fl(a + 0.0) == a.
//     Measured slower on the card: the fold decided per 32-lane step by
//     the segment's own warp through a ring; a thread per segment reading
//     through the lane ids (each term waits on two dependent loads); a run
//     of 16-bit lane ids folded through the ids; folding 8-term groups
//     flagged nonzero by a ballot. Measured faster at the sim's shape
//     (~14 against ~16 us) but at 64 bytes a lane (~3,600 lanes a solve):
//     every operand staged and each round's rates scattered to every
//     list position, so that a thread per short segment folds a
//     contiguous run;
//   * the lane pass of the next round cannot start under a long fold: every
//     lane reads its edge's new share, which the edge's fold produces last;
//   * one block holds a solve of ~12,100 lanes at f64; the chain is serial
//     anyway, so below that no cluster is needed.
//
// Past one block (waterfill_cluster_kernel, the sim's choice by
// kernels/waterfill/ops.py::needs_cluster) a solve runs on one cluster of
// K blocks on neighbouring SMs, K the smallest of 2, 4, 8 and 16 whose
// blocks hold its lanes (16 only where the card can place such a cluster;
// past that the lanes go to a device-memory scratch inside the same kernel,
// a template flag, so any lane count solves). What the single block spent
// its time on at the fleet's 24,576 lanes (a clock64 split of each pass):
// the segment pass walking all ~1,500 lists on twelve warps, a full count
// pass over them, and lane passes of 64 lanes a thread through L2. So:
//   * each block holds a contiguous range of lanes (cap, rate, state byte)
//     and runs (A) and (B) on its own in its own shared memory, its loads
//     four lanes at a time; the round's minimum, cap-hit and unfixed count
//     pass through distributed shared memory between
//     barrier.cluster.arrive.release / wait.acquire;
//   * every segment has one owner block (edges first, round robin) that
//     keeps its budget and unfixed count; every block keeps a replica of
//     every fair share, and the owner writes each new share into all K;
//   * counts: at staging each block counts its active lanes per segment
//     (one shared-memory atomic per run of equal segments in a warp), and
//     each owner sums the K blocks' counts: integers, any order;
//   * in (B) a newly fixed lane tags its segments at their owners with the
//     round; (C) then walks only the tagged lists (~260 of ~1,540 a round
//     at the fleet shape), each lane's state and rate read from the block
//     that holds it;
//   * a long list (2,048 lanes or more; the edges) is compacted by four
//     warps in turn, 16 steps a chunk, into a ring of four chunk slots, and
//     lane 0 of a fifth warp folds the chunks in order behind them; each
//     slot's full and empty mbarriers pass it between the two, so the fold
//     waits on its own f64 adds and not on the loads. Short lists take a
//     warp each from the round's queue. Measured slower: flags polled in
//     shared memory instead of mbarriers (the polling slowed the
//     compacting warps), and chunks of four or eight steps (more fold
//     overhead per term).
// The sim passes a device flag `changed`; when it is 0 the kernel copies
// the cached rates, so the caller never reads the flag on the host. The TPU
// layout (one-hot scatter matmuls, 8-row replicated tiles) is not carried
// over: here segment sums walk CSR lists.
//
// Each kernel has two instantiations:
//   double — the sim's parity solver: +inf shares, eps 1e-12, round bound
//            2*nv_active + ne_bound + 4 with nv_active taken from the active
//            lanes. Bitwise equal to the plain f64 version: every floating
//            budget sum adds its lanes in ascending connection order (no
//            float atomics), and the build uses --fmad=false.
//   float  — the TPU kernel's counterpart: BIG = 1e30 shares, eps 1e-6,
//            a fixed round count (rounds after convergence are no-ops, so
//            the loop may exit early).
//
// segsum_ordered_f64 is the sim's ordered segment sum: out[s] = 0 + v[i0] +
// v[i1] + ... over a segment's lanes in ascending order, one block of four
// warps per segment. The block loads the segment's values into shared
// memory with every load in flight at once, compacts the nonzero ones in
// lane order with every warp at once (per-step __ballot_sync counts, a
// warp's prefix over them, then the scatter), and one thread folds the run
// with the next eight loads issued before each eight adds: the chain is one
// f64 add per nonzero term. Skipping zeros of either sign is exact for
// terms of any sign: a sum is -0.0 only when both addends are, so a fold
// that starts at +0.0 never holds -0.0, and fl(a + 0.0) == fl(a - 0.0) == a
// for every other a. CUDA's index_add_ adds with atomics in no fixed order.
//
// f64_add_chain is a yardstick, not a port: one thread of dependent f64
// adds, built with the same flags, that gives the card's time per link of
// the budget chains (chip_smoke.py's chain bound).
//
// Entry points have a plain C interface (ctypes); each returns the CUDA
// error code of its launch and neither synchronises nor allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;  // timed against 256, 512 and 768
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRun = 256;  // new rates a warp compacts before lane 0 folds
constexpr int kChunk = 2048;  // segment values a segsum block stages at once
constexpr int kSegsumThreads = 128;

template <typename T>
struct WF;
template <>
struct WF<double> {
  static __device__ __forceinline__ double none() { return CUDART_INF; }
  static __device__ __forceinline__ double eps() { return 1e-12; }
};
template <>
struct WF<float> {
  static __device__ __forceinline__ float none() { return 1e30f; }
  static __device__ __forceinline__ float eps() { return 1e-6f; }
};

struct Csr {
  const int* off;  // [rows + 1]
  const int* idx;  // ascending connection indices of each row
};

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(kFull, v);
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Fold run[0, n) into acc, in order, in groups of eight: the next group's
// loads are issued before this group's adds. run must be readable up to
// n + 8 (its tail is padded); values past n are never added.
template <typename T>
__device__ __forceinline__ T fold_run(const T* run, int n, T acc) {
  T cur[8], nxt[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) cur[u] = run[u];
  int k = 0;
  for (; k + 8 <= n; k += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) nxt[u] = run[k + 8 + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = acc + cur[u];
#pragma unroll
    for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) acc = acc + (u < n - k ? cur[u] : T(0));
  return acc;
}

// Dynamic shared memory of one solve, in bytes: reals first (the
// reduction's minima, cap and rate per lane, each warp's run of new rates
// with fold_run's read-ahead, budget and share per segment), then ints
// (reduction words, the segment counter, unfixed counts per segment),
// then each lane's state byte.
size_t smem_bytes(int nc, int nv, int ne, int elem) {
  const size_t nseg = 2 * (size_t)nv + (size_t)ne;
  const size_t reals = (size_t)kWarps * (1 + kRun + 8) + 2 * (size_t)nc
                       + 2 * nseg;
  const size_t ints = (size_t)kWarps + 1 + nseg;
  const size_t b = reals * (size_t)elem + ints * 4 + (size_t)nc;
  return (b + 15) & ~(size_t)15;
}

// Dynamic shared memory one block may take (the kernel has no static).
size_t smem_limit(int) { return kMaxSmem; }

// The cluster kernel's lane scratch, in bytes: cap and rate per lane, then
// each lane's state byte (used where the largest cluster cannot hold the
// lanes).
size_t scratch_bytes(int nc, int elem) {
  return (2 * (size_t)nc * (size_t)elem + (size_t)nc + 15) & ~(size_t)15;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
waterfill_kernel(const T* __restrict__ caps, const int* __restrict__ src,
                 const int* __restrict__ dst, const int* __restrict__ eid,
                 const T* __restrict__ eg0, const T* __restrict__ in0,
                 const T* __restrict__ ed0, const uint8_t* __restrict__ active,
                 const uint8_t* __restrict__ changed,
                 const T* __restrict__ prev, Csr cs, Csr cd, Csr ce,
                 T* __restrict__ out, int nc, int nv, int ne, int ne_bound,
                 int n_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (changed != nullptr && *changed == 0) {  // membership unchanged
    for (int c = tid; c < nc; c += kThreads) out[c] = prev[c];
    return;
  }

  const int nseg = 2 * nv + ne;
  T* red_lo = reinterpret_cast<T*>(smem);  // [kWarps]
  T* cap = red_lo + kWarps;
  // a fixed lane's rate; an unfixed lane's share of the round
  T* rate = cap + nc;
  T* runs = rate + nc;  // per warp
  T* run = runs + warp * (kRun + 8);  // this warp's [kRun + 8]
  T* bud = runs + kWarps * (kRun + 8);  // [nseg] egress, ingress, edge
  T* seg_share = bud + nseg;            // [nseg]
  int* red_n = reinterpret_cast<int*>(seg_share + nseg);  // [kWarps]
  int* next_seg = red_n + kWarps;  // the segment counter of a pass
  int* cnt = next_seg + 1;         // [nseg] unfixed lanes
  // st: 1 = unfixed active lane, 2 = fixed this round, 0 = fixed earlier or
  // inactive
  uint8_t* st = reinterpret_cast<uint8_t*>(cnt + nseg);
  const unsigned lt = (1u << lane) - 1u;

  // ---- stage the solve's state in shared memory once
  int vmax = -1;
#pragma unroll 4
  for (int c = tid; c < nc; c += kThreads) {
    cap[c] = caps[c];
    rate[c] = T(0);
    const uint8_t a = active[c] != 0;
    st[c] = a;
    if (a) vmax = max(vmax, max(src[c], dst[c]));
  }
  for (int s = tid; s < nseg; s += kThreads)
    bud[s] = s < nv ? eg0[s] : (s < 2 * nv ? in0[s - nv] : ed0[s - 2 * nv]);
  if (tid == 0) *next_seg = 0;
  for (int o = 16; o > 0; o >>= 1)
    vmax = max(vmax, __shfl_xor_sync(kFull, vmax, o));
  if (lane == 0) red_n[warp] = vmax;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) vmax = max(vmax, red_n[w]);
  const int bound = n_iters >= 0 ? n_iters : 2 * (vmax + 1) + ne_bound + 4;

  // Segments go to warps from a counter, edges first (they hold the most
  // lanes); the result does not depend on which warp takes which.
  auto take = [&]() {
    int q = 0;
    if (lane == 0) q = atomicAdd(next_seg, 1);
    return nseg - 1 - __shfl_sync(kFull, q, 0);
  };
  // segment s's CSR list
  auto list = [&](int s, int& b, int& e) -> const int* {
    const Csr& c = s < nv ? cs : (s < 2 * nv ? cd : ce);
    const int r = s < nv ? s : (s < 2 * nv ? s - nv : s - 2 * nv);
    b = c.off[r];
    e = c.off[r + 1];
    return c.idx;
  };
  auto set_share = [&](int s, int n) {
    cnt[s] = n;
    seg_share[s] = n > 0 ? bud[s] / T(n) : WF<T>::none();
  };
  // unfixed count and fair share of every segment
  for (int s = take(); s >= 0; s = take()) {
    int b, e;
    const int* idx = list(s, b, e);
    int n = 0;
    for (int j = b + lane; j < e; j += 32) n += st[idx[j]];
    n = warp_sum(n);
    if (lane == 0) set_share(s, n);
  }
  __syncthreads();

  const T eps = WF<T>::eps();
  for (int k = 0; k < bound; ++k) {
    // (A) share, cap-hit and minimum of the lanes still unfixed; last
    // round's new fixes become old ones
    int hit = 0, un = 0;
    T lo = WF<T>::none();
    for (int c = tid; c < nc; c += kThreads) {
      const uint8_t sc = st[c];
      if (sc != 1) {
        if (sc == 2) st[c] = 0;
        continue;
      }
      T sh = tmin(seg_share[src[c]], seg_share[nv + dst[c]]);
      if (ne > 0) sh = tmin(sh, seg_share[2 * nv + eid[c]]);
      rate[c] = sh;
      hit |= cap[c] <= sh + eps;
      lo = tmin(lo, sh);
      ++un;
    }
    hit = __any_sync(kFull, hit);
    un = warp_sum(un);
    lo = warp_min(lo);
    if (lane == 0) {
      red_lo[warp] = lo;
      red_n[warp] = (un << 1) | hit;
    }
    if (tid == 0) *next_seg = 0;
    __syncthreads();
    int n_un = 0, hits = 0;
    T thresh = WF<T>::none();
    for (int w = 0; w < kWarps; ++w) {
      n_un += red_n[w] >> 1;
      hits |= red_n[w] & 1;
      thresh = tmin(thresh, red_lo[w]);
    }
    if (n_un == 0) break;
    const bool anyc = hits != 0;

    // (B) fix the lanes this round binds
    for (int c = tid; c < nc; c += kThreads) {
      if (st[c] != 1) continue;
      const T sh = rate[c], cp = cap[c];
      if (anyc ? cp <= sh + eps : sh <= thresh + eps) {
        rate[c] = anyc ? cp : sh;
        st[c] = 2;
      }
    }
    __syncthreads();

    // (C) budgets lose the new rates, summed in ascending lane order;
    // counts lose the newly fixed lanes; new fair shares. A warp walks its
    // segment's list 32 lanes a step (the ids two steps ahead, the lanes'
    // state and rates one step ahead), compacts the nonzero new rates in
    // lane order into its run, and lane 0 folds the run whenever it could
    // not take another step, and at the end.
    for (int s = take(); s >= 0; s = take()) {
      int b, e;
      const int* idx = list(s, b, e);
      int nb = 0, nnew = 0;
      T acc = T(0);
      int c1 = b + lane < e ? idx[b + lane] : 0;
      int c2 = b + 32 + lane < e ? idx[b + 32 + lane] : 0;
      uint8_t f1 = st[c1];
      T v1 = rate[c1];
      for (int base = b; base < e; base += 32) {
        const bool f = base + lane < e && f1 == 2;
        const T v = f ? v1 : T(0);
        const int j = base + 64 + lane;
        const int c3 = j < e ? idx[j] : 0;
        f1 = st[c2];
        v1 = rate[c2];
        c2 = c3;
        nnew += __popc(__ballot_sync(kFull, f));
        const unsigned m = __ballot_sync(kFull, v != T(0));
        if (v != T(0)) run[nb + __popc(m & lt)] = v;
        nb += __popc(m);
        if (nb > kRun - 32) {
          __syncwarp();
          if (lane == 0) acc = fold_run(run, nb, acc);
          __syncwarp();
          nb = 0;
        }
      }
      __syncwarp();
      if (lane == 0) {
        acc = fold_run(run, nb, acc);
        T x = bud[s] - acc;
        bud[s] = x < T(0) ? T(0) : x;
        set_share(s, cnt[s] - nnew);
      }
      __syncwarp();
    }
    __syncthreads();
  }
  for (int c = tid; c < nc; c += kThreads)
    out[c] = st[c] == 1 ? T(0) : rate[c];
}

__global__ void __launch_bounds__(kSegsumThreads)
segsum_ordered_kernel(const double* __restrict__ vals,
                      const int* __restrict__ off,
                      const int* __restrict__ idx, double* __restrict__ out) {
  __shared__ double buf[kChunk];
  __shared__ double run[kChunk + 8];  // + fold_run's read-ahead
  __shared__ int step_off[kChunk / 32 + 1];
  const int s = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nwarps = kSegsumThreads / 32;
  const unsigned lt = (1u << lane) - 1u;
  const int b = off[s], e = off[s + 1];
  double acc = 0.0;
  for (int c0 = b; c0 < e; c0 += kChunk) {
    const int n = min(kChunk, e - c0), nsteps = (n + 31) >> 5;
    // sixteen indices a thread, then their sixteen values, all in flight
    for (int i0 = threadIdx.x; i0 < n; i0 += 16 * kSegsumThreads) {
      int ix[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + u * kSegsumThreads;
        ix[u] = i < n ? idx[c0 + i] : -1;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (ix[u] >= 0) buf[i0 + u * kSegsumThreads] = vals[ix[u]];
    }
    __syncthreads();
    // nonzero values in each 32-lane step, a warp per step
    for (int t = warp; t < nsteps; t += nwarps) {
      const int i = 32 * t + lane;
      const unsigned m = __ballot_sync(kFull, i < n && buf[i] != 0.0);
      if (lane == 0) step_off[t] = __popc(m);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the counts: two steps a lane
      const int a0 = 2 * lane < nsteps ? step_off[2 * lane] : 0;
      const int a1 = 2 * lane + 1 < nsteps ? step_off[2 * lane + 1] : 0;
      int x = a0 + a1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      __syncwarp();
      if (2 * lane < nsteps) step_off[2 * lane] = x - a0 - a1;
      if (2 * lane + 1 < nsteps) step_off[2 * lane + 1] = x - a1;
      if (lane == 31) step_off[nsteps] = x;
    }
    __syncthreads();
    // the nonzero values compacted in lane order, every step at once
    for (int t = warp; t < nsteps; t += nwarps) {
      const int i = 32 * t + lane;
      const double v = i < n ? buf[i] : 0.0;
      const bool nz = i < n && v != 0.0;
      const unsigned m = __ballot_sync(kFull, nz);
      if (nz) run[step_off[t] + __popc(m & lt)] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) acc = fold_run(run, step_off[nsteps], acc);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[s] = acc;
}

// ------------------------------------------------- one cluster per solve
//
// Per block of a cluster of K: a contiguous range of L = ceil(nc / K) lanes
// (cap, rate and state byte; in shared memory, or in the caller's scratch
// when the largest cluster cannot hold them), a replica of every segment's
// fair share, and the segments it owns (segment order edges first, then
// VM egress and ingress; owner q % K, slot q / K): budget, unfixed count and
// the tag of the last round that fixed one of its lanes.
constexpr int kCThreads = 512;
constexpr int kCWarps = kCThreads / 32;
constexpr int kBatch = 4;        // lanes a thread loads at once in a pass
constexpr int kCRun = 128;       // a short segment's run: one group of steps
constexpr int kGroup = kCRun / 32;  // 32-lane steps loaded at once
constexpr int kTeam = 4;         // warps that compact a long segment
constexpr int kRing = 4;         // chunk slots of a long segment's run
constexpr int kRingSteps = 16;   // 32-lane steps a chunk
constexpr int kRingChunk = kRingSteps * 32;
constexpr int kLong = 2048;      // lanes from which a segment is long
constexpr int kClockRounds = 16;

// clocks[]: per-pass cycles, each the most over the cluster's blocks
enum Clock {
  kClkStage = 0,   // staging the lanes and budgets, counting in the block
  kClkCount = 1,   // the owners' counts and first shares
  kClkRounds = 2,  // rounds that ran (A), whole solve's cycles in block 0
  kClkTotal = 3,
  kClkRound0 = 4,  // then per round: A, B, C, long walk, fold, fold wait,
                   // the fold's wait for its first chunk
};
constexpr int kClkPerRound = 7;

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// release at the block's scope: the arriving thread's writes before it
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// acquire: until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void clock_max(long long* clocks, int i,
                                          long long v) {
  atomicMax(reinterpret_cast<unsigned long long*>(clocks + i),
            (unsigned long long)v);
}

// Dynamic shared memory of one block of a K-block cluster, in bytes: the
// ring's mbarriers; reals (the warps' minima and the block's, the share
// replica, owned budgets, the long-segment ring and the short-segment
// runs, each with fold_run's read-ahead, then cap and rate of the block's
// lanes); ints (the warps' and the block's reduction words, the queue's
// three counters, the ring slots' value and new-lane counts, owned unfixed
// counts and tags, the round's queue of tagged segments: slot, list begin
// and end); then the lanes' state bytes.
size_t cluster_smem_bytes(int nc, int nv, int ne, int elem, int k,
                          bool lanes_shared) {
  const size_t nseg = 2 * (size_t)nv + (size_t)ne;
  const size_t nown = (nseg + k - 1) / k;
  const size_t l = lanes_shared ? ((size_t)nc + k - 1) / k : 0;
  const size_t reals = (size_t)kCWarps + 1 + nseg + nown
                       + (size_t)kRing * (kRingChunk + 8)
                       + (size_t)kCWarps * (kCRun + 8) + 2 * l;
  const size_t ints = (size_t)kCWarps + 5 + 2 * (size_t)kRing + 5 * nown;
  const size_t b = 16 * (size_t)kRing + reals * (size_t)elem + ints * 4 + l;
  return (b + 15) & ~(size_t)15;
}

// K and where the lanes live: +K with the lanes in the cluster's shared
// memory (the smallest K of 2, 4, 8 and, up to kmax, 16 that holds them),
// -kmax with the lanes in device memory, 0 when not even the segments fit
int cluster_plan(int nc, int nv, int ne, int elem, int kmax) {
  for (int k = 2; k <= kmax; k *= 2)
    if (cluster_smem_bytes(nc, nv, ne, elem, k, true) <= kMaxSmem) return k;
  if (cluster_smem_bytes(nc, nv, ne, elem, kmax, false) <= kMaxSmem)
    return -kmax;
  return 0;
}

template <typename T, bool kLanesShared>
__global__ void __launch_bounds__(kCThreads, 1)
waterfill_cluster_kernel(
    const T* __restrict__ caps, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ eid,
    const T* __restrict__ eg0, const T* __restrict__ in0,
    const T* __restrict__ ed0, const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ changed, const T* __restrict__ prev, Csr cs,
    Csr cd, Csr ce, unsigned char* lanes, T* __restrict__ out, int nc,
    int nv, int ne, int ne_bound, int n_iters, long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int K = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int lk = __ffs(K) - 1;  // K is a power of two
  const int L = (nc + K - 1) / K;
  const int c0 = min(nc, r * L), nl = min(nc, c0 + L) - c0;
  const float inv_l = 1.0f / (float)L;

  if (changed != nullptr && *changed == 0) {  // membership unchanged
    for (int i = tid; i < nl; i += kCThreads) out[c0 + i] = prev[c0 + i];
    return;
  }
  const long long t_start = clock64();

  const int nseg = 2 * nv + ne, nown = (nseg + K - 1) / K;
  // each ring slot's two mbarriers: full (kRing) and empty (kRing)
  uint64_t* ring_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ring_empty = ring_full + kRing;
  T* red_lo = reinterpret_cast<T*>(ring_empty + kRing);  // [kCWarps]
  T* blk_lo = red_lo + kCWarps;            // [1] the block's minimum
  T* share = blk_lo + 1;                   // [nseg] every segment's
  T* bud = share + nseg;                   // [nown] owned budgets
  T* ring = bud + nown;                    // [kRing][kRingChunk + 8]
  T* run = ring + kRing * (kRingChunk + 8) + warp * (kCRun + 8);
  T* lane_end = ring + kRing * (kRingChunk + 8) + kCWarps * (kCRun + 8);
  T* cap = kLanesShared ? lane_end : reinterpret_cast<T*>(lanes) + c0;
  // a fixed lane's rate; an unfixed lane's share of the round
  T* rate = kLanesShared ? cap + L : reinterpret_cast<T*>(lanes) + nc + c0;
  int* red_n = reinterpret_cast<int*>(kLanesShared ? rate + L : lane_end);
  int* blk_n = red_n + kCWarps;  // [1] the block's (unfixed << 1) | hit
  int* blk_v = blk_n + 1;        // [1] the block's largest active VM
  int* next_short = blk_v + 1;   // [1] the short segments taken
  int* n_short = next_short + 1;  // [1] short segments queued (front)
  int* n_long = n_short + 1;     // [1] long segments queued (back)
  int* ring_n = n_long + 1;      // [kRing] values in a slot
  int* ring_new = ring_n + kRing;  // [kRing] newly fixed lanes in a slot
  int* cnt = ring_new + kRing;   // [nown] owned unfixed counts
  int* tag = cnt + nown;         // [nown] last round that fixed a lane
  int* q_slot = tag + nown;      // [nown] the round's tagged segments
  int* q_beg = q_slot + nown;    // [nown] their lists' begin and end
  int* q_end = q_beg + nown;
  // st: 1 = unfixed active lane, 2 = fixed this round, 0 = fixed earlier or
  // inactive
  uint8_t* st = kLanesShared
      ? reinterpret_cast<uint8_t*>(q_end + nown)
      : reinterpret_cast<uint8_t*>(reinterpret_cast<T*>(lanes) + 2 * nc) + c0;
  // a lane of any block: its state byte and rate
  const uint8_t* st_all = kLanesShared ? st : st - c0;
  const T* rate_all = kLanesShared ? rate : rate - c0;
  auto lane_state = [&](int c, uint8_t& sv, T& rv) {
    if (kLanesShared) {
      int b = (int)((float)c * inv_l);  // c / L, corrected below
      b -= b * L > c;
      b += (b + 1) * L <= c;
      const int i = c - b * L;
      sv = cluster.map_shared_rank(st_all, b)[i];
      rv = cluster.map_shared_rank(rate_all, b)[i];
    } else {
      sv = st_all[c];
      rv = rate_all[c];
    }
  };
  // segment s's owner (q & (K - 1)) and slot there (q >> lk)
  auto order = [&](int s) { return s >= 2 * nv ? s - 2 * nv : s + ne; };
  auto seg_of = [&](int i) {  // the segment in this block's slot i
    const int q = (i << lk) + r;
    return q < ne ? 2 * nv + q : q - ne;
  };
  // segment s's CSR list: its bounds, and the lanes of its kind
  auto bounds = [&](int s, int& b, int& e) {
    const Csr& c = s < nv ? cs : (s < 2 * nv ? cd : ce);
    const int row = s < nv ? s : (s < 2 * nv ? s - nv : s - 2 * nv);
    b = c.off[row];
    e = c.off[row + 1];
  };
  auto lanes_of = [&](int s) -> const int* {
    return s < nv ? cs.idx : (s < 2 * nv ? cd.idx : ce.idx);
  };
  // an owner's new share of slot i, into every block's replica
  auto publish = [&](int i, int n) {
    cnt[i] = n;
    const T sh = n > 0 ? bud[i] / T(n) : WF<T>::none();
    const int s = seg_of(i);
    for (int b = 0; b < K; ++b) cluster.map_shared_rank(share, b)[s] = sh;
  };
  // budget loses the folded new rates, count the new lanes; new share
  auto settle = [&](int i, T acc, int nnew) {
    const T x = bud[i] - acc;
    bud[i] = x < T(0) ? T(0) : x;
    publish(i, cnt[i] - nnew);
  };

  // ---- stage the block's lanes and the owned budgets, and count each
  // segment's active lanes in this block (ints in the share replica's
  // room, one shared-memory atomic per run of equal segments in a warp)
  int* lcnt = reinterpret_cast<int*>(share);  // [nseg] until the shares
  for (int s = tid; s < nseg; s += kCThreads) lcnt[s] = 0;
  for (int i = tid; i < nown; i += kCThreads) {
    tag[i] = 0;  // a slot past the last segment too: it is never tagged
    if ((i << lk) + r >= nseg) continue;
    const int s = seg_of(i);
    bud[i] = s < nv ? eg0[s] : (s < 2 * nv ? in0[s - nv] : ed0[s - 2 * nv]);
  }
  if (tid < kRing) {
    mbar_init(ring_full + tid, 32);
    mbar_init(ring_empty + tid, 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  auto count_in = [&](bool a, int s) {
    const unsigned m = __ballot_sync(kFull, a);
    if (a) {
      const unsigned g = __match_any_sync(m, s);
      if (lane == __ffs(g) - 1) atomicAdd(lcnt + s, __popc(g));
    }
  };
  // four lanes a thread at once: every load in flight before the atomics
  int vmax = -1;
  for (int i0 = 0; i0 < nl; i0 += kBatch * kCThreads) {
    bool a[kBatch];
    int sv[kBatch], dv[kBatch], ev[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kCThreads + tid;
      const bool in = i < nl;
      const int c = c0 + (in ? i : 0);
      const T cp = caps[c];
      a[u] = in && active[c] != 0;
      sv[u] = src[c];
      dv[u] = dst[c];
      ev[u] = ne > 0 ? eid[c] : 0;
      if (in) {
        cap[i] = cp;
        rate[i] = T(0);
        st[i] = a[u];
      }
      if (a[u]) vmax = max(vmax, max(sv[u], dv[u]));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      count_in(a[u], sv[u]);
      count_in(a[u], nv + dv[u]);
      if (ne > 0) count_in(a[u], 2 * nv + ev[u]);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    vmax = max(vmax, __shfl_xor_sync(kFull, vmax, o));
  if (lane == 0) red_n[warp] = vmax;
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < kCWarps; ++w) vmax = max(vmax, red_n[w]);
    *blk_v = vmax;
  }
  const long long t_staged = clock64();
  cluster_sync_all();
  // ---- owners sum their segments' counts over the blocks
  for (int i = tid; i < nown; i += kCThreads) {
    if ((i << lk) + r >= nseg) continue;
    const int s = seg_of(i);
    int n = 0;
    for (int b = 0; b < K; ++b) n += cluster.map_shared_rank(lcnt, b)[s];
    cnt[i] = n;
  }
  vmax = -1;
  for (int b = 0; b < K; ++b)
    vmax = max(vmax, *cluster.map_shared_rank(blk_v, b));
  const int bound = n_iters >= 0 ? n_iters : 2 * (vmax + 1) + ne_bound + 4;
  cluster_sync_all();
  for (int i = tid; i < nown; i += kCThreads)
    if ((i << lk) + r < nseg) publish(i, cnt[i]);
  cluster_sync_all();
  if (clocks != nullptr && tid == 0) {
    clock_max(clocks, kClkStage, t_staged - t_start);
    clock_max(clocks, kClkCount, clock64() - t_staged);
  }

  const T eps = WF<T>::eps();
  int chunks = 0;  // long-segment chunks through the ring so far
  int k = 0;
  for (; k < bound; ++k) {
    long long t0 = clock64();
    // (A) share, cap-hit and minimum of the block's unfixed lanes; last
    // round's new fixes become old ones
    int hit = 0, un = 0;
    T lo = WF<T>::none();
    for (int i0 = tid; i0 < nl; i0 += kBatch * kCThreads) {
      uint8_t sc[kBatch];
      int sv[kBatch], dv[kBatch], ev[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // every load in flight at once
        const int i = i0 + u * kCThreads;
        sc[u] = i < nl ? st[i] : 0;
        const int c = c0 + (sc[u] == 1 ? i : 0);
        sv[u] = src[c];
        dv[u] = dst[c];
        ev[u] = ne > 0 ? eid[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCThreads;
        if (sc[u] != 1) {
          if (sc[u] == 2) st[i] = 0;
          continue;
        }
        T sh = tmin(share[sv[u]], share[nv + dv[u]]);
        if (ne > 0) sh = tmin(sh, share[2 * nv + ev[u]]);
        rate[i] = sh;
        hit |= cap[i] <= sh + eps;
        lo = tmin(lo, sh);
        ++un;
      }
    }
    hit = __any_sync(kFull, hit);
    un = warp_sum(un);
    lo = warp_min(lo);
    if (lane == 0) {
      red_lo[warp] = lo;
      red_n[warp] = (un << 1) | hit;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0, h = 0;
      T m = WF<T>::none();
      for (int w = 0; w < kCWarps; ++w) {
        n += red_n[w] >> 1;
        h |= red_n[w] & 1;
        m = tmin(m, red_lo[w]);
      }
      *blk_lo = m;
      *blk_n = (n << 1) | h;
      *next_short = 0;
      *n_short = 0;
      *n_long = 0;
    }
    cluster_sync_all();
    // the cluster's: lane b reads block b's, then the warp reduces
    int bn = lane < K ? *cluster.map_shared_rank(blk_n, lane) : 0;
    T bl = lane < K ? *cluster.map_shared_rank(blk_lo, lane) : WF<T>::none();
    const int n_un = warp_sum(bn >> 1);
    const bool anyc = __any_sync(kFull, bn & 1);
    const T thresh = warp_min(bl);
    if (n_un == 0) break;
    long long t1 = clock64();

    // (B) fix the lanes this round binds; tag their segments at the owners
    const int rtag = k + 1;
    auto mark = [&](int s) {
      const int q = order(s);
      cluster.map_shared_rank(tag, q & (K - 1))[q >> lk] = rtag;
    };
    for (int i0 = tid; i0 < nl; i0 += kBatch * kCThreads) {
      bool fx[kBatch];
      int sv[kBatch], dv[kBatch], ev[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kCThreads;
        fx[u] = false;
        if (i < nl && st[i] == 1) {
          const T sh = rate[i], cp = cap[i];
          if (anyc ? cp <= sh + eps : sh <= thresh + eps) {
            rate[i] = anyc ? cp : sh;
            st[i] = 2;
            fx[u] = true;
          }
        }
        const int c = c0 + (fx[u] ? i : 0);
        sv[u] = src[c];
        dv[u] = dst[c];
        ev[u] = ne > 0 ? eid[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!fx[u]) continue;
        mark(sv[u]);
        mark(nv + dv[u]);
        if (ne > 0) mark(2 * nv + ev[u]);
      }
    }
    cluster_sync_all();
    long long t2 = clock64();
    // the block's tagged segments, queued: short ones from the front, long
    // ones from the back
    for (int i0 = warp * 32; i0 < nown; i0 += kCThreads) {
      const int i = i0 + lane;
      int b = 0, e = 0;
      const bool tagged = i < nown && tag[i] == rtag;
      if (tagged) bounds(seg_of(i), b, e);
      const bool lg = tagged && e - b >= kLong;
      const unsigned ms = __ballot_sync(kFull, tagged && !lg);
      const unsigned ml = __ballot_sync(kFull, lg);
      int at_s = 0, at_l = 0;
      if (lane == 0) {
        if (ms) at_s = atomicAdd(n_short, __popc(ms));
        if (ml) at_l = atomicAdd(n_long, __popc(ml));
      }
      at_s = __shfl_sync(kFull, at_s, 0) + __popc(ms & lt);
      at_l = nown - 1 - (__shfl_sync(kFull, at_l, 0) + __popc(ml & lt));
      if (tagged) {
        const int at = lg ? at_l : at_s;
        q_slot[at] = i;
        q_beg[at] = b;
        q_end[at] = e;
      }
    }
    __syncthreads();

    // (C) each owner settles its tagged segments: budgets lose the new
    // rates, summed in ascending lane order (each lane read from the block
    // that holds it); counts lose the new lanes; new shares to every block.
    // Long segments: warps 1..kTeam compact chunks of kRingSteps steps in
    // turn into the ring's slots, and lane 0 of warp 0 folds them in order
    // behind them; each slot's mbarriers pass it between the two (full:
    // the compacting warp's 32 lanes arrive; empty: the fold arrives).
    if (warp <= kTeam) {
      long long walk = 0, fold = 0, wait = 0, first = 0;
      int g = 0;  // the chunk's index over this round's long segments
      for (int u = 0; u < *n_long; ++u) {
        const int i = q_slot[nown - 1 - u];
        const int b = q_beg[nown - 1 - u], e = q_end[nown - 1 - u];
        const int* idx = lanes_of(seg_of(i));
        const int nch = (e - b + kRingChunk - 1) / kRingChunk;
        if (warp == 0) {
          if (lane == 0) {
            T acc = T(0);
            int nnew = 0;
            for (int j = 0; j < nch; ++j) {
              const int at = chunks + g + j;  // over the whole solve
              const int slot = at % kRing;
              const long long w0 = clock64();
              mbar_wait(ring_full + slot, (at / kRing) & 1);
              const long long w1 = clock64();
              acc = fold_run(ring + slot * (kRingChunk + 8), ring_n[slot],
                             acc);
              nnew += ring_new[slot];
              mbar_arrive(ring_empty + slot);
              if (j == 0) first += w1 - w0;
              wait += w1 - w0;
              fold += clock64() - w1;
            }
            settle(i, acc, nnew);
          }
          __syncwarp();
        } else {
          const long long w0 = clock64();
          for (int j = warp - 1 - g % kTeam; j < nch; j += kTeam) {
            if (j < 0) continue;
            const int at = chunks + g + j;
            const int slot = at % kRing;
            T* out_run = ring + slot * (kRingChunk + 8);
            const int p0 = b + j * kRingChunk;
            int cid[kRingSteps];
#pragma unroll
            for (int t = 0; t < kRingSteps; ++t) {
              const int p = p0 + 32 * t + lane;
              cid[t] = p < e ? idx[p] : -1;
            }
            uint8_t sv[kRingSteps];
            T rv[kRingSteps];
#pragma unroll
            for (int t = 0; t < kRingSteps; ++t)
              lane_state(max(cid[t], 0), sv[t], rv[t]);
            // the slot's last chunk folded (its first use passes at once)
            mbar_wait(ring_empty + slot, ((at / kRing) & 1) ^ 1);
            int nb = 0, nnew = 0;
#pragma unroll
            for (int t = 0; t < kRingSteps; ++t) {
              const bool f = cid[t] >= 0 && sv[t] == 2;
              const T v = f ? rv[t] : T(0);
              nnew += __popc(__ballot_sync(kFull, f));
              const unsigned m = __ballot_sync(kFull, v != T(0));
              if (v != T(0)) out_run[nb + __popc(m & lt)] = v;
              nb += __popc(m);
            }
            if (lane == 0) {
              ring_n[slot] = nb;
              ring_new[slot] = nnew;
            }
            __syncwarp();
            mbar_arrive(ring_full + slot);
          }
          walk += clock64() - w0;
        }
        g += nch;
      }
      chunks += g;
      if (clocks != nullptr && k < kClockRounds) {
        const int base = kClkRound0 + kClkPerRound * k;
        if (warp == 0 && lane == 0) {
          clock_max(clocks, base + 4, fold);
          clock_max(clocks, base + 5, wait);
          clock_max(clocks, base + 6, first);
        } else if (warp > 0 && lane == 0) {
          clock_max(clocks, base + 3, walk);
        }
      }
    }
    // short segments: a warp each, from the queue
    for (;;) {
      int u = 0;
      if (lane == 0) u = atomicAdd(next_short, 1);
      u = __shfl_sync(kFull, u, 0);
      if (u >= *n_short) break;
      const int i = q_slot[u], b = q_beg[u], e = q_end[u];
      const int* idx = lanes_of(seg_of(i));
      T acc = T(0);
      int nnew = 0;
      for (int p0 = b; p0 < e; p0 += kCRun) {
        int cid[kGroup];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const int p = p0 + 32 * t + lane;
          cid[t] = p < e ? idx[p] : -1;
        }
        uint8_t sv[kGroup];
        T rv[kGroup];
#pragma unroll
        for (int t = 0; t < kGroup; ++t) lane_state(max(cid[t], 0), sv[t], rv[t]);
        int nb = 0;
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const bool f = cid[t] >= 0 && sv[t] == 2;
          const T v = f ? rv[t] : T(0);
          nnew += __popc(__ballot_sync(kFull, f));
          const unsigned m = __ballot_sync(kFull, v != T(0));
          if (v != T(0)) run[nb + __popc(m & lt)] = v;
          nb += __popc(m);
        }
        __syncwarp();
        if (lane == 0) acc = fold_run(run, nb, acc);
        __syncwarp();
      }
      if (lane == 0) settle(i, acc, nnew);
    }
    cluster_sync_all();
    if (clocks != nullptr && tid == 0 && k < kClockRounds) {
      const int base = kClkRound0 + kClkPerRound * k;
      clock_max(clocks, base, t1 - t0);
      clock_max(clocks, base + 1, t2 - t1);
      clock_max(clocks, base + 2, clock64() - t2);
    }
  }
  for (int i = tid; i < nl; i += kCThreads)
    out[c0 + i] = st[i] == 1 ? T(0) : rate[i];
  if (clocks != nullptr && tid == 0) {
    clock_max(clocks, kClkRounds, k);
    if (r == 0) clock_max(clocks, kClkTotal, clock64() - t_start);
  }
  cluster_sync_all();  // no block leaves while another may read its memory
}

template <typename T>
int launch_waterfill(const void* caps, const void* src, const void* dst,
                     const void* eid, const void* eg, const void* in,
                     const void* ed, const void* active, const void* changed,
                     const void* prev, const void* src_off,
                     const void* src_idx, const void* dst_off,
                     const void* dst_idx, const void* ed_off,
                     const void* ed_idx, void* out, int nc, int nv, int ne,
                     int ne_bound, int n_iters, void* stream) {
  static size_t configured = 0;
  const size_t smem = smem_bytes(nc, nv, ne, (int)sizeof(T));
  if (smem > smem_limit((int)sizeof(T))) return (int)cudaErrorInvalidValue;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        waterfill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  Csr cs{(const int*)src_off, (const int*)src_idx};
  Csr cd{(const int*)dst_off, (const int*)dst_idx};
  Csr ce{(const int*)ed_off, (const int*)ed_idx};
  waterfill_kernel<T><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)caps, (const int*)src, (const int*)dst, (const int*)eid,
      (const T*)eg, (const T*)in, (const T*)ed, (const uint8_t*)active,
      (const uint8_t*)changed, (const T*)prev, cs, cd, ce, (T*)out, nc, nv,
      ne, ne_bound, n_iters);
  return (int)cudaGetLastError();
}

// Both cluster attributes of one instantiation, set once: non-portable
// sizes allowed, and dynamic shared memory up to a block's limit.
template <typename T, bool kLanesShared>
cudaError_t configure_cluster() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    auto kern = waterfill_cluster_kernel<T, kLanesShared>;
    done = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  }
  return done;
}

cudaLaunchConfig_t cluster_config(int k, size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, 1, 1);  // exactly one cluster
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// 16 where the card can hold one cluster of 16 blocks that each take a
// block's whole shared memory, else 8 (the portable size); minus the CUDA
// error where the attribute or occupancy query fails
int cluster_max() {
  static int kmax = 0;
  if (kmax == 0) {
    // an error pending from earlier work is not the query's to clear
    const bool clean = cudaPeekAtLastError() == cudaSuccess;
    int n = 0;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(16, kMaxSmem, nullptr, &attr);
    cudaError_t e = configure_cluster<double, true>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(
          &n, waterfill_cluster_kernel<double, true>, &cfg);
    if (e != cudaSuccess) {
      if (clean) cudaGetLastError();
      return -(int)e;
    }
    kmax = n >= 1 ? 16 : 8;
  }
  return kmax;
}

template <typename T>
int launch_cluster(const void* caps, const void* src, const void* dst,
                   const void* eid, const void* eg, const void* in,
                   const void* ed, const void* active, const void* changed,
                   const void* prev, const void* src_off, const void* src_idx,
                   const void* dst_off, const void* dst_idx,
                   const void* ed_off, const void* ed_idx, void* lanes,
                   void* out, int nc, int nv, int ne, int ne_bound,
                   int n_iters, void* clocks, void* stream) {
  const int kmax = cluster_max();
  if (kmax < 0) return -kmax;
  const int plan = cluster_plan(nc, nv, ne, (int)sizeof(T), kmax);
  if (plan == 0 || lanes == nullptr) return (int)cudaErrorInvalidValue;
  const bool shared = plan > 0;
  const int k = shared ? plan : -plan;
  const size_t smem = cluster_smem_bytes(nc, nv, ne, (int)sizeof(T), k,
                                         shared);
  Csr cs{(const int*)src_off, (const int*)src_idx};
  Csr cd{(const int*)dst_off, (const int*)dst_idx};
  Csr ce{(const int*)ed_off, (const int*)ed_idx};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(k, smem, stream, &attr);
  cudaError_t e = shared ? configure_cluster<T, true>()
                         : configure_cluster<T, false>();
  if (e != cudaSuccess) return (int)e;
  auto kern = shared ? waterfill_cluster_kernel<T, true>
                     : waterfill_cluster_kernel<T, false>;
  e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)caps, (const int*)src, (const int*)dst,
      (const int*)eid, (const T*)eg, (const T*)in, (const T*)ed,
      (const uint8_t*)active, (const uint8_t*)changed, (const T*)prev, cs,
      cd, ce, (unsigned char*)lanes, (T*)out, nc, nv, ne, ne_bound, n_iters,
      (long long*)clocks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__global__ void f64_add_chain_kernel(const double* __restrict__ x,
                                     double* __restrict__ out, int n) {
  const double d = x[0];
  double acc = 0.0;
  for (int i = 0; i < n; ++i) acc = acc + d;
  out[0] = acc;
}

}  // namespace

extern "C" {

size_t waterfill_smem_bytes(int nc, int nv, int ne, int elem) {
  return smem_bytes(nc, nv, ne, elem);
}

size_t waterfill_smem_limit(int elem) { return smem_limit(elem); }

size_t waterfill_scratch_bytes(int nc, int elem) {
  return scratch_bytes(nc, elem);
}

size_t waterfill_cluster_smem_bytes(int nc, int nv, int ne, int elem, int k,
                                    int lanes_shared) {
  return cluster_smem_bytes(nc, nv, ne, elem, k, lanes_shared != 0);
}

int waterfill_cluster_plan(int nc, int nv, int ne, int elem, int kmax) {
  return cluster_plan(nc, nv, ne, elem, kmax);
}

int waterfill_cluster_max() { return cluster_max(); }

#define WATERFILL_ARGS                                                      \
  const void *caps, const void *src, const void *dst, const void *eid,     \
      const void *eg, const void *in, const void *ed, const void *active,  \
      const void *changed, const void *prev, const void *src_off,          \
      const void *src_idx, const void *dst_off, const void *dst_idx,       \
      const void *ed_off, const void *ed_idx
#define WATERFILL_PASS                                                      \
  caps, src, dst, eid, eg, in, ed, active, changed, prev, src_off, src_idx, \
      dst_off, dst_idx, ed_off, ed_idx

// the shared-memory kernels: every lane in one block's shared memory
int waterfill_f64(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                  int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<double>(WATERFILL_PASS, out, nc, nv, ne, ne_bound,
                                  n_iters, stream);
}

int waterfill_f32(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                  int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<float>(WATERFILL_PASS, out, nc, nv, ne, ne_bound,
                                 n_iters, stream);
}

// the cluster kernels: one cluster of waterfill_cluster_plan's K blocks;
// `lanes` (waterfill_scratch_bytes(nc, elem) bytes, 16-byte aligned) holds
// the lanes where the cluster's shared memory cannot; `clocks` (null, or
// 128 zeroed int64) receives the per-pass cycles (enum Clock)
int waterfill_f64_cluster(WATERFILL_ARGS, void* lanes, void* out, int nc,
                          int nv, int ne, int ne_bound, int n_iters,
                          void* clocks, void* stream) {
  return launch_cluster<double>(WATERFILL_PASS, lanes, out, nc, nv, ne,
                                ne_bound, n_iters, clocks, stream);
}

int waterfill_f32_cluster(WATERFILL_ARGS, void* lanes, void* out, int nc,
                          int nv, int ne, int ne_bound, int n_iters,
                          void* clocks, void* stream) {
  return launch_cluster<float>(WATERFILL_PASS, lanes, out, nc, nv, ne,
                               ne_bound, n_iters, clocks, stream);
}

#undef WATERFILL_ARGS
#undef WATERFILL_PASS

int segsum_ordered_f64(const void* vals, const void* off, const void* idx,
                       void* out, int nseg, void* stream) {
  if (nseg <= 0) return 0;
  segsum_ordered_kernel<<<nseg, kSegsumThreads, 0, (cudaStream_t)stream>>>(
      (const double*)vals, (const int*)off, (const int*)idx, (double*)out);
  return (int)cudaGetLastError();
}

// n dependent f64 adds on one thread (the build's --fmad=false): what one
// link of the water-filling budget chains costs on this card
int f64_add_chain(const void* x, void* out, int n, void* stream) {
  f64_add_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)x, (double*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
