// Max-min water-filling for Hopper (sm_90a), one thread block per solve or,
// past one block's shared memory, one thread-block cluster per solve; and
// the sim's ordered segment sum.
//
// Two kernels take the solves of each precision, by size alone
// (kernels/waterfill/ops.py::launch_plan mirrors the rule): an f64 solve
// takes waterfill_shared_kernel where every operand fits one block's
// shared memory (shared_smem_bytes, ~54 bytes a lane: ~3,800 lanes at 12
// VMs and 36 edges), else waterfill_cluster_kernel; an f32 solve takes
// waterfill_kernel where its lanes fit one block (smem_bytes, 9 bytes a
// lane: ~24,000 lanes), else the cluster kernel. waterfill_kernel has no
// f64 instantiation: on an H100 (700 W) a cluster of two blocks solved
// 4,096 to 11,264 lanes (8 to 22 direct jobs of 8 VMs) in 0.059-0.101 ms
// against its 0.076-0.219, and below ~3,800 lanes the staged kernel beats
// it (11.2 against 24.6 us a broadcast solve).
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
// What waterfill_kernel does about it (designed around the f64 chain):
//   * the solve's state lives in shared memory for the whole solve: caps,
//     rates and a state byte per lane, budgets, fair shares and unfixed
//     counts per segment, and each warp's run of new rates. The lanes'
//     segment ids and the CSR lists stay in device memory and are read
//     through L1 (staging them measured no faster at the Fig. 6 sim's 600
//     lanes on one edge, where the one list's chain of 595 adds is the
//     bound; the staged kernel below is the design for short lists);
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
//     flagged nonzero by a ballot;
//   * the lane pass of the next round cannot start under a long fold: every
//     lane reads its edge's new share, which the edge's fold produces last;
//   * one block holds a solve of ~24,000 lanes at f32.
//
// waterfill_shared_kernel, for the small solves. A real solve of Skyplane's
// broadcast (12 VMs, 36 edges, 732 lanes, 151-422 of them active, 4 rounds
// on average) has 60 lists of 7 to 105 lanes: its adds are few, and
// waterfill_kernel spent its time walking them (each warp five lists in
// turn, every step two dependent loads through L1) and counting (its
// clock64 split over those solves: (C) 54% of the solve, the first counts
// 15%). So:
//   * one staging pass loads every operand with its loads in flight at
//     once: cap, state, the lanes' three segments and their positions in
//     the three lists (16-bit), each list position's active bit, budgets
//     and list bounds; after it no pass waits on device memory;
//   * the first counts are the popcounts of each segment's active bits;
//   * the lists lie end to end, a rate per position; a lane fixed in a
//     round writes its rate at its three positions and sets their fresh
//     bits (every other position holds +0.0: a lane's positions are
//     cleared the round after), so a segment's new lanes are its fresh
//     bits and its budget's loss is the
//     fold of a contiguous run: a thread folds a list of up to 64
//     positions outright (adding +0.0 is exact), a warp compacts a longer
//     one's nonzero rates for its lane 0 to fold, all segments at once;
//   * the least share of the round is the least share of a segment with
//     an unfixed lane (a lane's share is one of its segments'), so one warp
//     reads it from the 60 segments while the others pass their lanes, and
//     one barrier ORs the cap hits (bar.red.or);
//   * the loops that one thread runs once at these sizes are not unrolled.
// Measured on an H100 (700 W) over 200 recorded broadcast solves: 11.2 us a
// solve against waterfill_kernel's 24.6; the Fig. 6 sim's 600 lanes on one
// edge 12.4 against 15.9. Measured slower: the least share from the lanes
// (a warp reduction, then a 64-bit shared atomic, which is a CAS loop, or
// a reduction of the warps' words after the barrier); a thread a segment
// folding only its fresh positions, found bit by bit with __ffs, or ranked
// first by popcounts; a warp for every list; counts by warp-aggregated
// shared atomics (__match_any_sync); 256, 384, 512 and 1,024 threads.
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
// The cluster kernel has two instantiations, waterfill_shared_kernel the
// double one alone and waterfill_kernel the float one alone:
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

// The staged kernel's clock probes, compiled in only where kOn: per
// pass, thread 0's cycles from the barrier that began it to the one that
// ended it, into the caller's clocks[] (int64 [128], zeroed): staging, the
// first counts, the rounds that ran (A), the whole solve, then per round
// (A), (B), (C), the slowest thread's fold adds in (C), and for each of
// (A), (B) and (C) the slowest warp's cycles from the pass's start to its
// barrier.
enum BlockClock {
  kBClkStage = 0,
  kBClkCount = 1,
  kBClkRounds = 2,
  kBClkTotal = 3,
  kBClkRound0 = 4,
};
enum RoundClock {
  kBClkA = 0,
  kBClkB = 1,
  kBClkC = 2,
  kBClkFold = 3,
  kBClkWork = 4,  // then (A), (B), (C): the slowest warp's time to the barrier
};
constexpr int kBClkPerRound = 7;
constexpr int kBClkMaxRounds = (128 - kBClkRound0) / kBClkPerRound;

template <bool kOn>
struct Probe {
  long long* clocks;
  long long t0 = 0, last = 0, folds = 0, pass = 0;
  __device__ explicit Probe(long long* c) : clocks(c) {
    if (kOn) t0 = last = clock64();
  }
  __device__ long long now() const { return kOn ? clock64() : 0; }
  __device__ void put(int slot) {
    if (!kOn || threadIdx.x != 0) return;
    const long long t = clock64();
    if (slot >= 0) clocks[slot] = t - last;
    last = t;
  }
  __device__ void mark(int slot) { put(slot); }
  __device__ void mark_round(int k, int pass) {
    put(k < kBClkMaxRounds ? kBClkRound0 + kBClkPerRound * k + pass : -1);
  }
  __device__ void fold(long long f0) {
    if (kOn) folds += clock64() - f0;
  }
  // every thread, where a pass starts
  __device__ void start() {
    if (kOn) pass = clock64();
  }
  // every thread, before the barrier that ends pass p of round k
  __device__ void arrive(int k, int p) {
    if (kOn && (threadIdx.x & 31) == 0 && k < kBClkMaxRounds)
      atomicMax(reinterpret_cast<unsigned long long*>(
                    clocks + kBClkRound0 + kBClkPerRound * k + kBClkWork + p),
                (unsigned long long)(clock64() - pass));
  }
  // the warp's slowest fold of round k, at most over the block; every lane
  // of the warp calls it
  __device__ void fold_max(int k) {
    if (!kOn) return;
    long long f = folds;
    for (int o = 16; o > 0; o >>= 1) f = max(f, __shfl_xor_sync(kFull, f, o));
    folds = 0;
    if ((threadIdx.x & 31) == 0 && k < kBClkMaxRounds)
      atomicMax(reinterpret_cast<unsigned long long*>(
                    clocks + kBClkRound0 + kBClkPerRound * k + kBClkFold),
                (unsigned long long)f);
  }
  __device__ void finish(int k) {
    if (!kOn || threadIdx.x != 0) return;
    clocks[kBClkRounds] = k;
    clocks[kBClkTotal] = clock64() - t0;
  }
};

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

// ------------------------------------------ one block, every operand staged
//
// The layout of the small solves: cap, rate and state byte per lane, each
// lane's three segments and its position in each of the three CSR lists
// (16-bit), and the lists laid end to end (egress, ingress, edges, each
// from a multiple of 32 positions on) with a rate and two bits a
// position: its lane is active, and its lane was fixed this round
// (fresh). A lane fixed this round writes its rate at its three positions
// and sets their fresh bits; every other position holds +0.0. A segment's
// new lanes are its fresh bits, and its budget's loss is the fold of its
// contiguous run in list order, which is its lanes' ascending order. About
// 54 bytes a lane and 28 a segment.
constexpr int kSThreads = 768;
constexpr int kSWarps = kSThreads / 32;
constexpr int kSBatch = 2;      // lanes a thread stages at once
constexpr int kSRun = 128;      // a long list's positions a warp takes at once
constexpr int kShortList = 64;  // lists up to this long: a thread each
constexpr unsigned long long kInfBits = 0x7ff0000000000000ull;  // +inf

// Dynamic shared memory of one staged solve, in bytes: reals (each warp's
// run of nonzero rates with fold_run's read-ahead, the round's least
// share, cap and rate per lane, a rate per list position with the fold's
// read-ahead, budget and share per segment), ints (the largest active VM,
// whether the round has an unfixed lane, the long and short list counts,
// per segment its unfixed count, first list position (and the end's) and
// task slot, then the active and the fresh bit of every list position),
// the lanes' six 16-bit segment ids and positions, and a state byte per
// lane.
size_t shared_smem_bytes(int nc, int nv, int ne) {
  const size_t nseg = 2 * (size_t)nv + (size_t)ne;
  const size_t ncw = ((size_t)nc + 31) & ~(size_t)31;  // a list's positions
  const size_t reals = (size_t)kSWarps * (kSRun + 8) + 1 + 2 * (size_t)nc
                       + 3 * ncw + 8 + 2 * nseg;
  const size_t ints = 4 + 3 * nseg + 1 + 2 * (3 * ncw / 32);
  const size_t b = reals * 8 + ints * 4 + 12 * (size_t)nc + (size_t)nc;
  return (b + 15) & ~(size_t)15;
}

// The least of the warp's x, each the bits of a double >= +0.0 (whose
// order is theirs): the high words' least, then the low words' among them.
__device__ __forceinline__ unsigned long long warp_min_bits(
    unsigned long long x) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(x >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, (unsigned)(x >> 32) == hi ? (unsigned)x : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
}

// Word w of a bit array, limited to positions [b, e) (b < e).
__device__ __forceinline__ unsigned bits_in(const unsigned* words, int w,
                                            int b, int e) {
  unsigned m = words[w];
  if (w == b >> 5) m &= 0xffffffffu << (b & 31);
  if (w == (e - 1) >> 5) m &= 0xffffffffu >> (31 - ((e - 1) & 31));
  return m;
}

// The set bits of a bit array in positions [b, e).
__device__ __forceinline__ int count_bits(const unsigned* words, int b,
                                          int e) {
  int n = 0;
  for (int w = b >> 5; b < e && w <= (e - 1) >> 5; ++w)
    n += __popc(bits_in(words, w, b, e));
  return n;
}

template <bool kClocks>
__global__ void __launch_bounds__(kSThreads, 1)
waterfill_shared_kernel(
    const double* __restrict__ caps, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ eid,
    const double* __restrict__ eg0, const double* __restrict__ in0,
    const double* __restrict__ ed0, const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ changed, const double* __restrict__ prev,
    Csr cs, Csr cd, Csr ce, double* __restrict__ out, int nc, int nv, int ne,
    int ne_bound, int n_iters, long long* clocks) {
  using T = double;
  using Bits = unsigned long long;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  if (changed != nullptr && *changed == 0) {  // membership unchanged
    for (int c = tid; c < nc; c += kSThreads) out[c] = prev[c];
    return;
  }
  Probe<kClocks> probe(clocks);

  const int nseg = 2 * nv + ne;
  const int ncw = (nc + 31) & ~31;  // a list's positions
  const int nwords = 3 * ncw / 32;
  T* runs = reinterpret_cast<T*>(smem);  // [kSWarps][kSRun + 8]
  T* run = runs + warp * (kSRun + 8);
  T* least = runs + kSWarps * (kSRun + 8);  // the round's least share
  T* cap = least + 1;                       // [nc]
  // a fixed lane's rate; an unfixed lane's share of the round
  T* rate = cap + nc;
  T* pos_rate = rate + nc;          // [3 * ncw + 8] a fresh lane's rate
  T* bud = pos_rate + 3 * ncw + 8;  // [nseg] egress, ingress, edge
  T* share = bud + nseg;            // [nseg]
  int* blk_v = reinterpret_cast<int*>(share + nseg);  // the largest active VM
  int* blk_any = blk_v + 1;   // the round has an unfixed lane
  int* n_task = blk_any + 1;  // [2] long lists, short lists
  int* cnt = n_task + 2;      // [nseg] unfixed lanes
  int* first = cnt + nseg;    // [nseg + 1] segment s: [first[s], first[s + 1])
  // [nseg] the long lists' segments from the front, the short from the back
  int* task = first + nseg + 1;
  unsigned* act = reinterpret_cast<unsigned*>(task + nseg);  // [nwords]
  unsigned* fresh = act + nwords;  // [nwords] the lane was fixed this round
  uint16_t* seg = reinterpret_cast<uint16_t*>(fresh + nwords);  // [3][nc]
  uint16_t* pos = seg + 3 * nc;                                 // [3][nc]
  // st: 1 = unfixed active lane, 2 = fixed this round, 0 = fixed earlier or
  // inactive
  uint8_t* st = reinterpret_cast<uint8_t*>(pos + 3 * nc);

  // ---- stage every operand once: index j is a lane, a position in each
  // list and a segment; all of a batch's loads in flight, then the
  // activity of the lanes at the list positions (loads that wait on the
  // lists), then the stores. A warp's 32 positions are one word of each
  // list's bits.
  if (tid == 0) *blk_v = -1;
  const int nj = max(ncw, nseg + 1);
  for (int i0 = 0; i0 < nj; i0 += kSBatch * kSThreads) {
    int sv[kSBatch], dv[kSBatch], ev[kSBatch], ls[kSBatch], ld[kSBatch],
        le[kSBatch], fo[kSBatch];
    T cp[kSBatch], bg[kSBatch];
    bool a[kSBatch], as[kSBatch], ad[kSBatch], ae[kSBatch];
#pragma unroll
    for (int u = 0; u < kSBatch; ++u) {
      const int j = i0 + u * kSThreads + tid;
      const bool in = j < nc, ed = in && ne > 0;
      cp[u] = in ? caps[j] : T(0);
      a[u] = in && active[j] != 0;
      sv[u] = in ? src[j] : 0;
      dv[u] = in ? dst[j] : 0;
      ev[u] = ed ? eid[j] : 0;
      ls[u] = in ? cs.idx[j] : 0;
      ld[u] = in ? cd.idx[j] : 0;
      le[u] = ed ? ce.idx[j] : 0;
      fo[u] = j > nseg ? 0
                       : (j < nv ? cs.off[j]
                                 : (j < 2 * nv ? ncw + cd.off[j - nv]
                                               : 2 * ncw + ce.off[j - 2 * nv]));
      bg[u] = j >= nseg ? T(0)
                        : (j < nv ? eg0[j]
                                  : (j < 2 * nv ? in0[j - nv]
                                                : ed0[j - 2 * nv]));
    }
#pragma unroll
    for (int u = 0; u < kSBatch; ++u) {
      const int j = i0 + u * kSThreads + tid;
      as[u] = j < nc && active[ls[u]] != 0;
      ad[u] = j < nc && active[ld[u]] != 0;
      ae[u] = j < nc && ne > 0 && active[le[u]] != 0;
    }
#pragma unroll
    for (int u = 0; u < kSBatch; ++u) {
      const int j = i0 + u * kSThreads + tid;
      if (j < nc) {
        cap[j] = cp[u];
        rate[j] = T(0);
        st[j] = a[u];
        seg[j] = (uint16_t)sv[u];
        seg[nc + j] = (uint16_t)(nv + dv[u]);
        seg[2 * nc + j] = (uint16_t)(2 * nv + ev[u]);
        pos[ls[u]] = (uint16_t)j;  // the lane at list position j
        pos[nc + ld[u]] = (uint16_t)(ncw + j);
        pos[2 * nc + le[u]] = (uint16_t)(2 * ncw + j);
      }
      if (j < ncw) {  // the whole warp: ncw and its first j are 32-aligned
        const unsigned ms = __ballot_sync(kFull, as[u]);
        const unsigned md = __ballot_sync(kFull, ad[u]);
        const unsigned me = __ballot_sync(kFull, ae[u]);
        const int w = j >> 5, nw = ncw >> 5;
        if (lane == 0) {
          act[w] = ms;
          act[nw + w] = md;
          act[2 * nw + w] = me;
        }
        pos_rate[j] = pos_rate[ncw + j] = pos_rate[2 * ncw + j] = T(0);
      }
      if (j < 8) pos_rate[3 * ncw + j] = T(0);
      if (j <= nseg) first[j] = fo[u];
      if (j < nseg) bud[j] = bg[u];
    }
  }
  __syncthreads();
  probe.mark(kBClkStage);

  // ---- unfixed counts (each segment's active bits), first fair shares and
  // the largest active VM, a thread a segment; warp 0 lists the long and
  // the short lists for the rounds (the result does not depend on which
  // warp or thread takes which)
  auto is_long = [&](int s) { return first[s + 1] - first[s] > kShortList; };
  if (warp == 0) {
    int nl = 0, ns = 0;
    for (int s0 = 0; s0 < nseg; s0 += 32) {
      const int s = s0 + lane;
      const bool lg = s < nseg && is_long(s), sh = s < nseg && !lg;
      const unsigned ml = __ballot_sync(kFull, lg);
      const unsigned ms = __ballot_sync(kFull, sh);
      if (lg) task[nl + __popc(ml & lt)] = s;
      if (sh) task[nseg - 1 - ns - __popc(ms & lt)] = s;
      nl += __popc(ml);
      ns += __popc(ms);
    }
    if (lane == 0) {
      n_task[0] = nl;
      n_task[1] = ns;
    }
  }
#pragma unroll 1
  for (int s = kSThreads - 1 - tid; s < nseg; s += kSThreads) {
    const int n = count_bits(act, first[s], first[s + 1]);
    cnt[s] = n;
    share[s] = n > 0 ? bud[s] / T(n) : WF<T>::none();
    if (n > 0 && s < 2 * nv) atomicMax(blk_v, s < nv ? s : s - nv);
  }
  __syncthreads();
  probe.mark(kBClkCount);
  const int n_long = n_task[0], n_short = n_task[1];
  const int bound = n_iters >= 0 ? n_iters : 2 * (*blk_v + 1) + ne_bound + 4;

  // budget loses the folded new rates, count the new lanes; new share
  auto settle = [&](int s, T acc, int nnew) {
    const T x = bud[s] - acc;
    const T b = x < T(0) ? T(0) : x;
    const int n = cnt[s] - nnew;
    bud[s] = b;
    cnt[s] = n;
    share[s] = n > 0 ? b / T(n) : WF<T>::none();
  };

  const T eps = WF<T>::eps();
  int k = 0;
  for (; k < bound; ++k) {
    // (A) each unfixed lane's share and cap-hit, one barrier ORs the hits;
    // last round's fixes become old ones and leave the positions. The last
    // warp (which holds lanes only past kSThreads - 32) finds the least
    // share of an unfixed lane, which is the least share of a segment that
    // holds one (a lane's share is one of its segments'; a segment with an
    // unfixed lane gives it no more than its own), by its bits (every
    // share is >= +0.0 once -0.0 is +0.0), and whether any does: none ends
    // the solve.
    probe.start();
    if (warp == kSWarps - 1) {
      Bits lo = kInfBits;
      bool any_un = false;
      for (int s = lane; s < nseg; s += 32) {
        if (cnt[s] > 0) {
          lo = min(lo, (Bits)__double_as_longlong(share[s] + T(0)));
          any_un = true;
        }
      }
      lo = warp_min_bits(lo);
      any_un = __any_sync(kFull, any_un);
      if (lane == 0) {
        *least = __longlong_as_double((long long)lo);
        *blk_any = any_un;
      }
    }
    for (int w = tid; w < nwords; w += kSThreads) fresh[w] = 0;
    int hit = 0;
#pragma unroll 1
    for (int c = tid; c < nc; c += kSThreads) {
      const uint8_t sc = st[c];
      if (sc == 2) {
        st[c] = 0;
        pos_rate[pos[c]] = T(0);
        pos_rate[pos[nc + c]] = T(0);
        if (ne > 0) pos_rate[pos[2 * nc + c]] = T(0);
        continue;
      }
      if (sc != 1) continue;
      T sh = tmin(share[seg[c]], share[seg[nc + c]]);
      if (ne > 0) sh = tmin(sh, share[seg[2 * nc + c]]);
      rate[c] = sh;
      hit |= cap[c] <= sh + eps;
    }
    probe.arrive(k, kBClkA);
    const bool anyc = __syncthreads_or(hit) != 0;
    if (!*blk_any) break;
    const T thresh = *least;
    probe.mark_round(k, kBClkA);
    probe.start();

    // (B) fix the lanes this round binds: each writes its rate at its three
    // list positions and sets their fresh bits
#pragma unroll 1
    for (int c = tid; c < nc; c += kSThreads) {
      if (st[c] != 1) continue;
      const T sh = rate[c], cp = cap[c];
      if (!(anyc ? cp <= sh + eps : sh <= thresh + eps)) continue;
      const T r = anyc ? cp : sh;
      rate[c] = r;
      st[c] = 2;
      int at[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) at[l] = pos[l * nc + c];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        if (l == 2 && ne == 0) break;
        pos_rate[at[l]] = r;
        atomicOr(fresh + (at[l] >> 5), 1u << (at[l] & 31));
      }
    }
    probe.arrive(k, kBClkB);
    __syncthreads();
    probe.mark_round(k, kBClkB);
    probe.start();

    // (C) each segment with fresh lanes folds its contiguous run in list
    // order (the lanes' ascending order) and loses its fresh lanes from
    // its count: a long one by a warp, which compacts the nonzero rates
    // kSRun positions at a time for lane 0 to fold; a short one by a
    // thread over every position, zeros included (+0.0 leaves a sum of
    // terms >= +0.0 as it is). All segments at once.
#pragma unroll 1
    for (int u = warp; u < n_long; u += kSWarps) {
      const int s = task[u];
      const int b = first[s], e = first[s + 1];
      int nnew = 0;
      for (int w = (b >> 5) + lane; w <= (e - 1) >> 5; w += 32)
        nnew += __popc(bits_in(fresh, w, b, e));
      nnew = __reduce_add_sync(kFull, nnew);
      if (nnew == 0) continue;
      T acc = T(0);
      for (int p0 = b; p0 < e; p0 += kSRun) {
        T v[kSRun / 32];
#pragma unroll
        for (int t = 0; t < kSRun / 32; ++t) {
          const int p = p0 + 32 * t + lane;
          v[t] = p < e ? pos_rate[p] : T(0);
        }
        int nb = 0;
#pragma unroll
        for (int t = 0; t < kSRun / 32; ++t) {
          const unsigned m = __ballot_sync(kFull, v[t] != T(0));
          if (v[t] != T(0)) run[nb + __popc(m & lt)] = v[t];
          nb += __popc(m);
        }
        __syncwarp();
        if (lane == 0 && nb > 0) {
          const long long f0 = probe.now();
          acc = fold_run(run, nb, acc);
          probe.fold(f0);
        }
        __syncwarp();
      }
      if (lane == 0) settle(s, acc, nnew);
      __syncwarp();
    }
#pragma unroll 1
    for (int u = kSThreads - 1 - tid; u < n_short; u += kSThreads) {
      const int s = task[nseg - 1 - u];
      const int b = first[s], e = first[s + 1];
      const int nnew = count_bits(fresh, b, e);
      if (nnew == 0) continue;
      const long long f0 = probe.now();
      const T acc = fold_run(pos_rate + b, e - b, T(0));
      probe.fold(f0);
      settle(s, acc, nnew);
    }
    probe.fold_max(k);
    probe.arrive(k, kBClkC);
    __syncthreads();
    probe.mark_round(k, kBClkC);
  }
  for (int c = tid; c < nc; c += kSThreads)
    out[c] = st[c] == 1 ? T(0) : rate[c];
  probe.finish(k);
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

// Raises kern's dynamic shared memory limit to smem where it is lower
// (once per size increase; `configured` is the instantiation's own).
template <typename K>
cudaError_t configure(K kern, size_t smem, size_t& configured) {
  if (smem <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) configured = smem;
  return e;
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
  cudaError_t e = configure(waterfill_kernel<T>, smem, configured);
  if (e != cudaSuccess) return (int)e;
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

template <bool kClocks>
int launch_shared(const void* caps, const void* src, const void* dst,
                  const void* eid, const void* eg, const void* in,
                  const void* ed, const void* active, const void* changed,
                  const void* prev, const void* src_off, const void* src_idx,
                  const void* dst_off, const void* dst_idx,
                  const void* ed_off, const void* ed_idx, void* out, int nc,
                  int nv, int ne, int ne_bound, int n_iters, void* clocks,
                  void* stream) {
  static size_t configured = 0;
  const size_t smem = shared_smem_bytes(nc, nv, ne);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure(waterfill_shared_kernel<kClocks>, smem,
                            configured);
  if (e != cudaSuccess) return (int)e;
  Csr cs{(const int*)src_off, (const int*)src_idx};
  Csr cd{(const int*)dst_off, (const int*)dst_idx};
  Csr ce{(const int*)ed_off, (const int*)ed_idx};
  waterfill_shared_kernel<kClocks>
      <<<1, kSThreads, smem, (cudaStream_t)stream>>>(
          (const double*)caps, (const int*)src, (const int*)dst,
          (const int*)eid, (const double*)eg, (const double*)in,
          (const double*)ed, (const uint8_t*)active, (const uint8_t*)changed,
          (const double*)prev, cs, cd, ce, (double*)out, nc, nv, ne,
          ne_bound, n_iters, (long long*)clocks);
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

size_t waterfill_shared_smem_bytes(int nc, int nv, int ne) {
  return shared_smem_bytes(nc, nv, ne);
}

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

// the one-block f32 kernel: every lane in one block's shared memory
int waterfill_f32(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                  int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<float>(WATERFILL_PASS, out, nc, nv, ne, ne_bound,
                                 n_iters, stream);
}

// the one-block f64 kernel, every operand staged in shared memory
// (waterfill_shared_smem_bytes up to the limit)
int waterfill_f64_shared(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                         int ne_bound, int n_iters, void* stream) {
  return launch_shared<false>(WATERFILL_PASS, out, nc, nv, ne, ne_bound,
                              n_iters, nullptr, stream);
}

#ifdef WATERFILL_CLOCKS
// the staged kernel with its clock probes compiled in: `clocks` (128
// zeroed int64) receives the cycles per pass (enum BlockClock,
// RoundClock). Built only with -DWATERFILL_CLOCKS (build.py's CLOCKED
// library), so the sim's build does not compile it
int waterfill_f64_clocked(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                          int ne_bound, int n_iters, void* clocks,
                          void* stream) {
  return launch_shared<true>(WATERFILL_PASS, out, nc, nv, ne, ne_bound,
                             n_iters, clocks, stream);
}
#endif  // WATERFILL_CLOCKS

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
