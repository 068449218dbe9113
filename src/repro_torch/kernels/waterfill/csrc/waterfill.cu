// Max-min water-filling for Hopper (sm_90a), one thread block per solve,
// and the sim's ordered segment sum.
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
//   * thread-block clusters are not needed: a solve of a few thousand lanes
//     fits one block's shared memory, and the chain is serial anyway.
// A second instantiation keeps the three per-lane arrays (cap, rate and the
// state byte) in a scratch buffer in device memory, which the caller
// allocates (waterfill_scratch_bytes), and everything else in shared
// memory as above: the budgets, shares and counts per segment and each
// warp's run. It takes solves past one block's shared memory (about
// 12,100 lanes at f64), of any lane count, up to ~10,300 segments (VM
// egress, VM ingress and edges) at f64. One template parameter
// picks where the three pointers point, so the chain order, the rounds and
// the build are the same code, and its f64 results are bitwise equal to
// the plain version too. The lane passes then go through L1 and L2; the
// sim takes this variant only for solves that do not fit
// (kernels/waterfill/ops.py, lanes_in_device_memory).
//
// The sim passes a device flag `changed`; when it is 0 the kernel copies
// the cached rates, so the caller never reads the flag on the host. The TPU
// layout (one-hot scatter matmuls, 8-row replicated tiles) is not carried
// over: here segment sums walk CSR lists.
//
// Two instantiations of one template:
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
// Entry points have a plain C interface (ctypes); each returns the CUDA
// error code of its launch and neither synchronises nor allocates.

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

// The device-memory variant's per-lane scratch, in bytes: cap and rate per
// lane, then each lane's state byte. Its shared memory is smem_bytes with
// no lanes.
size_t scratch_bytes(int nc, int elem) {
  return (2 * (size_t)nc * (size_t)elem + (size_t)nc + 15) & ~(size_t)15;
}

// kLanesShared: cap, rate and the state byte per lane in shared memory;
// otherwise in `lanes`, a device-memory buffer of scratch_bytes(nc)
template <typename T, bool kLanesShared>
__global__ void __launch_bounds__(kThreads)
waterfill_kernel(const T* __restrict__ caps, const int* __restrict__ src,
                 const int* __restrict__ dst, const int* __restrict__ eid,
                 const T* __restrict__ eg0, const T* __restrict__ in0,
                 const T* __restrict__ ed0, const uint8_t* __restrict__ active,
                 const uint8_t* __restrict__ changed,
                 const T* __restrict__ prev, Csr cs, Csr cd, Csr ce,
                 unsigned char* lanes, T* __restrict__ out, int nc, int nv,
                 int ne, int ne_bound, int n_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (changed != nullptr && *changed == 0) {  // membership unchanged
    for (int c = tid; c < nc; c += kThreads) out[c] = prev[c];
    return;
  }

  const int nseg = 2 * nv + ne;
  T* red_lo = reinterpret_cast<T*>(smem);  // [kWarps]
  T* cap = kLanesShared ? red_lo + kWarps : reinterpret_cast<T*>(lanes);
  // a fixed lane's rate; an unfixed lane's share of the round
  T* rate = cap + nc;
  T* runs = kLanesShared ? rate + nc : red_lo + kWarps;  // shared, per warp
  T* run = runs + warp * (kRun + 8);  // this warp's [kRun + 8]
  T* bud = runs + kWarps * (kRun + 8);  // [nseg] egress, ingress, edge
  T* seg_share = bud + nseg;            // [nseg]
  int* red_n = reinterpret_cast<int*>(seg_share + nseg);  // [kWarps]
  int* next_seg = red_n + kWarps;  // the segment counter of a pass
  int* cnt = next_seg + 1;         // [nseg] unfixed lanes
  // st: 1 = unfixed active lane, 2 = fixed this round, 0 = fixed earlier or
  // inactive
  uint8_t* st = kLanesShared ? reinterpret_cast<uint8_t*>(cnt + nseg)
                             : reinterpret_cast<uint8_t*>(rate + nc);
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

// lanes == nullptr: the shared-memory kernel; otherwise the device-memory
// variant on that scratch
template <typename T, bool kLanesShared>
int launch_waterfill(const void* caps, const void* src, const void* dst,
                     const void* eid, const void* eg, const void* in,
                     const void* ed, const void* active, const void* changed,
                     const void* prev, const void* src_off,
                     const void* src_idx, const void* dst_off,
                     const void* dst_idx, const void* ed_off,
                     const void* ed_idx, void* lanes, void* out, int nc,
                     int nv, int ne, int ne_bound, int n_iters,
                     void* stream) {
  static size_t configured = 0;
  const size_t smem =
      smem_bytes(kLanesShared ? nc : 0, nv, ne, (int)sizeof(T));
  if (smem > smem_limit((int)sizeof(T))) return (int)cudaErrorInvalidValue;
  if (!kLanesShared && lanes == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        waterfill_kernel<T, kLanesShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  Csr cs{(const int*)src_off, (const int*)src_idx};
  Csr cd{(const int*)dst_off, (const int*)dst_idx};
  Csr ce{(const int*)ed_off, (const int*)ed_idx};
  waterfill_kernel<T, kLanesShared>
      <<<1, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)caps, (const int*)src, (const int*)dst, (const int*)eid,
          (const T*)eg, (const T*)in, (const T*)ed, (const uint8_t*)active,
          (const uint8_t*)changed, (const T*)prev, cs, cd, ce,
          (unsigned char*)lanes, (T*)out, nc, nv, ne, ne_bound, n_iters);
  return (int)cudaGetLastError();
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
  return launch_waterfill<double, true>(WATERFILL_PASS, nullptr, out, nc, nv,
                                        ne, ne_bound, n_iters, stream);
}

int waterfill_f32(WATERFILL_ARGS, void* out, int nc, int nv, int ne,
                  int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<float, true>(WATERFILL_PASS, nullptr, out, nc, nv,
                                       ne, ne_bound, n_iters, stream);
}

// the device-memory variants: per-lane arrays in `lanes`
// (waterfill_scratch_bytes(nc, elem) bytes, 16-byte aligned)
int waterfill_f64_global(WATERFILL_ARGS, void* lanes, void* out, int nc,
                         int nv, int ne, int ne_bound, int n_iters,
                         void* stream) {
  return launch_waterfill<double, false>(WATERFILL_PASS, lanes, out, nc, nv,
                                         ne, ne_bound, n_iters, stream);
}

int waterfill_f32_global(WATERFILL_ARGS, void* lanes, void* out, int nc,
                         int nv, int ne, int ne_bound, int n_iters,
                         void* stream) {
  return launch_waterfill<float, false>(WATERFILL_PASS, lanes, out, nc, nv,
                                        ne, ne_bound, n_iters, stream);
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

}  // extern "C"
