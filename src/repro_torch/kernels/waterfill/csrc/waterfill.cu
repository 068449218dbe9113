// Max-min water-filling for Hopper (sm_90a), one thread block per solve.
//
// Replaces the TPU kernel kernels/waterfill/waterfill.py::_waterfill_kernel
// of the reference package (launched by waterfill_8x), and on the sim's
// default path its f64 twin kernels/waterfill/ref.py::masked_maxmin_rates.
//
// What bounds it on this card: not bytes (a solve reads a few kB) and not
// arithmetic (a few hundred flops per connection). A solve is a chain of
// up to 2*nv + ne + 4 dependent rounds, each of which needs every
// connection's share before any can be fixed, and every fixed rate before
// the budgets move; on top of that sits one launch per solve. So the bound
// is launch latency plus the serial round chain. The design answers both:
// the whole solve is one launch into one block, every per-connection,
// per-VM and per-edge array lives in shared memory for all rounds, rounds
// are separated by __syncthreads only, and the loop exits as soon as no
// connection is left unfixed. The sim passes a device flag `changed`; when
// it is 0 the kernel copies the cached rates, so the caller never reads
// the flag on the host. The TPU layout (one-hot scatter matmuls, 8-row
// replicated tiles) is not carried over: here segment sums walk CSR lists.
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
// v[i1] + ... over a segment's lanes in ascending order, one warp per
// segment. CUDA's index_add_ adds with atomics in no fixed order.
//
// Entry points have a plain C interface (ctypes); each returns the CUDA
// error code of its launch and neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr unsigned kFull = 0xffffffffu;

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide reductions; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = op(r, scratch[w]);
  __syncthreads();
  return r;
}

size_t smem_bytes(int nc, int nv, int ne, int elem) {
  // cap, rate, share per conn; budget + share per segment; state per conn
  size_t nseg = 2 * (size_t)nv + (size_t)ne;
  size_t b = (3 * (size_t)nc + 2 * nseg) * (size_t)elem + (size_t)nc;
  return (b + 15) & ~(size_t)15;
}

// Dynamic shared memory one block may take: the opt-in limit less the
// kernel's static reduction scratch (red_t, red_i), rounded up to 16 B.
size_t smem_limit(int elem) {
  const size_t stat = (size_t)kWarps * ((size_t)elem + sizeof(int));
  return kMaxSmem - ((stat + 15) & ~(size_t)15);
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
  __shared__ T red_t[kWarps];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (changed != nullptr && *changed == 0) {  // membership unchanged
    for (int c = tid; c < nc; c += kThreads) out[c] = prev[c];
    return;
  }

  const int nseg = 2 * nv + ne;
  T* cap = reinterpret_cast<T*>(smem);
  T* rate = cap + nc;
  T* share = rate + nc;
  T* bud = share + nc;        // [nseg] egress, ingress, edge budgets
  T* seg_share = bud + nseg;  // [nseg]
  // st: bit 0 = unfixed active lane, bit 1 = fixed in this round
  uint8_t* st = reinterpret_cast<uint8_t*>(seg_share + nseg);

  auto imax = [](int a, int b) { return a > b ? a : b; };
  auto isum = [](int a, int b) { return a + b; };
  auto ior = [](int a, int b) { return a | b; };
  auto fmin_ = [](T a, T b) { return tmin(a, b); };

  int vmax = -1, n_act = 0;
  for (int c = tid; c < nc; c += kThreads) {
    cap[c] = caps[c];
    rate[c] = T(0);
    const uint8_t a = active[c] != 0;
    st[c] = a;
    if (a) {
      vmax = imax(vmax, imax(src[c], dst[c]));
      ++n_act;
    }
  }
  for (int s = tid; s < nseg; s += kThreads)
    bud[s] = s < nv ? eg0[s] : (s < 2 * nv ? in0[s - nv] : ed0[s - 2 * nv]);
  vmax = block_reduce(vmax, red_i, imax);
  int n_un = block_reduce(n_act, red_i, isum);
  const int bound = n_iters >= 0 ? n_iters : 2 * (vmax + 1) + ne_bound + 4;

  for (int k = 0; k < bound && n_un > 0; ++k) {
    // (1) unfixed counts and fair share of every segment, a warp each
    for (int s = warp; s < nseg; s += kWarps) {
      const Csr L = s < nv ? cs : (s < 2 * nv ? cd : ce);
      const int row = s < nv ? s : (s < 2 * nv ? s - nv : s - 2 * nv);
      const int b = L.off[row], e = L.off[row + 1];
      int cnt = 0;
      for (int j = b + lane; j < e; j += 32) cnt += st[L.idx[j]] & 1;
      cnt = warp_sum(cnt);
      if (lane == 0) seg_share[s] = cnt > 0 ? bud[s] / T(cnt) : WF<T>::none();
    }
    __syncthreads();

    // (2) share per connection, (3) cap-hit flag and threshold minimum
    int hit = 0;
    T lo = WF<T>::none();
    for (int c = tid; c < nc; c += kThreads) {
      if (!(st[c] & 1)) continue;
      T sh = tmin(seg_share[src[c]], seg_share[nv + dst[c]]);
      if (ne > 0) sh = tmin(sh, seg_share[2 * nv + eid[c]]);
      share[c] = sh;
      hit |= cap[c] <= sh + WF<T>::eps();
      lo = tmin(lo, sh);
    }
    const int anyc = block_reduce(hit, red_i, ior);
    const T thresh = block_reduce(lo, red_t, fmin_);

    // (4) fix the newly bound connections
    int fixed_now = 0;
    for (int c = tid; c < nc; c += kThreads) {
      if (!(st[c] & 1)) continue;
      const bool nw = anyc ? cap[c] <= share[c] + WF<T>::eps()
                           : share[c] <= thresh + WF<T>::eps();
      if (nw) {
        rate[c] = anyc ? cap[c] : share[c];
        st[c] = 2;
        ++fixed_now;
      }
    }
    n_un -= block_reduce(fixed_now, red_i, isum);

    // (5) budgets lose the new rates, summed in ascending connection order
    for (int s = warp; s < nseg; s += kWarps) {
      const Csr L = s < nv ? cs : (s < 2 * nv ? cd : ce);
      const int row = s < nv ? s : (s < 2 * nv ? s - nv : s - 2 * nv);
      const int b = L.off[row], e = L.off[row + 1];
      T acc = T(0);
      for (int base = b; base < e; base += 32) {
        const int j = base + lane;
        const int c = j < e ? L.idx[j] : 0;
        const bool nw = j < e && (st[c] & 2);
        const T r = nw ? rate[c] : T(0);
        unsigned m = __ballot_sync(kFull, nw);
        while (m) {  // warp-uniform: lanes in order, zeros skipped
          const int bit = __ffs(m) - 1;
          acc = acc + __shfl_sync(kFull, r, bit);
          m &= m - 1;
        }
      }
      if (lane == 0) {
        const T x = bud[s] - acc;
        bud[s] = x < T(0) ? T(0) : x;
      }
    }
    __syncthreads();
    for (int c = tid; c < nc; c += kThreads)
      if (st[c] & 2) st[c] = 0;
    __syncthreads();
  }
  for (int c = tid; c < nc; c += kThreads) out[c] = rate[c];
}

__global__ void segsum_ordered_kernel(const double* __restrict__ vals,
                                      const int* __restrict__ off,
                                      const int* __restrict__ idx,
                                      double* __restrict__ out, int nseg) {
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  for (int s = w0; s < nseg; s += nw) {
    const int b = off[s], e = off[s + 1];
    double acc = 0.0;
    for (int base = b; base < e; base += 32) {
      const int j = base + lane;
      const double v = j < e ? vals[idx[j]] : 0.0;
      const int n = e - base < 32 ? e - base : 32;
      for (int k = 0; k < n; ++k) acc = acc + __shfl_sync(kFull, v, k);
    }
    if (lane == 0) out[s] = acc;
  }
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

}  // namespace

extern "C" {

size_t waterfill_smem_bytes(int nc, int nv, int ne, int elem) {
  return smem_bytes(nc, nv, ne, elem);
}

size_t waterfill_smem_limit(int elem) { return smem_limit(elem); }

int waterfill_f64(const void* caps, const void* src, const void* dst,
                  const void* eid, const void* eg, const void* in,
                  const void* ed, const void* active, const void* changed,
                  const void* prev, const void* src_off, const void* src_idx,
                  const void* dst_off, const void* dst_idx,
                  const void* ed_off, const void* ed_idx, void* out, int nc,
                  int nv, int ne, int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<double>(caps, src, dst, eid, eg, in, ed, active,
                                  changed, prev, src_off, src_idx, dst_off,
                                  dst_idx, ed_off, ed_idx, out, nc, nv, ne,
                                  ne_bound, n_iters, stream);
}

int waterfill_f32(const void* caps, const void* src, const void* dst,
                  const void* eid, const void* eg, const void* in,
                  const void* ed, const void* active, const void* changed,
                  const void* prev, const void* src_off, const void* src_idx,
                  const void* dst_off, const void* dst_idx,
                  const void* ed_off, const void* ed_idx, void* out, int nc,
                  int nv, int ne, int ne_bound, int n_iters, void* stream) {
  return launch_waterfill<float>(caps, src, dst, eid, eg, in, ed, active,
                                 changed, prev, src_off, src_idx, dst_off,
                                 dst_idx, ed_off, ed_idx, out, nc, nv, ne,
                                 ne_bound, n_iters, stream);
}

int segsum_ordered_f64(const void* vals, const void* off, const void* idx,
                       void* out, int nseg, void* stream) {
  if (nseg <= 0) return 0;
  const int threads = 256;
  const int blocks = (nseg * 32 + threads - 1) / threads;
  segsum_ordered_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)vals, (const int*)off, (const int*)idx, (double*)out,
      nseg);
  return (int)cudaGetLastError();
}

}  // extern "C"
