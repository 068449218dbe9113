// Flash attention on Hopper's tensor cores (sm_90a): bf16 inputs, GQA,
// causal and sliding-window, online softmax in f32, wgmma + TMA.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:32 (_flash_kernel,
//   launched by flash_attention_bhsd at :105, pallas_call at :125)
// for bf16 inputs whose head dim D is a multiple of 16 up to 192; f32
// inputs and other head dims keep the vector-unit kernel of
// flash_attention.cu. It computes the same function as ref.py: for each
// query row i of head h, over the keys j of kv head h / q_per_kv with
// j <= i (causal) and j > i - window (sliding window), softmax(q_i k_j^T *
// scale) @ v, with the running max, sum and accumulator in f32 and the
// output divided by a guarded sum (l > 0 ? l : 1), in bf16. The softmax
// weights are rounded to bf16 before the product with v, as the plain
// version rounds them to v's type.
//
// What bounds it on the H100: operations. At Zamba2's prefill shape
// (B 4, S 4096, 32 heads, D 112, causal) it does ~4.8e11 FLOP of bf16
// products against ~0.47 GB of q/k/v/out, far above the card's ~295
// FLOP/byte ridge, so the design keeps the tensor cores fed.
//
// Design. One block of 384 threads owns 128 query rows of one (batch,
// head). Warpgroups 0 and 1 are consumers and own 64 rows each (the wgmma
// M); warpgroup 2 is the producer, whose first thread issues every TMA
// load: Q once, then K and V tiles of BN keys into a ring of STAGES
// shared-memory stages, each guarded by a full barrier per tensor (TMA
// completes its bytes there) and one empty barrier (every consumer thread
// arrives after its last wgmma on the stage has retired). setmaxnreg gives
// the producer 24 registers and the consumers 240. BN is 128 for D <= 128
// and 64 above, so Q plus three K and V stages fit in shared memory (225
// KB at D 112 and 128, 192 KB at D 192).
//   S = Q K^T: wgmma m64n{BN}k16, both operands K-major in shared memory
//   (K as stored, [keys][D], is K-major for this product).
//   Online softmax on the S accumulator fragments in registers: each
//   thread holds two rows; row max by quad shuffles; exp2 on the
//   special-function unit (ex2.approx) with scale * log2(e) folded into
//   the scores; the causal and window masks
//   only on tiles that straddle the diagonal, the window edge or S; the
//   row sums stay per thread until the epilogue.
//   O += P V: P to bf16 in registers, where the S accumulator layout is
//   already wgmma's register-A layout; wgmma m64n{D}k16 with V from
//   shared memory through the transposed-B (N-major) descriptor. P never
//   touches shared memory.
//   Epilogue: guarded divide, bf16, stored from registers; rows >= S are
//   not written.
// Within a warpgroup the products of two tiles overlap: tile n's S = Q K^T
// is issued, then tile n - 1's O += P V behind it; the warpgroup waits for
// S alone, runs tile n's softmax while P V runs, then waits for P V,
// releases tile n - 1's stage and rescales O. The two consumer
// warpgroups take turns issuing their products (named barriers 1 and 2),
// so that one's softmax runs while the tensor cores work for the other.
// KV tiles that the causal mask or the window rule out for the whole
// block are never loaded (sliding-window attention costs O(S * window)); a
// consumer skips the products of the tiles ruled out for its own 64 rows
// (a prefix of its walk under the causal mask, a suffix under the window).
// Query tiles are issued last-first: the causal tiles near the end of the
// sequence carry the most work. Each block walks its KV tiles from the
// diagonal down, so the masked tiles come first.
//
// D = 112 and the 128-byte swizzle: the swizzle atom is 64 bf16 wide, so
// the shared tiles are padded to whole atoms (128 columns for D 112) and
// TMA zero-fills columns 112-127, which lie past the tensor's D extent.
// S = Q K^T runs D / 16 k-steps and never reads the padding; O's N is D
// itself (n112 is a legal wgmma width).
//
// Tensor maps: cuTensorMapEncodeTiled is a driver-API call, obtained
// through cudaGetDriverEntryPoint (no -lcuda). The maps are built per
// call on the host over the 4-D [B, S, heads, D] tensor (dims D, heads,
// S, B), so rows past S are zero-filled within each batch, and passed as
// __grid_constant__ parameters. Layout: q/out [B, S, H, D], k/v
// [B, S, Kv, D], contiguous, 16-byte aligned (read as they are; no
// transpose).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int BM = 128;     // query rows per block: two consumer warpgroups
constexpr int NT = 384;     // consumers: warpgroups 0 and 1; producer: 2
constexpr int STAGES = 3;   // K / V ring depth
constexpr int ROW_BYTES = 128;  // one swizzle-atom row: 64 bf16

template <int D>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;  // padded to whole atoms
  static constexpr int ATOMS = DP / 64;
  static constexpr int BN = D <= 128 ? 128 : 64;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;  // one K or V stage
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // tiles, barriers, and slack to align the base to 1024 bytes
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES +
                              1024;
};

// named barriers 1 and 2 over the two consumer warpgroups (256 threads):
// one warpgroup syncs, the other arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int S, int H,
                       int q_per_kv, int causal, int window,
                       float scale_log2) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;  // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  // 8-byte barriers: q_full, then k_full, v_full and empty per stage
  const uint32_t q_full = sV + STAGES * C::KV_BYTES;
#define k_full(s) (q_full + 8 * (1 + (s)))
#define v_full(s) (q_full + 8 * (1 + STAGES + (s)))
#define empty(s) (q_full + 8 * (1 + 2 * STAGES + (s)))

  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / q_per_kv;

  // kv tiles some query of this block sees, walked from hi - 1 down to lo
  const int nk = (S + BN - 1) / BN;
  int hi = nk;
  if (causal) hi = min(nk, (q0 + BM - 1) / BN + 1);
  int lo = 0;
  if (window >= 0) {
    const int first_key = q0 - window + 1;
    if (first_key > 0) lo = first_key / BN;
  }
  const int ntiles = hi - lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::ATOMS; ++c)
        tma_load(sQ + c * BM * ROW_BYTES, &tq, q_full, 64 * c, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (hi - 1 - it) * BN;
        const uint32_t ks = sK + s * C::KV_BYTES;
        const uint32_t vs = sV + s * C::KV_BYTES;
        mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::ATOMS; ++c)
          tma_load(ks + c * BN * ROW_BYTES, &tk, k_full(s), 64 * c, kh, k0, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::ATOMS; ++c)
          tma_load(vs + c * BN * ROW_BYTES, &tv, v_full(s), 64 * c, kh, k0, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;
    const int row0 = q0 + 64 * wg;                     // warpgroup's rows
    const int r_lo = row0 + 16 * warp + (lane >> 2);   // and r_lo + 8
    const bool live = row0 < S;
    const int last = min(row0 + 63, S - 1);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BN / 16][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];

    // iterations [it_a, it_b) hold keys that some row of this warpgroup
    // sees: the causal mask rules out a prefix (the walk starts at the
    // diagonal), the window a suffix
    int it_a = 0, it_b = live ? ntiles : 0;
    if (causal)
      while (it_a < it_b && (hi - 1 - it_a) * BN > last) ++it_a;
    if (window >= 0)
      while (it_b > it_a && (hi - it_b) * BN + BN - 1 <= row0 - window)
        --it_b;
    auto stage = [](int it) { return it % STAGES; };
    auto parity = [](int it) { return (uint32_t)(it / STAGES) & 1; };
    // a tile this warpgroup does not use: wait for it (so that no
    // warpgroup arrives twice in one phase of its empty barrier), release
    auto pass = [&](int it) {
      mbar_wait(k_full(stage(it)), parity(it));
      mbar_wait(v_full(stage(it)), parity(it));
      mbar_arrive(empty(stage(it)));
    };
    // S = Q K^T over D / 16 k-steps; k-step kk lies in atom kk / 4, 32
    // bytes per step into its swizzled 128-byte rows
    auto issue_qk = [&](int it) {
      const uint32_t ks = sK + stage(it) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk & 3) * 32;
        const uint64_t da = sw128_desc(
            sQ + (kk >> 2) * BM * ROW_BYTES + wg * 64 * ROW_BYTES + col, 16,
            1024);
        const uint64_t db =
            sw128_desc(ks + (kk >> 2) * BN * ROW_BYTES + col, 16, 1024);
        wgmma_ss<BN>(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V, 16 keys a step; V is N-major: 8-key groups 1024 bytes
    // apart (SBO), 64-column atoms BN rows apart (LBO)
    auto issue_pv = [&](int it) {
      const uint32_t vs = sV + stage(it) * C::KV_BYTES;
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
        wgmma_rs<D>(o, pa[t], sw128_desc(vs + t * 16 * ROW_BYTES,
                                         BN * ROW_BYTES, 1024));
      wg_commit();
    };
    // online softmax of S in place (P = exp2 of the scaled scores less
    // the running max), m and l updated, alpha the factor for O. Score i:
    // row r_lo + 8 * ((i >> 1) & 1), column k0 + 8 * (i >> 2) +
    // 2 * (lane & 3) + (i & 1)
    auto softmax = [&](int it) {
      const int k0 = (hi - 1 - it) * BN;
      const bool masked = k0 + BN > S || (causal && k0 + BN - 1 > row0) ||
                          (window >= 0 && k0 <= last - window);
      float mx[2] = {-INFINITY, -INFINITY};
      if (masked) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int qi = r_lo + 8 * ((i >> 1) & 1);
          const int kj = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const bool ok = kj < S && (!causal || kj <= qi) &&
                          (window < 0 || kj > qi - window);
          sc[i] = ok ? sc[i] * scale_log2 : -INFINITY;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          sc[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        // a row with no visible key yet keeps p = 0 and alpha = 0
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = fast_exp2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(sc[i] - mu[r]);
        l[r] += sc[i];
      }
    };
    // P to bf16: the S accumulator of keys 16t..16t+15 is wgmma's
    // register-A fragment as it lies
    auto pack_p = [&]() {
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[t][j] = pack_bf16(sc[8 * t + 2 * j], sc[8 * t + 2 * j + 1]);
    };

    // the two warpgroups take turns issuing their products, so that one's
    // softmax runs under the other's products; each takes ntiles + 1
    // turns, warpgroup 0 first
    auto turn_begin = [&]() { named_sync(1 + wg); };
    auto turn_end = [&]() { named_arrive(2 - wg); };
    if (wg == 1) named_arrive(1);

    mbar_wait(q_full, 0);
    for (int it = 0; it < it_a; ++it) {
      pass(it);
      turn_begin();
      turn_end();
    }
    if (it_a < it_b) {
      mbar_wait(k_full(stage(it_a)), parity(it_a));
      turn_begin();
      wg_fence();
      issue_qk(it_a);
      turn_end();
      wg_wait<0>();
      reg_fence(sc);
      softmax(it_a);
      pack_p();
      // tile it's S = Q K^T runs while tile it - 1's O += P V is queued
      // behind it; the softmax of tile it then overlaps that PV
      for (int it = it_a + 1; it < it_b; ++it) {
        mbar_wait(k_full(stage(it)), parity(it));
        mbar_wait(v_full(stage(it - 1)), parity(it - 1));
        turn_begin();
        wg_fence();
        issue_qk(it);
        issue_pv(it - 1);
        turn_end();
        wg_wait<1>();
        reg_fence(sc);
        softmax(it);
        wg_wait<0>();
        reg_fence(o);
        reg_fence_u(pa);
        mbar_arrive(empty(stage(it - 1)));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p();
      }
      mbar_wait(v_full(stage(it_b - 1)), parity(it_b - 1));
      turn_begin();
      wg_fence();
      issue_pv(it_b - 1);
      turn_end();
      wg_wait<0>();
      reg_fence(o);
      mbar_arrive(empty(stage(it_b - 1)));
    } else {
      turn_begin();
      turn_end();
    }
    for (int it = it_b; it < ntiles; ++it) {
      pass(it);
      turn_begin();
      turn_end();
    }
#undef k_full
#undef v_full
#undef empty

    if (live) {
      float safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lr = quad_sum(l[r]);
        safe[r] = lr > 0.f ? lr : 1.f;
      }
      const int64_t row_stride = (int64_t)H * D;
      __nv_bfloat16* ob = out + (int64_t)b * S * row_stride + (int64_t)h * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r_lo + 8 * r;
        if (qi >= S) continue;
        __nv_bfloat16* orow = ob + (int64_t)qi * row_stride + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / safe[r], o[4 * j + 2 * r + 1] / safe[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v;
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, encode, q, B, S, H, D, BM) ||
      !make_map(&mk, encode, k, B, S, KV, D, C::BN) ||
      !make_map(&mv, encode, v, B, S, KV, D, C::BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_wgmma_kernel<D><<<grid, NT, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, S, H, H / KV, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v, out; D a multiple of 16 up to 192; every pointer 16-byte
// aligned. window < 0: no window. Returns a CUDA error code (0 on a
// launch that was accepted).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int KV, int D,
                          int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D % 16 != 0 ||
      D <= 0 || D > 192)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / 16) {
#define WGMMA_CASE(n)                                                         \
  case n:                                                                     \
    return launch<16 * n>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    WGMMA_CASE(1) WGMMA_CASE(2) WGMMA_CASE(3) WGMMA_CASE(4)
    WGMMA_CASE(5) WGMMA_CASE(6) WGMMA_CASE(7) WGMMA_CASE(8)
    WGMMA_CASE(9) WGMMA_CASE(10) WGMMA_CASE(11) WGMMA_CASE(12)
#undef WGMMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
