// Blockwise online-softmax (flash) attention for Hopper (sm_90a), GQA,
// causal and sliding-window, f32 math on f32 or bf16 inputs.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:32 (_flash_kernel,
//   launched by flash_attention_bhsd at :105, pallas_call at :125).
// It computes the same function: for each query row i of head h, over the
// keys j of kv head h / q_per_kv with j <= i (causal) and j > i - window
// (sliding window), softmax(q_i k_j^T * scale) @ v, with the running max,
// sum and accumulator in f32 and the output divided by a guarded sum
// (l > 0 ? l : 1), in q's type.
//
// What bounds it on the H100: operations. At Zamba2's prefill shape
// (B 4, S 4096, 32 heads, D 112, causal) it does ~4.8e11 FLOP against
// ~0.47 GB of q/k/v/out, far above the card's ~295 FLOP/byte ridge.
// This first kernel runs that arithmetic on the f32 vector units (as the
// TPU kernel did in f32 after casting its tiles), not on the tensor cores,
// so it is slow against its bound; wgmma tiles come in a later change.
//
// Design. One block of 256 threads owns a 64-row query tile of one
// (batch, head); the TPU's sequential kv grid axis becomes a loop inside
// the block that carries (m, l, acc) in registers. Each thread holds a
// 4-row x 4-column patch of the 64 x 64 score tile and a 4-row x
// ceil(D/16)-column patch of the accumulator, so D may be any value up to
// 192 (D = 112 here). q, k and v tiles are staged in shared memory as f32
// with a row stride of D + 1, which keeps the strided k reads free of bank
// conflicts. Tiles that the causal mask or the window rules out entirely
// are never visited, so sliding-window attention costs O(S * window).
// Query tiles are issued last-first: the causal tiles near the end of the
// sequence carry the most work.
//
// Layout: q/out [B, S, H, D], k/v [B, S, Kv, D], contiguous (the model's
// layout; no transpose). Rows at or past S (a ragged last tile) are read
// as zeros, never attended to and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr int MAX_NCOL = 12;  // D <= 192
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [s0, s0 + 64) of one head of a [B, S, heads, D] tensor into a
// [64][D + 1] f32 tile; rows at or past S read as 0
template <typename T>
__device__ void load_tile(float* dst, const T* src, int s0, int S,
                          int64_t row_stride, int D) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int s = s0 + r;
    dst[r * ld + c] = s < S ? to_f32(src[(int64_t)s * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NCOL>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int D, int q_per_kv, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;             // [BM][D + 1]
  float* Ks = Qs + BM * ld;     // [BN][D + 1]
  float* Vs = Ks + BN * ld;     // [BN][D + 1]
  float* Ps = Vs + BN * ld;     // [BM][BN + 1]

  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / q_per_kv;
  const int64_t qrow = (int64_t)H * D;
  const int64_t krow = (int64_t)KV * D;
  const T* qb = q + (int64_t)b * S * qrow + (int64_t)h * D;
  const T* kb = k + (int64_t)b * S * krow + (int64_t)kh * D;
  const T* vb = v + (int64_t)b * S * krow + (int64_t)kh * D;
  T* ob = o + (int64_t)b * S * qrow + (int64_t)h * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(Qs, qb, q0, S, qrow, D);

  float acc[4][NCOL];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[r][c] = 0.f;
  }

  // tile-level reachability: only kv tiles some query of this tile sees
  const int nk = (S + BN - 1) / BN;
  int hi = nk;
  if (causal) hi = min(nk, (q0 + BM - 1) / BN + 1);
  int lo = 0;
  if (window >= 0) {
    const int first_key = q0 - window + 1;
    if (first_key > 0) lo = first_key / BN;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile(Ks, kb, k0, S, krow, D);
    load_tile(Vs, vb, k0, S, krow, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        ok[c] = kj < S && (!causal || kj <= qi) &&
                (window < 0 || kj > qi - window);
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty * 4 + r) * (BN + 1) + tx + 16 * c] = p;
        rs += p;
      }
      rs = group16_sum(rs);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * (BN + 1) + j];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < D ? Vs[j * ld + col] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += pv[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= S) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[(int64_t)qi * qrow + col] = from_f32<T>(acc[r][c] / safe);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BM + 2 * BN) * (D + 1) + BM * (BN + 1));
}

template <typename T, int NCOL>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NCOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_fwd_kernel<T, NCOL><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, D, H / KV,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, int causal, int window, float scale,
             cudaStream_t st) {
  switch ((D + 15) / 16) {
#define FLASH_CASE(n)                                                     \
  case n:                                                                 \
    return launch<T, n>(q, k, v, o, B, S, H, KV, D, causal, window, scale, \
                        st);
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8)
    FLASH_CASE(9) FLASH_CASE(10) FLASH_CASE(11) FLASH_CASE(12)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. window < 0: no window. Returns a CUDA
// error code (0 on a launch that was accepted).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int H, int KV, int D,
                        int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || D <= 0 ||
      D > 16 * MAX_NCOL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, KV, D, causal, window, scale,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
