// Mamba2 SSD chunked scan (state-space duality form) for Hopper (sm_90a),
// f32 math on f32 or bf16 inputs: the vector-unit kernel. bf16 at the
// shapes ssd_wgmma.cu takes runs there, on the tensor cores
// (ops.py::kernel_for); this kernel takes f32 and the other shapes.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:30 (_ssd_kernel, launched by
//   ssd_scan_bhsp at :84, pallas_call at :93).
// It computes the same function. Per (batch, head) and per chunk of Q
// steps, with cum the within-chunk cumulative sum of dt * a (a < 0):
//   intra:  y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter:  y_i += exp(cum_i) (C_i S_prev^T)
//   state:  S    = S_prev exp(cum_last)
//                  + sum_j (x_j exp(cum_last - cum_j) dt_j) B_j^T
// with the state S [P, N] carried in f32 from chunk to chunk; y is written
// in x's type and the last state in f32.
//
// What bounds it on the H100: at Zamba2's shape (B 4, S 4096, 112 heads,
// P 64, N 64, Q 256) it moves ~0.49 GB (x and y dominate) and does
// ~1e11 FLOP, so in bf16 on tensor cores bytes and operations would be
// near balance (~0.15 ms each); this kernel does the arithmetic on the
// f32 vector units, which makes it operation bound, and slow against that
// bound. f32's 1e-3 tolerance rules out bf16 products.
//
// Design. On the TPU the chunk index is the sequential grid axis and the
// state lives in VMEM across it. Hopper's blocks run in no order, so one
// block of 256 threads owns a whole (batch, head) and walks its chunks in
// a loop, with the state in shared memory. The TPU kernel's one [Q, Q]
// f32 score tile per chunk is 256 KB at Q = 256, above the 227 KB a block
// may have, so the intra-chunk product is tiled 64 x 64: for each 64-row
// tile of queries i, only the key tiles j <= i are visited (the causal
// triangle), and the decay exp(cum_i - cum_j) is evaluated only where
// i >= j, so the masked entries, whose exponent is positive and may
// overflow, never reach a product (inf * 0 would be NaN here, where the
// TPU's where() dropped it). Each thread holds a 4 x 4 patch of the score
// tile, a 4 x 4 patch of y (P <= 64) and a 4 x ceil(N/16) patch of the
// state (N <= 128). The cumulative sum is a shared-memory scan.
//
// Layout: x/y [B, S, H, P], dt [B, S, H] f32, a [H] f32, B/C [B, S, N],
// state [B, H, P, N] f32, all contiguous (the model's layout; no
// transpose). S must be a multiple of Q (the wrapper pads with dt = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads: 16 x 16
constexpr int TQ = 64;      // rows of one intra-chunk tile
constexpr int MAX_Q = 256;  // chunk length
constexpr int MAX_P = 64;   // head dim
constexpr int MAX_NCN = 8;  // N <= 128

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

// rows [t0, t0 + n) of a row-major source with row stride `stride` and
// `cols` columns into a [TQ][ld] f32 tile; rows past n read as 0
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, int64_t stride,
                          int n, int cols) {
  for (int idx = threadIdx.x; idx < TQ * cols; idx += NT) {
    const int r = idx / cols;
    const int c = idx - r * cols;
    dst[r * ld + c] = r < n ? to_f32(src[(int64_t)r * stride + c]) : 0.f;
  }
}

template <typename T, int NCN>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int Q) {
  extern __shared__ float sm[];
  const int ldn = N + 1;
  float* cum = sm;                  // [MAX_Q]
  float* dts = cum + MAX_Q;         // [MAX_Q]
  float* Cs = dts + MAX_Q;          // [TQ][N + 1]
  float* Bs = Cs + TQ * ldn;        // [TQ][N + 1]
  float* Xs = Bs + TQ * ldn;        // [TQ][P]
  float* Ss = Xs + TQ * P;          // [TQ][TQ + 1]
  float* St = Ss + TQ * (TQ + 1);   // [P][N + 1]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float a_h = a[h];
  const int64_t xrow = (int64_t)H * P;
  const T* xb = x + (int64_t)b * S * xrow + (int64_t)h * P;
  T* yb = y + (int64_t)b * S * xrow + (int64_t)h * P;
  const float* dtb = dt + (int64_t)b * S * H + h;
  const T* bb = bm + (int64_t)b * S * N;
  const T* cb = cm + (int64_t)b * S * N;

  for (int idx = threadIdx.x; idx < P * ldn; idx += NT) St[idx] = 0.f;

  const int n_chunks = S / Q;
  const int n_tiles = (Q + TQ - 1) / TQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    __syncthreads();  // the previous chunk is done with cum, dts and St
    // ---- dt and the inclusive cumulative sum of dt * a (Hillis-Steele)
    if ((int)threadIdx.x < Q) {
      const float d = dtb[(int64_t)(t0 + threadIdx.x) * H];
      dts[threadIdx.x] = d;
      cum[threadIdx.x] = d * a_h;
    }
    __syncthreads();
    for (int off = 1; off < Q; off <<= 1) {
      float add = 0.f;
      if ((int)threadIdx.x < Q && (int)threadIdx.x >= off)
        add = cum[threadIdx.x - off];
      __syncthreads();
      if ((int)threadIdx.x < Q) cum[threadIdx.x] += add;
      __syncthreads();
    }
    const float cum_last = cum[Q - 1];

    // ---- y for each 64-row tile: intra-chunk triangle, then the carry
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * TQ;
      const int ni = min(TQ, Q - i0);
      float yacc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[r][c] = 0.f;
      __syncthreads();  // Cs of the previous tile is consumed
      load_rows(Cs, ldn, cb + (int64_t)(t0 + i0) * N, N, ni, N);
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        const int nj = min(TQ, Q - j0);
        __syncthreads();  // Bs, Xs and Ss of the previous tile are consumed
        load_rows(Bs, ldn, bb + (int64_t)(t0 + j0) * N, N, nj, N);
        load_rows(Xs, P, xb + (int64_t)(t0 + j0) * xrow, xrow, nj, P);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * ldn + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float w = 0.f;
            if (i < Q && j < Q && i >= j)
              w = s[r][c] * expf(cum[i] - cum[j]) * dts[j];
            Ss[(ty * 4 + r) * (TQ + 1) + tx + 16 * c] = w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < TQ; ++jj) {
          float sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty * 4 + r) * (TQ + 1) + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tx + 16 * c;
            const float xv = p < P ? Xs[jj * P + p] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r) yacc[r][c] += sv[r] * xv;
          }
        }
      }
      // inter-chunk: exp(cum_i) * (C_i . S_prev[p, :]), then store
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= Q) continue;
        const float e = expf(cum[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p >= P) continue;
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot += Cs[(ty * 4 + r) * ldn + n] * St[p * ldn + n];
          yb[(int64_t)(t0 + i) * xrow + p] = from_f32<T>(yacc[r][c] + dot * e);
        }
      }
    }

    // ---- state: S = S_prev exp(cum_last) + sum_j (x_j w_j) B_j^T
    float sacc[4][NCN];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NCN; ++c) sacc[r][c] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * TQ;
      const int nj = min(TQ, Q - j0);
      __syncthreads();  // every y tile has read St; Bs and Xs are free
      load_rows(Bs, ldn, bb + (int64_t)(t0 + j0) * N, N, nj, N);
      load_rows(Xs, P, xb + (int64_t)(t0 + j0) * xrow, xrow, nj, P);
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        const int j = j0 + jj;
        const float w = expf(cum_last - cum[j]) * dts[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ty * 4 + r;
          const float xw = p < P ? Xs[jj * P + p] * w : 0.f;
#pragma unroll
          for (int c = 0; c < NCN; ++c) {
            const int n = tx + 16 * c;
            if (n < N) sacc[r][c] += xw * Bs[jj * ldn + n];
          }
        }
      }
    }
    const float decay = expf(cum_last);
    __syncthreads();  // no thread reads St any more in this chunk
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        const int n = tx + 16 * c;
        if (n < N) St[p * ldn + n] = St[p * ldn + n] * decay + sacc[r][c];
      }
    }
  }
  __syncthreads();
  float* sb = state_out + ((int64_t)b * H + h) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += NT) {
    const int p = idx / N;
    const int n = idx - p * N;
    sb[idx] = St[p * ldn + n];
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)2 * MAX_Q + 2 * TQ * (N + 1) + TQ * P +
                          TQ * (TQ + 1) + (size_t)P * (N + 1));
}

template <typename T, int NCN>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* st, int B, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NCN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_scan_kernel<T, NCN><<<grid, NT, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)cm, (T*)y, (float*)st, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, void* y, void* st, int B, int S, int H, int P,
             int N, int Q, cudaStream_t s) {
  switch ((N + 15) / 16) {
#define SSD_CASE(n) \
  case n:           \
    return launch<T, n>(x, dt, a, bm, cm, y, st, B, S, H, P, N, Q, s);
    SSD_CASE(1) SSD_CASE(2) SSD_CASE(3) SSD_CASE(4)
    SSD_CASE(5) SSD_CASE(6) SSD_CASE(7) SSD_CASE(8)
#undef SSD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (x, B, C and y); dt, a and the state are
// float32. Returns a CUDA error code (0 on a launch that was accepted).
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* st, int dtype, int B, int S,
                 int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 ||
      N > 16 * MAX_NCN || Q <= 0 || Q > MAX_Q || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, dt, a, bm, cm, y, st, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, a, bm, cm, y, st, B, S, H, P, N, Q,
                                   s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
