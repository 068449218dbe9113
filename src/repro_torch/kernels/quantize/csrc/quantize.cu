// Per-block symmetric int8 quantization and its inverse, for Hopper
// (sm_90a), f32 in and out.
//
// Replaces the TPU kernels
//   src/repro/kernels/quantize/quantize.py:19 (_quant_kernel, launched by
//   quantize_int8_2d at :33, pallas_call at :40) and
//   src/repro/kernels/quantize/quantize.py:28 (_dequant_kernel, launched by
//   dequantize_int8_2d at :57, pallas_call at :61).
// They compute the same functions. For each block of `block` consecutive
// values (the last one ragged):
//   absmax = max |x|            (NaN propagates, as jnp.max does)
//   scale  = absmax / 127 where absmax > 0, else 1   (so 1 for NaN too)
//   q      = clip(rint(x / scale), -127, 127)  as int8
// and the inverse x = float(q) * scale. Both divisions are IEEE (no
// --use_fast_math, no reciprocal multiply) and rintf rounds half to even
// as jnp.round does, so q and the scales equal the plain version bit for
// bit on finite inputs. q of a NaN or infinite input is outside the
// contract (the reference casts NaN to int8).
//
// What bounds it on the H100: bytes. Quantizing n values reads 4n bytes
// and writes n + 4 n / block; dequantizing reads n + 4 n / block and
// writes 4n; the arithmetic is a few operations per value. For the whole
// smollm-135m gradient (134.5M values) the quantizer's bound is ~0.20 ms
// at 3.35 TB/s.
//
// Design. The TPU kernel reduced an (8, 256) VMEM tile per grid step; the
// 8 rows were the VPU's sublanes. Here one warp owns one block of 256:
// each lane holds 8 values from two float4 loads, the absmax is a warp
// shuffle reduction, and each lane stores its 8 codes as one 8-byte word,
// so every byte of x is read once and every output byte written once.
// Warps walk the blocks grid-stride. The ragged last block is masked
// inside the kernel (the wrapper pads nothing). Any other block size, or
// a pointer without 16-byte alignment, takes a scalar warp-per-block
// kernel that reads its block twice (the second read hits L1).
// Dequantization is one thread per 4 values: a 4-byte load, one scale,
// a float4 store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 16;

// max that keeps NaN: jnp.max propagates it, fmaxf would drop it.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// jnp.where(absmax > 0, absmax / 127, 1): a NaN absmax gives 1.
__device__ __forceinline__ float block_scale(float absmax) {
  return absmax > 0.0f ? absmax / 127.0f : 1.0f;
}

__device__ __forceinline__ int8_t code(float x, float scale) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// block == 256, x 16-byte and q 8-byte aligned: 8 values per lane.
__global__ void __launch_bounds__(kThreads)
quant256(const float* __restrict__ x, int8_t* __restrict__ q,
         float* __restrict__ scales, long long n, long long nblocks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long b = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       b < nblocks; b += nwarps) {
    const long long base = b * 256 + lane * 8;
    const bool full = base + 8 <= n;
    float v[8];
    if (full) {
      const float4 lo = *reinterpret_cast<const float4*>(x + base);
      const float4 hi = *reinterpret_cast<const float4*>(x + base + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = base + j < n ? x[base + j] : 0.0f;
    }
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = nan_max(m, fabsf(v[j]));
    const float scale = block_scale(warp_max(m));
    if (lane == 0) scales[b] = scale;
    if (full) {
      uint32_t w0 = 0, w1 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0 |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[j], scale)))
              << (8 * j);
        w1 |= static_cast<uint32_t>(
                  static_cast<uint8_t>(code(v[j + 4], scale)))
              << (8 * j);
      }
      *reinterpret_cast<uint2*>(q + base) = make_uint2(w0, w1);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (base + j < n) q[base + j] = code(v[j], scale);
    }
  }
}

// any block size: one warp per block, two passes over it.
__global__ void __launch_bounds__(kThreads)
quant_any(const float* __restrict__ x, int8_t* __restrict__ q,
          float* __restrict__ scales, long long n, int block,
          long long nblocks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long b = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       b < nblocks; b += nwarps) {
    const long long lo = b * block;
    const long long len = n - lo < block ? n - lo : block;
    float m = 0.0f;
    for (long long i = lane; i < len; i += 32) m = nan_max(m, fabsf(x[lo + i]));
    const float scale = block_scale(warp_max(m));
    if (lane == 0) scales[b] = scale;
    for (long long i = lane; i < len; i += 32) q[lo + i] = code(x[lo + i], scale);
  }
}

// shift >= 0: block == 1 << shift and block % 4 == 0, so the four values
// of a group share one scale; q 4-byte and x 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
dequant4(const int8_t* __restrict__ q, const float* __restrict__ scales,
         float* __restrict__ x, long long n, int shift) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g * 4 < n; g += stride) {
    const long long i = g * 4;
    const float s = scales[i >> shift];
    if (i + 4 <= n) {
      const char4 c = *reinterpret_cast<const char4*>(q + i);
      *reinterpret_cast<float4*>(x + i) = make_float4(
          static_cast<float>(c.x) * s, static_cast<float>(c.y) * s,
          static_cast<float>(c.z) * s, static_cast<float>(c.w) * s);
    } else {
      for (long long j = i; j < n; ++j) x[j] = static_cast<float>(q[j]) * s;
    }
  }
}

// any block size or alignment: one value per thread.
__global__ void __launch_bounds__(kThreads)
dequant_any(const int8_t* __restrict__ q, const float* __restrict__ scales,
            float* __restrict__ x, long long n, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    x[i] = static_cast<float>(q[i]) * scales[i / block];
}

int grid_for(long long work_items) {
  const long long g = (work_items + kThreads - 1) / kThreads;
  return static_cast<int>(g < kMaxGrid ? (g > 0 ? g : 1) : kMaxGrid);
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

extern "C" {

// x f32 [n] -> q int8 [n], scales f32 [ceil(n / block)]. Returns a CUDA
// error code (0 on a launch that was accepted).
int quantize_int8_f32(const float* x, int8_t* q, float* scales, long long n,
                      int block, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long nblocks = (n + block - 1) / block;
  const int grid = grid_for(nblocks * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block == 256 && aligned(x, 16) && aligned(q, 8))
    quant256<<<grid, kThreads, 0, s>>>(x, q, scales, n, nblocks);
  else
    quant_any<<<grid, kThreads, 0, s>>>(x, q, scales, n, block, nblocks);
  return static_cast<int>(cudaGetLastError());
}

// q int8 [n], scales f32 [ceil(n / block)] -> x f32 [n].
int dequantize_int8_f32(const int8_t* q, const float* scales, float* x,
                        long long n, int block, void* stream) {
  if (n < 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int shift = -1;
  if ((block & (block - 1)) == 0 && block % 4 == 0)
    for (shift = 0; (1 << shift) != block; ++shift) {
    }
  if (shift >= 0 && aligned(q, 4) && aligned(x, 16))
    dequant4<<<grid_for((n + 3) / 4), kThreads, 0, s>>>(q, scales, x, n,
                                                        shift);
  else
    dequant_any<<<grid_for(n), kThreads, 0, s>>>(q, scales, x, n, block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
