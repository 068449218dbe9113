// Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a): bf16 x, B and
// C, products on wgmma (bf16 x bf16 into f32), TMA loads, the state kept
// on chip in f32.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:30 (_ssd_kernel, launched by
//   ssd_scan_bhsp at :84, pallas_call at :93)
// for bf16 inputs with a chunk Q that is a multiple of 64 up to 256, a head
// dim P that is a multiple of 8 up to 64 and a state N that is a multiple
// of 8 up to 128; f32 inputs and other shapes keep the vector-unit kernel
// of ssd_scan.cu. It computes what ref.py computes. Per (batch, head) and
// per chunk of Q steps, with cum the inclusive within-chunk cumulative sum
// of dt * a (f32, a < 0):
//   intra:  y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter:  y_i += exp(cum_i) (C_i S_prev^T)
//   state:  S    = S_prev exp(cum_last)
//                  + sum_j (x_j exp(cum_last - cum_j) dt_j) B_j^T
// with S [P, N] carried in f32 from chunk to chunk; y is written in bf16
// and the last state in f32.
//
// What bounds it on the H100: at Zamba2's shape (B 4, S 4096, 112 heads,
// P 64, N 64, Q 256) it must move ~0.49 GB (x and y dominate), 0.146 ms at
// 3.35 TB/s; its products over the causal triangle, the carry-in and the
// state update are ~0.9e11 FLOP, ~0.09 ms at 989 TFLOP/s. So bytes bound
// it, with operations close behind: the products must run on the tensor
// cores, and the state must not leave the chip between chunks (a
// chunk-state / state-pass / chunk-scan split would write and read 117 MB
// of f32 states at this shape).
//
// Design. One block of two warpgroups (256 threads) owns one (batch, head)
// and walks its chunks in order, as the TPU kernel's sequential grid axis
// does; 448 blocks at Zamba2's shape, one an SM (3.4 waves).
//   Loads: thread 0 issues one TMA box per 64-column atom of x (the head's
//   [Q, P] rows), B and C ([Q, N]) of a chunk into a stage of shared memory,
//   128-byte swizzled, completing on the stage's mbarrier. Two stages where
//   they fit (N <= 64: 96 KB a stage at Q 256), so chunk c + 1 loads while
//   chunk c computes; one stage at N 128. P and N are padded to whole
//   64-column atoms: TMA zero-fills the columns past the tensor's extent,
//   so padded products add zeros.
//   Cumulative sum: one value a thread, a warp-shuffle inclusive scan and
//   the warps' totals, in f32; kept as cum * log2(e) for ex2. The next
//   chunk's dt is loaded into a register while this chunk computes. Where
//   cum never rises in the chunk (dt * a <= 0, every model's case), the
//   decay of a tile below the diagonal factors into a row part and a key
//   part exp(cum_J - cum_j) dt_j (J the key tile's last row), both <= 1,
//   the key part computed once a chunk: two exponentials a row and tile
//   instead of one an element.
//   y, 64 query rows at a time (the wgmma M): warpgroup 0 takes query tiles
//   0 and 3, warpgroup 1 tiles 1 and 2 (five causal tile pairs each at
//   Q 256). Per tile, the carry-in first: C_i (S_hi + S_lo)^T, wgmma
//   m64n64k16 with both operands K-major in shared memory, where S_hi and
//   S_lo are the f32 state split into bf16 high and low parts (so the
//   carry-in keeps ~16 bits of the state), scaled by exp(cum_i) in
//   registers. Then for each key tile j <= i only (the causal triangle):
//   G = C_i B_j^T (m64n64k16, K-major operands), the scores
//   G * exp(cum_i - cum_j) * dt_j in the accumulator's registers, with
//   the exponent evaluated only where i >= j (above the diagonal it is
//   positive and may overflow), split into bf16 high and low parts in
//   registers, where the accumulator's layout is wgmma's register-A
//   layout, and y += hi @ X_j + lo @ X_j (m64n64k16, A from registers, X
//   N-major from shared memory). One bf16 part alone (8 bits) left the
//   reference's 1e-1 tolerance at N 128 on the card, where y cancels
//   between large terms. Key tile j + 1's G is issued ahead of tile j's
//   products with X, and its scores computed while they run. The scores
//   never touch shared memory; y is stored from registers.
//   State: once every y tile has read the chunk's x, the block scales x in
//   place by w_j = exp(cum_last - cum_j) dt_j (bf16), and the state's
//   owner (warpgroup 0 at N <= 64; at N 128 each warpgroup owns one
//   64-column atom) runs (w x)^T B over the chunk, wgmma with A M-major
//   and B N-major in shared memory, and adds it to S exp(cum_last) in f32
//   registers, which hold S from the first chunk to the last.
//   It then writes S_hi and S_lo, swizzled K-major, for the next chunk's
//   carry-in, and the last chunk's S to device memory in f32.
//
// Tensor maps: cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (no
// -lcuda), built per call over x [B, S, H, P] (dims P, H, S, B) and over
// B and C [B, S, N] as [B, S, 1, N], passed as __grid_constant__
// parameters (flash_attention/csrc/hopper.cuh). Layout: x/y [B, S, H, P]
// bf16, dt [B, S, H] f32, a [H] f32, B/C [B, S, N] bf16, state
// [B, H, P, N] f32, all contiguous, x, B and C 16-byte aligned. S must be a
// multiple of Q (the wrapper pads with dt = 0).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../flash_attention/csrc/hopper.cuh"
#include "../../flash_attention/csrc/wgmma_ops.cuh"

namespace {

constexpr int NT = 256;        // two warpgroups
constexpr int TQ = 64;         // rows of a query or key tile: the wgmma M
constexpr int MAX_Q = 256;     // chunk length
constexpr int ROW = 128;       // bytes of one swizzled row: 64 bf16
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory, in bytes from a 1024-aligned base: per stage x
// [Q][64], then B and C as NA atoms of [Q][64] each (bf16, swizzled); the
// carry-in tiles S_hi and S_lo as NA atoms of [64][64] each; then cum
// (log2 units), dt and the key columns' factors [MAX_Q] f32, the scan's
// warp totals and the stages' mbarriers.
struct Layout {
  int q, na, stages;
  __host__ __device__ int stage_bytes() const { return q * ROW * (1 + 2 * na); }
  __host__ __device__ int x(int s) const { return s * stage_bytes(); }
  __host__ __device__ int b(int s) const { return x(s) + q * ROW; }
  __host__ __device__ int c(int s) const { return b(s) + na * q * ROW; }
  __host__ __device__ int s_hi() const { return stages * stage_bytes(); }
  __host__ __device__ int s_lo() const { return s_hi() + na * TQ * ROW; }
  __host__ __device__ int cum() const { return s_lo() + na * TQ * ROW; }
  __host__ __device__ int dts() const { return cum() + MAX_Q * 4; }
  __host__ __device__ int colw() const { return dts() + MAX_Q * 4; }
  __host__ __device__ int wsum() const { return colw() + MAX_Q * 4; }
  __host__ __device__ int bars() const { return wsum() + (NT / 32) * 4; }
  // + slack to align the base to 1024 bytes
  __host__ __device__ int total() const { return bars() + 8 * stages + 1024; }
};

// byte offset of bf16 element (row, col) in a [rows][64] 128-byte-swizzled
// tile whose base is 1024-aligned (TMA's and wgmma's SWIZZLE_128B)
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * ROW + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2));
}

template <int NA>
__global__ void __launch_bounds__(NT, 1)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const float* __restrict__ dt, const float* __restrict__ a,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ state_out, int S, int H, int P,
                     int N, int Q, int stages) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const Layout L{Q, NA, stages};
  float* cum2 = reinterpret_cast<float*>(gbase + L.cum());
  float* dts = reinterpret_cast<float*>(gbase + L.dts());
  float* colw = reinterpret_cast<float*>(gbase + L.colw());
  float* wsum = reinterpret_cast<float*>(gbase + L.wsum());
  const uint32_t bar0 = base + L.bars();

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup, read from lane 0 so that the compiler treats it as
  // warp-uniform: branches on it hold wgmma instructions
  const int wg = __shfl_sync(kFull, tid >> 7, 0);
  const int wl = warp & 3;        // warp within its warpgroup
  const int n_chunks = S / Q;
  const int n_tiles = Q / TQ;
  const float a_h = a[h];
  const float* dtb = dt + (int64_t)b * S * H + h;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunk c's x, B and C into stage c % stages (thread 0)
  auto issue = [&](int c) {
    const int s = c % stages;
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, L.stage_bytes());
    tma_load(base + L.x(s), &tx, bar, 0, h, c * Q, b);
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      tma_load(base + L.b(s) + k * Q * ROW, &tb, bar, 64 * k, 0, c * Q, b);
      tma_load(base + L.c(s) + k * Q * ROW, &tc, bar, 64 * k, 0, c * Q, b);
    }
  };
  if (tid == 0)
    for (int c = 0; c < stages - 1 && c < n_chunks; ++c) issue(c);
  // S_hi and S_lo start at 0: the first chunk's carry-in adds zeros
  for (int k = tid; k < 2 * NA * TQ * ROW / 16; k += NT)
    reinterpret_cast<uint4*>(gbase + L.s_hi())[k] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  float dt_next = tid < Q ? dtb[(int64_t)tid * H] : 0.f;

  // the state's owner holds S [64 p][64 n] of atom `own_atom` in wgmma's
  // accumulator layout: element i at p = 16 wl + lane / 4 + 8 ((i / 2) % 2),
  // n = 8 (i / 4) + 2 (lane % 4) + i % 2
  const bool owner = NA == 2 || wg == 0;
  const int own_atom = NA == 2 ? wg : 0;
  float st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % stages;
    const int t0 = c * Q;
    // chunk c - 1 is done: its stage, cum and dt are free, S is written
    __syncthreads();
    if (tid == 0 && c + stages - 1 < n_chunks) issue(c + stages - 1);

    // ---- inclusive cumulative sum of dt * a: warp shuffles, then the
    // totals of the warps before
    const float d = dt_next;
    if (c + 1 < n_chunks && tid < Q)
      dt_next = dtb[(int64_t)(t0 + Q + tid) * H];
    float v = tid < Q ? d * a_h : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float before = 0.f;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    if (tid < Q) {
      cum2[tid] = (v + before) * LOG2E;
      dts[tid] = d;
    }
    // cum never rises in the chunk (dt * a <= 0 everywhere, as in every
    // model): then off the diagonal exp(cum_i - cum_j) factors into
    // exp(cum_i - cum_J) exp(cum_J - cum_j), J the key tile's last row,
    // both <= 1 (neither overflows, and neither underflows where the
    // product does not); the key side, times dt_j, is computed once here
    const bool falling = __syncthreads_and(tid >= Q || d * a_h <= 0.f);
    if (tid < Q) colw[tid] = fast_exp2(cum2[tid | (TQ - 1)] - cum2[tid]) * d;
    __syncthreads();
    mbar_wait(bar0 + 8 * s, (uint32_t)(c / stages) & 1);
    const uint32_t sx = base + L.x(s), sb = base + L.b(s), sc = base + L.c(s);
    const float last2 = cum2[Q - 1];

    // ---- y: warpgroup 0 takes query tiles 0 and 3 (mod 4), warpgroup 1
    // tiles 1 and 2
    for (int it = 0; it < n_tiles; ++it) {
      const int m4 = it & 3;
      if ((m4 == 0 || m4 == 3) != (wg == 0)) continue;
      const int r0 = it * TQ + 16 * wl + (lane >> 2);  // rows r0, r0 + 8
      const float c_r[2] = {cum2[r0], cum2[r0 + 8]};
      const uint32_t c_tile = sc + it * TQ * ROW;
      // C_i rows, k-step kk of 16 state columns: atom kk / 4, 32 bytes a
      // step into its swizzled rows
      auto desc_c = [&](int kk) {
        return sw128_desc(c_tile + (kk >> 2) * Q * ROW + (kk & 3) * 32, 16,
                          1024);
      };
      // scores of key tile jt in place of its G = C_i B_j^T; element i:
      // row r0 + 8 ((i / 2) % 2), key column 64 jt + 8 (i / 4) +
      // 2 (lane % 4) + i % 2
      auto scores = [&](float (&g)[32], int jt) {
        if (falling && jt < it) {  // below the diagonal: factored decay
          const float c_last = cum2[jt * TQ + TQ - 1];
          const float f[2] = {fast_exp2(c_r[0] - c_last),
                              fast_exp2(c_r[1] - c_last)};
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int j = jt * TQ + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            g[i] *= f[(i >> 1) & 1] * colw[j];
          }
          return;
        }
        const bool diag = jt == it;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int rr = (i >> 1) & 1;
          const int j = jt * TQ + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const bool live = !diag || r0 + 8 * rr >= j;
          const float e = fast_exp2(live ? c_r[rr] - cum2[j] : -INFINITY);
          g[i] = live ? g[i] * e * dts[j] : 0.f;
        }
      };
      auto issue_g = [&](float (&g)[32], int jt) {
#pragma unroll
        for (int kk = 0; kk < 4 * NA; ++kk)
          wgmma_ss<64>(g, desc_c(kk),
                       sw128_desc(sb + (kk >> 2) * Q * ROW + jt * TQ * ROW +
                                      (kk & 3) * 32,
                                  16, 1024),
                       kk > 0);
      };
      float acc[32], g[32];
      uint32_t hi[4][4], lo[4][4];  // the scores as bf16 high + low parts
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      // the carry-in C_i (S_hi + S_lo)^T (S is 0 before the first chunk)
      // and key tile 0's G
      wg_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const uint32_t s_tile = base + (part == 0 ? L.s_hi() : L.s_lo());
#pragma unroll
        for (int kk = 0; kk < 4 * NA; ++kk)
          wgmma_ss<64>(acc, desc_c(kk),
                       sw128_desc(s_tile + (kk >> 2) * TQ * ROW +
                                      (kk & 3) * 32,
                                  16, 1024),
                       1);
      }
      issue_g(g, 0);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(g);
      const float e0 = fast_exp2(c_r[0]), e1 = fast_exp2(c_r[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= ((i >> 1) & 1) ? e1 : e0;
      scores(g, 0);
      // y += hi @ X_j + lo @ X_j for key tile jt, from registers
      auto split = [&]() {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const uint32_t h2 = pack_bf16(g[i], g[i + 1]);
          const __nv_bfloat162 hb =
              *reinterpret_cast<const __nv_bfloat162*>(&h2);
          const float2 hf = __bfloat1622float2(hb);
          hi[i >> 3][(i >> 1) & 3] = h2;
          lo[i >> 3][(i >> 1) & 3] = pack_bf16(g[i] - hf.x, g[i + 1] - hf.y);
        }
      };
      auto issue_x = [&](int jt) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t dx =
              sw128_desc(sx + (jt * TQ + 16 * t) * ROW, Q * ROW, 1024);
          wgmma_rs<64>(acc, hi[t], dx);
          wgmma_rs<64>(acc, lo[t], dx);
        }
      };
      // key tile jt + 1's G runs ahead of tile jt's products with X, and
      // tile jt + 1's scores are computed while those run
      for (int jt = 0; jt < it; ++jt) {
        split();
        wg_fence();
        issue_g(g, jt + 1);
        wg_commit();
        issue_x(jt);
        wg_commit();
        wg_wait<1>();
        reg_fence(g);
        scores(g, jt + 1);
        wg_wait<0>();
        reg_fence(acc);
        reg_fence_u(hi);
        reg_fence_u(lo);
      }
      split();
      wg_fence();
      issue_x(it);
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      // store y: element i at row r0 + 8 ((i / 2) % 2), column
      // 8 (i / 4) + 2 (lane % 4) + i % 2
      const int64_t row_stride = (int64_t)H * P;
      __nv_bfloat16* yb =
          y + ((int64_t)b * S + t0) * row_stride + (int64_t)h * P;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        __nv_bfloat16* yr = yb + (int64_t)(r0 + 8 * rr) * row_stride;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)  // columns 8 jj.. < P: P % 8 == 0
          if (jj < (P >> 3))
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * jj +
                                               2 * (lane & 3)) =
                __floats2bfloat162_rn(acc[4 * jj + 2 * rr],
                                      acc[4 * jj + 2 * rr + 1]);
      }
    }

    // ---- state: x <- x * w_j in place (each 16-byte chunk of a swizzled
    // row holds 8 columns of that row), then S = S exp(cum_last) + x^T B
    __syncthreads();  // every product of this chunk has read x
    uint4* xs = reinterpret_cast<uint4*>(gbase + L.x(s));
    for (int k = tid; k < Q * (ROW / 16); k += NT) {
      const int j = k / (ROW / 16);
      const float w = fast_exp2(last2 - cum2[j]) * dts[j];
      uint4 q = xs[k];
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(h2[u]);
        h2[u] = __floats2bfloat162_rn(f.x * w, f.y * w);
      }
      xs[k] = q;
    }
    fence_proxy_async();
    __syncthreads();
    if (owner) {
      // this chunk's (w x)^T B into an accumulator of its own, one group
      // per 64 key rows, each waited before the loop goes on (a wgmma left
      // in flight across the loop's back edge made ptxas serialize every
      // wgmma of the kernel); the running S = S exp(cum_last) + that
      // stays in plain registers
      float ds[32];
      for (int jt = 0; jt < n_tiles; ++jt) {
        wg_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t row = (jt * TQ + 16 * t) * ROW;
          wgmma_ss_tt<64>(ds, sw128_desc(sx + row, Q * ROW, 1024),
                          sw128_desc(sb + own_atom * Q * ROW + row, Q * ROW,
                                     1024),
                          jt > 0 || t > 0);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence(ds);
      }
      const float decay = fast_exp2(last2);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = st[i] * decay + ds[i];
      // S_hi = bf16(S), S_lo = bf16(S - S_hi), K-major for the carry-in
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int p = 16 * wl + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * (lane & 3);
        const uint32_t off = own_atom * TQ * ROW + sw128_offset(p, n);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(st[i], st[i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(gbase + L.s_hi() + off) = hi;
        *reinterpret_cast<__nv_bfloat162*>(gbase + L.s_lo() + off) =
            __floats2bfloat162_rn(st[i] - hf.x, st[i + 1] - hf.y);
      }
      fence_proxy_async();
    }
  }

  if (owner) {
    float* sb_out = state_out + ((int64_t)b * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = 16 * wl + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int n = 64 * own_atom + 8 * (i >> 2) + 2 * (lane & 3);
      if (p < P && n < N)
        *reinterpret_cast<float2*>(sb_out + (int64_t)p * N + n) =
            make_float2(st[i], st[i + 1]);
    }
  }
}

Layout layout_for(int Q, int NA) {
  const Layout two{Q, NA, 2};
  return (size_t)two.total() <= kMaxSmem ? two : Layout{Q, NA, 1};
}

template <int NA>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* st, int B, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mx, mb, mc;
  if (!make_map(&mx, encode, x, B, S, H, P, Q) ||
      !make_map(&mb, encode, bm, B, S, 1, N, Q) ||
      !make_map(&mc, encode, cm, B, S, 1, N, Q))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_for(Q, NA);
  if ((size_t)L.total() > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total());
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_wgmma_kernel<NA><<<grid, NT, L.total(), stream>>>(
      mx, mb, mc, (const float*)dt, (const float*)a, (__nv_bfloat16*)y,
      (float*)st, S, H, P, N, Q, L.stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 x, B, C and y; f32 dt, a and state. Q a multiple of 64 up to 256, S a
// multiple of Q, P and N multiples of 8 up to 64 and 128; x, B and C
// 16-byte aligned. Returns a CUDA error code (0 on a launch that was
// accepted).
int ssd_scan_wgmma(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* st, int B,
                   int S, int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q % TQ != 0 || Q > MAX_Q ||
      S % Q != 0 || P <= 0 || P % 8 != 0 || P > 64 || N <= 0 || N % 8 != 0 ||
      N > 128)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm) % 16 != 0 ||
      (uintptr_t)y % 4 != 0 || (uintptr_t)st % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 64) return launch<1>(x, dt, a, bm, cm, y, st, B, S, H, P, N, Q, s);
  return launch<2>(x, dt, a, bm, cm, y, st, B, S, H, P, N, Q, s);
}

}  // extern "C"
