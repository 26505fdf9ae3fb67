// Flash attention for fp32 inputs, on the CUDA cores: every product is a
// chain of fp32 FMAs, so no operand is rounded to bf16 (the tensor-core
// kernels of flash_attention.cu and flash_attention_sm90.cu take bf16 only).
//
// Three kernels, each a template on the head dim D and each computing what
// a Pallas TPU kernel of aozora_sdxl_training_tpu/ops/flash_attention.py
// computes when its operands are fp32 (the Pallas bodies multiply in the
// operands' own dtype):
//
//   flash_fwd_f32_kernel<D>      <- _fwd_kernel      D = 64, 128, 512
//   flash_bwd_dq_f32_kernel<D>   <- _bwd_dq_kernel   D = 64, 128
//   flash_bwd_dkv_f32_kernel<D>  <- _bwd_dkv_kernel  D = 64, 128
//
// Only those head dims are instantiated: the SD-VAE decoder's mid-attention
// (D = 512, the preview) runs forward only, and no caller differentiates
// there. Exact attention with an online softmax over key tiles, fp32
// statistics, keys >= Skv masked to -1e30, l clamped at 1e-30, the
// backward recomputing P from the saved row logsumexp, delta = rowsum(dO *
// O) written by the dQ kernel and read by the dK/dV kernel. No atomics: the
// sums over the other sequence run inside a block, and the row reductions
// over lanes in a fixed order, so results are bitwise the same from run to
// run.
//
// Layout (the callers'): q, o, dout, dq contiguous fp32 (B, Sq, H, D); k,
// v, dk, dv contiguous fp32 (B, Skv, H, D); lse and delta contiguous fp32
// (B * H, Sq).
//
// What bounds them: the fp32 FMA rate (4, 6 and 8 * Sq * Skv * D flop per
// head against 4 * S * D bytes per operand). The design is the simple one:
// a block of 256 threads owns BQ rows of the stationary sequence and loops
// over tiles of BK rows of the other, all tiles in shared memory (rows
// padded by 4 floats, so that the 16-byte loads of 8 neighbouring rows
// fall in 8 different bank groups). Thread t = 16 rb + cb computes a
// register tile: rows rb + 16 i of the BQ x BK score products (columns
// cb + 16 j), reading 4 columns of D at a time, and the same rows of the
// BQ x D output products (4-column groups cb + 16 j). The score tile (P,
// dS, P^T, dS^T) goes through shared memory between the two products, and
// the online softmax reads it there, 256 / BQ of a block's threads to a
// row. The tiles come in by cp.async, all of a tile's copies in flight at
// once; the second operand of a tile's score products (V, dO) is waited
// for only after the first product. No tensor cores. Tiles: BQ = BK = 64 at
// D = 64 and 128; BQ = 64, BK = 16 at D = 512, where the Q tile alone takes
// 132 KB of the 227 KB a block may have (32-row blocks with 32-key tiles,
// 2 x 2 register tiles, measured 26.15 ms at S = 16384 on the H100).
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C functions at the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"   // cp.async

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int BQ = 64;                   // stationary rows of a block
  static constexpr int BK = D == 512 ? 16 : 64;   // rows of a streamed tile
  static constexpr int TM = BQ / 16;              // rows of a thread's register tile
  static constexpr int TN = BK / 16;              // score columns of a thread
  static constexpr int C4 = D / 64;               // 4-column output groups of a thread
  static constexpr int LD = D + 4;                // row stride of the D-wide tiles
  static constexpr int LDS = BK + 4;              // row stride of the score tiles
  static constexpr int ROW_T = THREADS / BQ;      // softmax threads a row
  static constexpr int QTILE = BQ * LD;           // floats of a stationary D-wide tile
  static constexpr int KTILE = BK * LD;           // floats of a streamed D-wide tile
  static constexpr int STILE = BQ * LDS;          // floats of one score tile
  static constexpr size_t FWD_SMEM = (QTILE + 2 * KTILE + STILE + BQ) * sizeof(float);
  static constexpr size_t DQ_SMEM = (2 * QTILE + 2 * KTILE + STILE + 2 * BQ) * sizeof(float);
  static constexpr size_t DKV_SMEM =
      (2 * QTILE + 2 * KTILE + 2 * STILE + 2 * BK) * sizeof(float);
  static_assert(16 * TM == BQ && 16 * TN == BK && 64 * C4 == D, "register tiles");
  static_assert(FWD_SMEM <= 232448 && (D == 512 || DKV_SMEM <= 232448),
                "shared memory of one block");
};

// Rows [row0, row0 + R) of one head of a (B, S, H, D) fp32 tensor (row
// stride rs floats) into a tile of row stride D + 4, by cp.async (the
// caller commits and waits); rows >= S are zeros.
template <int R, int D>
__device__ __forceinline__ void load_tile_async(float* dst, const float* head, int row0, int S,
                                                int rs) {
  constexpr int C = D / 4;                  // 16-byte chunks of a row
  static_assert((R * C) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * C / THREADS; ++i) {
    const unsigned c = threadIdx.x + i * THREADS;
    const int r = c / C, col = (c % C) * 4;
    const bool ok = row0 + r < S;
    sm90::cp_async16(sm90::smem_u32(dst + r * (D + 4) + col),
                     head + (size_t)(ok ? row0 + r : 0) * rs + col, ok);
  }
}

// acc[i][j] = sum_d A[rb + 16 i][d] B[cb + 16 j][d] over d < D; A and B
// tiles of row stride D + 4.
template <int D, int TM, int TN>
__device__ __forceinline__ void nt_product(float (&acc)[TM][TN], const float* A,
                                           const float* B, int rb, int cb) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rb + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][4 j + e] += sum_c P[rb + 16 i][c] V[c][4 (cb + 16 j) + e] over
// c < K; P of row stride ldp, V of row stride D + 4; W = 4 C4 columns.
template <int D, int K, int TM, int W>
__device__ __forceinline__ void nn_accumulate(float (&acc)[TM][W], const float* P, int ldp,
                                              const float* V, int rb, int cb) {
  constexpr int LD = D + 4, C4 = W / 4;
#pragma unroll 2
  for (int c = 0; c < K; c += 4) {
    float4 p[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (rb + 16 * i) * ldp + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < C4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(V + (c + e) * LD + 4 * (cb + 16 * j));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float pi = lane4(p[i], e);
          acc[i][4 * j] = fmaf(pi, v.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(pi, v.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pi, v.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pi, v.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// Writes rows rb + 16 i of a thread's output tile, scaled by mul[i], into
// rows [row0, row0 + 16 TM) of one head (row stride rs floats); rows >= S
// are dropped.
template <int TM, int W>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][W], const float (&mul)[TM],
                                           float* head, int row0, int S, int rs, int rb,
                                           int cb) {
  constexpr int C4 = W / 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rb + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < C4; ++j)
      *reinterpret_cast<float4*>(head + (size_t)row * rs + 4 * (cb + 16 * j)) =
          make_float4(acc[i][4 * j] * mul[i], acc[i][4 * j + 1] * mul[i],
                      acc[i][4 * j + 2] * mul[i], acc[i][4 * j + 3] * mul[i]);
  }
}

// ---------------------------------------------------------------------------
// Forward. Grid (ceil(Sq / BQ), B * H).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + C::QTILE;
  float* sV = sK + C::KTILE;
  float* sP = sV + C::KTILE;
  float* sRow = sP + C::STILE;              // per row: alpha, then 1 / l
  const int tid = threadIdx.x, rb = tid / 16, cb = tid % 16;
  const int r = tid / C::ROW_T, u = tid % C::ROW_T;   // softmax: row and lane in it
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int rs = H * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_tile_async<C::BQ, D>(sQ, q + (size_t)b * Sq * rs + h * D, q0, Sq, rs);
  sm90::cp_async_commit();
  float acc[C::TM][4 * C::C4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int x = 0; x < 4 * C::C4; ++x) acc[i][x] = 0.f;
  float m = NEG_INF, l = 0.f;               // of row r, held by its ROW_T threads

  for (int k0 = 0; k0 < Skv; k0 += C::BK) {
    __syncthreads();                        // the previous tile is consumed
    load_tile_async<C::BK, D>(sK, kh, k0, Skv, rs);
    sm90::cp_async_commit();
    load_tile_async<C::BK, D>(sV, vh, k0, Skv, rs);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();               // K (and Q) landed
    __syncthreads();
    float s[C::TM][C::TN];
    nt_product<D>(s, sQ, sK, rb, cb);       // S = Q K^T
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int col = cb + 16 * j;
        sP[(rb + 16 * i) * C::LDS + col] = (k0 + col < Skv) ? s[i][j] * scale : NEG_INF;
      }
    __syncthreads();
    // online softmax of row r over this tile's BK keys
    float* prow = sP + r * C::LDS;
    float mx = m;
#pragma unroll
    for (int x = u; x < C::BK; x += C::ROW_T) mx = fmaxf(mx, prow[x]);
#pragma unroll
    for (int off = 1; off < C::ROW_T; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float alpha = expf(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int x = u; x < C::BK; x += C::ROW_T) {
      const float p = expf(prow[x] - mx);
      prow[x] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < C::ROW_T; off *= 2) sum += __shfl_xor_sync(FULL, sum, off);
    l = l * alpha + sum;
    m = mx;
    if (u == 0) sRow[r] = alpha;
    sm90::cp_async_wait<0>();               // V landed
    __syncthreads();
    // O = alpha O + P V
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const float a = sRow[rb + 16 * i];
#pragma unroll
      for (int x = 0; x < 4 * C::C4; ++x) acc[i][x] *= a;
    }
    nn_accumulate<D, C::BK>(acc, sP, C::LDS, sV, rb, cb);
  }

  const float safe_l = fmaxf(l, 1e-30f);
  __syncthreads();                          // every thread has read this tile's alpha
  if (u == 0) {
    sRow[r] = 1.f / safe_l;
    if (q0 + r < Sq) lse[(size_t)bh * Sq + q0 + r] = m + logf(safe_l);
  }
  __syncthreads();
  float inv[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) inv[i] = sRow[rb + 16 * i];
  store_tile(acc, inv, o + (size_t)b * Sq * rs + h * D, q0, Sq, rs, rb, cb);
}

// ---------------------------------------------------------------------------
// dQ, and delta = rowsum(dO * O) for the dK/dV kernel. Grid
// (ceil(Sq / BQ), B * H); the key loop is inside the block.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                        int Skv, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + C::QTILE;
  float* sK = sDO + C::QTILE;
  float* sV = sK + C::KTILE;
  float* sDS = sV + C::KTILE;
  float* sLse = sDS + C::STILE;
  float* sDelta = sLse + C::BQ;
  const int tid = threadIdx.x, rb = tid / 16, cb = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_tile_async<C::BQ, D>(sQ, q + qoff, q0, Sq, rs);
  load_tile_async<C::BQ, D>(sDO, dout + qoff, q0, Sq, rs);
  sm90::cp_async_commit();
  {
    // delta of row r: ROW_T threads, D / ROW_T columns each, reduced over
    // the lanes in a fixed order
    const int r = tid / C::ROW_T, u = tid % C::ROW_T, row = q0 + r;
    float dl = 0.f;
    if (row < Sq) {
      const float* orow = o + qoff + (size_t)row * rs;
      const float* drow = dout + qoff + (size_t)row * rs;
#pragma unroll 4
      for (int c = u * 4; c < D; c += 4 * C::ROW_T) {
        const float4 fo = *reinterpret_cast<const float4*>(orow + c);
        const float4 fd = *reinterpret_cast<const float4*>(drow + c);
        dl += fd.x * fo.x + fd.y * fo.y + fd.z * fo.z + fd.w * fo.w;
      }
    }
#pragma unroll
    for (int off = 1; off < C::ROW_T; off *= 2) dl += __shfl_xor_sync(FULL, dl, off);
    if (u == 0) {
      sDelta[r] = dl;
      sLse[r] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
      if (row < Sq) delta[(size_t)bh * Sq + row] = dl;
    }
  }
  __syncthreads();
  float lse_r[C::TM], dl_r[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    lse_r[i] = sLse[rb + 16 * i];
    dl_r[i] = sDelta[rb + 16 * i];
  }

  float acc[C::TM][4 * C::C4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int x = 0; x < 4 * C::C4; ++x) acc[i][x] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += C::BK) {
    __syncthreads();                        // the previous tile is consumed
    load_tile_async<C::BK, D>(sK, kh, k0, Skv, rs);
    sm90::cp_async_commit();
    load_tile_async<C::BK, D>(sV, vh, k0, Skv, rs);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();               // K (and Q, dO) landed
    __syncthreads();
    float s[C::TM][C::TN], dp[C::TM][C::TN];
    nt_product<D>(s, sQ, sK, rb, cb);       // S = Q K^T
    sm90::cp_async_wait<0>();               // V landed
    __syncthreads();
    nt_product<D>(dp, sDO, sV, rb, cb);     // dP = dO V^T
    // dS = P (dP - delta) scale
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int col = cb + 16 * j;
        const float p = (k0 + col < Skv) ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sDS[(rb + 16 * i) * C::LDS + col] = p * (dp[i][j] - dl_r[i]) * scale;
      }
    __syncthreads();
    nn_accumulate<D, C::BK>(acc, sDS, C::LDS, sK, rb, cb);   // dQ += dS K
  }

  float one[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) one[i] = 1.f;
  store_tile(acc, one, dq + qoff, q0, Sq, rs, rb, cb);
}

// ---------------------------------------------------------------------------
// dK and dV from the saved lse and the dQ kernel's delta. Grid
// (ceil(Skv / BQ), B * H); the query loop is inside the block, on
// transposed scores (rows = keys, columns = queries).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                         int Skv, float scale) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + C::QTILE;
  float* sQ = sV + C::QTILE;
  float* sDO = sQ + C::KTILE;
  float* sPT = sDO + C::KTILE;
  float* sDST = sPT + C::STILE;
  float* sLse = sDST + C::STILE;
  float* sDelta = sLse + C::BK;
  const int tid = threadIdx.x, rb = tid / 16, cb = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * C::BQ;
  const int rs = H * D;
  const size_t kvoff = (size_t)b * Skv * rs + h * D;
  const float* qh = q + (size_t)b * Sq * rs + h * D;
  const float* doh = dout + (size_t)b * Sq * rs + h * D;

  load_tile_async<C::BQ, D>(sK, k + kvoff, kv0, Skv, rs);
  load_tile_async<C::BQ, D>(sV, v + kvoff, kv0, Skv, rs);
  sm90::cp_async_commit();
  float acc_dk[C::TM][4 * C::C4], acc_dv[C::TM][4 * C::C4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int x = 0; x < 4 * C::C4; ++x) acc_dk[i][x] = acc_dv[i][x] = 0.f;

  for (int j0 = 0; j0 < Sq; j0 += C::BK) {
    __syncthreads();                        // the previous tile is consumed
    load_tile_async<C::BK, D>(sQ, qh, j0, Sq, rs);
    sm90::cp_async_commit();
    load_tile_async<C::BK, D>(sDO, doh, j0, Sq, rs);
    sm90::cp_async_commit();
    if (tid < C::BK) {
      const bool ok = j0 + tid < Sq;
      sLse[tid] = ok ? lse[(size_t)bh * Sq + j0 + tid] : 0.f;
      sDelta[tid] = ok ? delta[(size_t)bh * Sq + j0 + tid] : 0.f;
    }
    sm90::cp_async_wait<1>();               // Q (and K, V) landed
    __syncthreads();
    float st[C::TM][C::TN], dpt[C::TM][C::TN];
    nt_product<D>(st, sK, sQ, rb, cb);      // S^T = K Q^T
    sm90::cp_async_wait<0>();               // dO landed
    __syncthreads();
    nt_product<D>(dpt, sV, sDO, rb, cb);    // dP^T = V dO^T
    // P^T, 0 for queries >= Sq, and dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int col = cb + 16 * j;
        const float p = (j0 + col < Sq) ? expf(st[i][j] * scale - sLse[col]) : 0.f;
        sPT[(rb + 16 * i) * C::LDS + col] = p;
        sDST[(rb + 16 * i) * C::LDS + col] = p * (dpt[i][j] - sDelta[col]) * scale;
      }
    __syncthreads();
    nn_accumulate<D, C::BK>(acc_dv, sPT, C::LDS, sDO, rb, cb);   // dV += P^T dO
    nn_accumulate<D, C::BK>(acc_dk, sDST, C::LDS, sQ, rb, cb);   // dK += dS^T Q
  }

  float one[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) one[i] = 1.f;
  store_tile(acc_dk, one, dk + kvoff, kv0, Skv, rs, rb, cb);
  store_tile(acc_dv, one, dv + kvoff, kv0, Skv, rs, rb, cb);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
        int Skv, float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<D>, Cfg<D>::FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + Cfg<D>::BQ - 1) / Cfg<D>::BQ, B * H);
  flash_fwd_f32_kernel<D><<<grid, THREADS, Cfg<D>::FWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
           float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
        aligned16(dq)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_bwd_dq_f32_kernel<D>, Cfg<D>::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + Cfg<D>::BQ - 1) / Cfg<D>::BQ, B * H);
  flash_bwd_dq_f32_kernel<D><<<grid, THREADS, Cfg<D>::DQ_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      lse, delta, (float*)dq, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int B, int H, int Sq, int Skv, float scale,
            void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dk) &&
        aligned16(dv)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_bwd_dkv_f32_kernel<D>, Cfg<D>::DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + Cfg<D>::BQ - 1) / Cfg<D>::BQ, B * H);
  flash_bwd_dkv_f32_kernel<D><<<grid, THREADS, Cfg<D>::DKV_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one entry point per kernel and head dim. Each returns
// the cudaError_t of its launch; cudaErrorInvalidValue for a pointer the
// 16-byte loads cannot take.
extern "C" {

const char* aozora_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int aozora_flash_fwd_f32_d64(const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int H, int Sq, int Skv, float scale,
                             void* stream) {
  return fwd<64>(q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_fwd_f32_d128(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int H, int Sq, int Skv, float scale,
                             void* stream) {
  return fwd<128>(q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_fwd_f32_d512(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int H, int Sq, int Skv, float scale,
                             void* stream) {
  return fwd<512>(q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dq_f32_d64(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, float* delta, void* dq, int B,
                                int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dkv_f32_d64(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int H, int Sq, int Skv, float scale,
                                 void* stream) {
  return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dq_f32_d128(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, float* delta, void* dq, int B,
                                 int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dkv_f32_d128(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dk, void* dv, int B, int H, int Sq, int Skv,
                                  float scale, void* stream) {
  return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, stream);
}

}  // extern "C"
