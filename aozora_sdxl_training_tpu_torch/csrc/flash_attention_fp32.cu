// Flash attention for fp32 inputs, to fp32 accuracy: no operand is
// rounded to bf16 (the bf16 kernels of flash_attention_sm90.cu take bf16
// only). Each kernel computes what a Pallas TPU kernel of
// aozora_sdxl_training_tpu/ops/flash_attention.py computes when its
// operands are fp32 (the Pallas bodies multiply in the operands' own
// dtype):
//
//   flash_fwd_f32_kernel<D>         <- _fwd_kernel (_flash_forward)   D = 64, 128
//   flash_bwd_dq_f32_kernel<64>     <- _bwd_dq_kernel (_flash_backward)
//   flash_bwd_dkv_f32_kernel<64>    <- _bwd_dkv_kernel (_flash_backward)
//   flash_bwd_dq_f32_d128_kernel    <- _flash_backward_folded, dq pallas_call
//   flash_bwd_dkv_f32_d128_kernel   <- _flash_backward_folded, dk/dv pallas_call
//   flash_fwd_f32_d512_kernel       <- _fwd_kernel (_flash_forward_folded) at D = 512
//
// The last is the SD-VAE decoder's mid-attention in the preview (one head
// of 512 over 16384 tokens at 1024px), forward only: no caller
// differentiates there. All: exact attention with an online softmax over
// key tiles, fp32 statistics, keys >= Skv masked to -1e30, l clamped at
// 1e-30, the backward recomputing P from the saved row logsumexp, delta =
// rowsum(dO * O) written by the dQ kernel and read by the dK/dV kernel. No
// atomics: the sums over the other sequence run inside a block, and the row
// reductions over lanes in a fixed order, so results are bitwise the same
// from run to run.
//
// Layout (the callers'): q, o, dout, dq contiguous fp32 (B, Sq, H, D); k,
// v, dk, dv contiguous fp32 (B, Skv, H, D); lse and delta contiguous fp32
// (B * H, Sq).
//
// The forwards at head_dim 64 and 128 and the backward at 64, on the CUDA
// cores: bound by the fp32 FMA rate (4, 6 and 8 * Sq * Skv * D flop per
// head against 4 * S * D bytes per operand); no caller of the trainers
// reaches them (both compute in bf16), so they are the simple design: a
// block of 256 threads owns 64 rows of the stationary sequence and loops
// over 64-row tiles of the other,
// all tiles in shared memory (rows padded by 4 floats, so that the 16-byte
// loads of 8 neighbouring rows fall in 8 different bank groups). Thread
// t = 16 rb + cb computes a register tile: rows rb + 16 i of the score
// products (columns cb + 16 j), reading 4 columns of D at a time, and the
// same rows of the output products (4-column groups cb + 16 j). The score
// tile (P, dS, P^T, dS^T) goes through shared memory between the two
// products, and the online softmax reads it there, 4 threads to a row. The
// tiles come in by cp.async; the second operand of a tile's score products
// (V, dO) is waited for only after the first product.
//
// The backward at head_dim 128 and the forward at 512, on the tensor cores
// in 3xTF32 (the backward's design is at its kernels). The forward's 4 * S^2 *
// 512 flop (5.5e11 at S = 16384) take 8.2 ms at the fp32 FMA peak (67
// TFLOP/s), where the CUDA-core kernel of the design above took 23.6 ms on
// the H100; as three TF32 products (495 TFLOP/s) they take 3.3 ms. Each
// fp32 operand x is split into hi = x rounded to TF32 and lo = x - hi,
// and a product is lo hi + hi lo + hi hi on mma.sync m16n8k8 TF32 with fp32
// accumulation: hi hi alone keeps about 11 bits (~5e-4 of the output), the
// two cross terms bring it to ~2^-21 (the lo lo term left out), the level
// of fp32 summation order. The softmax statistics stay fp32. What bounds it
// on the card is the work around the tensor cores, not their rate: it runs
// at about a quarter of the 3.3 ms, and the form of the split alone moves
// its time by a quarter (see tf32_rna), as every element of a fragment is
// split in registers each time a warp loads it. The design does about
// that:
// * a block owns 64 query rows (the Q tile, 132 KB of the 227 KB, stays
//   in shared memory; in registers its fragments would take 256 per
//   thread) and its 8 warps split the work 4 row groups x 2 halves of D:
//   the O accumulator (64 x 512 fp32) is 128 registers a thread, and the
//   score products run over each warp's half of D, the two partial 16 x 16
//   score tiles summed through shared memory, so that a Q fragment is
//   loaded and split once per 2 n-tiles and both halves' warps have the
//   whole row for the softmax;
// * 16-key tiles, K and V taking turns in two slots (the copy of V_j runs
//   under S_j, that of K_{j + 1} under P V_j), by cp.async;
// * every fragment comes by wide loads: the reduction index of the score
//   products is permuted (the same way in Q and K) and O's columns are
//   permuted within 32-column groups, so that one 16-byte load covers two
//   k-steps of a Q or K fragment and one 8-byte load the V fragments of two
//   n-tiles; row strides keep the loads free of bank conflicts;
// * the tensor cores' adder truncates, so no running sum lives in an mma
//   accumulator: each 16-key tile's P V and each pair of k-steps' scores
//   go into fresh fragments that are added into O and S in fp32 (kept
//   across all 1024 tiles of S = 16384, O drifted 1.3e-4 of its largest
//   magnitude from the fp32 result; now ~2e-6 from float64);
// * O is written straight from the registers: after the permutation a
//   lane holds 8 neighbouring columns of each of its rows. The kernel takes
//   255 registers a thread without a spill; the epilogue reads the block
//   index anew so that no offset stays live through the key loop.
// Weighed and not taken: wgmma, whose TF32 form reads shared-memory
// operands K-major only (V would be transposed on the way in) and B only
// from shared memory (K and V split there: twice the bytes), with Q's split
// pieces (2 x 128 KB) not fitting beside the rest.
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
  static constexpr int BK = 64;                   // rows of a streamed tile
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
  static_assert(DKV_SMEM <= 232448, "shared memory of one block");
};

// Rows [row0, row0 + R) of one head of a (B, S, H, D) fp32 tensor (row
// stride rs floats) into a tile of row stride LD, by cp.async (the caller
// commits and waits); rows >= S are zeros.
template <int R, int D, int LD = D + 4>
__device__ __forceinline__ void load_tile_async(float* dst, const float* head, int row0, int S,
                                                int rs) {
  constexpr int C = D / 4;                  // 16-byte chunks of a row
  static_assert((R * C) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * C / THREADS; ++i) {
    const unsigned c = threadIdx.x + i * THREADS;
    const int r = c / C, col = (c % C) * 4;
    const bool ok = row0 + r < S;
    sm90::cp_async16(sm90::smem_u32(dst + r * LD + col),
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

// ---------------------------------------------------------------------------
// The forward at head_dim 512 on the tensor cores, to fp32 accuracy: both
// products in 3xTF32 (see the header). Grid (ceil(Sq / 64), B * H); 8
// warps, warp w owning rows [16 (w % 4), +16) of the block's 64 and half
// w / 4 of D: its 256 columns of the score products' reduction and its 256
// columns of O. Key tiles of 16 rows; K and V take turns in two slots, so
// each tile's copy overlaps the other product.
// ---------------------------------------------------------------------------
namespace d512 {
constexpr int D = 512, BQ = 64, BK = 16;
// Row strides in floats. Q and K: 16 mod 32, so that the 16-byte fragment
// loads of a quarter warp (rows g, g + 1 at 4 c) fall in 8 bank groups; V:
// 8 mod 32 (rows c, columns 4 g); the score exchange: rows g, keys c.
constexpr int LDQ = D + 16, LDV = D + 8, LDX = BK + 4;
constexpr int Q_FLOATS = BQ * LDQ, K_FLOATS = BK * LDQ, V_FLOATS = BK * LDV;
constexpr int X_FLOATS = 2 * BQ * LDX;   // [half of D][row][key]
constexpr size_t SMEM = (size_t)(Q_FLOATS + K_FLOATS + V_FLOATS + X_FLOATS) * sizeof(float);
static_assert(SMEM <= 232448, "shared memory of one block");
}  // namespace d512

// The TF32 split x = hi + lo. hi is x rounded to TF32, to nearest with ties
// away as cvt.rna.tf32.f32 (for every finite x): add half a TF32 ulp to the
// magnitude and clear the low 13 bits, an fp32 bit pattern the tensor cores
// read exactly. lo = x - hi is exact in fp32 and goes in as it is: the
// tensor cores take the top 19 bits of a TF32 operand's register and drop
// the low 13, so lo enters the product truncated to TF32, within 2^-21 of
// x. The PTX ISA leaves the layout of .tf32 data in a .b32 register to the
// implementation, so this truncation is the hardware's behaviour, not a
// documented rule. CUTLASS's 3xTF32 warp MMA relies on it the same way:
// FastF32 in cutlass/gemm/warp/mma_tensor_op_fast_f32.h converts its small
// part with NumericConverter<tfloat32_t, float, round_half_ulp_truncate>
// (or round_half_ulp_trunc_dntz) of cutlass/numeric_conversion.h, which add
// half a TF32 ulp and leave the low 13 bits for the tensor cores to drop;
// tests/test_torch_port_cuda.py::test_f32_d512_forward_matches_float64_on_card
// holds the kernel to 1e-5 of float64 on the card. Timed on the H100 and not
// kept: hi and lo both by cvt.rna.tf32.f32 (29% slower), lo rounded by the
// integer form (8% slower, no more accurate).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 operands, fp32
// accumulation. Per lane (g = lane / 4, c = lane % 4): a = {A[g][c],
// A[g + 8][c], A[g][c + 4], A[g + 8][c + 4]}, b = {B[c][g], B[c + 4][g]},
// d = {D[g][2c], D[g][2c + 1], D[g + 8][2c], D[g + 8][2c + 1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to fp32 accuracy from the split operands: lo hi + hi lo + hi hi
// (lo lo, about 2^-22 of the product, is left out), the small terms first.
// The tensor cores truncate where they add into d, so a caller keeps d to a
// few products and adds it into its running sums in fp32 (see below).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32(d, ah, al, bh0, bh1, bl0, bl1);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_d512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  using namespace d512;
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Q_FLOATS;
  float* sV = sK + K_FLOATS;
  float* sX = sV + V_FLOATS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = 16 * (warp % 4), dh = warp / 4, d0 = 256 * dh;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int rs = H * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_tile_async<BQ, D, LDQ>(sQ, q + (size_t)b * Sq * rs + h * D, q0, Sq, rs);
  load_tile_async<BK, D, LDQ>(sK, kh, 0, Skv, rs);
  sm90::cp_async_commit();

  // O: columns d0 + 32 j + [0, 32) in n-tiles t = 0..3, logical column n of
  // n-tile t at d0 + 32 j + 4 n + t, so that a lane's elements of a row are
  // 8 neighbouring columns and a V fragment load covers 4 n-tiles
  float acc[8][4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8; m in log2 units
  const float sl2 = scale * LOG2E;
  const float* qa = sQ + (r0 + g) * LDQ + d0 + 4 * c;   // row g; row g + 8 at 8 LDQ
  const float* kb = sK + g * LDQ + d0 + 4 * c;          // key g; key g + 8 at 8 LDQ
  const float* vb = sV + c * LDV + d0 + 4 * g;          // key c, column group g
  float* xw = sX + (dh * BQ + r0) * LDX;              // this warp's partial scores
  const float* x0 = sX + r0 * LDX;                      // the two halves' partials
  const float* x1 = x0 + BQ * LDX;
  const int nk = (Skv + BK - 1) / BK;

  for (int j = 0; j < nk; ++j) {
    sm90::cp_async_wait<0>();         // K_j (and Q) landed
    __syncthreads();                  // ... for every thread; V_{j-1} is consumed
    load_tile_async<BK, D, LDV>(sV, vh, j * BK, Skv, rs);
    sm90::cp_async_commit();

    // partial S over this warp's half of D: 16 rows x 16 keys (n-tiles u =
    // keys 8 u + [0, 8)). Each 16-byte load covers two k-steps: logical k
    // = c and c + 4 of k-step e are columns 4 c + 2 e and 4 c + 2 e + 1 of
    // the 16, in Q and K alike. The two k-steps' products go into a fresh
    // fragment, added into s in fp32: summed in the tensor cores' truncating
    // adder over all 64 k-steps, s would drift by some 1e-5 of itself.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
    for (int p = 0; p < 16; ++p) {
      const float4 qg = *reinterpret_cast<const float4*>(qa + 16 * p);
      const float4 qg8 = *reinterpret_cast<const float4*>(qa + 8 * LDQ + 16 * p);
      uint32_t ah[2][4], al[2][4];
      split_tf32(qg.x, ah[0][0], al[0][0]);
      split_tf32(qg8.x, ah[0][1], al[0][1]);
      split_tf32(qg.y, ah[0][2], al[0][2]);
      split_tf32(qg8.y, ah[0][3], al[0][3]);
      split_tf32(qg.z, ah[1][0], al[1][0]);
      split_tf32(qg8.z, ah[1][1], al[1][1]);
      split_tf32(qg.w, ah[1][2], al[1][2]);
      split_tf32(qg8.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 kv = *reinterpret_cast<const float4*>(kb + 8 * u * LDQ + 16 * p);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(t, ah[0], al[0], kv.x, kv.y);
        mma_3xtf32(t, ah[1], al[1], kv.z, kv.w);
#pragma unroll
        for (int x = 0; x < 4; ++x) s[u][x] += t[x];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      xw[g * LDX + 8 * u + 2 * c] = s[u][0];
      xw[g * LDX + 8 * u + 2 * c + 1] = s[u][1];
      xw[(g + 8) * LDX + 8 * u + 2 * c] = s[u][2];
      xw[(g + 8) * LDX + 8 * u + 2 * c + 1] = s[u][3];
    }
    __syncthreads();                  // partials whole; K_j is consumed
    if (j + 1 < nk) load_tile_async<BK, D, LDQ>(sK, kh, (j + 1) * BK, Skv, rs);
    sm90::cp_async_commit();

    // S = the two halves' sum, as the A fragments of O += P V (k-step e:
    // keys 8 e + c and 8 e + c + 4; element i: row g + 8 (i % 2), key
    // 8 e + c + 4 (i / 2)), then the online softmax in log2 units. Both
    // warps of a row group compute the same m and l.
    float p[2][4], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i % 2), key = 8 * e + c + 4 * (i / 2);
        const float sv = x0[row * LDX + key] + x1[row * LDX + key];
        p[e][i] = (j * BK + key < Skv) ? sv * sl2 : NEG_INF;
        mx[i % 2] = fmaxf(mx[i % 2], p[e][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = exp2f(p[e][i] - m[i % 2]);
        l[i % 2] += x;
        split_tf32(x, ph[e][i], pl[e][i]);
      }
    sm90::cp_async_wait<1>();         // V_j landed (K_{j+1} may still be in flight)
    __syncthreads();
    // O = alpha O + P V over this warp's 256 columns, two n-tiles at a
    // time: per k-step two 8-byte loads (keys 8 e + c, 8 e + c + 4; columns
    // 32 jj + 4 g + 2 hh, + 1) give their B fragments; the tile's products
    // go into fresh fragments, added into O in fp32 (over the key tiles the
    // tensor cores' truncating adder would bias O by some 1e-4)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* vp = vb + 8 * e * LDV + 32 * jj + 2 * hh;
          const float2 v0 = *reinterpret_cast<const float2*>(vp);
          const float2 v1 = *reinterpret_cast<const float2*>(vp + 4 * LDV);
          mma_3xtf32(pv[0], ph[e], pl[e], v0.x, v1.x);
          mma_3xtf32(pv[1], ph[e], pl[e], v0.y, v1.y);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[jj][2 * hh + t][x] = fmaf(acc[jj][2 * hh + t][x], alpha[x / 2], pv[t][x]);
      }
  }

  // the epilogue's offsets come from the block index read anew: kept from
  // the start, one of them would be spilled past the key loop, where the
  // accumulators hold 128 registers a thread
  unsigned bx, by;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
  const int row0 = bx * BQ + r0 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const float safe_l = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / safe_l;
    const int row = row0 + 8 * r;
    if (dh == 0 && c == 0 && row < Sq) lse[(size_t)by * Sq + row] = m[r] * LN2 + logf(safe_l);
  }
  // a lane's row g holds columns d0 + 32 jj + 8 c + [0, 8): n-tile t's
  // elements 0 and 1 are columns 8 c + t and 8 c + 4 + t
  float* oh = o + ((size_t)(by / H) * Sq * H + by % H) * D + d0 + 8 * c;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    float* orow = oh + (size_t)row * rs;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float (&a)[4][4] = acc[jj];
      *reinterpret_cast<float4*>(orow + 32 * jj) =
          make_float4(a[0][2 * r] * inv[r], a[1][2 * r] * inv[r], a[2][2 * r] * inv[r],
                      a[3][2 * r] * inv[r]);
      *reinterpret_cast<float4*>(orow + 32 * jj + 4) =
          make_float4(a[0][2 * r + 1] * inv[r], a[1][2 * r + 1] * inv[r],
                      a[2][2 * r + 1] * inv[r], a[3][2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward at head_dim 128 on the tensor cores, to fp32 accuracy: every
// product in 3xTF32 as above. A block of 4 warps owns 32 rows of the
// stationary sequence (queries in the dQ kernel, keys in the dK/dV kernel)
// and loops over 32-row tiles of the other; warp w takes the stationary
// rows a0 = 16 (w % 2) .. + 16 and the streamed rows b0 = 16 (w / 2) .. + 16
// of each tile. Its score products (16 x 16, reduced over all of D) stay in
// registers: the accumulator of an n-tile is the A fragment of a k-step of
// the accumulating product once that product's reduction index (the
// streamed rows) is permuted to match (logical k = c and c + 4 of k-step e
// are rows 8 e + 2 c and 8 e + 2 c + 1), so no score tile goes through
// shared memory. Each warp accumulates its 16 streamed rows' share of the
// 16 x 128 output (dQ; dK and dV) and the two warps of a row group add
// theirs once, in the epilogue, in a fixed order. Every tile's accumulating
// products go into fresh fragments added into the fp32 sums, and each
// k-step's scores likewise (the tensor cores' adder truncates).
//
// Tiles are rows of 128 floats whose 16-byte chunks are permuted by row
// (swz): the score products read a row's chunks 4 p + c (rows g of a
// quarter warp), the accumulating products chunk 8 jj + g of rows 2 c and
// 2 c + 1, and both fall in 8 different bank groups. 32-row blocks give
// B * H = 4, S = 1024 128 blocks; 96.5 KB of shared memory (the stationary
// tiles, two cp.async stages of the streamed ones, the lse and delta rows)
// lets 2 blocks share a SM (registers allow no third: dQ 214, dK/dV 255 a
// thread, where dK/dV applies P to dV before it forms dP, and reads its
// fragments at per-lane offsets, to fit). What bounds it on the H100 is the
// work around the tensor cores: about 30% of the 3xTF32 bound at B * H =
// 16, S = 4096, with 8 warps a SM and the stationary operand split again
// for every tile. Also measured on the H100 (PERF.md), and slower: each
// stage's streamed tiles split into hi and lo once in shared memory (160.5
// KB, 1 block a SM; 1.2-1.7x slower), hi by truncation in place of rounding
// (and 3x further from float64); a fully unrolled score loop spills dK/dV.
// ---------------------------------------------------------------------------
namespace b128 {
constexpr int D = 128, BR = 32, THREADS = 128;
constexpr int CH = D / 4;                        // 16-byte chunks of a row
constexpr int TILE = BR * D;                     // floats of a 32-row tile
// the stationary tiles, 2 stages of the 2 streamed tiles, then lse and
// delta: of the block's rows (dQ), of each stage (dK/dV)
constexpr size_t SMEM = (size_t)(6 * TILE + 4 * BR) * sizeof(float);
static_assert(SMEM <= 232448, "shared memory of one block");
}  // namespace b128

// float offset of 16-byte chunk ch of row r
__device__ __forceinline__ int swz(int r, int ch) {
  return (r * b128::CH + (ch ^ ((r & 6) ^ ((r & 1) << 2)))) * 4;
}

// Rows [row0, row0 + 32) of one head (row stride rs floats) into a tile, by
// cp.async (the caller commits and waits); rows >= S are zeros.
__device__ __forceinline__ void load_rows32(float* tile, const float* head, int row0, int S,
                                            int rs) {
#pragma unroll
  for (int i = 0; i < b128::BR * b128::CH / b128::THREADS; ++i) {
    const unsigned c = threadIdx.x + i * b128::THREADS;
    const int r = c / b128::CH, ch = c % b128::CH;
    const bool ok = row0 + r < S;
    sm90::cp_async16(sm90::smem_u32(tile + swz(r, ch)),
                     head + (size_t)(ok ? row0 + r : 0) * rs + ch * 4, ok);
  }
}

// 4 neighbouring floats of a streamed tile at float offset off, split
struct Split4 {
  uint32_t h[4], l[4];
};
__device__ __forceinline__ Split4 load_split4(const float* tile, int off) {
  Split4 r;
  const float4 f = *reinterpret_cast<const float4*>(tile + off);
  split_tf32(f.x, r.h[0], r.l[0]);
  split_tf32(f.y, r.h[1], r.l[1]);
  split_tf32(f.z, r.h[2], r.l[2]);
  split_tf32(f.w, r.h[3], r.l[3]);
  return r;
}

// The offsets (floats) of the fragments a lane (g = lane / 4, c = lane % 4)
// reads in a tile, past its row's start, by swz: a score product reads row
// g (mod 8) at 16-column group p, chunk 4 p + c, at 32 (p / 2) + xo[p % 2];
// an accumulating product reads rows 2 c + i (mod 8) at 32-column group jj,
// chunk 8 jj + g, at 32 jj + yo[i] past row 2 c.
struct LaneOffsets {
  int xo[2], yo[2];
  __device__ __forceinline__ LaneOffsets(int g, int c) {
    const int f = (g & 6) ^ ((g & 1) << 2);
    xo[0] = 4 * (c ^ f);
    xo[1] = 4 * ((4 + c) ^ f);
    yo[0] = 4 * (g ^ (2 * c));
    yo[1] = b128::D + 4 * (g ^ (2 * c) ^ 4);
  }
};

// s[u] (16 x 8, u = 0, 1) = A[rows a0 .. a0 + 16) B[rows b0 + 8 u .. + 8)^T
// over the 128 columns: A stationary, B streamed; Ag = A + (a0 + g) D and
// Bg = B + (b0 + g) D. The reduction index is permuted alike in A and B:
// logical k = c and c + 4 of k-step e of 16-column group p are columns
// 16 p + 4 c + 2 e and + 1, so one 16-byte load covers two k-steps.
// s[u][x]: row a0 + g + 8 (x / 2), column b0 + 8 u + 2 c + x % 2.
__device__ __forceinline__ void score16(float (&s)[2][4], const float* Ag, const float* Bg,
                                        const LaneOffsets& lo) {
  constexpr int D = b128::D;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[u][x] = 0.f;
#pragma unroll 1
  for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int off = 32 * pp + lo.xo[par];
      const float4 x = *reinterpret_cast<const float4*>(Ag + off);
      const float4 x8 = *reinterpret_cast<const float4*>(Ag + 8 * D + off);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x.x, ah[0][0], al[0][0]);
      split_tf32(x8.x, ah[0][1], al[0][1]);
      split_tf32(x.y, ah[0][2], al[0][2]);
      split_tf32(x8.y, ah[0][3], al[0][3]);
      split_tf32(x.z, ah[1][0], al[1][0]);
      split_tf32(x8.z, ah[1][1], al[1][1]);
      split_tf32(x.w, ah[1][2], al[1][2]);
      split_tf32(x8.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // the two k-steps into fragments of their own: 4 independent
        // chains of 3 products a warp in place of 2 of 6
        const Split4 b = load_split4(Bg, 8 * u * D + off);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(t0, ah[0], al[0], b.h[0], b.h[1], b.l[0], b.l[1]);
        mma_3xtf32(t1, ah[1], al[1], b.h[2], b.h[3], b.l[2], b.l[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] += t0[e] + t1[e];
      }
    }
  }
}

// The A fragment index of score element x: elements 0 and 2 (columns 2 c)
// are logical k = c of rows g and g + 8, elements 1 and 3 logical k = c + 4.
__device__ __forceinline__ int a_index(int x) { return ((x & 1) << 1) | (x >> 1); }

// acc[4 jj + i] (16 x 8) += P B[rows b0 .. b0 + 16): P the two score
// fragments e = 0, 1 as the A fragments of k-steps (rows 8 e + 2 c, + 1 of
// B), split (ph, pl); Bc = B + (b0 + 2 c) D. n-tile 4 jj + i's logical
// column n is column 32 jj + 4 n + i, so that a 16-byte load gives the B
// fragments of 4 n-tiles, and a lane's elements of row g are columns
// 32 jj + 8 c + [0, 8): element 0 of n-tile 4 jj + i is column 32 jj + 8 c
// + i, element 1 column 32 jj + 8 c + 4 + i.
__device__ __forceinline__ void accumulate16(float (&acc)[16][4], const uint32_t (&ph)[2][4],
                                             const uint32_t (&pl)[2][4], const float* Bc,
                                             const LaneOffsets& lo) {
  constexpr int D = b128::D;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float f[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) f[i][x] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const Split4 r0 = load_split4(Bc, 8 * e * D + 32 * jj + lo.yo[0]);
      const Split4 r1 = load_split4(Bc, 8 * e * D + 32 * jj + lo.yo[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_3xtf32(f[i], ph[e], pl[e], r0.h[i], r1.h[i], r0.l[i], r1.l[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[4 * jj + i][x] += f[i][x];
  }
}

// Writes rows g and g + 8 of a warp's 16 x 128 sums (accumulate16's column
// order) as rows [row0, row0 + 16) of one head; rows >= S are dropped.
__device__ __forceinline__ void store16(const float (&acc)[16][4], float* head, int row0, int S,
                                        int rs, int g, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    float* out = head + (size_t)row * rs + 8 * c;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<float4*>(out + 32 * jj) =
          make_float4(acc[4 * jj][2 * i], acc[4 * jj + 1][2 * i], acc[4 * jj + 2][2 * i],
                      acc[4 * jj + 3][2 * i]);
      *reinterpret_cast<float4*>(out + 32 * jj + 4) =
          make_float4(acc[4 * jj][2 * i + 1], acc[4 * jj + 1][2 * i + 1],
                      acc[4 * jj + 2][2 * i + 1], acc[4 * jj + 3][2 * i + 1]);
    }
  }
}

// The epilogue's exchange: the warps of streamed half 1 hand their sums to
// those of half 0 through shared memory (slot: a row group's n x 4 x 32
// floats, lane-minor), which add them, so each sum is half 0's share plus
// half 1's, in that order.
__device__ __forceinline__ void hand_over(const float (&acc)[16][4], float* slot) {
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) slot[(4 * t + x) * 32] = acc[t][x];
}
__device__ __forceinline__ void take_over(float (&acc)[16][4], const float* slot) {
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] += slot[(4 * t + x) * 32];
}

// dQ, and delta = rowsum(dO * O) for the dK/dV kernel. Grid (ceil(Sq / 32),
// B * H); the key loop is inside the block.
__global__ void __launch_bounds__(b128::THREADS, 2)
flash_bwd_dq_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ o,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                             int Skv, float scale) {
  using namespace b128;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + TILE;
  float* sK = sDO + TILE;                   // 2 stages
  float* sV = sK + 2 * TILE;                // 2 stages
  float* sLse = sV + 2 * TILE;
  float* sDelta = sLse + BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int a0 = 16 * (warp & 1), b0 = 16 * (warp >> 1);
  const LaneOffsets lo(g, c);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_rows32(sQ, q + qoff, q0, Sq, rs);
  load_rows32(sDO, dout + qoff, q0, Sq, rs);
  load_rows32(sK, kh, 0, Skv, rs);
  load_rows32(sV, vh, 0, Skv, rs);
  sm90::cp_async_commit();
  {
    // delta of row r: 4 threads, 32 columns each, reduced in a fixed order
    const int r = tid / 4, u = tid % 4, row = q0 + r;
    float dl = 0.f;
    if (row < Sq) {
      const float* orow = o + qoff + (size_t)row * rs + 32 * u;
      const float* drow = dout + qoff + (size_t)row * rs + 32 * u;
#pragma unroll
      for (int x = 0; x < 32; x += 4) {
        const float4 fo = *reinterpret_cast<const float4*>(orow + x);
        const float4 fd = *reinterpret_cast<const float4*>(drow + x);
        dl += fd.x * fo.x + fd.y * fo.y + fd.z * fo.z + fd.w * fo.w;
      }
    }
    dl += __shfl_xor_sync(FULL, dl, 1);
    dl += __shfl_xor_sync(FULL, dl, 2);
    if (u == 0) {
      sDelta[r] = dl;
      sLse[r] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
      if (row < Sq) delta[(size_t)bh * Sq + row] = dl;
    }
  }
  __syncthreads();
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = sLse[a0 + g + 8 * i] * LOG2E;
    dl[i] = sDelta[a0 + g + 8 * i];
  }

  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] = 0.f;
  const float sl2 = scale * LOG2E;
  const int nk = (Skv + BR - 1) / BR;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();                        // tile j landed; tile j - 1 is consumed
    if (j + 1 < nk) {
      load_rows32(sK + (st ^ 1) * TILE, kh, (j + 1) * BR, Skv, rs);
      load_rows32(sV + (st ^ 1) * TILE, vh, (j + 1) * BR, Skv, rs);
    }
    sm90::cp_async_commit();
    const float* tK = sK + st * TILE;
    const float* tV = sV + st * TILE;

    float s[2][4], dp[2][4];
    score16(s, sQ + (a0 + g) * D, tK + (b0 + g) * D, lo);      // S = Q K^T
    score16(dp, sDO + (a0 + g) * D, tV + (b0 + g) * D, lo);    // dP = dO V^T
    // dS = P (dP - delta) scale, split, as the A fragments of dQ += dS K
    uint32_t dsh[2][4], dsl[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = x >> 1;
        const float p = (j * BR + b0 + 8 * e + 2 * c + (x & 1) < Skv)
                            ? exp2f(s[e][x] * sl2 - lse2[i]) : 0.f;
        split_tf32(p * (dp[e][x] - dl[i]) * scale, dsh[e][a_index(x)], dsl[e][a_index(x)]);
      }
    accumulate16(acc, dsh, dsl, tK + (b0 + 2 * c) * D, lo);
  }

  __syncthreads();                          // the K stages are free
  float* slot = sK + (warp & 1) * 64 * 32 + lane;
  if (warp >> 1) hand_over(acc, slot);
  __syncthreads();
  if (warp >> 1) return;
  take_over(acc, slot);
  store16(acc, dq + qoff, q0 + a0, Sq, rs, g, c);
}

// dK and dV from the saved lse and the dQ kernel's delta. Grid
// (ceil(Skv / 32), B * H); the query loop is inside the block, on
// transposed scores (rows = keys, columns = queries).
__global__ void __launch_bounds__(b128::THREADS, 2)
flash_bwd_dkv_f32_d128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                              int Skv, float scale) {
  using namespace b128;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;                    // 2 stages
  float* sDO = sQ + 2 * TILE;               // 2 stages
  float* sStats = sDO + 2 * TILE;           // [stage][lse | delta][BR]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int a0 = 16 * (warp & 1), b0 = 16 * (warp >> 1);
  const LaneOffsets lo(g, c);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * BR;
  const int rs = H * D;
  const size_t kvoff = (size_t)b * Skv * rs + h * D;
  const float* qh = q + (size_t)b * Sq * rs + h * D;
  const float* doh = dout + (size_t)b * Sq * rs + h * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;

  // query tile [row0, row0 + 32): Q, dO, lse and delta into a stage
  auto load_q_tile = [&](int stage, int row0) {
    load_rows32(sQ + stage * TILE, qh, row0, Sq, rs);
    load_rows32(sDO + stage * TILE, doh, row0, Sq, rs);
    if (tid < 2 * BR) {
      const int row = row0 + tid % BR;
      const bool ok = row < Sq;
      sm90::cp_async4(sm90::smem_u32(sStats + stage * 2 * BR + tid),
                      (tid < BR ? lse_h : delta_h) + (ok ? row : 0), ok);
    }
  };
  load_rows32(sK, k + kvoff, kv0, Skv, rs);
  load_rows32(sV, v + kvoff, kv0, Skv, rs);
  load_q_tile(0, 0);
  sm90::cp_async_commit();

  float acc_dk[16][4], acc_dv[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc_dk[t][x] = acc_dv[t][x] = 0.f;
  const float sl2 = scale * LOG2E;
  const int nq = (Sq + BR - 1) / BR;

  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();                        // tile j landed; tile j - 1 is consumed
    if (j + 1 < nq) load_q_tile(st ^ 1, (j + 1) * BR);
    sm90::cp_async_commit();
    const float* tQ = sQ + st * TILE;
    const float* tDO = sDO + st * TILE;
    const float* sl = sStats + st * 2 * BR;   // lse, then delta of the tile's queries

    // S^T = K Q^T; P^T, 0 for queries >= Sq (their Q rows and lse are
    // zeros), split as A fragments; dV += P^T dO
    float p[2][4];
    uint32_t ah[2][4], al[2][4];
    score16(p, sK + (a0 + g) * D, tQ + (b0 + g) * D, lo);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = b0 + 8 * e + 2 * c + (x & 1);
        p[e][x] = (j * BR + col < Sq) ? exp2f(p[e][x] * sl2 - sl[col] * LOG2E) : 0.f;
        split_tf32(p[e][x], ah[e][a_index(x)], al[e][a_index(x)]);
      }
    accumulate16(acc_dv, ah, al, tDO + (b0 + 2 * c) * D, lo);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta) scale; dK += dS^T Q
    float dp[2][4];
    score16(dp, sV + (a0 + g) * D, tDO + (b0 + g) * D, lo);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = b0 + 8 * e + 2 * c + (x & 1);
        split_tf32(p[e][x] * (dp[e][x] - sl[BR + col]) * scale, ah[e][a_index(x)],
                   al[e][a_index(x)]);
      }
    accumulate16(acc_dk, ah, al, tQ + (b0 + 2 * c) * D, lo);
  }

  __syncthreads();                          // the Q stages are free
  float* slot = sQ + (warp & 1) * 128 * 32 + lane;
  if (warp >> 1) {
    hand_over(acc_dk, slot);
    hand_over(acc_dv, slot + 64 * 32);
  }
  __syncthreads();
  if (warp >> 1) return;
  take_over(acc_dk, slot);
  take_over(acc_dv, slot + 64 * 32);
  store16(acc_dk, dk + kvoff, kv0 + a0, Skv, rs, g, c);
  store16(acc_dv, dv + kvoff, kv0 + a0, Skv, rs, g, c);
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

int fwd_d512(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Sq, int Skv, float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_f32_d512_kernel, d512::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + d512::BQ - 1) / d512::BQ, B * H);
  flash_fwd_f32_d512_kernel<<<grid, THREADS, d512::SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

int bwd_dq_d128(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
                float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
        aligned16(dq)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_bwd_dq_f32_d128_kernel, b128::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + b128::BR - 1) / b128::BR, B * H);
  flash_bwd_dq_f32_d128_kernel<<<grid, b128::THREADS, b128::SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      lse, delta, (float*)dq, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

int bwd_dkv_d128(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Sq,
                 int Skv, float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dk) &&
        aligned16(dv)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_bwd_dkv_f32_d128_kernel, b128::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + b128::BR - 1) / b128::BR, B * H);
  flash_bwd_dkv_f32_d128_kernel<<<grid, b128::THREADS, b128::SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, Sq, Skv, scale);
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
  return fwd_d512(q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
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
  return bwd_dq_d128(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dkv_f32_d128(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dk, void* dv, int B, int H, int Sq, int Skv,
                                  float scale, void* stream) {
  return bwd_dkv_d128(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, stream);
}

}  // extern "C"
