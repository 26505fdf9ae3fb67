// Flash attention for fp32 inputs, to fp32 accuracy, on the tensor cores:
// no operand is rounded to bf16 (the bf16 kernels of flash_attention_sm90.cu
// take bf16 only). Each kernel computes what a Pallas TPU kernel of
// aozora_sdxl_training_tpu/ops/flash_attention.py computes when its
// operands are fp32 (the Pallas bodies multiply in the operands' own
// dtype):
//
//   flash_fwd_3xtf32_kernel<D>      <- _fwd_kernel (_flash_forward at 64,
//                                      _flash_forward_folded at 128)
//   flash_bwd_dq_3xtf32_kernel<D>   <- _bwd_dq_kernel (_flash_backward at 64,
//                                      _flash_backward_folded's dq call at 128)
//   flash_bwd_dkv_3xtf32_kernel<D>  <- _bwd_dkv_kernel (the dk/dv call of
//                                      either)
//   flash_fwd_f32_d512_kernel       <- _fwd_kernel (_flash_forward_folded) at D = 512
//
// D = 64 (the SDXL UNet's head dim) or 128 (the Anima DiT's). The last is
// the SD-VAE decoder's mid-attention in the preview (one head of 512 over
// 16384 tokens at 1024px), forward only: no caller differentiates there.
// All: exact attention with an online softmax over key tiles, fp32
// statistics, keys >= Skv masked to -1e30, l clamped at 1e-30, the backward
// recomputing P from the saved row logsumexp, delta = rowsum(dO * O)
// written by the dQ kernel and read by the dK/dV kernel. No atomics: the
// sums over the other sequence run inside a block, and the row reductions
// over lanes and warps in a fixed order, so results are bitwise the same
// from run to run.
//
// Layout (the callers'): q, o, dout, dq contiguous fp32 (B, Sq, H, D); k,
// v, dk, dv contiguous fp32 (B, Skv, H, D); lse and delta contiguous fp32
// (B * H, Sq).
//
// One design, 3xTF32 on mma.sync m16n8k8. Each fp32 operand x is split
// into hi = x rounded to TF32 and lo = x - hi, and a product is lo hi +
// hi lo + hi hi with fp32 accumulation: hi hi alone keeps about 11 bits
// (~5e-4 of the output), the two cross terms bring it to ~2^-21 (the lo lo
// term left out), the level of fp32 summation order. The softmax
// statistics stay fp32. Counted as three TF32 products at 495 TFLOP/s, the
// 4, 6 and 8 * Sq * Skv * D flop per head of the forward, dQ and dK/dV
// bound every kernel by operations (as fp32 FMAs at 67 TFLOP/s they would
// take 2.5x as long). What bounds them on the H100 is the work around the
// tensor cores, not their rate: every element of a fragment is split in
// registers each time a warp loads it, and the form of the split alone
// moves a kernel's time by a quarter (see tf32_rna). Common to all:
// * the tensor cores' adder truncates, so no running sum lives in an mma
//   accumulator: each tile's accumulating products and each k-step's (or
//   pair of k-steps') scores go into fresh fragments that are added into
//   the sums in fp32 (kept across all 1024 tiles of S = 16384, O drifted
//   1.3e-4 of its largest magnitude from the fp32 result; now ~2e-6 from
//   float64);
// * scores stay in registers: the accumulator of a score n-tile is the A
//   fragment of a k-step of the next product once that product's reduction
//   index is permuted to match, and outputs are written straight from the
//   registers;
// * every fragment comes by wide loads from tiles laid out so that a
//   quarter warp's loads fall in 8 different bank groups (a padded row
//   stride at 512, a swizzle at 64 and 128).
// Weighed and not taken: wgmma, whose TF32 form reads shared-memory
// operands K-major only (V would be transposed on the way in) and B only
// from shared memory (K and V split there: twice the bytes; splitting the
// streamed tiles once in shared memory made the backward at 128 1.2-1.7x
// slower, PERF.md). Each kernel's design is at it.
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C functions at the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"   // cp.async, the host side of a launch

namespace {

using sm90::aligned16;
using sm90::allow_smem;
using sm90::attributes;

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

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
// tests/test_torch_port_cuda.py::test_f32_forward_matches_float64_on_card
// holds the kernels to 1e-5 of float64 on the card. Timed on the H100 and not
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

// ---------------------------------------------------------------------------
// The forward at head_dim 512. Its 4 * S^2 * 512 flop (5.5e11 at S =
// 16384) take 8.2 ms at the fp32 FMA peak, where a CUDA-core kernel took
// 23.6 ms on the H100; as three TF32 products they take 3.3 ms, and the
// kernel runs at about a quarter of that. Grid (ceil(Sq / 64), B * H):
// * a block owns 64 query rows (the Q tile, 132 KB of the 227 KB, stays
//   in shared memory; in registers its fragments would take 256 per
//   thread) and its 8 warps split the work 4 row groups x 2 halves of D
//   (warp w: rows [16 (w % 4), +16), half w / 4): the O accumulator (64 x
//   512 fp32) is 128 registers a thread, and the score products run over
//   each warp's half of D, the two partial 16 x 16 score tiles summed
//   through shared memory, so that a Q fragment is loaded and split once
//   per 2 n-tiles and both halves' warps have the whole row for the
//   softmax;
// * 16-key tiles, K and V taking turns in two slots (the copy of V_j runs
//   under S_j, that of K_{j + 1} under P V_j), by cp.async;
// * the reduction index of the score products is permuted (the same way
//   in Q and K) and O's columns are permuted within 32-column groups, so
//   that one 16-byte load covers two k-steps of a Q or K fragment and one
//   8-byte load the V fragments of two n-tiles; row strides keep the loads
//   free of bank conflicts;
// * O is written straight from the registers: after the permutation a
//   lane holds 8 neighbouring columns of each of its rows. The kernel takes
//   255 registers a thread without a spill; the epilogue reads the block
//   index anew so that no offset stays live through the key loop.
// Weighed and not taken here: wgmma, with Q's split pieces (2 x 128 KB)
// not fitting beside the rest.
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

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_d512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  using namespace d512;
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
// The kernels at head_dim 64 and 128. Every tile holds rows of D floats
// whose 16-byte chunks are permuted by row (swz). A warp forms 16 x 16
// score tiles (score16: 16 rows of the stationary sequence against 16 of
// the streamed one, reduced over all of D), keeps them in registers as the
// A fragments of the accumulating product (accumulate16: a 16 x D sum over
// those 16 streamed rows), and writes its sums straight from the registers
// (store16).
//
// The backward: a block of 4 warps owns 32 rows of the stationary sequence
// (queries in the dQ kernel, keys in the dK/dV kernel) and loops over
// 32-row tiles of the other, in two cp.async stages; warp w takes the
// stationary rows a0 = 16 (w % 2) .. + 16 and the streamed rows b0 =
// 16 (w / 2) .. + 16 of each tile. Each warp accumulates its 16 streamed
// rows' share of the 16 x D output (dQ; dK and dV) and the two warps of a
// row group add theirs once, in the epilogue, in a fixed order. 32-row
// blocks give B * H = 4, S = 1024 128 blocks. At D = 128 the stationary
// tiles, the two stages and the lse and delta rows take 96.5 KB and 2
// blocks share a SM (registers allow no third: dQ 214, dK/dV 255 a thread,
// where dK/dV applies P to dV before it forms dP, and reads its fragments
// at per-lane offsets, to fit); at D = 64 they take 48.5 KB, and dQ (159
// registers) runs 3 blocks a SM, dK/dV (187) 2. What bounds it on the H100
// is the work around the tensor cores: about 30% of the 3xTF32 bound at
// full width, with the stationary operand split again for every tile.
// Also measured on the H100 (PERF.md), and slower: at D = 128 each stage's
// streamed tiles split into hi and lo once in shared memory (160.5 KB, 1
// block a SM; 1.2-1.7x slower), hi by truncation in place of rounding (and
// 3x further from float64); at D = 64 dK/dV held to 168 registers for 3
// blocks a SM (12% slower at B * H = 4, S = 1024, 2% faster at B * H = 10,
// S = 4096). A fully unrolled score loop spills dK/dV at D = 128.
//
// The forward: a block of 8 warps owns 32 query rows and loops over 64-key
// tiles of K and V in two cp.async stages; warp w takes the query rows
// a0 = 16 (w % 2) .. + 16 and the keys b0 = 16 (w / 2) .. + 16 of each
// tile, with an online softmax of its own (m, l and O over its quarter of
// the keys, m and l quad-reduced in a fixed order), and the four quarters
// of a row group are merged once, in the epilogue, in a fixed order. So
// B * H = 4, S = 1024 gives 128 blocks of 8 warps, where 64-row blocks
// would leave half the SMs idle, and each K and V element is loaded and
// split by two warps. Q stays in shared memory (its split fragments in
// registers would take 128 a thread at D = 128, beside O's 64) and is
// split again on every key tile. At D = 128 a thread takes 216 registers
// (1 block a SM); at D = 64 the launch bounds hold it to 128 (153 free),
// so 2 blocks share a SM: 11% faster at B * H = 10, S = 4096, 2% slower at
// B * H = 4, S = 1024, where the grid fills 128 SMs once. It runs at ~25%
// of the 3xTF32 bound. Also measured on the H100 (PERF.md), and slower: Q
// split once into hi and lo planes in shared memory (6-9%; the loads that
// score16 gains cost more than the splits it saves), and P V in 8 chains
// of 3 products in place of 4 of 6 (3-5%; 243 registers at D = 128).
// ---------------------------------------------------------------------------
template <int D>
struct Tc {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int NT = D / 8;                 // n-tiles of a warp's 16 x D sums
  static constexpr int BR = 32;                    // backward: rows of a tile
  static constexpr int BWD_THREADS = 128;
  static constexpr int TILE = BR * D;              // floats of a backward tile
  // the stationary tiles, 2 stages of the 2 streamed tiles, then lse and
  // delta: of the block's rows (dQ), of each stage (dK/dV)
  static constexpr size_t BWD_SMEM = (size_t)(6 * TILE + 4 * BR) * sizeof(float);
  static constexpr int BQ = 32, BK = 64;           // forward: query rows, keys of a tile
  static constexpr size_t FWD_SMEM = (size_t)(BQ + 4 * BK) * D * sizeof(float);
  static_assert(BWD_SMEM <= 232448 && FWD_SMEM <= 232448, "shared memory of one block");
};

// float offset of 16-byte chunk ch of row r: the chunk is permuted within
// its group of 8 by row, so that the score products' loads (chunk 4 p + c
// of rows g) and the accumulating products' (chunk 8 jj + g of rows 2 c and
// 2 c + 1) fall in 8 different bank groups. A row is 32 (D = 128) or 16
// (D = 64) chunks, a multiple of the 8 bank groups, so a chunk's bank group
// is its index mod 8 at either D and the same permutation serves both.
template <int D>
__device__ __forceinline__ int swz(int r, int ch) {
  return (r * (D / 4) + (ch ^ ((r & 6) ^ ((r & 1) << 2)))) * 4;
}

// Rows [row0, row0 + R) of one head (row stride rs floats) into a tile, by
// cp.async from NTH threads (the caller commits and waits); rows >= S are
// zeros.
template <int D, int R, int NTH>
__device__ __forceinline__ void load_rows(float* tile, const float* head, int row0, int S,
                                          int rs) {
  constexpr int CH = D / 4;
  static_assert(R * CH % NTH == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / NTH; ++i) {
    const unsigned c = threadIdx.x + i * NTH;
    const int r = c / CH, ch = c % CH;
    const bool ok = row0 + r < S;
    sm90::cp_async16(sm90::smem_u32(tile + swz<D>(r, ch)),
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
template <int D>
struct LaneOffsets {
  int xo[2], yo[2];
  __device__ __forceinline__ LaneOffsets(int g, int c) {
    const int f = (g & 6) ^ ((g & 1) << 2);
    xo[0] = 4 * (c ^ f);
    xo[1] = 4 * ((4 + c) ^ f);
    yo[0] = 4 * (g ^ (2 * c));
    yo[1] = D + 4 * (g ^ (2 * c) ^ 4);
  }
};

// s[u] (16 x 8, u = 0, 1) = A[rows a0 .. a0 + 16) B[rows b0 + 8 u .. + 8)^T
// over the D columns: A stationary, B streamed; Ag = A + (a0 + g) D and
// Bg = B + (b0 + g) D. The reduction index is permuted alike in A and B:
// logical k = c and c + 4 of k-step e of 16-column group p are columns
// 16 p + 4 c + 2 e and + 1, so one 16-byte load covers two k-steps.
// s[u][x]: row a0 + g + 8 (x / 2), column b0 + 8 u + 2 c + x % 2.
template <int D>
__device__ __forceinline__ void score16(float (&s)[2][4], const float* Ag, const float* Bg,
                                        const LaneOffsets<D>& lo) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[u][x] = 0.f;
#pragma unroll 1
  for (int pp = 0; pp < D / 32; ++pp) {
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
// + i, element 1 column 32 jj + 8 c + 4 + i. With RESCALE, acc = acc alpha
// + P B, alpha0 for row g and alpha1 for row g + 8 (the forward's online
// softmax).
template <int D, bool RESCALE = false>
__device__ __forceinline__ void accumulate16(float (&acc)[D / 8][4], const uint32_t (&ph)[2][4],
                                             const uint32_t (&pl)[2][4], const float* Bc,
                                             const LaneOffsets<D>& lo, float alpha0 = 1.f,
                                             float alpha1 = 1.f) {
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj) {
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
      for (int x = 0; x < 4; ++x) {
        float& a = acc[4 * jj + i][x];
        a = RESCALE ? fmaf(a, x < 2 ? alpha0 : alpha1, f[i][x]) : a + f[i][x];
      }
  }
}

// Writes rows g and g + 8 of a warp's 16 x D sums (accumulate16's column
// order) as rows [row0, row0 + 16) of one head; rows >= S are dropped.
template <int D>
__device__ __forceinline__ void store16(const float (&acc)[D / 8][4], float* head, int row0,
                                        int S, int rs, int g, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    float* out = head + (size_t)row * rs + 8 * c;
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj) {
      *reinterpret_cast<float4*>(out + 32 * jj) =
          make_float4(acc[4 * jj][2 * i], acc[4 * jj + 1][2 * i], acc[4 * jj + 2][2 * i],
                      acc[4 * jj + 3][2 * i]);
      *reinterpret_cast<float4*>(out + 32 * jj + 4) =
          make_float4(acc[4 * jj][2 * i + 1], acc[4 * jj + 1][2 * i + 1],
                      acc[4 * jj + 2][2 * i + 1], acc[4 * jj + 3][2 * i + 1]);
    }
  }
}

// The epilogues' exchange of a warp's sums through shared memory (slot: n x
// 4 x 32 floats, lane-minor, read back by the same lane of another warp).
template <int N>
__device__ __forceinline__ void hand_over(const float (&acc)[N][4], float* slot) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) slot[(4 * t + x) * 32] = acc[t][x];
}
template <int N>
__device__ __forceinline__ void take_over(float (&acc)[N][4], const float* slot) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] += slot[(4 * t + x) * 32];
}

// ---------------------------------------------------------------------------
// Forward. Grid (ceil(Sq / 32), B * H); the key loop is inside the block.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  using C = Tc<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * D;                  // 2 stages
  float* sV = sK + 2 * BK * D;              // 2 stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int a0 = 16 * (warp & 1), quarter = warp >> 1, b0 = 16 * quarter;
  const LaneOffsets<D> lo(g, c);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_rows<D, BQ, THREADS>(sQ, q + qoff, q0, Sq, rs);
  load_rows<D, BK, THREADS>(sK, kh, 0, Skv, rs);
  load_rows<D, BK, THREADS>(sV, vh, 0, Skv, rs);
  sm90::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8; m in log2 units
  const float sl2 = scale * LOG2E;
  const float* Ag = sQ + (a0 + g) * D;
  const int nk = (Skv + BK - 1) / BK;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();                        // tile j landed; tile j - 1 is consumed
    if (j + 1 < nk) {
      load_rows<D, BK, THREADS>(sK + (st ^ 1) * BK * D, kh, (j + 1) * BK, Skv, rs);
      load_rows<D, BK, THREADS>(sV + (st ^ 1) * BK * D, vh, (j + 1) * BK, Skv, rs);
    }
    sm90::cp_async_commit();
    const float* tK = sK + st * BK * D;
    const float* tV = sV + st * BK * D;

    // S = Q K^T over this warp's 16 keys, then the online softmax of rows
    // g and g + 8 (the 4 lanes of a quad hold a row's 16 scores). Keys >=
    // Skv are -1e30: a warp whose keys are all past Skv keeps m at -1e30
    // and its O at zero (V's rows there are zeros), and weighs nothing in
    // the merge.
    float s[2][4], mx[2] = {m[0], m[1]};
    score16<D>(s, Ag, tK + (b0 + g) * D, lo);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int key = j * BK + b0 + 8 * e + 2 * c + (x & 1);
        s[e][x] = key < Skv ? s[e][x] * sl2 : NEG_INF;
        mx[x >> 1] = fmaxf(mx[x >> 1], s[e][x]);
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
    // P, split, as the A fragments of O = alpha O + P V
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = exp2f(s[e][x] - m[x >> 1]);
        l[x >> 1] += p;
        split_tf32(p, ph[e][a_index(x)], pl[e][a_index(x)]);
      }
    accumulate16<D, true>(acc, ph, pl, tV + (b0 + 2 * c) * D, lo, alpha[0], alpha[1]);
  }

  // the four quarters of a row group: quarters 1-3 hand (O, m, l) to
  // quarter 0 through the stages, which adds them in that order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  constexpr int XS = (4 * NT + 4) * 32;     // floats of a warp's slot
  static_assert(6 * XS <= 4 * BK * D, "the exchange fits in the stages");
  float* xs = sK + 3 * (warp & 1) * XS + lane;
  __syncthreads();                          // every warp is done with the stages
  if (quarter > 0) {
    float* slot = xs + (quarter - 1) * XS;
    hand_over(acc, slot);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      slot[(4 * NT + r) * 32] = m[r];
      slot[(4 * NT + 2 + r) * 32] = l[r];
    }
  }
  __syncthreads();
  if (quarter > 0) return;
  float mt[2] = {m[0], m[1]};
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int r = 0; r < 2; ++r) mt[r] = fmaxf(mt[r], xs[w * XS + (4 * NT + r) * 32]);
  float wt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    wt[r] = exp2f(m[r] - mt[r]);
    l[r] *= wt[r];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] *= wt[x >> 1];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const float* slot = xs + w * XS;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wt[r] = exp2f(slot[(4 * NT + r) * 32] - mt[r]);
      l[r] = fmaf(slot[(4 * NT + 2 + r) * 32], wt[r], l[r]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[t][x] = fmaf(slot[(4 * t + x) * 32], wt[x >> 1], acc[t][x]);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float safe_l = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / safe_l;
    const int row = q0 + a0 + g + 8 * r;
    if (c == 0 && row < Sq) lse[(size_t)bh * Sq + row] = mt[r] * LN2 + logf(safe_l);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] *= inv[x >> 1];
  store16<D>(acc, o + qoff, q0 + a0, Sq, rs, g, c);
}

// ---------------------------------------------------------------------------
// dQ, and delta = rowsum(dO * O) for the dK/dV kernel. Grid (ceil(Sq / 32),
// B * H); the key loop is inside the block.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Tc<D>::BWD_THREADS, 2)
flash_bwd_dq_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ o,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                           int Skv, float scale) {
  using C = Tc<D>;
  constexpr int BR = C::BR, TILE = C::TILE, NTH = C::BWD_THREADS;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + TILE;
  float* sK = sDO + TILE;                   // 2 stages
  float* sV = sK + 2 * TILE;                // 2 stages
  float* sLse = sV + 2 * TILE;
  float* sDelta = sLse + BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int a0 = 16 * (warp & 1), b0 = 16 * (warp >> 1);
  const LaneOffsets<D> lo(g, c);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const float* kh = k + (size_t)b * Skv * rs + h * D;
  const float* vh = v + (size_t)b * Skv * rs + h * D;

  load_rows<D, BR, NTH>(sQ, q + qoff, q0, Sq, rs);
  load_rows<D, BR, NTH>(sDO, dout + qoff, q0, Sq, rs);
  load_rows<D, BR, NTH>(sK, kh, 0, Skv, rs);
  load_rows<D, BR, NTH>(sV, vh, 0, Skv, rs);
  sm90::cp_async_commit();
  {
    // delta of row r: 4 threads, D / 4 columns each, reduced in a fixed order
    const int r = tid / 4, u = tid % 4, row = q0 + r;
    float dl = 0.f;
    if (row < Sq) {
      const float* orow = o + qoff + (size_t)row * rs + (D / 4) * u;
      const float* drow = dout + qoff + (size_t)row * rs + (D / 4) * u;
#pragma unroll
      for (int x = 0; x < D / 4; x += 4) {
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

  float acc[C::NT][4];
#pragma unroll
  for (int t = 0; t < C::NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[t][x] = 0.f;
  const float sl2 = scale * LOG2E;
  const int nk = (Skv + BR - 1) / BR;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();                        // tile j landed; tile j - 1 is consumed
    if (j + 1 < nk) {
      load_rows<D, BR, NTH>(sK + (st ^ 1) * TILE, kh, (j + 1) * BR, Skv, rs);
      load_rows<D, BR, NTH>(sV + (st ^ 1) * TILE, vh, (j + 1) * BR, Skv, rs);
    }
    sm90::cp_async_commit();
    const float* tK = sK + st * TILE;
    const float* tV = sV + st * TILE;

    float s[2][4], dp[2][4];
    score16<D>(s, sQ + (a0 + g) * D, tK + (b0 + g) * D, lo);      // S = Q K^T
    score16<D>(dp, sDO + (a0 + g) * D, tV + (b0 + g) * D, lo);    // dP = dO V^T
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
    accumulate16<D>(acc, dsh, dsl, tK + (b0 + 2 * c) * D, lo);
  }

  // the two streamed halves: half 1 hands its sums to half 0 through the K
  // stages, which adds them
  __syncthreads();                          // the K stages are free
  float* slot = sK + (warp & 1) * 4 * C::NT * 32 + lane;
  if (warp >> 1) hand_over(acc, slot);
  __syncthreads();
  if (warp >> 1) return;
  take_over(acc, slot);
  store16<D>(acc, dq + qoff, q0 + a0, Sq, rs, g, c);
}

// ---------------------------------------------------------------------------
// dK and dV from the saved lse and the dQ kernel's delta. Grid
// (ceil(Skv / 32), B * H); the query loop is inside the block, on
// transposed scores (rows = keys, columns = queries).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Tc<D>::BWD_THREADS, 2)
flash_bwd_dkv_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                            int Skv, float scale) {
  using C = Tc<D>;
  constexpr int BR = C::BR, TILE = C::TILE, NTH = C::BWD_THREADS;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;                    // 2 stages
  float* sDO = sQ + 2 * TILE;               // 2 stages
  float* sStats = sDO + 2 * TILE;           // [stage][lse | delta][BR]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int a0 = 16 * (warp & 1), b0 = 16 * (warp >> 1);
  const LaneOffsets<D> lo(g, c);
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
    load_rows<D, BR, NTH>(sQ + stage * TILE, qh, row0, Sq, rs);
    load_rows<D, BR, NTH>(sDO + stage * TILE, doh, row0, Sq, rs);
    if (tid < 2 * BR) {
      const int row = row0 + tid % BR;
      const bool ok = row < Sq;
      sm90::cp_async4(sm90::smem_u32(sStats + stage * 2 * BR + tid),
                      (tid < BR ? lse_h : delta_h) + (ok ? row : 0), ok);
    }
  };
  load_rows<D, BR, NTH>(sK, k + kvoff, kv0, Skv, rs);
  load_rows<D, BR, NTH>(sV, v + kvoff, kv0, Skv, rs);
  load_q_tile(0, 0);
  sm90::cp_async_commit();

  float acc_dk[C::NT][4], acc_dv[C::NT][4];
#pragma unroll
  for (int t = 0; t < C::NT; ++t)
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
    score16<D>(p, sK + (a0 + g) * D, tQ + (b0 + g) * D, lo);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = b0 + 8 * e + 2 * c + (x & 1);
        p[e][x] = (j * BR + col < Sq) ? exp2f(p[e][x] * sl2 - sl[col] * LOG2E) : 0.f;
        split_tf32(p[e][x], ah[e][a_index(x)], al[e][a_index(x)]);
      }
    accumulate16<D>(acc_dv, ah, al, tDO + (b0 + 2 * c) * D, lo);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta) scale; dK += dS^T Q
    float dp[2][4];
    score16<D>(dp, sV + (a0 + g) * D, tDO + (b0 + g) * D, lo);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = b0 + 8 * e + 2 * c + (x & 1);
        split_tf32(p[e][x] * (dp[e][x] - sl[BR + col]) * scale, ah[e][a_index(x)],
                   al[e][a_index(x)]);
      }
    accumulate16<D>(acc_dk, ah, al, tQ + (b0 + 2 * c) * D, lo);
  }

  // as in the dQ kernel, through the Q stages
  __syncthreads();                          // the Q stages are free
  float* slot = sQ + (warp & 1) * 8 * C::NT * 32 + lane;
  if (warp >> 1) {
    hand_over(acc_dk, slot);
    hand_over(acc_dv, slot + 4 * C::NT * 32);
  }
  __syncthreads();
  if (warp >> 1) return;
  take_over(acc_dk, slot);
  take_over(acc_dv, slot + 4 * C::NT * 32);
  store16<D>(acc_dk, dk + kvoff, kv0 + a0, Skv, rs, g, c);
  store16<D>(acc_dv, dv + kvoff, kv0 + a0, Skv, rs, g, c);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
        int Skv, float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_3xtf32_kernel<D>, Tc<D>::FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + Tc<D>::BQ - 1) / Tc<D>::BQ, B * H);
  flash_fwd_3xtf32_kernel<D><<<grid, THREADS, Tc<D>::FWD_SMEM, (cudaStream_t)stream>>>(
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

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
           float scale, void* stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
        aligned16(dq)))
    return (int)cudaErrorInvalidValue;
  using C = Tc<D>;
  cudaError_t e = allow_smem(flash_bwd_dq_3xtf32_kernel<D>, C::BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + C::BR - 1) / C::BR, B * H);
  flash_bwd_dq_3xtf32_kernel<D><<<grid, C::BWD_THREADS, C::BWD_SMEM, (cudaStream_t)stream>>>(
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
  using C = Tc<D>;
  cudaError_t e = allow_smem(flash_bwd_dkv_3xtf32_kernel<D>, C::BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + C::BR - 1) / C::BR, B * H);
  flash_bwd_dkv_3xtf32_kernel<D><<<grid, C::BWD_THREADS, C::BWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <int D>
int attributes_of(int kernel, int* out) {
  using C = Tc<D>;
  if (kernel == 0) return attributes(flash_fwd_3xtf32_kernel<D>, THREADS, C::FWD_SMEM, out);
  if (kernel == 1)
    return attributes(flash_bwd_dq_3xtf32_kernel<D>, C::BWD_THREADS, C::BWD_SMEM, out);
  if (kernel == 2)
    return attributes(flash_bwd_dkv_3xtf32_kernel<D>, C::BWD_THREADS, C::BWD_SMEM, out);
  return (int)cudaErrorInvalidValue;
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
  return bwd_dq<128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dkv_f32_d128(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dk, void* dv, int B, int H, int Sq, int Skv,
                                  float scale, void* stream) {
  return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, stream);
}

// kernel: 0 forward, 1 dQ, 2 dK/dV; head_dim 64 or 128 (512: the forward
// only); out: 5 ints (see attributes() in sm90_wgmma.cuh).
int aozora_flash_fp32_attributes(int kernel, int head_dim, int* out) {
  if (head_dim == 64) return attributes_of<64>(kernel, out);
  if (head_dim == 128) return attributes_of<128>(kernel, out);
  if (head_dim == 512 && kernel == 0)
    return attributes(flash_fwd_f32_d512_kernel, THREADS, d512::SMEM, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
