// Flash attention for Hopper (sm_90a), built on wgmma: every bf16 and fp16
// kernel. At head_dim 64 (the SDXL UNet) the forward K1 and the backward's
// dQ and dK/dV kernels K2/K3; at 128 (the Anima DiT) the forward K4a and the
// backward K4b; at 512 (the SD-VAE mid-attention) the forward K4a (bf16
// only: no fp16 path reaches head_dim 512).
//
// They replace the Pallas TPU kernels of
// aozora_sdxl_training_tpu/ops/flash_attention.py:
//
//   flash_fwd_sm90_kernel<T, 64>       <- _flash_forward (body _fwd_kernel)
//   flash_bwd_dq_sm90_kernel<T, 64>    <- _flash_backward, dq pallas_call (_bwd_dq_kernel)
//   flash_bwd_dkv_sm90_kernel<T, 64>   <- _flash_backward, dk/dv pallas_call (_bwd_dkv_kernel)
//   flash_fwd_sm90_kernel<T, 128>      <- _flash_forward_folded (body _fwd_kernel)
//   flash_bwd_dq_sm90_kernel<T, 128>   <- _flash_backward_folded, dq pallas_call
//   flash_bwd_dkv_sm90_kernel<T, 128>  <- _flash_backward_folded, dk/dv pallas_call
//   flash_fwd_d512_sm90_kernel         <- _flash_forward_folded at head_dim 512
//
// T is the element type, bf16 or fp16 (sm90::Elem): each template is built
// for both, with the same tiles, warpgroups and shared memory. The Pallas
// kernels are generic in the dtype the same way: the scores, statistics and
// accumulators in fp32, P and dS rounded to the input dtype before each
// product. In fp16 that rounding keeps 11 significant bits against bf16's
// 8, and takes dS below fp16's subnormal range (6e-8) to 0, as the Pallas
// kernels' casts do; an output past 65504 becomes inf, as theirs does.
//
// and compute what those compute: exact attention with an online softmax
// over KV tiles, fp32 statistics and accumulators, keys >= Skv masked to
// -1e30, l clamped at 1e-30, the backward recomputing P from the saved row
// logsumexp, delta = rowsum(dO * O) computed by the dQ kernel and read by
// the dK/dV kernel (so a caller may pass a global (out, lse) with a shard
// of the keys, as ring attention does). No atomics: dQ is reduced over key
// tiles inside a block of the dQ kernel, dK and dV over query tiles inside
// a block of the dK/dV kernel, so the results are bitwise the same from run
// to run.
//
// Layout (the callers'): q, o, dout, dq are (B, Sq, H, D); k, v, dk, dv
// are (B, Skv, H, D), all contiguous bf16 or all fp16, row stride H * D;
// lse and delta are contiguous fp32 (B * H, Sq). fp32 inputs never come
// here: they go to the fp32 kernels of flash_attention_fp32.cu.
//
// What bounds them: at the SDXL shapes (B * H = 10, S = 4096 and
// B * H = 20, S = 1024, D = 64), the Anima shape (B * H = 16, S = 4096,
// D = 128) and the SD-VAE one (B * H = 1, S = 16384, D = 512) 4, 6 and
// 8 * S^2 * D flop per head against 2 * S * D bytes per operand, so the
// tensor cores. The design, per block of WG consumer warpgroups (two at
// head_dim 128, one at 64), each owning a 64-row tile of the block's
// stationary rows (the head_dim-512 forward has its own kernel, below: a
// 64-row fp32 O does not fit one warpgroup's registers there):
//
// * Every product is a wgmma on a 64-row tile in T with fp32
//   accumulation: S = Q K^T and O += P V (forward); S, dP = dO V^T and
//   dQ += dS K (dQ); S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and
//   dK += dS^T Q (dK/dV). The score products read both operands from
//   shared memory (K-major, D / 16 k-steps); the accumulating products
//   (m64nDk16) read P, dS, P^T, dS^T from registers, converted from the
//   score accumulator in place (sm90_wgmma.cuh), and B from shared memory
//   MN-major. No score tile goes to shared memory.
// * Accumulators stay in registers: O with the online softmax's m and l
//   and its rescale (the row max and sum reduce over the 4 lanes of a
//   row; l is kept per lane and reduced once at the end), dQ, dK and dV.
// * The streamed tiles (K and V; Q, dO, lse and delta in the dK/dV
//   kernel) come into a ring of two stages by cp.async into the swizzled
//   layout: the copy of tile j + 1 is issued before the products on tile
//   j and overlaps them. The stationary tiles (Q; Q and dO; K and V) are
//   loaded once.
// * Epilogue: each warpgroup stages its 64 x D result in the shared memory
//   of its own stationary tile and writes it with 16-byte stores.
//
// Register operands of a wgmma are pinned (fence_regs) before each
// wgmma.fence and after each wait, and no accumulator is rewritten while
// its group is in flight: otherwise ptxas serialises the wgmmas.
//
// Occupancy. At head_dim 128, 128 stationary rows per block (two
// warpgroups), so the Anima shape has 16 * 4096 / 128 = 512 blocks for 132
// SMs, one block (8 warps) a SM: the registers (ptxas for sm_90a, bf16: about 155
// forward, 162 dQ, 232 dK/dV a thread, no spill; chip_smoke.py prints them)
// allow no second block. At head_dim 64 the accumulators are half as large
// (O and dQ 32 fp32 registers a thread, dK and dV 64) and the score
// products have 4 k-steps, so the softmax's share of the work per
// tensor-core flop is twice D = 128's. There a block is one warpgroup of 64
// stationary rows, so that several blocks share a SM and do not wait on
// each other's tiles: about 117 registers a thread for the forward, 128
// for dQ and 165 for dK/dV (4, 4 and 3 blocks a SM): the SDXL shapes' 640
// and 320 blocks fill the card in 1.2 and 0.6 waves of the forward and dQ,
// 1.6 and 0.8 of dK/dV.
// Measured on the H100 and not kept at head_dim 64: the forward as WMMA
// tiles with the scores and O in shared memory (0.695 ms at B * H = 10,
// S = 4096, 4.6x this design), two warpgroups a block (dQ 13%, dK/dV 34%,
// the forward 14% slower at B * H = 10, S = 4096, the forward 21% at
// B * H = 20, S = 1024), launch bounds
// that ask for 128 registers a thread (dK/dV spills and is 13-81% slower),
// and 128-key tiles in the dQ kernel (201 registers, 2 blocks a SM; 5%
// slower at S = 4096, 11% at 1024). Shared memory with the 1 KB alignment
// slack, at D = 128 / 64 (either T): forward 99,328 / 41,984 bytes (Q x WG, K and V x
// 2 stages), dQ 133,120 / 50,688 (Q, dO x WG, K and V x 2 stages, lse and
// delta), dK/dV 133,120 / 51,200 (K, V x WG, Q and dO x 2 stages, lse and
// delta). The dK/dV kernel holds dK and dV and keeps P as T (the A
// fragment of dV += P^T dO), from which it also forms dS, so that its
// scores fit beside them. Tried at D = 128 on the H100 and not kept, being
// no faster beyond the run-to-run spread: rings of 3 and 4 stages, issuing
// the next tile's scores beside the accumulating product (forward and dQ),
// and Q as register A fragments for S = Q K^T.
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C functions at the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::f16;
using sm90::Elem;
using sm90::aligned16;
using sm90::allow_smem;
using sm90::attributes;

constexpr int BM = 64;             // rows of a warpgroup's tile (wgmma M)
constexpr int BN = 64;             // rows of a streamed tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// Consumer warpgroups of a block at head dim D
constexpr int warpgroups(int d) { return d == 64 ? 1 : 2; }

// Threads, stationary rows, tile bytes and shared memory at head dim D
// with WG consumer warpgroups, with 1 KB of slack for the alignment: the
// stationary tiles and two stages of each streamed tile (plus lse and
// delta rows)
template <int D, int WG>
struct Geo {
  static constexpr int THREADS = WG * 128;
  static constexpr int ROWS = WG * BM;
  static constexpr int TILE = sm90::Tile<64, D>::BYTES;   // 8 KB at D = 64, 16 KB at 128
  static constexpr size_t FWD_SMEM = 1024 + (WG + 4) * TILE;
  static constexpr size_t DQ_SMEM = 1024 + (2 * WG + 4) * TILE + 2 * ROWS * sizeof(float);
  static constexpr size_t DKV_SMEM = 1024 + (2 * WG + 4) * TILE + 2 * 2 * BN * sizeof(float);
  static_assert(FWD_SMEM <= 232448 && DQ_SMEM <= 232448 && DKV_SMEM <= 232448,
                "shared memory of one block");
};

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// swizzle atom); the generic pointer and the shared-window address.
struct Smem {
  unsigned char* ptr;
  uint32_t addr;
  __device__ __forceinline__ Smem(unsigned char* raw) {
    const uint32_t a = sm90::smem_u32(raw);
    addr = (a + 1023u) & ~1023u;
    ptr = raw + (addr - a);
  }
};

// 8 elements of T (16 bytes) as fp32
template <typename T>
__device__ __forceinline__ void load8f(const T* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = Elem<T>::unpack(w[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Writes a warpgroup's 64 x D fp32 accumulator, row i-half scaled by
// mul[i], as rows [row0, row0 + 64) of one head of a (B, S, H, D) T
// output: through `stage` (64 * D * 2 bytes of shared memory this
// warpgroup alone uses, rows of D * 2 bytes with 16-byte chunks swizzled by
// row), then 16-byte stores. t: thread in the warpgroup; bar: its named
// barrier.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&mul)[2],
                                           unsigned char* stage, T* head, int row0, int S,
                                           int rs, int t, int bar) {
  constexpr int ROW_BYTES = D * 2, CH = D / 8;
  const int w = t / 32, g = (t % 32) / 4, c4 = t % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * w + g + 8 * i;
      const int byte = (8 * j + 2 * c4) * 2;
      uint32_t* p = reinterpret_cast<uint32_t*>(stage + row * ROW_BYTES +
                                                (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15));
      *p = Elem<T>::pack(acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
    }
  }
  sm90::named_barrier(bar, 128);
#pragma unroll
  for (int it = 0; it < 64 * CH / 128; ++it) {
    const unsigned c = t + it * 128;
    const int row = c / CH, ch = c % CH;
    const uint4 val =
        *reinterpret_cast<const uint4*>(stage + row * ROW_BYTES + ((ch ^ (row & 7)) << 4));
    if (row0 + row < S)
      *reinterpret_cast<uint4*>(head + (size_t)(row0 + row) * rs + ch * 8) = val;
  }
  sm90::named_barrier(bar, 128);
}

// ---------------------------------------------------------------------------
// K1 / K4a: forward. Grid (ceil(Sq / (64 WG)), B * H); warpgroup w owns
// query rows [q0 + 64 w, q0 + 64 w + 64).
// ---------------------------------------------------------------------------
template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128, 1)
flash_fwd_sm90_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      int H, int Sq, int Skv, float scale) {
  constexpr int THREADS = WG * 128, ROWS = WG * BM, TILE = Geo<D, WG>::TILE;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, c4 = t % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * ROWS;
  const int rs = H * D;
  const T* kh = k + (size_t)b * Skv * rs + h * D;
  const T* vh = v + (size_t)b * Skv * rs + h * D;
  // tiles: Q of each warpgroup, then K stage 0 and 1, then V stage 0 and 1
  const uint32_t sQ = sm.addr + wg * TILE;
  const uint32_t sK = sm.addr + WG * TILE;
  const uint32_t sV = sK + 2 * TILE;

#pragma unroll
  for (int x = 0; x < WG; ++x)
    sm90::load_tile_async<BM, D, THREADS>(sm.addr + x * TILE, q + (size_t)b * Sq * rs + h * D,
                                          q0 + x * BM, Sq, rs, tid);
  sm90::load_tile_async<BN, D, THREADS>(sK, kh, 0, Skv, rs, tid);
  sm90::load_tile_async<BN, D, THREADS>(sV, vh, 0, Skv, rs, tid);
  sm90::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in log2 units
  const float sl2 = scale * LOG2E;
  const int nk = (Skv + BN - 1) / BN;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();                  // tile j landed; tile j - 1 is consumed
    if (j + 1 < nk) {
      sm90::load_tile_async<BN, D, THREADS>(sK + (st ^ 1) * TILE, kh, (j + 1) * BN, Skv, rs,
                                            tid);
      sm90::load_tile_async<BN, D, THREADS>(sV + (st ^ 1) * TILE, vh, (j + 1) * BN, Skv, rs,
                                            tid);
    }
    sm90::cp_async_commit();

    // S = Q K^T
    float s[32];
    sm90::fence_regs(acc);            // the rescale below is written before the fence
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T>(s, sm90::kmajor_desc<BM>(sQ, kk), sm90::kmajor_desc<BN>(sK + st * TILE, kk),
                   kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // online softmax over this tile's 64 keys, in log2 units; the row max
    // and the rescale reduce over the 4 lanes of a row, l stays per lane
    float p[32], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x / 2) % 2;      // element x: row half (x / 2) % 2, column block x / 4
      p[x] = (j * BN + 8 * (x / 4) + 2 * c4 + x % 2 < Skv) ? s[x] * sl2 : NEG_INF;
      mx[i] = fmaxf(mx[i], p[x]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x / 2) % 2;
      p[x] = exp2f(p[x] - m[i]);
      l[i] += p[x];
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x / 2) % 2];
    uint32_t pa[16];
    sm90::pack_a<T>(p, pa);

    // O += P V
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::mma_rs<T>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sV + st * TILE, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float safe_l = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / safe_l;
    const int row = q0 + wg * BM + 16 * w + g + 8 * i;
    if (c4 == 0 && row < Sq) lse[(size_t)bh * Sq + row] = m[i] * LN2 + logf(safe_l);
  }
  store_rows<T, D>(acc, inv, sm.ptr + wg * TILE, o + (size_t)b * Sq * rs + h * D,
                   q0 + wg * BM, Sq, rs, t, 1 + wg);
}

// ---------------------------------------------------------------------------
// K2 / K4b dQ: dQ, and delta = rowsum(dO * O) for the dK/dV kernel. Grid
// (ceil(Sq / (64 WG)), B * H); the key loop is inside the block.
// ---------------------------------------------------------------------------
template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128, 1)
flash_bwd_dq_sm90_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq, int H, int Sq,
                         int Skv, float scale) {
  constexpr int THREADS = WG * 128, ROWS = WG * BM, TILE = Geo<D, WG>::TILE;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, c4 = t % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * ROWS;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const T* kh = k + (size_t)b * Skv * rs + h * D;
  const T* vh = v + (size_t)b * Skv * rs + h * D;
  // tiles: Q x WG warpgroups, dO x WG, K x 2 stages, V x 2 stages (of BN
  // keys); then lse and delta of the block's rows
  const uint32_t sQ = sm.addr + wg * TILE;
  const uint32_t sDO = sm.addr + (WG + wg) * TILE;
  const uint32_t sK = sm.addr + 2 * WG * TILE;
  const uint32_t sV = sK + 2 * TILE;
  float* sLse = reinterpret_cast<float*>(sm.ptr + 2 * WG * TILE + 4 * TILE);
  float* sDelta = sLse + ROWS;

#pragma unroll
  for (int x = 0; x < WG; ++x)
    sm90::load_tile_async<BM, D, THREADS>(sm.addr + x * TILE, q + qoff, q0 + x * BM, Sq, rs,
                                          tid);
  sm90::load_tile_async<BN, D, THREADS>(sK, kh, 0, Skv, rs, tid);
  sm90::load_tile_async<BN, D, THREADS>(sV, vh, 0, Skv, rs, tid);
  sm90::cp_async_commit();

  // dO into its tiles, and delta from dO and O: two threads a row, D / 2
  // columns each
  {
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    unsigned char* tile = sm.ptr + (WG + r / BM) * TILE;
    float dl = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int ch = half * (D / 16) + c;
      float fo[8], fd[8];
      if (row < Sq) {
        load8f(dout + qoff + (size_t)row * rs + ch * 8, fd);
        load8f(o + qoff + (size_t)row * rs + ch * 8, fo);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) fo[e] = fd[e] = 0.f;
      }
      uint4 packed;
      packed.x = Elem<T>::pack(fd[0], fd[1]);
      packed.y = Elem<T>::pack(fd[2], fd[3]);
      packed.z = Elem<T>::pack(fd[4], fd[5]);
      packed.w = Elem<T>::pack(fd[6], fd[7]);
      *reinterpret_cast<uint4*>(tile + sm90::Tile<BM, D>::chunk(r % BM, ch)) = packed;
#pragma unroll
      for (int e = 0; e < 8; ++e) dl += fd[e] * fo[e];
    }
    dl += __shfl_xor_sync(FULL, dl, 1);
    if (half == 0) {
      sDelta[r] = dl;
      sLse[r] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
      if (row < Sq) delta[(size_t)bh * Sq + row] = dl;
    }
  }
  __syncthreads();
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * BM + 16 * w + g + 8 * i;
    lse2[i] = sLse[r] * LOG2E;
    dl[i] = sDelta[r];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const int nk = (Skv + BN - 1) / BN;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();                  // tile j landed; tile j - 1 is consumed
    if (j + 1 < nk) {
      sm90::load_tile_async<BN, D, THREADS>(sK + (st ^ 1) * TILE, kh, (j + 1) * BN, Skv, rs,
                                            tid);
      sm90::load_tile_async<BN, D, THREADS>(sV + (st ^ 1) * TILE, vh, (j + 1) * BN, Skv, rs,
                                            tid);
    }
    sm90::cp_async_commit();

    // S = Q K^T, then dP = dO V^T
    float s[BN / 2], dp[BN / 2];
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T>(s, sm90::kmajor_desc<BM>(sQ, kk), sm90::kmajor_desc<BN>(sK + st * TILE, kk),
                   kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T>(dp, sm90::kmajor_desc<BM>(sDO, kk), sm90::kmajor_desc<BN>(sV + st * TILE, kk),
                   kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();            // S is done; dP may still run
    sm90::fence_regs(s);
    float p[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) {
      const int i = (x / 2) % 2;      // element x: row half (x / 2) % 2, column block x / 4
      p[x] = (j * BN + 8 * (x / 4) + 2 * c4 + x % 2 < Skv) ? exp2f(s[x] * sl2 - lse2[i]) : 0.f;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    // dS = P (dP - delta) scale, as the A fragments of dQ += dS K
    uint32_t da[BN / 4];
#pragma unroll
    for (int x = 0; x < BN / 4; ++x) {
      const int i = x % 2;            // elements 2x, 2x + 1: row half x % 2
      da[x] = Elem<T>::pack(p[2 * x] * (dp[2 * x] - dl[i]) * scale,
                              p[2 * x + 1] * (dp[2 * x + 1] - dl[i]) * scale);
    }
    sm90::fence_regs(da);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::mma_rs<T>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sK + st * TILE, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(da);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(acc, one, sm.ptr + wg * TILE, dq + qoff, q0 + wg * BM, Sq, rs, t, 1 + wg);
}

// ---------------------------------------------------------------------------
// K3 / K4b dK/dV: dK and dV from the saved lse and the dQ kernel's delta.
// Grid (ceil(Skv / (64 WG)), B * H); warpgroup w owns key rows [kv0 + 64 w,
// +64); the query loop is inside the block. Works on transposed scores
// (rows = keys, columns = queries), so P^T and dS^T are the A operands.
// ---------------------------------------------------------------------------
template <typename T, int D, int WG>
__global__ void __launch_bounds__(WG * 128, 1)
flash_bwd_dkv_sm90_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv,
                          float scale) {
  constexpr int THREADS = WG * 128, ROWS = WG * BM, TILE = Geo<D, WG>::TILE;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int c4 = t % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * ROWS;
  const int rs = H * D;
  const size_t kvoff = (size_t)b * Skv * rs + h * D;
  const T* qh = q + (size_t)b * Sq * rs + h * D;
  const T* doh = dout + (size_t)b * Sq * rs + h * D;
  const float* lse_h = lse + (size_t)bh * Sq;
  const float* delta_h = delta + (size_t)bh * Sq;
  // tiles: K x WG warpgroups, V x WG, Q x 2 stages, dO x 2 stages; then lse
  // and delta of each stage
  const uint32_t sK = sm.addr + wg * TILE;
  const uint32_t sV = sm.addr + (WG + wg) * TILE;
  const uint32_t sQ = sm.addr + 2 * WG * TILE;
  const uint32_t sDO = sQ + 2 * TILE;
  const uint32_t sStats = sm.addr + (2 * WG + 4) * TILE;   // [stage][lse | delta][BN]
  const float* fStats = reinterpret_cast<const float*>(sm.ptr + (2 * WG + 4) * TILE);

  // query tile [row0, row0 + 64): Q, dO, lse and delta into a stage
  auto load_q_tile = [&](int stage, int row0) {
    sm90::load_tile_async<BN, D, THREADS>(sQ + stage * TILE, qh, row0, Sq, rs, tid);
    sm90::load_tile_async<BN, D, THREADS>(sDO + stage * TILE, doh, row0, Sq, rs, tid);
    if (tid < 2 * BN) {
      const int r = tid % BN, row = row0 + r;
      const bool ok = row < Sq;
      const float* src = (tid < BN ? lse_h : delta_h) + (ok ? row : 0);
      sm90::cp_async4(sStats + (stage * 2 * BN + tid) * 4, src, ok);
    }
  };

#pragma unroll
  for (int x = 0; x < WG; ++x) {
    sm90::load_tile_async<BM, D, THREADS>(sm.addr + x * TILE, k + kvoff, kv0 + x * BM, Skv, rs,
                                          tid);
    sm90::load_tile_async<BM, D, THREADS>(sm.addr + (WG + x) * TILE, v + kvoff, kv0 + x * BM,
                                          Skv, rs, tid);
  }
  load_q_tile(0, 0);
  sm90::cp_async_commit();

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const float sl2 = scale * LOG2E;
  const int nq = (Sq + BN - 1) / BN;

  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();                  // tile j landed; tile j - 1 is consumed
    if (j + 1 < nq) load_q_tile(st ^ 1, (j + 1) * BN);
    sm90::cp_async_commit();

    // S^T = K Q^T, then dP^T = V dO^T
    float s[32], dp[32];
    sm90::fence_regs(acc_dk);
    sm90::fence_regs(acc_dv);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T>(s, sm90::kmajor_desc<BM>(sK, kk), sm90::kmajor_desc<BN>(sQ + st * TILE, kk),
                   kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T>(dp, sm90::kmajor_desc<BM>(sV, kk), sm90::kmajor_desc<BN>(sDO + st * TILE, kk),
                   kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);

    // P^T, forced to 0 for queries >= Sq (their Q rows and lse are zeros);
    // kept as the T A fragments of dV += P^T dO
    const float* sl = fStats + st * 2 * BN;
    uint32_t pa[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * (x / 2) + 2 * c4 + c;   // the column of element 2x + c
        p[c] = (j * BN + qc < Sq) ? exp2f(s[2 * x + c] * sl2 - sl[qc] * LOG2E) : 0.f;
      }
      pa[x] = Elem<T>::pack(p[0], p[1]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);

    // dS^T = P^T (dP^T - delta) scale, from the T P^T (no wgmma reads
    // pa yet)
    uint32_t da[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float2 p = Elem<T>::unpack(pa[x]);
      const int qc = 8 * (x / 2) + 2 * c4;
      da[x] = Elem<T>::pack(p.x * (dp[2 * x] - sl[BN + qc]) * scale,
                              p.y * (dp[2 * x + 1] - sl[BN + qc + 1]) * scale);
    }

    // dV += P^T dO, dK += dS^T Q
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::mma_rs<T>(acc_dv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sDO + st * TILE, kk));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::mma_rs<T>(acc_dk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sQ + st * TILE, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_dv);
    sm90::fence_regs(acc_dk);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(acc_dk, one, sm.ptr + wg * TILE, dk + kvoff, kv0 + wg * BM, Skv, rs, t,
                   1 + wg);
  store_rows<T, D>(acc_dv, one, sm.ptr + (WG + wg) * TILE, dv + kvoff, kv0 + wg * BM, Skv,
                   rs, t, 1 + wg);
}

// ---------------------------------------------------------------------------
// K4a at head_dim 512 (forward only). Grid (ceil(Sq / 64), B * H); the two
// warpgroups share the block's 64 query rows, warpgroup w owning O's
// columns [256 w, 256 w + 256): two m64n128 accumulators, 128 fp32
// registers a thread (one warpgroup would need 256). Each warpgroup
// computes S = Q K^T over its half of D (16 of the 32 k-steps) and the two
// fp32 partials are summed through shared memory; both then run the same
// online softmax on the whole row, so m, l and P agree without another
// exchange (a + b and b + a are the same float). Computing all of S in each
// warpgroup instead (no exchange, half as much tensor-core work again)
// measured 7% slower on the H100 (PERF.md). K and V have one slot
// each: V_j comes in under S_j, K_{j+1} under P V_j; 230,400 bytes of
// shared memory (Q, K, V, the exchange), one block a SM, 252 registers a
// thread. At B * H = 1, S = 16384 it runs at about 36% of its bound: the
// softmax and the exchange leave the tensor cores idle (no ping-pong).
// ---------------------------------------------------------------------------
namespace d512 {
constexpr int D = 512, THREADS = 256;
constexpr int TILE = sm90::Tile<64, D>::BYTES;      // 64 KB: Q, K or V
constexpr int HALF = 64 * 128;                      // one 64-column half of a tile
constexpr int XCH = 2 * 32 * 128 * sizeof(float);   // [warpgroup][element][thread]
constexpr size_t SMEM = 1024 + 3 * TILE + XCH;
static_assert(SMEM <= 232448, "shared memory of one block");
}  // namespace d512

__global__ void __launch_bounds__(d512::THREADS, 1)
flash_fwd_d512_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int H, int Sq, int Skv, float scale) {
  using namespace d512;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, c4 = t % 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int rs = H * D;
  const bf16* kh = k + (size_t)b * Skv * rs + h * D;
  const bf16* vh = v + (size_t)b * Skv * rs + h * D;
  const uint32_t sQ = sm.addr, sK = sQ + TILE, sV = sK + TILE;
  float* xch = reinterpret_cast<float*>(sm.ptr + 3 * TILE);

  sm90::load_tile_async<BM, D, THREADS>(sQ, q + (size_t)b * Sq * rs + h * D, q0, Sq, rs, tid);
  sm90::load_tile_async<BN, D, THREADS>(sK, kh, 0, Skv, rs, tid);
  sm90::cp_async_commit();

  float o0[64], o1[64];                // columns 256 wg + [0, 128) and + [128, 256)
#pragma unroll
  for (int i = 0; i < 64; ++i) o0[i] = o1[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in log2 units
  const float sl2 = scale * LOG2E;
  constexpr int KS = D / 32;           // k-steps of this warpgroup's S
  const int k0 = wg * KS;
  const int nk = (Skv + BN - 1) / BN;

  for (int j = 0; j < nk; ++j) {
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    __syncthreads();                  // K_j landed; V_{j-1} is consumed
    sm90::load_tile_async<BN, D, THREADS>(sV, vh, j * BN, Skv, rs, tid);
    sm90::cp_async_commit();

    float s[32];
    sm90::fence_regs(o0);             // the rescale below is written before the fence
    sm90::fence_regs(o1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      sm90::mma_ss<bf16>(s, sm90::kmajor_desc<BM>(sQ, k0 + kk), sm90::kmajor_desc<BN>(sK, k0 + kk),
                   kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    // thread t of the other warpgroup holds the same elements of the other
    // half's partial
#pragma unroll
    for (int x = 0; x < 32; ++x) xch[(wg * 32 + x) * 128 + t] = s[x];
    __syncthreads();                  // both halves' S_j read K_j and wrote their partials
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] += xch[((wg ^ 1) * 32 + x) * 128 + t];
    if (j + 1 < nk) sm90::load_tile_async<BN, D, THREADS>(sK, kh, (j + 1) * BN, Skv, rs, tid);
    sm90::cp_async_commit();

    // online softmax over this tile's 64 keys, as flash_fwd_sm90_kernel
    float p[32], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x / 2) % 2;
      p[x] = (j * BN + 8 * (x / 4) + 2 * c4 + x % 2 < Skv) ? s[x] * sl2 : NEG_INF;
      mx[i] = fmaxf(mx[i], p[x]);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x / 2) % 2;
      p[x] = exp2f(p[x] - m[i]);
      l[i] += p[x];
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      o0[x] *= alpha[(x / 2) % 2];
      o1[x] *= alpha[(x / 2) % 2];
    }
    uint32_t pa[16];
    sm90::pack_a<bf16>(p, pa);

    sm90::cp_async_wait<1>();         // V_j landed (K_{j+1} may still be in flight)
    sm90::fence_async_smem();
    __syncthreads();
    // O += P V over this warpgroup's 256 columns (halves 4 wg .. 4 wg + 3)
    sm90::fence_regs(o0);
    sm90::fence_regs(o1);
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      sm90::mma_rs<bf16>(o0, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sV + 4 * wg * HALF, kk));
      sm90::mma_rs<bf16>(o1, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   sm90::mnmajor_desc<BN>(sV + (4 * wg + 2) * HALF, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o0);
    sm90::fence_regs(o1);
    sm90::fence_regs(pa);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    const float safe_l = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / safe_l;
    const int row = q0 + 16 * w + g + 8 * i;
    if (wg == 0 && c4 == 0 && row < Sq) lse[(size_t)bh * Sq + row] = m[i] * LN2 + logf(safe_l);
  }
  // no thread reads Q after the last barrier above: each warpgroup stages
  // its two 64 x 128 quarters of O in its 32 KB of the Q tile
  bf16* oh = o + (size_t)b * Sq * rs + h * D + 256 * wg;
  store_rows<bf16, 128>(o0, inv, sm.ptr + wg * 2 * 16384, oh, q0, Sq, rs, t, 1 + wg);
  store_rows<bf16, 128>(o1, inv, sm.ptr + (wg * 2 + 1) * 16384, oh + 128, q0, Sq, rs, t,
                        1 + wg);
}

template <typename T, int D, int WG = warpgroups(D)>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
        int Skv, float scale, cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  using G = Geo<D, WG>;
  cudaError_t e = allow_smem(flash_fwd_sm90_kernel<T, D, WG>, G::FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + G::ROWS - 1) / G::ROWS, B * H);
  flash_fwd_sm90_kernel<T, D, WG><<<grid, G::THREADS, G::FWD_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int WG = warpgroups(D)>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
           float scale, cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dout) &&
        aligned16(dq)))
    return (int)cudaErrorInvalidValue;
  using G = Geo<D, WG>;
  cudaError_t e = allow_smem(flash_bwd_dq_sm90_kernel<T, D, WG>, G::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + G::ROWS - 1) / G::ROWS, B * H);
  flash_bwd_dq_sm90_kernel<T, D, WG><<<grid, G::THREADS, G::DQ_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq,
      H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int WG = warpgroups(D)>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int B, int H, int Sq, int Skv, float scale,
            cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dk) &&
        aligned16(dv)))
    return (int)cudaErrorInvalidValue;
  using G = Geo<D, WG>;
  cudaError_t e = allow_smem(flash_bwd_dkv_sm90_kernel<T, D, WG>, G::DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + G::ROWS - 1) / G::ROWS, B * H);
  flash_bwd_dkv_sm90_kernel<T, D, WG><<<grid, G::THREADS, G::DKV_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, H, Sq,
      Skv, scale);
  return (int)cudaGetLastError();
}

int fwd_d512(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Sq, int Skv, float scale, cudaStream_t stream) {
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_fwd_d512_sm90_kernel, d512::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_d512_sm90_kernel<<<grid, d512::THREADS, d512::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int attributes_of(int kernel, int* out) {
  using G = Geo<D, warpgroups(D)>;
  if (kernel == 0)
    return attributes(flash_fwd_sm90_kernel<T, D, warpgroups(D)>, G::THREADS, G::FWD_SMEM, out);
  if (kernel == 1)
    return attributes(flash_bwd_dq_sm90_kernel<T, D, warpgroups(D)>, G::THREADS, G::DQ_SMEM,
                      out);
  if (kernel == 2)
    return attributes(flash_bwd_dkv_sm90_kernel<T, D, warpgroups(D)>, G::THREADS, G::DKV_SMEM,
                      out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one entry point per kernel, head dim and element type
// (no suffix: bf16 at head_dim 64, K1-K3; _d128: bf16 at 128, K4a/K4b;
// _d512: the bf16 head_dim-512 forward; _f16 and _f16_d128: the same
// kernels on fp16 at 64 and 128). Each returns the cudaError_t of its
// launch; cudaErrorInvalidValue for a pointer the 16-byte loads cannot
// take.
extern "C" {

const char* aozora_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int aozora_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd<bf16, 64>(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

int aozora_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, int B,
                        int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<bf16, 64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                         (cudaStream_t)stream);
}

int aozora_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dkv<bf16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale,
                          (cudaStream_t)stream);
}

int aozora_flash_fwd_d128(const void* q, const void* k, const void* v, void* o, float* lse,
                          int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd<bf16, 128>(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

int aozora_flash_bwd_dq_d128(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, int B,
                             int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<bf16, 128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                         (cudaStream_t)stream);
}

int aozora_flash_bwd_dkv_d128(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dkv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale,
                          (cudaStream_t)stream);
}

int aozora_flash_fwd_f16(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd<f16, 64>(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

int aozora_flash_bwd_dq_f16(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq, int B,
                            int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<f16, 64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                         (cudaStream_t)stream);
}

int aozora_flash_bwd_dkv_f16(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, int B,
                             int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dkv<f16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale,
                          (cudaStream_t)stream);
}

int aozora_flash_fwd_f16_d128(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd<f16, 128>(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

int aozora_flash_bwd_dq_f16_d128(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* lse, float* delta, void* dq, int B,
                                 int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dq<f16, 128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                         (cudaStream_t)stream);
}

int aozora_flash_bwd_dkv_f16_d128(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv, int B,
                                  int H, int Sq, int Skv, float scale, void* stream) {
  return bwd_dkv<f16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale,
                          (cudaStream_t)stream);
}

int aozora_flash_fwd_d512(const void* q, const void* k, const void* v, void* o, float* lse,
                          int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd_d512(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

// kernel: 0 forward, 1 dQ, 2 dK/dV on bf16, 3, 4, 5 the same on fp16; head_dim
// 64 or 128 (512: the bf16 forward only); out: 5 ints (see attributes() in
// sm90_wgmma.cuh).
int aozora_flash_sm90_attributes(int kernel, int head_dim, int* out) {
  if (head_dim == 64) return kernel < 3 ? attributes_of<bf16, 64>(kernel, out)
                                        : attributes_of<f16, 64>(kernel - 3, out);
  if (head_dim == 128) return kernel < 3 ? attributes_of<bf16, 128>(kernel, out)
                                         : attributes_of<f16, 128>(kernel - 3, out);
  if (head_dim == 512 && kernel == 0)
    return attributes(flash_fwd_d512_sm90_kernel, d512::THREADS, d512::SMEM, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
