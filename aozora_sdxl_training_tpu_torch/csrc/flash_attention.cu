// Flash attention forward and backward for Hopper (sm_90a), head_dim 64 and
// 128.
//
// Three kernels, each a template on the head dim D and each replacing Pallas
// TPU kernels of aozora_sdxl_training_tpu/ops/flash_attention.py:
//
//   flash_fwd_kernel<D>      <- _fwd_kernel     (D=64: _flash_forward;
//                                                D=128: _flash_forward_folded)
//   flash_bwd_dq_kernel<D>   <- _bwd_dq_kernel  (D=64: _flash_backward;
//                                                D=128: _flash_backward_folded)
//   flash_bwd_dkv_kernel<D>  <- _bwd_dkv_kernel (the same two)
//
// The D=64 instantiations serve the SDXL UNet (K1-K3), the D=128 ones the
// Anima DiT (K4a forward, K4b backward). Each instantiation has its own C
// entry point, so the wrappers count them apart.
//
// They compute what the Pallas kernels compute (exact attention with an
// online softmax over KV tiles, fp32 statistics and accumulators, padded KV
// columns masked to -1e30, l clamped at 1e-30, the backward recomputing P
// from the saved row logsumexp) but are laid out for the GPU:
//
// * They read and write the (B, S, H, D) layout of the callers directly:
//   row s of head (b, h) starts at ((b * S + s) * H + h) * D. That is also
//   the (B, S, H*D) "folded" layout of the TPU's D % 128 == 0 kernels, so
//   K4a/K4b are the same bodies at D=128. No transposes and no padding
//   around the call; the ragged edge of S is masked here.
// * lse and delta are plain (B*H, S) fp32 rows (no 128-lane replication).
// * Each block loops over the other sequence inside itself, since a grid
//   dimension cannot carry an accumulator on the GPU.
//
// What bounds them: at the SDXL and Anima shapes (S = 1024 or 4096) all
// three are compute-bound (4*S^2*D flop per head forward, 6 and 8 for dq and
// dk/dv, against 2*S*D*2 bytes per operand). The design keeps every S x S
// tile in shared memory, never in device memory, and runs the products on
// the tensor cores (WMMA bf16 16x16x16, fp32 accumulate). This is the
// simple version: one block of 4 warps per 64-row tile, each warp owning 16
// rows, K/V (or Q/dO) tiles staged in shared memory with plain loads and no
// double buffering, and the softmax done from shared memory. The score tiles
// (S, P, dS) are 64 wide whatever D is; the operand tiles and the output
// accumulator are D wide. At D=128 a block takes 110-121 KB of shared
// memory, and the dK/dV kernel's two accumulators take 16 WMMA fragments
// (128 fp32 registers) per thread: ptxas spills 56 bytes at its 255-register
// limit. Keeping dV in shared memory instead, as the forward keeps O, ends
// the spill (168 registers) but measured 23% slower on an H100, so the
// fragments stay. wgmma, TMA and warp specialisation are the next steps.
//
// fp32 inputs are accepted: tiles are rounded to bf16 when they are staged
// for the tensor cores, and everything else (softmax, statistics,
// accumulation, outputs) stays fp32.
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C functions at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;           // rows of a tile, in either sequence
constexpr int NWARPS = 4;          // each warp owns 16 rows of the tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDP = TILE + 8;      // leading dim of bf16 score tiles (P, dS)
constexpr int LDS = TILE + 4;      // leading dim of fp32 score tiles (S, dP)
constexpr int P_TILE = TILE * LDP; // elements of one bf16 score tile
constexpr int S_TILE = TILE * LDS; // elements of one fp32 score tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Tile geometry for head dim D. A lane owns row lane / 2 of its warp's 16
// rows, and half of that row's columns: TILE / 2 score columns and D / 2
// output columns.
template <int D>
struct Geometry {
  static constexpr int LDH = D + 8;       // leading dim of bf16 operand tiles (Q, K, V, dO)
  static constexpr int LDO = D + 4;       // leading dim of fp32 D-wide tiles (O, staging)
  static constexpr int H_TILE = TILE * LDH;
  static constexpr int O_TILE = TILE * LDO;
  // the fp32 region that holds S and dP also stages the D-wide outputs
  static constexpr int F_REGION = (2 * S_TILE > O_TILE) ? 2 * S_TILE : O_TILE;
  static constexpr size_t FWD_SMEM =
      (3 * H_TILE + P_TILE) * sizeof(__nv_bfloat16) + (S_TILE + O_TILE) * sizeof(float);
  static constexpr size_t DQ_SMEM =
      (4 * H_TILE + P_TILE) * sizeof(__nv_bfloat16) + F_REGION * sizeof(float);
  static constexpr size_t DKV_SMEM =
      (4 * H_TILE + 2 * P_TILE) * sizeof(__nv_bfloat16) + (F_REGION + 2 * TILE) * sizeof(float);
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(O_TILE <= F_REGION, "staging must fit the fp32 region");
};

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements from device memory into 16 bytes of shared memory.
__device__ __forceinline__ void stage8(const bf16* src, bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void stage8(const float* src, bf16* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  __nv_bfloat162 r[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(r);
}

// Rows [row0, row0 + TILE) of one head into a bf16 D-wide tile; rows >= S
// are zeros.
template <int D, typename T>
__device__ void load_tile(bf16* dst, const T* head, int row0, int S, int row_stride) {
  constexpr int LDH = Geometry<D>::LDH;
  for (int c = threadIdx.x; c < TILE * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    bf16* d = dst + r * LDH + col;
    if (row0 + r < S) {
      stage8(head + (size_t)(row0 + r) * row_stride + col, d);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// C(16 x 64, fp32, shared, ld LDS) = A(16 x D) * B(64 x D)^T for one warp:
// the scores of the warp's 16 rows against a 64-row tile.
template <int D>
__device__ __forceinline__ void warp_scores(const bf16* a, const bf16* b, float* c) {
  constexpr int LDH = Geometry<D>::LDH;
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] += A(16 x 64, ld LDP) * B(64 x D, ld LDH)[:, 16n : 16n + 16].
template <int D>
__device__ __forceinline__ void warp_gemm_acc(const bf16* a, const bf16* b, FragC* acc) {
  constexpr int LDH = Geometry<D>::LDH;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// C(16 x D, fp32, shared, ld LDO) += A(16 x 64, ld LDP) * B(64 x D, ld LDH):
// an accumulator kept in shared memory (the forward's O, which the online
// softmax rescales per row), round-tripping through fragments.
template <int D>
__device__ __forceinline__ void warp_gemm_acc_smem(const bf16* a, const bf16* b, float* c) {
  using G = Geometry<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC acc;
    wmma::load_matrix_sync(acc, c + n * 16, G::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDP);
      wmma::load_matrix_sync(fb, b + kk * 16 * G::LDH + n * 16, G::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + n * 16, acc, G::LDO, wmma::mem_row_major);
  }
}

// Writes a warp's 16 x D fp32 accumulators as rows of a (B, S, H, D) output
// through its 16 rows of the fp32 staging tile (ld LDO). Lane `lane` writes
// D / 2 columns of row lane / 2.
template <int D, typename T>
__device__ void warp_store_rows(FragC* acc, float* stage, T* head, int row0, int S,
                                int row_stride, int lane) {
  constexpr int LDO = Geometry<D>::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage + n * 16, acc[n], LDO, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane / 2, c0 = (lane % 2) * (D / 2);
  if (row0 + r < S) {
    T* dst = head + (size_t)(row0 + r) * row_stride + c0;
#pragma unroll 16
    for (int i = 0; i < D / 2; ++i) dst[i] = from_float<T>(stage[r * LDO + c0 + i]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K1 / K4a: forward. Grid (ceil(Sq / 64), B * H); one block per 64 query rows.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
                 float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + G::H_TILE;
  bf16* sV = sK + G::H_TILE;
  bf16* sP = sV + G::H_TILE;
  float* sS = reinterpret_cast<float*>(sP + P_TILE);
  float* sO = sS + S_TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int rs = H * D;
  const T* qh = q + (size_t)b * Sq * rs + h * D;
  const T* kh = k + (size_t)b * Skv * rs + h * D;
  const T* vh = v + (size_t)b * Skv * rs + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;               // the warp's first row in the tile
  const int r = wr + lane / 2;            // this lane's row
  const int cs = (lane % 2) * (TILE / 2); // this lane's 32 score columns
  const int co = (lane % 2) * (D / 2);    // this lane's D / 2 output columns

  load_tile<D>(sQ, qh, q0, Sq, rs);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) sO[r * G::LDO + co + i] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += TILE) {
    __syncthreads();                      // the previous K/V tile is consumed
    load_tile<D>(sK, kh, k0, Skv, rs);
    load_tile<D>(sV, vh, k0, Skv, rs);
    __syncthreads();

    warp_scores<D>(sQ + wr * G::LDH, sK, sS + wr * LDS);   // S = Q K^T
    __syncwarp();

    float s[TILE / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      float x = sS[r * LDS + cs + i] * scale;
      if (k0 + cs + i >= Skv) x = NEG_INF;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const float p = __expf(s[i] - m_new);
      sum += p;
      sP[r * LDP + cs + i] = __float2bfloat16(p);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) sO[r * G::LDO + co + i] *= alpha;
    sum += __shfl_xor_sync(FULL, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // O += P V, the accumulator in shared memory so that the per-row
    // rescale above can reach it
    warp_gemm_acc_smem<D>(sP + wr * LDP, sV, sO + wr * G::LDO);
    __syncwarp();
  }

  const float safe_l = fmaxf(l, 1e-30f);
  if (q0 + r < Sq) {
    const float inv = 1.f / safe_l;
    T* orow = o + (size_t)b * Sq * rs + (size_t)(q0 + r) * rs + h * D + co;
#pragma unroll 16
    for (int i = 0; i < D / 2; ++i) orow[i] = from_float<T>(sO[r * G::LDO + co + i] * inv);
    if ((lane % 2) == 0) lse[(size_t)bh * Sq + q0 + r] = m + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// K2 / K4b dq: dQ, with delta = rowsum(dO * O) computed on the way and
// written out for the dK/dV kernel. Grid (ceil(Sq / 64), B * H); the KV loop
// is inside the block.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Sq, int Skv, float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + G::H_TILE;
  bf16* sK = sDO + G::H_TILE;
  bf16* sV = sK + G::H_TILE;
  bf16* sDS = sV + G::H_TILE;
  float* sS = reinterpret_cast<float*>(sDS + P_TILE);
  float* sDP = sS + S_TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int rs = H * D;
  const size_t qoff = (size_t)b * Sq * rs + h * D;
  const T* kh = k + (size_t)b * Skv * rs + h * D;
  const T* vh = v + (size_t)b * Skv * rs + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;
  const int r = wr + lane / 2;
  const int cs = (lane % 2) * (TILE / 2);
  const int co = (lane % 2) * (D / 2);

  load_tile<D>(sQ, q + qoff, q0, Sq, rs);
  load_tile<D>(sDO, dout + qoff, q0, Sq, rs);

  float dl = 0.f, lse_r = 0.f;
  if (q0 + r < Sq) {
    const T* orow = o + qoff + (size_t)(q0 + r) * rs + co;
    const T* dorow = dout + qoff + (size_t)(q0 + r) * rs + co;
#pragma unroll 16
    for (int i = 0; i < D / 2; ++i) dl += to_float(orow[i]) * to_float(dorow[i]);
  }
  dl += __shfl_xor_sync(FULL, dl, 1);
  if (q0 + r < Sq) {
    lse_r = lse[(size_t)bh * Sq + q0 + r];
    if ((lane % 2) == 0) delta[(size_t)bh * Sq + q0 + r] = dl;
  }

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < Skv; k0 += TILE) {
    __syncthreads();
    load_tile<D>(sK, kh, k0, Skv, rs);
    load_tile<D>(sV, vh, k0, Skv, rs);
    __syncthreads();

    warp_scores<D>(sQ + wr * G::LDH, sK, sS + wr * LDS);    // S = Q K^T
    warp_scores<D>(sDO + wr * G::LDH, sV, sDP + wr * LDS);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int j = r * LDS + cs + i;
      const float p = (k0 + cs + i < Skv) ? __expf(sS[j] * scale - lse_r) : 0.f;
      sDS[r * LDP + cs + i] = __float2bfloat16(p * (sDP[j] - dl) * scale);
    }
    __syncwarp();
    warp_gemm_acc<D>(sDS + wr * LDP, sK, acc);                // dQ += dS K
  }

  __syncthreads();   // the staging rows span other warps' score rows
  warp_store_rows<D>(acc, sS + wr * G::LDO, dq + qoff, q0 + wr, Sq, rs, lane);
}

// ---------------------------------------------------------------------------
// K3 / K4b dkv: dK and dV. Grid (ceil(Skv / 64), B * H); the Q loop is
// inside the block. Works on transposed tiles (rows = keys, columns =
// queries) so that P^T and dS^T are the A operands of the two accumulating
// products.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Sq, int Skv, float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + G::H_TILE;
  bf16* sQ = sV + G::H_TILE;
  bf16* sDO = sQ + G::H_TILE;
  bf16* sP = sDO + G::H_TILE;
  bf16* sDS = sP + P_TILE;
  float* sS = reinterpret_cast<float*>(sDS + P_TILE);
  float* sDP = sS + S_TILE;
  float* sL = sS + G::F_REGION;
  float* sD = sL + TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv0 = blockIdx.x * TILE;
  const int rs = H * D;
  const size_t kvoff = (size_t)b * Skv * rs + h * D;
  const T* qh = q + (size_t)b * Sq * rs + h * D;
  const T* doh = dout + (size_t)b * Sq * rs + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;
  const int r = wr + lane / 2;                // this lane's key row
  const int cs = (lane % 2) * (TILE / 2);     // this lane's 32 query columns
  const bool key_valid = kv0 + r < Skv;

  load_tile<D>(sK, k + kvoff, kv0, Skv, rs);
  load_tile<D>(sV, v + kvoff, kv0, Skv, rs);

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  for (int q0 = 0; q0 < Sq; q0 += TILE) {
    __syncthreads();
    load_tile<D>(sQ, qh, q0, Sq, rs);
    load_tile<D>(sDO, doh, q0, Sq, rs);
    if (threadIdx.x < TILE) {
      const bool ok = q0 + threadIdx.x < Sq;
      sL[threadIdx.x] = ok ? lse[(size_t)bh * Sq + q0 + threadIdx.x] : 0.f;
      sD[threadIdx.x] = ok ? delta[(size_t)bh * Sq + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    warp_scores<D>(sK + wr * G::LDH, sQ, sS + wr * LDS);    // S^T = K Q^T
    warp_scores<D>(sV + wr * G::LDH, sDO, sDP + wr * LDS);  // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int qi = cs + i;
      const int j = r * LDS + qi;
      const float p = (key_valid && q0 + qi < Sq) ? __expf(sS[j] * scale - sL[qi]) : 0.f;
      sP[r * LDP + qi] = __float2bfloat16(p);
      sDS[r * LDP + qi] = __float2bfloat16(p * (sDP[j] - sD[qi]) * scale);
    }
    __syncwarp();
    warp_gemm_acc<D>(sP + wr * LDP, sDO, acc_dv);             // dV += P^T dO
    warp_gemm_acc<D>(sDS + wr * LDP, sQ, acc_dk);             // dK += dS^T Q
  }

  __syncthreads();   // the staging rows span other warps' score rows
  warp_store_rows<D>(acc_dk, sS + wr * G::LDO, dk + kvoff, kv0 + wr, Skv, rs, lane);
  warp_store_rows<D>(acc_dv, sS + wr * G::LDO, dv + kvoff, kv0 + wr, Skv, rs, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
        int Sq, int Skv, float scale, cudaStream_t stream) {
  const size_t smem = Geometry<D>::FWD_SMEM;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
           float scale, cudaStream_t stream) {
  const size_t smem = Geometry<D>::DQ_SMEM;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, delta,
      (T*)dq, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int B, int H, int Sq, int Skv,
            float scale, cudaStream_t stream) {
  const size_t smem = Geometry<D>::DKV_SMEM;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + TILE - 1) / TILE, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, H,
      Sq, Skv, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = bfloat16, 1 = float32.
template <int D>
int fwd_entry(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int H, int Sq, int Skv, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return fwd<bf16, D>(q, k, v, o, lse, B, H, Sq, Skv, scale, s);
  if (dtype == 1) return fwd<float, D>(q, k, v, o, lse, B, H, Sq, Skv, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int bwd_dq_entry(int dtype, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq, int B, int H,
                 int Sq, int Skv, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dq<bf16, D>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, s);
  if (dtype == 1)
    return bwd_dq<float, D>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int bwd_dkv_entry(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                  int Sq, int Skv, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dkv<bf16, D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, s);
  if (dtype == 1)
    return bwd_dkv<float, D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, one entry point per kernel and head dim (no suffix:
// D=64, K1-K3; _d128: D=128, K4a/K4b). q, o, dout, dq are contiguous
// (B, Sq, H, D); k, v, dk, dv contiguous (B, Skv, H, D); lse and delta
// contiguous (B * H, Sq) fp32. Each returns the cudaError_t of its launch.
extern "C" {

const char* aozora_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int aozora_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd_entry<64>(dtype, q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_fwd_d128(int dtype, const void* q, const void* k, const void* v, void* o,
                          float* lse, int B, int H, int Sq, int Skv, float scale,
                          void* stream) {
  return fwd_entry<128>(dtype, q, k, v, o, lse, B, H, Sq, Skv, scale, stream);
}

int aozora_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, float* delta,
                        void* dq, int B, int H, int Sq, int Skv, float scale,
                        void* stream) {
  return bwd_dq_entry<64>(dtype, q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                          stream);
}

int aozora_flash_bwd_dq_d128(int dtype, const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const float* lse,
                             float* delta, void* dq, int B, int H, int Sq, int Skv,
                             float scale, void* stream) {
  return bwd_dq_entry<128>(dtype, q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, scale,
                           stream);
}

int aozora_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Skv, float scale,
                         void* stream) {
  return bwd_dkv_entry<64>(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, scale,
                           stream);
}

int aozora_flash_bwd_dkv_d128(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta,
                              void* dk, void* dv, int B, int H, int Sq, int Skv,
                              float scale, void* stream) {
  return bwd_dkv_entry<128>(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                            scale, stream);
}

}  // extern "C"
