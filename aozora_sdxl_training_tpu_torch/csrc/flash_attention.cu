// The bf16 flash-attention forward at head_dim 512 (K4a on the SD-VAE
// mid-attention: one head of 512 over 128 x 128 = 16384 tokens at 1024px),
// on the tensor cores' WMMA tiles. Every other bf16 kernel (K1-K3 at
// head_dim 64, K4a/K4b at 128) lives in flash_attention_sm90.cu (wgmma);
// fp32 inputs go to flash_attention_fp32.cu. This one takes bf16 only.
//
// It replaces the Pallas TPU kernel of
// aozora_sdxl_training_tpu/ops/flash_attention.py:
//
//   flash_fwd_d512_kernel    <- _flash_forward_folded (body _fwd_kernel)
//
// and computes what it computes (exact attention with an online softmax
// over KV tiles, fp32 statistics and accumulation, keys >= Skv masked to
// -1e30, l clamped at 1e-30) but laid out for the GPU: it reads and writes
// the callers' (B, S, H, D) layout directly (row s of head (b, h) starts at
// ((b * S + s) * H + h) * D, the TPU's "folded" (B, S, H*D) layout), lse is
// a plain (B*H, S) fp32 row, and each block loops over the keys inside
// itself, since a grid dimension cannot carry an accumulator on the GPU.
//
// What bounds it: 4 * Sq * Skv * 512 flop against 8 * S * 512 bytes of
// operands, so the tensor cores (0.556 ms at S = 16384). It is the simple
// version, at 5% of that: 32-query WMMA tiles with the O accumulator in
// shared memory and one K/V buffer loaded by plain copies (see the kernel).
// It runs on no trainer path (the encoder's flash route only; the cache
// encoder and the preview's decoder compute in fp32), so its wgmma redesign
// waits in ROADMAP.md.
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

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Rows [row0, row0 + ROWS) of one head into a bf16 D-wide tile (ld LD),
// loaded by THREADS threads with 16-byte copies; rows >= S are zeros.
template <int ROWS, int D, int LD, int THREADS>
__device__ void load_rows(bf16* dst, const bf16* head, int row0, int S, int row_stride) {
  for (int c = threadIdx.x; c < ROWS * (D / 8); c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + col);
    *d = (row0 + r < S)
             ? *reinterpret_cast<const uint4*>(head + (size_t)(row0 + r) * row_stride + col)
             : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// K4a at head_dim 512: forward only, as no caller differentiates there.
//
// A 64-row block does not fit at D=512: its fp32 O tile alone is 128 KB,
// and with a 64 x 512 bf16 Q tile and K and V tiles of 64 KB each a block
// would need ~330 KB of the 227 KB it may have. So:
//
// * 32 query rows per block (Q 33 KB bf16, O 66 KB fp32 in shared memory,
//   where the per-row online-softmax rescale can reach it);
// * one 64 x 512 bf16 key/value buffer (67 KB): K is loaded for S = Q K^T,
//   then V over it for O += P V, so no work is done twice;
// * 8 warps: for S each warp owns one 16 x 16 score tile (32 k-steps over
//   D); the softmax gives each row 8 lanes (columns lane, lane + 8, ...);
//   for P V each warp owns a 16 x 128 slice of O (8 tiles of 4 k-steps).
//
// 175 KB of shared memory: one block per SM, 8 warps. With B * H = 1 the
// grid is Sq / 32 = 512 blocks, about 3.9 waves on 132 SMs. Bound by
// operations (4 * Sq * Skv * 512 flop against 8 * S * 512 bytes of
// operands).
// ---------------------------------------------------------------------------
struct D512 {
  static constexpr int D = 512;
  static constexpr int BQ = 32;               // query rows of a block
  static constexpr int BK = 64;               // key rows of a K/V tile
  static constexpr int WARPS = 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDH = D + 8;           // bf16 Q and K/V tiles
  static constexpr int LDO = D + 4;           // fp32 O tile
  static constexpr int LDS = BK + 4;          // fp32 S tile
  static constexpr int LDP = BK + 8;          // bf16 P tile
  static constexpr int ROW_LANES = THREADS / BQ;   // softmax lanes per row: 8
  static constexpr size_t SMEM =
      (size_t)(BQ * LDH + BK * LDH + BQ * LDP) * sizeof(__nv_bfloat16) +
      (size_t)(BQ * LDO + BQ * LDS) * sizeof(float);
};
static_assert(D512::SMEM <= 232448, "shared memory of one block");
static_assert(D512::BQ * D512::BK / 256 == D512::WARPS, "one 16 x 16 score tile per warp");

__global__ void __launch_bounds__(D512::THREADS)
flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int H, int Sq, int Skv, float scale) {
  using G = D512;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + G::BQ * G::LDH;
  bf16* sP = sKV + G::BK * G::LDH;
  float* sO = reinterpret_cast<float*>(sP + G::BQ * G::LDP);
  float* sS = sO + G::BQ * G::LDO;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * G::BQ;
  const int rs = H * G::D;
  const bf16* qh = q + (size_t)b * Sq * rs + h * G::D;
  const bf16* kh = k + (size_t)b * Skv * rs + h * G::D;
  const bf16* vh = v + (size_t)b * Skv * rs + h * G::D;
  const int warp = threadIdx.x / 32;
  // S = Q K^T: this warp's score tile (rows sr..sr+16, keys sc..sc+16)
  const int sr = (warp / 4) * 16, sc = (warp % 4) * 16;
  // O += P V: this warp's O slice (rows sr, columns oc..oc+128)
  const int oc = (warp % 4) * (G::D / 4);
  // softmax: this thread's row and first column (then every 8th)
  const int r = threadIdx.x / G::ROW_LANES, c0 = threadIdx.x % G::ROW_LANES;

  load_rows<G::BQ, G::D, G::LDH, G::THREADS>(sQ, qh, q0, Sq, rs);
  for (int i = threadIdx.x; i < G::BQ * G::LDO; i += G::THREADS) sO[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += G::BK) {
    __syncthreads();                      // the previous V tile is consumed
    load_rows<G::BK, G::D, G::LDH, G::THREADS>(sKV, kh, k0, Skv, rs);
    __syncthreads();
    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 8
      for (int kk = 0; kk < G::D / 16; ++kk) {
        FragA fa;
        FragBCol fb;
        wmma::load_matrix_sync(fa, sQ + sr * G::LDH + kk * 16, G::LDH);
        wmma::load_matrix_sync(fb, sKV + sc * G::LDH + kk * 16, G::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + sr * G::LDS + sc, acc, G::LDS, wmma::mem_row_major);
    }
    __syncthreads();                      // S is whole and K is consumed
    load_rows<G::BK, G::D, G::LDH, G::THREADS>(sKV, vh, k0, Skv, rs);

    // online softmax of row r over this tile's 64 keys, 8 lanes per row
    float s[G::BK / G::ROW_LANES];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < G::BK / G::ROW_LANES; ++i) {
      const int c = c0 + i * G::ROW_LANES;
      const float x = (k0 + c < Skv) ? sS[r * G::LDS + c] * scale : NEG_INF;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 1; off < G::ROW_LANES; off *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < G::BK / G::ROW_LANES; ++i) {
      const float p = __expf(s[i] - m_new);
      sum += p;
      sP[r * G::LDP + c0 + i * G::ROW_LANES] = __float2bfloat16(p);
    }
#pragma unroll
    for (int off = 1; off < G::ROW_LANES; off *= 2)
      sum += __shfl_xor_sync(FULL, sum, off);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll 8
    for (int i = 0; i < G::D / G::ROW_LANES; ++i) sO[r * G::LDO + c0 + i * G::ROW_LANES] *= alpha;
    __syncthreads();                      // P, V and the rescaled O are ready

    FragA fa[G::BK / 16];
#pragma unroll
    for (int kk = 0; kk < G::BK / 16; ++kk)
      wmma::load_matrix_sync(fa[kk], sP + sr * G::LDP + kk * 16, G::LDP);
#pragma unroll 2
    for (int n = 0; n < G::D / 4 / 16; ++n) {
      float* c = sO + sr * G::LDO + oc + n * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, c, G::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < G::BK / 16; ++kk) {
        FragBRow fb;
        wmma::load_matrix_sync(fb, sKV + kk * 16 * G::LDH + oc + n * 16, G::LDH);
        wmma::mma_sync(acc, fa[kk], fb, acc);
      }
      wmma::store_matrix_sync(c, acc, G::LDO, wmma::mem_row_major);
    }
  }

  // 1 / l per row through shared memory (the S tile is free now), then the
  // whole O tile written row-contiguously by all threads
  const float safe_l = fmaxf(l, 1e-30f);
  __syncthreads();
  if (c0 == 0) {
    sS[r] = 1.f / safe_l;
    if (q0 + r < Sq) lse[(size_t)bh * Sq + q0 + r] = m + logf(safe_l);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G::BQ * G::D; i += G::THREADS) {
    const int row = i / G::D, col = i % G::D;
    if (q0 + row < Sq)
      o[(size_t)b * Sq * rs + (size_t)(q0 + row) * rs + h * G::D + col] =
          __float2bfloat16(sO[row * G::LDO + col] * sS[row]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int fwd_d512(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int Sq, int Skv, float scale, cudaStream_t stream) {
  cudaError_t e = allow_smem(flash_fwd_d512_kernel, D512::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + D512::BQ - 1) / D512::BQ, B * H);
  flash_fwd_d512_kernel<<<grid, D512::THREADS, D512::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface: q and o are contiguous bf16 (B, Sq, H, 512); k and v
// contiguous bf16 (B, Skv, H, 512); lse contiguous (B * H, Sq) fp32.
// Returns the cudaError_t of the launch.
extern "C" {

const char* aozora_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int aozora_flash_fwd_d512(const void* q, const void* k, const void* v, void* o, float* lse,
                          int B, int H, int Sq, int Skv, float scale, void* stream) {
  return fwd_d512(q, k, v, o, lse, B, H, Sq, Skv, scale, (cudaStream_t)stream);
}

}  // extern "C"
