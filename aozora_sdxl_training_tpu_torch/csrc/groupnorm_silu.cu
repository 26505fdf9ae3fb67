// Fused GroupNorm + SiLU forward for Hopper (sm_90a), NHWC.
//
// Replaces the Pallas TPU kernel aozora_sdxl_training_tpu/ops/
// groupnorm_silu.py::group_norm_silu_pallas (body _kernel): for x of shape
// (B, HW, C) and `groups` groups of C / groups channels,
//
//   mean, var  over the HW * (C / groups) elements of each (batch, group), fp32
//   y   = (x - mean) * rsqrt(var + eps) * scale + bias
//   out = y * sigmoid(y), in x's dtype (bfloat16 or float32).
//
// What bounds it: memory. It does ~10 flop per element against 2 bytes read
// and 2 written (bf16), far below the card's 295 flop/byte, so the least
// time is x read once and out written once at device bandwidth. This design
// reads x twice (once for the statistics, once to apply them), 1.5x that
// bound, as the Pallas kernel's two phases do; the second read of a 2-40 MB
// activation partly hits the 50 MB L2.
//
// The Pallas kernel walks the HW tiles of one batch in order and carries the
// group sums in scratch from one grid step to the next. Blocks on the GPU
// run in no order, so the reduction is split in three launches:
//
// 1. gn_stats_kernel, grid (chunks, B): each block reads `rows_per_chunk`
//    rows (HW / 512 rounded up, so that every site spreads over up to 512
//    blocks) of all C channels with 16-byte vector loads (consecutive
//    threads on consecutive columns, so a row is read coalesced whatever the
//    group width: at C = 320 a group is 10 channels and a vector of 8 bf16
//    may straddle two groups, which does not matter because each thread
//    keeps per-channel sums). Sums are taken of x - K_c, where K_c is the
//    channel's value in the chunk's first row: the shifted sums keep
//    E[d^2] - E[d]^2 from cancelling when |mean| >> std (the JAX kernel's
//    E[x^2] - mean^2 does cancel there). The block then folds its channels
//    into one (count, mean, M2) per group with Chan's pairwise formula.
// 2. gn_finalize_kernel, one warp per (group, batch): folds the chunks'
//    (count, mean, M2) in a fixed order (so the result does not depend on
//    block scheduling) and writes each channel's mean and rstd * scale. The
//    variance is the population variance M2 / count, as jnp.var's and the
//    JAX kernel's.
// 3. gn_apply_kernel: each thread owns one vector of channels (their
//    coefficients in registers) and walks rows, (x - mean) * (rstd * scale)
//    + bias, then SiLU, stored in x's dtype.
//
// Any HW and any C divisible by groups work: the last chunk is short, and
// where C is not a multiple of the vector width (or a pointer is not 16-byte
// aligned) the same kernels run with scalar loads.
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C function at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int APPLY_BLOCKS_PER_SM = 8;

// ---- vector loads and stores of V elements as fp32 ----

template <typename T, int V>
struct Vec;

template <>
struct Vec<bf16, 8> {
  __device__ static void load(const bf16* p, float (&out)[8]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float (&in)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float (&out)[4]) {
    float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
  __device__ static void store(float* p, const float (&in)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<bf16, 1> {
  __device__ static void load(const bf16* p, float (&out)[1]) { out[0] = __bfloat162float(*p); }
  __device__ static void store(bf16* p, const float (&in)[1]) { *p = __float2bfloat16(in[0]); }
};

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float (&out)[1]) { out[0] = *p; }
  __device__ static void store(float* p, const float (&in)[1]) { *p = in[0]; }
};

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// (n, mean, M2) += (nb, mean_b, M2_b): Chan et al.'s pairwise update.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  const float total = n + nb;
  if (total <= 0.f) return;
  const float delta = mean_b - mean;
  mean += delta * (nb / total);
  m2 += m2_b + delta * delta * (n * nb / total);
  n = total;
}

// ---- 1. per-chunk group statistics ----
//
// Shared memory: s1 and s2, each [rows_per_pass][C] fp32, the per-thread
// column sums (rows_per_pass threads share a column when C / V < THREADS).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW, int C, int G,
                int rows_per_chunk) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  const int ncols = C / V;
  const int rows_per_pass = ncols >= THREADS ? 1 : THREADS / ncols;
  const int row0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, HW - row0);
  const T* xb = x + ((size_t)b * HW + row0) * C;   // the chunk's first row
  float* s1 = smem;
  float* s2 = smem + (size_t)rows_per_pass * C;

  const int rsub = ncols >= THREADS ? 0 : threadIdx.x / ncols;
  if (rsub < rows_per_pass) {
    const int col_step = ncols >= THREADS ? THREADS : ncols;
    for (int col = ncols >= THREADS ? threadIdx.x : threadIdx.x % ncols; col < ncols;
         col += col_step) {
      float shift[V], a1[V], a2[V], v[V];
      Vec<T, V>::load(xb + (size_t)col * V, shift);
#pragma unroll
      for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
      // unrolled so that each thread keeps several loads in flight
#pragma unroll 4
      for (int r = rsub; r < rows; r += rows_per_pass) {
        Vec<T, V>::load(xb + (size_t)r * C + (size_t)col * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - shift[j];
          a1[j] += d;
          a2[j] = fmaf(d, d, a2[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[(size_t)rsub * C + col * V + j] = a1[j];
        s2[(size_t)rsub * C + col * V + j] = a2[j];
      }
    }
  }
  __syncthreads();

  const int cpg = C / G;
  const float n_c = (float)rows;   // elements of one channel in this chunk
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < rows_per_pass; ++r) {
        t1 += s1[(size_t)r * C + c];
        t2 += s2[(size_t)r * C + c];
      }
      const float mean_c = to_float(xb[c]) + t1 / n_c;
      const float m2_c = fmaxf(t2 - t1 * (t1 / n_c), 0.f);
      chan_merge(n, mean, m2, n_c, mean_c, m2_c);
    }
    float* out = partial + (((size_t)b * nchunks + chunk) * G + g) * 3;
    out[0] = n;
    out[1] = mean;
    out[2] = m2;
  }
}

// ---- 2. per-channel coefficients: mean and rstd * scale ----
//
// One warp per (group, batch): the lanes fold the chunks' partials in
// strides, then a fixed shuffle tree folds the lanes (the same order in
// every run), and lane 0's result is written for each channel of the group.
__global__ void __launch_bounds__(32)
gn_finalize_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                   float* __restrict__ coef, int C, int G, int nchunks, float eps) {
  const int g = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 4
  for (int k = lane; k < nchunks; k += 32) {
    const float* p = partial + (((size_t)b * nchunks + k) * G + g) * 3;
    chan_merge(n, mean, m2, p[0], p[1], p[2]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, offset);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, offset);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, offset);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  n = __shfl_sync(0xffffffffu, n, 0);
  mean = __shfl_sync(0xffffffffu, mean, 0);
  m2 = __shfl_sync(0xffffffffu, m2, 0);
  const float rstd = rsqrtf(m2 / n + eps);
  const int cpg = C / G;
  for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
    coef[2 * ((size_t)b * C + c)] = mean;
    coef[2 * ((size_t)b * C + c) + 1] = rstd * scale[c];
  }
}

// ---- 3. normalise, affine, SiLU ----
//
// Grid (column tiles, row tiles, B): a thread owns one vector of V channels,
// holds their coefficients in registers and walks the rows, so the loop has
// no index arithmetic beyond the row stride.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                const float* __restrict__ bias, T* __restrict__ y, int HW, int C,
                int cols_tile, int rows_per_iter) {
  const int tx = threadIdx.x % cols_tile, ty = threadIdx.x / cols_tile;
  const int col = blockIdx.x * cols_tile + tx;
  if (ty >= rows_per_iter || col >= C / V) return;
  const int b = blockIdx.z, c0 = col * V;
  float mu[V], sc[V], bi[V];
  const float* cf = coef + 2 * ((size_t)b * C + c0);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = cf[2 * j];
    sc[j] = cf[2 * j + 1];
    bi[j] = bias[c0 + j];
  }
  const size_t base = (size_t)b * HW * C + c0;
  for (int r = blockIdx.y * rows_per_iter + ty; r < HW; r += gridDim.y * rows_per_iter) {
    float v[V];
    Vec<T, V>::load(x + base + (size_t)r * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = (v[j] - mu[j]) * sc[j] + bi[j];
      v[j] = z / (1.f + expf(-z));
    }
    Vec<T, V>::store(y + base + (size_t)r * C, v);
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int V>
int run(const void* x, const float* scale, const float* bias, void* y, float* partial,
        float* coef, int B, int HW, int C, int G, int rows_per_chunk, float eps,
        cudaStream_t stream) {
  const int ncols = C / V;
  const int rows_per_pass = ncols >= THREADS ? 1 : THREADS / ncols;
  const size_t smem = 2 * sizeof(float) * (size_t)rows_per_pass * C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gn_stats_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nchunks = (HW + rows_per_chunk - 1) / rows_per_chunk;
  gn_stats_kernel<T, V><<<dim3(nchunks, B), THREADS, smem, stream>>>(
      (const T*)x, partial, HW, C, G, rows_per_chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_finalize_kernel<<<dim3(G, B), 32, 0, stream>>>(partial, scale, coef, C, G, nchunks, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // enough blocks for ~APPLY_BLOCKS_PER_SM per SM, each thread then walks
  // several rows
  const int cols_tile = ncols < THREADS ? ncols : THREADS;
  const int rows_per_iter = THREADS / cols_tile;
  const int col_tiles = (ncols + cols_tile - 1) / cols_tile;
  const int row_tiles_max = (HW + rows_per_iter - 1) / rows_per_iter;
  int row_tiles = num_sms() * APPLY_BLOCKS_PER_SM / (col_tiles * B);
  row_tiles = row_tiles < 1 ? 1 : row_tiles > row_tiles_max ? row_tiles_max : row_tiles;
  gn_apply_kernel<T, V><<<dim3(col_tiles, row_tiles, B), THREADS, 0, stream>>>(
      (const T*)x, coef, bias, (T*)y, HW, C, cols_tile, rows_per_iter);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Plain C interface. x and y contiguous (B, HW, C) in `dtype` (0 = bfloat16,
// 1 = float32); scale and bias contiguous (C,) fp32; partial fp32 scratch of
// B * ceil(HW / rows_per_chunk) * G * 3 elements; coef fp32 scratch of
// B * C * 2. Returns the cudaError_t of the first launch that failed, or 0.
extern "C" {

const char* aozora_gn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int aozora_group_norm_silu(int dtype, const void* x, const float* scale, const float* bias,
                           void* y, float* partial, float* coef, int B, int HW, int C, int G,
                           int rows_per_chunk, float eps, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || rows_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(y);
  if (dtype == 0) {
    if (vec && C % 8 == 0)
      return run<bf16, 8>(x, scale, bias, y, partial, coef, B, HW, C, G, rows_per_chunk, eps, s);
    return run<bf16, 1>(x, scale, bias, y, partial, coef, B, HW, C, G, rows_per_chunk, eps, s);
  }
  if (dtype == 1) {
    if (vec && C % 4 == 0)
      return run<float, 4>(x, scale, bias, y, partial, coef, B, HW, C, G, rows_per_chunk, eps,
                           s);
    return run<float, 1>(x, scale, bias, y, partial, coef, B, HW, C, G, rows_per_chunk, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
