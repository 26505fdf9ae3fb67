// Fused GroupNorm + SiLU forward for Hopper (sm_90a), in two layouts.
//
// Replaces the Pallas TPU kernel aozora_sdxl_training_tpu/ops/
// groupnorm_silu.py::group_norm_silu_pallas (body _kernel): for x with
// `groups` groups of C / groups channels,
//
//   mean, var  over the HW * (C / groups) elements of each (batch, group), fp32
//   y   = (x - mean) * rsqrt(var + eps) * scale + bias
//   out = y * sigmoid(y), in x's dtype (bfloat16, float16 or float32).
//
// What bounds it: memory. It does ~10 flop per element against 2 bytes read
// and 2 written (bf16 or fp16), far below the card's 295 flop/byte, so the least
// time is x read once and out written once at device bandwidth. The SiLU
// uses the special-function unit twice an element (__expf, __fdividef):
// 16 a clock per SM, which keeps the arithmetic of the apply pass under
// the time of its stores.
//
// Statistics: shifted sums (x - K, K one sample of the data each sum
// covers) keep E[d^2] - E[d]^2 from cancelling when |mean| >> std (the JAX
// kernel's E[x^2] - mean^2 does cancel there); partial (count, mean, M2)
// are folded with Chan et al.'s formula, pairwise or, where a fold is a
// long chain, for many partials at once about a common pivot, which turns
// the fold into sums. Every fold runs in a fixed order, so two runs on the
// same input are bit-identical. The variance is the population variance
// M2 / count, as jnp.var's.
//
// 1. NCHW (B, C, H, W), contiguous: gn_nchw_kernel, one launch, x read from
//    device memory once and out written once. Each (batch, group) is one
//    contiguous span of C / groups * HW elements, and one thread-block
//    cluster of `csize` CTAs (at most 8) owns it; CTA `rank` owns the
//    rank-th slice. The CTA copies its slice into shared memory with TMA
//    bulk copies (cp.async.bulk, NSTAGES pieces, one mbarrier each, so the
//    sums start on the first piece while the others land), takes the shifted
//    sums of the slice, and publishes its (count, mean, M2). After a cluster
//    barrier every CTA folds the cluster's partials in rank order through
//    distributed shared memory (lane r of warp 0 reads CTA r's, lane 0
//    merges them pairwise in rank order, the same in every CTA), then
//    normalises its slice from shared memory and writes it. No second
//    launch, no grid barrier, no second read. Bounds of the design: a slice
//    must fit the CTA's shared memory (227 KB), and where the grid could sit
//    on the card at once, the wrapper (ops/groupnorm_silu.py::nchw_plan)
//    holds each CTA to its share of an SM's 228 KB, so that CTAs do not
//    come in two waves that each load and then store; the part of a slice
//    past `cached` elements is then read twice, once for the sums and once
//    to apply them (mostly from L2). The plan asks the runtime how many
//    clusters fit at once (clusters of 8 fit 120 of an H100's 132 SMs) and
//    sizes the clusters to cover the SMs where the spans allow it. What is
//    left is a fixed cost a launch (~5 us before and between the byte
//    moves: the copies' latency, two cluster barriers) and, at the widest
//    sites, every CTA loading and then storing in step. Where the span is not a whole
//    number of 16-byte vectors (or a pointer is not 16-byte aligned) the
//    same kernel runs with scalar loads into shared memory in place of TMA.
// 2. NHWC (B, HW, C), the op's own layout: the elements of a group are
//    strided by C, so a group is not one span; two launches.
//    gn_nhwc_stats_kernel, grid (chunks, B): each block reads `rows_per_chunk`
//    rows of all C channels with 16-byte vector loads (consecutive threads
//    on consecutive columns, each thread keeping per-channel sums shifted by
//    the channel's value in the chunk's first row), then the whole block
//    folds them: one thread per channel over the rows (mean_c, M2_c), then
//    a warp per group about the group's pivot (its first element in the
//    first row), giving sums (S1, S2) that add across chunks. The last block
//    of a batch to finish (an arrival counter behind __threadfence, reset by
//    that block, so CUDA-graph replays stay right) sums the chunks' partials
//    in chunk order, a warp per group, and writes each group's mean and
//    rstd. gn_nhwc_apply_kernel (one wave of blocks, a programmatic
//    dependent launch that is scheduled while the statistics run and waits
//    for them) then re-reads x (mostly from the 50 MB L2), normalises, and
//    writes out: 1.5x the bytes of the bound from device memory at worst.
//    The counters are one static
//    array per device, so NHWC calls on two streams of one device must not
//    overlap in time.
//
// Any B, HW and C divisible by groups work in both layouts.
//
// Built by aozora_sdxl_training_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the plain C functions at the end.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int THREADS = 256;            // NHWC kernels
constexpr int NCHW_THREADS = 512;
constexpr int NSTAGES = 4;              // TMA pieces of an NCHW slice
constexpr int MAX_BATCH = 65535;        // gridDim.y of the NHWC stats kernel
constexpr int FOLD_GROUPS = 4;          // groups a warp folds at once (NHWC)
constexpr int FOLD_CHUNKS = 8;          // chunks a lane loads at once (NHWC)

// one arrival counter per batch element for the NHWC statistics; each is
// back at 0 when its launch ends
__device__ unsigned int g_arrivals[MAX_BATCH];

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
struct Vec<f16, 8> {
  __device__ static void load(const f16* p, float (&out)[8]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(f16* p, const float (&in)[8]) {
    uint4 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(in[2 * i], in[2 * i + 1]);
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
struct Vec<f16, 1> {
  __device__ static void load(const f16* p, float (&out)[1]) { out[0] = __half2float(*p); }
  __device__ static void store(f16* p, const float (&in)[1]) { *p = __float2half_rn(in[0]); }
};

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float (&out)[1]) { out[0] = *p; }
  __device__ static void store(float* p, const float (&in)[1]) { *p = in[0]; }
};

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(f16 v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// (n, mean, M2) += (nb, mean_b, M2_b): Chan et al.'s pairwise update. The
// weight nb / total is taken with __fdividef (2 ulp; an IEEE division's
// slow-path check made each update ~200 ns long, and the folds are chains
// of them).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mean_b, float m2_b) {
  const float total = n + nb;
  if (total <= 0.f) return;
  const float w = __fdividef(nb, total);
  const float delta = mean_b - mean;
  mean = fmaf(delta, w, mean);
  m2 += m2_b + delta * delta * (n * w);
  n = total;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// ---- mbarrier, TMA bulk copy, cluster barrier (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> this CTA's shared memory, `bytes` a multiple of 16, both
// addresses 16-byte aligned; completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// relaxed: it only tells the cluster that this CTA's reads of the others'
// shared memory are done (their values are already in registers)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Channel of element e of a span (e / HW) and its place in the channel
// (e % HW), walked forward by a fixed step without a division per step.
struct ChanWalk {
  int c, r, q, rm, hw;
  __device__ ChanWalk(int e, int step, int HW)
      : c(e / HW), r(e % HW), q(step / HW), rm(step % HW), hw(HW) {}
  __device__ void next() {
    c += q;
    r += rm;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
  }
};

// v = silu((v - mean) * rstd * scale_c + bias_c) for the V elements of a
// span from the one `w` points at (channel w.c, place w.r in it); sc and
// bi hold the group's scale and bias.
template <int V>
__device__ __forceinline__ void normalise(float (&v)[V], const ChanWalk& w, int HW, float mean,
                                          float rstd, const float* sc, const float* bi) {
  if (V == 1 || HW % V == 0) {
    const float a = rstd * sc[w.c], bb = bi[w.c];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = silu((v[j] - mean) * a + bb);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = HW >= V ? w.c + (w.r + j >= HW) : w.c + (w.r + j) / HW;
      v[j] = silu((v[j] - mean) * (rstd * sc[c]) + bi[c]);
    }
  }
}

// ---- 1. NCHW: one cluster per (batch, group), one launch ----
//
// Dynamic shared memory: the cached slice (`cached` elements of T, rounded
// up to 16 bytes), then the group's per-channel scale and bias (2 * cpg
// floats).
template <typename T, int V>
__global__ void __launch_bounds__(NCHW_THREADS)
gn_nchw_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, int HW, int cpg, int G,
               int span, int slice, int cached, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[2][NCHW_THREADS / 32];
  __shared__ float part[3];   // this CTA's (count, mean, M2), read by the cluster
  __shared__ float stat[2];   // the group's mean and rstd
  __shared__ __align__(8) uint64_t bars[NSTAGES];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long s = blockIdx.x / csize;   // b * G + g
  const int g = (int)(s % G);
  const int lo = min(rank * slice, span);
  const int n_el = min(lo + slice, span) - lo;
  const int nvc = min(n_el, cached) / V;   // vectors held in shared memory
  const int nv = n_el / V;                 // vectors of the slice
  const T* xs = x + s * span + lo;
  T* ys = y + s * span + lo;
  T* cache = reinterpret_cast<T*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (((size_t)cached * sizeof(T) + 15) / 16) * 16);
  float* bi = sc + cpg;
  const int per_stage = (nvc + NSTAGES - 1) / NSTAGES;

  // the slice into shared memory
  if constexpr (V > 1) {
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < NSTAGES; ++k) mbar_init(&bars[k], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < NSTAGES; ++k) {
        const int v0 = min(k * per_stage, nvc), v1 = min(v0 + per_stage, nvc);
        if (v1 > v0) {
          const uint32_t bytes = (uint32_t)(v1 - v0) * V * sizeof(T);
          mbar_expect_tx(&bars[k], bytes);
          bulk_load(cache + (size_t)v0 * V, xs + (size_t)v0 * V, bytes, &bars[k]);
        }
      }
    }
  } else {
    for (int i = tid; i < nvc; i += NCHW_THREADS) cache[i] = xs[i];
  }
  // the group's scale and bias while the slice lands
  for (int c = tid; c < cpg; c += NCHW_THREADS) {
    sc[c] = scale[(size_t)g * cpg + c];
    bi[c] = bias[(size_t)g * cpg + c];
  }
  if constexpr (V == 1) __syncthreads();

  // shifted sums of the slice, shift K = the slice's first element
  const float K = n_el > 0 ? to_float(xs[0]) : 0.f;
  float a1 = 0.f, a2 = 0.f;
  for (int k = 0; k < NSTAGES; ++k) {
    const int v0 = min(k * per_stage, nvc), v1 = min(v0 + per_stage, nvc);
    if (v1 <= v0) continue;
    if constexpr (V > 1) mbar_wait(&bars[k], 0);
    for (int i = v0 + tid; i < v1; i += NCHW_THREADS) {
      float v[V];
      Vec<T, V>::load(cache + (size_t)i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - K;
        a1 += d;
        a2 = fmaf(d, d, a2);
      }
    }
  }
  for (int i = nvc + tid; i < nv; i += NCHW_THREADS) {   // past the cache
    float v[V];
    Vec<T, V>::load(xs + (size_t)i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - K;
      a1 += d;
      a2 = fmaf(d, d, a2);
    }
  }
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    red[0][warp] = a1;
    red[1][warp] = a2;
  }
  __syncthreads();
  if (tid == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < NCHW_THREADS / 32; ++w) {
      t1 += red[0][w];
      t2 += red[1][w];
    }
    const float n = (float)n_el;
    part[0] = n;
    part[1] = n > 0.f ? K + t1 / n : 0.f;
    part[2] = n > 0.f ? fmaxf(t2 - t1 * (t1 / n), 0.f) : 0.f;
  }
  cluster.sync();   // every CTA's part is written
  if (warp == 0) {
    // lane r reads CTA r's partial (one round trip for all), lane 0 folds
    // them in rank order
    float pn = 0.f, pm = 0.f, pq = 0.f;
    if (lane < csize) {
      const float* p = cluster.map_shared_rank(part, lane);
      pn = p[0];
      pm = p[1];
      pq = p[2];
    }
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float nb = __shfl_sync(0xffffffffu, pn, r);
      const float mb = __shfl_sync(0xffffffffu, pm, r);
      const float qb = __shfl_sync(0xffffffffu, pq, r);
      chan_merge(n, mean, m2, nb, mb, qb);
    }
    if (lane == 0) {
      stat[0] = mean;
      stat[1] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();
  cluster_arrive();   // done reading the other CTAs' shared memory
  const float mean = stat[0], rstd = stat[1];

  // normalise, affine, SiLU; element e of the span is in channel e / HW
  ChanWalk w(lo + tid * V, NCHW_THREADS * V, HW);
  for (int i = tid; i < nvc; i += NCHW_THREADS, w.next()) {
    float v[V];
    Vec<T, V>::load(cache + (size_t)i * V, v);
    normalise<V>(v, w, HW, mean, rstd, sc, bi);
    Vec<T, V>::store(ys + (size_t)i * V, v);
  }
  ChanWalk wr(lo + (nvc + tid) * V, NCHW_THREADS * V, HW);
  for (int i = nvc + tid; i < nv; i += NCHW_THREADS, wr.next()) {
    float v[V];
    Vec<T, V>::load(xs + (size_t)i * V, v);
    normalise<V>(v, wr, HW, mean, rstd, sc, bi);
    Vec<T, V>::store(ys + (size_t)i * V, v);
  }
  cluster_wait();   // no CTA leaves while another may read its part
}

// ---- 2a. NHWC: per-chunk group statistics; the last block folds them ----
//
// Shared memory: s1 and s2, each [rows_per_pass][C] fp32, the per-thread
// column sums (rows_per_pass threads share a column when C / V < THREADS);
// the chunk's first row (each channel's shift, C floats); each group's
// pivot (G floats).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_nhwc_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     float* __restrict__ gstat, int HW, int C, int G, int rows_per_chunk,
                     float eps) {
  extern __shared__ float smem[];
  __shared__ bool is_last;
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncols = C / V, cpg = C / G;
  const int rows_per_pass = ncols >= THREADS ? 1 : THREADS / ncols;
  const int row0 = chunk * rows_per_chunk;
  const int rows = min(rows_per_chunk, HW - row0);
  const T* xrow0 = x + (size_t)b * HW * C;         // the batch element's first row
  const T* xb = xrow0 + (size_t)row0 * C;          // the chunk's first row
  float* s1 = smem;
  float* s2 = smem + (size_t)rows_per_pass * C;
  float* shift_c = s2 + (size_t)rows_per_pass * C;
  float* pivot = shift_c + C;

  // the apply kernel may be scheduled now (it waits for this grid to finish
  // before it reads gstat): its launch overlaps this kernel
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int g = tid; g < G; g += THREADS) pivot[g] = to_float(xrow0[(size_t)g * cpg]);
  const int rsub = ncols >= THREADS ? 0 : tid / ncols;
  if (rsub < rows_per_pass) {
    const int col_step = ncols >= THREADS ? THREADS : ncols;
    for (int col = ncols >= THREADS ? tid : tid % ncols; col < ncols; col += col_step) {
      float shift[V], a1[V], a2[V], v[V];
      Vec<T, V>::load(xb + (size_t)col * V, shift);
#pragma unroll
      for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
      // unrolled so that each thread keeps several loads in flight
#pragma unroll 8
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
        if (rsub == 0) shift_c[col * V + j] = shift[j];
      }
    }
  }
  __syncthreads();

  // fold the rows of each channel (a thread per channel; the result goes to
  // row 0, which only that thread reads) ...
  const float n_c = (float)rows;   // elements of one channel in this chunk
  for (int c = tid; c < C; c += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < rows_per_pass; ++r) {
      t1 += s1[(size_t)r * C + c];
      t2 += s2[(size_t)r * C + c];
    }
    s1[c] = shift_c[c] + t1 / n_c;                 // the channel's mean
    s2[c] = fmaxf(t2 - t1 * (t1 / n_c), 0.f);      // and M2
  }
  __syncthreads();
  // ... then the channels of each group (a warp per group), with Chan's
  // formula for many sets at once about the group's pivot P, the group's
  // first element in the batch element's first row: S1 = sum of
  // n_c (mean_c - P), S2 = sum of M2_c + n_c (mean_c - P)^2. Every block
  // uses the same P, so its (S1, S2) add across chunks: the folds from here
  // on are sums. Stored as S1[b][g][chunk] and S2[b][g][chunk].
  const size_t plane = (size_t)gridDim.y * G * nchunks;
  float* ps1 = partial;
  float* ps2 = partial + plane;
  for (int g = warp; g < G; g += THREADS / 32) {
    const float P = pivot[g];
    float t1 = 0.f, t2 = 0.f;
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
      const float d = s1[c] - P;
      t1 = fmaf(n_c, d, t1);
      t2 += fmaf(n_c * d, d, s2[c]);
    }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    if (lane == 0) {
      ps1[((size_t)b * G + g) * nchunks + chunk] = t1;
      ps2[((size_t)b * G + g) * nchunks + chunk] = t2;
    }
  }

  // the last block of this batch element to finish folds every chunk
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&g_arrivals[b], 1u) == (unsigned)(nchunks - 1);
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) g_arrivals[b] = 0;   // ready for the next launch
  __threadfence();
  // a warp per group; lane l sums chunks l, l + 32, ... in order, then the
  // fixed butterfly. FOLD_GROUPS groups' partials (FOLD_CHUNKS a lane) are
  // loaded before any is added, so the L2 round trips overlap. Each group's
  // mean and rstd go to gstat[b][g].
  const float count = (float)HW * cpg;
  for (int g0 = warp * FOLD_GROUPS; g0 < G; g0 += (THREADS / 32) * FOLD_GROUPS) {
    float sum1[FOLD_GROUPS] = {}, sum2[FOLD_GROUPS] = {};
    for (int k0 = 0; k0 < nchunks; k0 += 32 * FOLD_CHUNKS) {
      float l1[FOLD_GROUPS][FOLD_CHUNKS], l2[FOLD_GROUPS][FOLD_CHUNKS];
#pragma unroll
      for (int gi = 0; gi < FOLD_GROUPS; ++gi)
#pragma unroll
        for (int i = 0; i < FOLD_CHUNKS; ++i) {
          const int g = g0 + gi, k = k0 + 32 * i + lane;
          const bool ok = g < G && k < nchunks;
          const size_t at = ((size_t)b * G + (ok ? g : 0)) * nchunks + (ok ? k : 0);
          l1[gi][i] = ok ? __ldcg(ps1 + at) : 0.f;
          l2[gi][i] = ok ? __ldcg(ps2 + at) : 0.f;
        }
#pragma unroll
      for (int gi = 0; gi < FOLD_GROUPS; ++gi)
#pragma unroll
        for (int i = 0; i < FOLD_CHUNKS; ++i) {
          sum1[gi] += l1[gi][i];
          sum2[gi] += l2[gi][i];
        }
    }
#pragma unroll
    for (int gi = 0; gi < FOLD_GROUPS; ++gi) {
      const int g = g0 + gi;
      const float t1 = warp_sum(sum1[gi]), t2 = warp_sum(sum2[gi]);
      if (lane == 0 && g < G) {   // lane 0's sums: the same in every run
        const float d = t1 / count;   // mean - P
        gstat[2 * ((size_t)b * G + g)] = pivot[g] + d;
        gstat[2 * ((size_t)b * G + g) + 1] = rsqrtf(fmaxf(t2 / count - d * d, 0.f) + eps);
      }
    }
  }
}

// ---- 2b. NHWC: normalise, affine, SiLU ----
//
// Grid (column tiles, row tiles, B): a thread owns one vector of V channels,
// holds their coefficients in registers and walks the rows, so the loop has
// no index arithmetic beyond the row stride.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_nhwc_apply_kernel(const T* __restrict__ x, const float* __restrict__ gstat,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ y, int HW, int C, int G, int cols_tile, int rows_per_iter) {
  const int tx = threadIdx.x % cols_tile, ty = threadIdx.x / cols_tile;
  const int col = blockIdx.x * cols_tile + tx;
  if (ty >= rows_per_iter || col >= C / V) return;
  const int b = blockIdx.z, c0 = col * V, cpg = C / G;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the statistics are written
  float mu[V], sc[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float* st = gstat + 2 * ((size_t)b * G + (c0 + j) / cpg);
    mu[j] = st[0];
    sc[j] = st[1] * scale[c0 + j];
    bi[j] = bias[c0 + j];
  }
  const size_t base = (size_t)b * HW * C + c0;
#pragma unroll 4
  for (int r = blockIdx.y * rows_per_iter + ty; r < HW; r += gridDim.y * rows_per_iter) {
    float v[V];
    Vec<T, V>::load(x + base + (size_t)r * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = silu((v[j] - mu[j]) * sc[j] + bi[j]);
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

// Raises the kernel's dynamic shared memory limit to `bytes` the first time
// a launch needs more than the last limit set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int& limit) {
  if ((int)bytes <= limit) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) limit = (int)bytes;
  return e;
}

template <typename T, int V>
int run_nhwc(const void* x, const float* scale, const float* bias, void* y, float* partial,
             float* gstat, int B, int HW, int C, int G, int rows_per_chunk, float eps,
             cudaStream_t stream) {
  const int ncols = C / V;
  const int rows_per_pass = ncols >= THREADS ? 1 : THREADS / ncols;
  static int smem_limit = 0;
  const size_t smem = sizeof(float) * ((2 * (size_t)rows_per_pass + 1) * C + G);
  cudaError_t e = allow_smem(gn_nhwc_stats_kernel<T, V>, smem, smem_limit);
  if (e != cudaSuccess) return (int)e;
  const int nchunks = (HW + rows_per_chunk - 1) / rows_per_chunk;
  gn_nhwc_stats_kernel<T, V><<<dim3(nchunks, B), THREADS, smem, stream>>>(
      (const T*)x, partial, gstat, HW, C, G, rows_per_chunk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // as many blocks as the SMs hold at once (one wave), each thread then
  // walks several rows
  static int apply_blocks_per_sm = 0;
  if (apply_blocks_per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&apply_blocks_per_sm,
                                                      gn_nhwc_apply_kernel<T, V>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (apply_blocks_per_sm < 1) apply_blocks_per_sm = 1;
  }
  const int cols_tile = ncols < THREADS ? ncols : THREADS;
  const int rows_per_iter = THREADS / cols_tile;
  const int col_tiles = (ncols + cols_tile - 1) / cols_tile;
  const int row_tiles_max = (HW + rows_per_iter - 1) / rows_per_iter;
  int row_tiles = num_sms() * apply_blocks_per_sm / (col_tiles * B);
  row_tiles = row_tiles < 1 ? 1 : row_tiles > row_tiles_max ? row_tiles_max : row_tiles;
  // a programmatic dependent launch: scheduled while the statistics kernel
  // runs, its blocks wait (griddepcontrol.wait) until that grid is done
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, row_tiles, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_nhwc_apply_kernel<T, V>, (const T*)x, (const float*)gstat,
                         scale, bias, (T*)y, HW, C, G, cols_tile, rows_per_iter);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Sets what a launch of gn_nchw_kernel<T, V> with `smem` bytes of dynamic
// shared memory needs: the most shared memory an SM can give (so that two
// or more CTAs sit on it at once) and the dynamic shared memory limit.
template <typename T, int V>
cudaError_t prepare_nchw(size_t smem) {
  static int smem_limit = 0;
  cudaError_t e = cudaSuccess;
  if (smem_limit == 0)
    e = cudaFuncSetAttribute(gn_nchw_kernel<T, V>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = allow_smem(gn_nchw_kernel<T, V>, smem, smem_limit);
  return e;
}

cudaLaunchConfig_t nchw_config(int clusters, int csize, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)clusters * csize), 1, 1);
  cfg.blockDim = dim3(NCHW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

size_t nchw_smem(size_t cached_bytes, int cpg) {
  return (cached_bytes + 15) / 16 * 16 + 2 * sizeof(float) * cpg;
}

template <typename T, int V>
int run_nchw(const void* x, const float* scale, const float* bias, void* y, int B, int C,
             int HW, int G, int csize, int slice, int cached, float eps, cudaStream_t stream) {
  const int cpg = C / G;
  const int span = cpg * HW;
  const size_t smem = nchw_smem((size_t)cached * sizeof(T), cpg);
  cudaError_t e = prepare_nchw<T, V>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nchw_config(B * G, csize, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, gn_nchw_kernel<T, V>, (const T*)x, scale, bias, (T*)y, HW, cpg,
                         G, span, slice, cached, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int nchw_max_clusters(int csize, size_t smem) {
  cudaError_t e = prepare_nchw<T, V>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nchw_config(1, csize, smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, gn_nchw_kernel<T, V>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Plain C interface. Returns the cudaError_t of the first launch that
// failed, or 0. `dtype`: 0 = bfloat16, 1 = float32, 2 = float16; scale and bias
// contiguous (C,) fp32.
extern "C" {

const char* aozora_gn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// NHWC: x and y contiguous (B, HW, C); partial fp32 scratch of
// 2 * B * G * ceil(HW / rows_per_chunk) elements; gstat fp32 scratch of
// B * G * 2 (each group's mean and rstd). Two launches.
int aozora_group_norm_silu(int dtype, const void* x, const float* scale, const float* bias,
                           void* y, float* partial, float* gstat, int B, int HW, int C, int G,
                           int rows_per_chunk, float eps, void* stream) {
  if (B <= 0 || B > MAX_BATCH || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      rows_per_chunk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(x) && aligned16(y);
  if (dtype == 0) {
    if (vec && C % 8 == 0)
      return run_nhwc<bf16, 8>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk,
                               eps, s);
    return run_nhwc<bf16, 1>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk, eps,
                             s);
  }
  if (dtype == 1) {
    if (vec && C % 4 == 0)
      return run_nhwc<float, 4>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk,
                                eps, s);
    return run_nhwc<float, 1>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk,
                              eps, s);
  }
  if (dtype == 2) {
    if (vec && C % 8 == 0)
      return run_nhwc<f16, 8>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk,
                              eps, s);
    return run_nhwc<f16, 1>(x, scale, bias, y, partial, gstat, B, HW, C, G, rows_per_chunk, eps,
                            s);
  }
  return (int)cudaErrorInvalidValue;
}

// NCHW: x and y contiguous (B, C, HW), a (batch, group) span of
// C / G * HW < 2^31 elements. `vec` 1 takes 16-byte vectors and TMA (x and
// y 16-byte aligned, the span, slice and cached multiples of the vector), 0
// scalar loads. A cluster of `csize` CTAs (at most 8) per (batch, group),
// CTA r owning elements [r * slice, (r + 1) * slice) of the span, the first
// `cached` of them held in shared memory. One launch.
int aozora_group_norm_silu_nchw(int dtype, int vec, const void* x, const float* scale,
                                const float* bias, void* y, int B, int C, int HW, int G,
                                int csize, int slice, int cached, float eps, void* stream) {
  const long long span = G > 0 ? (long long)(C / G) * HW : 0;
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || span >= (1ll << 31) ||
      csize < 1 || csize > 8 || slice <= 0 || cached < 0 || cached > slice ||
      (long long)slice * csize < span)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int V = dtype == 1 ? 4 : 8;
  if (vec && (!aligned16(x) || !aligned16(y) || span % V || slice % V || cached % V))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec)
      return run_nchw<bf16, 8>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
    return run_nchw<bf16, 1>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
  }
  if (dtype == 1) {
    if (vec)
      return run_nchw<float, 4>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
    return run_nchw<float, 1>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
  }
  if (dtype == 2) {
    if (vec)
      return run_nchw<f16, 8>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
    return run_nchw<f16, 1>(x, scale, bias, y, B, C, HW, G, csize, slice, cached, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `csize` CTAs of the NCHW kernel, each with the
// shared memory `cached` elements need, the card holds at once (the
// runtime's occupancy count); a negative cudaError_t on failure.
int aozora_group_norm_silu_nchw_max_clusters(int dtype, int vec, int C, int G, int csize,
                                             int cached) {
  if (C <= 0 || G <= 0 || C % G != 0 || csize < 1 || csize > 8 || cached < 0)
    return -(int)cudaErrorInvalidValue;
  const int cpg = C / G;
  if (dtype == 0) {
    const size_t smem = nchw_smem((size_t)cached * sizeof(bf16), cpg);
    return vec ? nchw_max_clusters<bf16, 8>(csize, smem) : nchw_max_clusters<bf16, 1>(csize, smem);
  }
  if (dtype == 1) {
    const size_t smem = nchw_smem((size_t)cached * sizeof(float), cpg);
    return vec ? nchw_max_clusters<float, 4>(csize, smem) : nchw_max_clusters<float, 1>(csize, smem);
  }
  if (dtype == 2) {
    const size_t smem = nchw_smem((size_t)cached * sizeof(f16), cpg);
    return vec ? nchw_max_clusters<f16, 8>(csize, smem) : nchw_max_clusters<f16, 1>(csize, smem);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
