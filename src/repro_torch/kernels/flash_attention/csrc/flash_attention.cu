// Causal / non-causal GQA flash attention for Hopper (sm_90a): online
// softmax over key tiles, never materialising the (S, T) logits.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py (and the padding rules of its
// wrapper, ops.py).  Semantics kept by both kernels below:
//   * query row r sees key c iff c <= r + (T - S) (bottom-right alignment);
//     key tiles wholly in the future of a query tile are never visited;
//   * the running max m, the running sum l and the output accumulator stay
//     in fp32; the probabilities are rounded to the input type before the
//     P V product (as `p.astype(v.dtype)`), l sums them unrounded;
//   * a row whose l is 0 outputs 0; the output is cast to the input type;
//   * q head h of batch b reads kv head h / group of batch b;
//   * ragged S and T are masked in the kernel: nothing is padded, and rows
//     past S are never written;
//   * q, k, v and out are addressed through (batch, head, seq) strides with
//     D contiguous, so the model passes its (B, S, H, D) projections
//     without a transpose copy.
//
// What bounds it on this card: operations, at the 989 TFLOP/s bf16
// tensor-core rate, at every shape of the models' paths (B 4, S = T, bf16):
//   gemma-2b prefill (Hq 8 / Hkv 1, 2048, D 256, causal): 6.9e10 flops,
//     0.069 ms, against 75 MB of inputs and output, 0.023 ms at 3.35 TB/s;
//   kimi-k2 (64 / 8, 2048, D 112, causal): 2.4e11 flops, 0.243 ms (264 MB,
//     0.079 ms);
//   phi-3-vision prefill (32 / 32, 576 + 2048, D 96, causal): 1.7e11 flops,
//     0.171 ms (258 MB, 0.077 ms); its training shape (2048): 0.104 ms;
//   hubert-xlarge (16 / 16, 2048, D 80, non-causal): 8.6e10 flops, 0.087 ms
//     (84 MB, 0.025 ms).
//
// Two kernels; the choice is fixed by dtype and head dim (`variant_of`,
// mirrored by ops.variant):
//
// "wgmma_tma" -- bf16 at D = 64, 80, 96, 112, 128, 256 (every bf16 head dim
// of the full-size configs):
//   * one CTA per (batch * q head, 64-row query tile): one consumer
//     warpgroup (128 threads) and one producer warp (160 threads);
//     blockIdx.y runs over query tiles longest first, so the causal
//     tiles with the most keys start in the first wave;
//   * the producer's one thread starts TMA loads (tensor maps built on the
//     host from the strides, 4-D: D, seq, head, batch; 64-column boxes
//     with the 128-byte swizzle): the Q tile once, then each 64-key K and V
//     tile into a 2-stage ring, each completed on its own mbarrier; the
//     consumer frees a stage's K as soon as S is computed and its V after
//     P V, so the next tiles' loads overlap this tile's work.  TMA
//     zero-fills rows past S or T;
//   * a D that is not a multiple of 64 (80, 96, 112) takes D = 128's tile
//     layout, (D + 63) / 64 = 2 boxes a row: the second box starts at
//     column 64 and TMA zero-fills its columns D .. 127, which lie past the
//     tensor map (the transaction counts the whole box, fill included, as
//     for rows past S or T).  S = Q K^T runs only the k-steps over real
//     columns; P V runs whole chunks, V's zero columns giving zero
//     accumulator columns, rescaled with the rest (left alone they made
//     ptxas serialize the wgmmas) and never stored: the epilogue stores
//     only columns < D (in the model's (B, S, H, D) layout columns
//     D .. 127 of head h are head h + 1's);
//   * S = Q K^T is wgmma m64n64k16 (bf16 in, fp32 accumulate), Q and K
//     K-major from shared memory, D / 16 k-steps (5, 6, 7 at D = 80, 96,
//     112); the causal and ragged-T mask acts on the fp32 S fragment in
//     registers, only on tiles that cross the diagonal or T;
//   * the online softmax runs on the fragment (each thread holds 2 rows x
//     16 keys; a row's max and sum reduce over its 4-thread quad); p is
//     rounded to bf16 into the register A operand of O += P V
//     (wgmma m64n64k16 per 64-column chunk, the accumulator fragment of S
//     is the A fragment of P), with V MN-major from shared memory
//     (transpose bit);
//   * the warpgroup pipelines itself: S of tile j + 1 and P V of tile j go
//     to the tensor cores back to back, and the softmax of tile j + 1 runs
//     while P V of tile j is still in flight (wait_group 1);
//   * O (64 x 64 (D + 63) / 64 fp32: 32 registers a thread a chunk, 128 at
//     D = 256), m and l stay in registers; the epilogue divides by l and
//     stores bf16 pairs.
//   Shared memory: Q 64 x 64 chunks, and 2 x (K + V) tiles of as many, bf16
//   (80 KB at D = 80 .. 128, 160 KB at D = 256: one CTA an SM).  ptxas must
//   not serialize the wgmmas: no non-wgmma instruction may touch an
//   accumulator while its product is in flight (chip_smoke.py fails on
//   ptxas's C7514 note).
//
// "scalar_fp32" -- fp32 at every D (IEEE fp32, which the fp32 tests at
// 2e-4 rely on) and bf16 at D = 16, 32 (the smoke configs):
//   * one CTA of 256 threads per (batch * q head, 64-row query tile); it
//     loops over 64-key tiles up to the causal limit;
//   * the Q tile, and each K and V tile, are staged in shared memory as
//     fp32 (rows padded by 4 floats: conflict-free float4 reads), in
//     dynamic shared memory above 48 KB (cudaFuncSetAttribute);
//   * thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3:
//     its 4 x 4 logits (keys tx + 16 j) and its 4 x D/16 accumulator columns
//     (tx + 16 j) stay in registers; the 16 threads of a row group reduce
//     max and sum with half-warp shuffles;
//   * D is a multiple of 16 (D / 16 accumulator columns a thread: 5, 6
//     and 7 at D = 80, 96, 112) and so of 4 (float4 staging); a padded row
//     of D + 4 floats keeps the float4 reads conflict-free at every D here
//     (the 84- and 116-float rows of D = 80 and 112 put 8 lanes' rows on
//     banks 0, 20, 8, 28, 16, 4, 24, 12; the 100-float rows of D = 96 on
//     0, 4, ..., 28); shared memory (192 (D + 4) + 64 x 68 floats) is 80,
//     92 and 104 KB at D = 80, 96, 112;
//   * scalar fp32 FMAs on the CUDA cores, keys past T zero-filled and
//     masked.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

namespace {

struct Strides {
  long long b, h, s;  // elements; D is contiguous
};

// ============================ scalar_fp32 ============================

constexpr int kThreads = 256;
constexpr int kBQ = 64;     // query rows per CTA
constexpr int kBK = 64;     // keys per tile
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v alike");
constexpr int kGroupLanes = 16;  // threads sharing one group of 4 query rows
constexpr int kRowsPerThread = 4;
constexpr int kKeysPerThread = kBK / kGroupLanes;  // 4
constexpr int kPad = 4;     // floats of padding per shared-memory row
constexpr int kPStride = kBK + kPad;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ + 2 * kBK) * (D + kPad) + size_t(kBQ) * kPStride);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// p as the P V product sees it: rounded to the input type.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Stage `rows` valid rows of a (64, D) tile (row stride `stride` elements,
// D contiguous) into shared memory as fp32; rows past `rows` are zeroed.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int rows) {
  constexpr int kVec = D / 4;
  constexpr int kStride = D + kPad;
  for (int idx = threadIdx.x; idx < kBK * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * kStride + c) = v;
  }
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = kGroupLanes / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroupLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int group, int S, int Tk, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal) {
  constexpr int kStride = D + kPad;
  constexpr int kCols = D / kGroupLanes;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * kStride;
  float* sV = sK + kBK * kStride;
  float* sP = sV + kBK * kStride;

  const int tid = threadIdx.x;
  const int ty = tid / kGroupLanes, tx = tid % kGroupLanes;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y % Hq, hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  const int offset = Tk - S;  // row r sees key c iff c <= r + offset
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kend = causal ? min(Tk, last_row + offset + 1) : Tk;

  load_tile<D>(sQ, qb + q0 * qs.s, qs.s, min(kBQ, S - q0));

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous K, V and P tiles
    load_tile<D>(sK, kb + k0 * ks.s, ks.s, min(kBK, Tk - k0));
    load_tile<D>(sV, vb + k0 * vs.s, vs.s, min(kBK, Tk - k0));
    __syncthreads();

    // ---- logits: s[i][j] = q[4 ty + i] . k[tx + 16 j] ----
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * kRowsPerThread + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + kGroupLanes * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // ---- online softmax: mask, new max, rescale, probabilities ----
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = ty * kRowsPerThread + i;
      const int r = q0 + row;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int c = k0 + tx + kGroupLanes * j;
        const bool ok = c < Tk && (!causal || c <= r + offset);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      // No visible key yet (m_new = -inf): nothing to add, nothing to rescale.
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        rsum += p;
        sP[row * kPStride + tx + kGroupLanes * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row group's P row is written and read by one half-warp

    // ---- acc[i][j] += sum_c P[4 ty + i][c] * V[c][tx + 16 j] ----
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        p[i] = *reinterpret_cast<const float4*>(sP + (ty * kRowsPerThread + i) * kPStride + c);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + kGroupLanes * j;
        const float v0 = sV[(c + 0) * kStride + col];
        const float v1 = sV[(c + 1) * kStride + col];
        const float v2 = sV[(c + 2) * kStride + col];
        const float v3 = sV[(c + 3) * kStride + col];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          float a = acc[i][j];
          a = fmaf(p[i].x, v0, a);
          a = fmaf(p[i].y, v1, a);
          a = fmaf(p[i].z, v2, a);
          a = fmaf(p[i].w, v3, a);
          acc[i][j] = a;
        }
      }
    }
  }

  // ---- out = acc / l (0 where l = 0), cast to the input type ----
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = q0 + ty * kRowsPerThread + i;
    if (r >= S) continue;
    const bool any = l[i] > 0.f;
    T* orow = ob + r * os.s;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[tx + kGroupLanes * j] = from_f<T>(any ? acc[i][j] / l[i] : 0.f);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int S, int Tk, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hq / Hkv, S, Tk, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}


// ============================ wgmma_tma ============================

namespace wg {

constexpr int kBQ = 64;         // query rows per CTA: one consumer warpgroup
constexpr int kBK = 64;         // keys per tile
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + one producer warp

template <int D, int kStages>
struct Layout {
  static_assert(D % 16 == 0, "k-steps of 16 columns; stores of 8");
  // 64-column boxes per row, the last one zero-filled past D.
  static constexpr int kChunks = (D + 63) / 64;
  // Whole boxes: a TMA transaction counts the zero-filled part too.
  static constexpr size_t q_bytes = size_t(kBQ) * kChunks * 64 * 2;
  static constexpr size_t kv_bytes = size_t(kBK) * kChunks * 64 * 2;  // one K or V tile
  static constexpr size_t bar_offset = q_bytes + 2 * kStages * kv_bytes;
  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr size_t bytes = bar_offset + 8 * (1 + 4 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (MUFU.EX2; subnormal results flush to 0, -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      int Hq, int group, int S, int Tk, Strides os, float scale_log2,
                      int causal) {
  using L = Layout<D, kStages>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sK = sQ + kChunks * kBQ * 64;               // [stage][chunk][key][64]
  __nv_bfloat16* sV = sK + kStages * kChunks * kBK * 64;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bar_offset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal tiles first
  const int offset = Tk - S;  // row r sees key c iff c <= r + offset
  const int last_row = min(q0 + kBQ, S) - 1;
  const int kend = causal ? min(Tk, last_row + offset + 1) : Tk;
  const int n_tiles = (kend + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], kConsumers);
      sm90::mbar_init(&v_empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread keeps the ring of K and V tiles full ----
    if (threadIdx.x == kConsumers) {
      sm90::mbar_arrive_expect_tx(q_full, L::q_bytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        sm90::tma_load_4d(sQ + c * kBQ * 64, &tq, q_full, c * 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the previous round's release
        if (j >= kStages) sm90::mbar_wait(&k_empty[s], parity);
        sm90::mbar_arrive_expect_tx(&k_full[s], L::kv_bytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          sm90::tma_load_4d(sK + (s * kChunks + c) * kBK * 64, &tk, &k_full[s], c * 64,
                            j * kBK, hk, b);
        if (j >= kStages) sm90::mbar_wait(&v_empty[s], parity);
        sm90::mbar_arrive_expect_tx(&v_full[s], L::kv_bytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          sm90::tma_load_4d(sV + (s * kChunks + c) * kBK * 64, &tv, &v_full[s], c * 64,
                            j * kBK, hk, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  // Accumulator fragment of a 64 x N wgmma: register 4 n + 2 i + e holds
  // row 16 warp + lane / 4 + 8 i, column 8 n + 2 (lane % 4) + e.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);

  float acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float sc[32];      // S of one tile, then its probabilities (fp32)
  float alpha[2];    // the rescale of acc for the tile in sc
  uint32_t pa[4][4];  // P in bf16: the A operand of the P V product in flight

  // S = Q K_j^T (64 x 64, fp32) into sc: started, not waited for.  Only
  // the D / 16 k-steps over real columns: the zero-filled ones would add 0.
  auto start_s = [&](int j) {
    const int s = j % kStages;
    sm90::mbar_wait(&k_full[s], (j / kStages) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks / 4, kk = ks % 4;  // 64-column chunk, 16-column step in it
      const uint64_t da = sm90::desc_sw128(sQ + c * kBQ * 64 + kk * 16, 16);
      const uint64_t db = sm90::desc_sw128(sK + (s * kChunks + c) * kBK * 64 + kk * 16, 16);
      sm90::wgmma_m64n64k16_ss(sc, da, db, ks != 0);
    }
    sm90::wgmma_commit();
  };
  // Once S_j is in: release K_j, scale to log2 units, mask (diagonal and
  // ragged-T tiles only), update m and l, and leave the probabilities p in
  // sc (2^x as one MUFU.EX2, without exp2f's range handling: the softmax,
  // not the tensor cores, bounds this warpgroup's loop).
  auto softmax = [&](int j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sm90::fence_reg(sc[i]);
    sm90::mbar_arrive(&k_empty[j % kStages]);
    const int k0 = j * kBK;
    const bool masked = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + offset);
    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * n + 2 * i + e] * scale_log2;
          if (masked) {
            const int c = k0 + 8 * n + col0 + e;
            if (c >= Tk || (causal && c > row0 + 8 * i + offset)) x = -INFINITY;
          }
          sc[4 * n + 2 * i + e] = x;
          rmax[i] = fmaxf(rmax[i], x);
        }
    float m_use[2];  // m, or 0 while no key is visible (then every x is -inf)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(rmax[i]));
      // No visible key yet (m_new = -inf): nothing to add, nothing to rescale.
      alpha[i] = m_new == -INFINITY ? 1.f : ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2(sc[4 * n + 2 * i + e] - m_use[i]);
          rsum[i] += pv;
          sc[4 * n + 2 * i + e] = pv;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
  };
  // With no product in flight: round the probabilities in sc to bf16 into
  // pa, the A operand of four m64n64k16 steps (16 keys each: the S
  // fragment's columns 16 kc .. 16 kc + 15); rescale acc, every register:
  // left out, the zero columns past D made ptxas serialize the wgmmas
  // (C7511, "insufficient register resources").
  auto pack = [&]() {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
        sm90::fence_reg(pa[kc][r]);  // packed here, before the next S rewrites sc
      }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[c][4 * n + 2 * i] *= alpha[i];
          acc[c][4 * n + 2 * i + 1] *= alpha[i];
        }
  };
  // O += P_j V_j, V MN-major: started, not waited for.  Whole 64-column
  // chunks, past D too (V's zero-filled columns).
  auto start_pv = [&](int j) {
    const int s = j % kStages;
    sm90::mbar_wait(&v_full[s], (j / kStages) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t db = sm90::desc_sw128(
            sV + (s * kChunks + c) * kBK * 64 + kc * 16 * 64, kBK * 64 * 2);
        sm90::wgmma_m64n64k16_rs_mn(acc[c], pa[kc], db);
      }
    sm90::wgmma_commit();
  };
  // Wait for P_j V_j, then release V_j.
  auto finish_pv = [&](int j) {
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::fence_reg(acc[c][i]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) sm90::fence_reg(pa[kc][r]);
    sm90::mbar_arrive(&v_empty[j % kStages]);
  };

  sm90::mbar_wait(q_full, 0);
  start_s(0);
  sm90::wgmma_wait<0>();
  softmax(0);
  // Tile j: S_{j+1} and P_j V_j go to the tensor cores back to back, and
  // the softmax of tile j + 1 runs while P_j V_j is still in flight.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    pack();
    rescale();
    start_s(j + 1);
    start_pv(j);
    sm90::wgmma_wait<1>();  // S_{j+1} is in
    softmax(j + 1);
    finish_pv(j);
  }
  pack();
  rescale();
  start_pv(n_tiles - 1);
  finish_pv(n_tiles - 1);

  // ---- out = acc / l (0 where l = 0), bf16, rows past S and columns
  // past D not written (in a (B, S, H, D) layout they are another head's) ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const int r = row0 + 8 * i;
    if (r >= S) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + r * os.s;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {  // columns 8 g .. 8 g + 7: chunk g / 8, n = g % 8
      const float v0 = l > 0.f ? acc[g / 8][4 * (g % 8) + 2 * i] / l : 0.f;
      const float v1 = l > 0.f ? acc[g / 8][4 * (g % 8) + 2 * i + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g + col0) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (so nothing links -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoEncode = 99999;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 100000;   // + the CUresult (> 0) of a refused tensor map

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map of a bf16 (batch, head, seq, D) tensor, innermost first, with
// boxes of 64 columns x box_rows rows.  The innermost dimension is D
// itself, so where D is not a multiple of 64 the last box's columns past D
// lie outside the map and arrive as zeros, as do rows past S or T
// (FLOAT_OOB_FILL_NONE fills zeros; with the NaN fill a key row past T
// would poison P V, its p being 0 and 0 x NaN NaN).  A dimension of size 1
// is never stepped, so its stride is replaced by a harmless 16-byte
// multiple (2 D bytes: D is a multiple of 16).
int make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int batch,
             Strides st, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const long long fill = 2LL * D;
  const cuuint64_t strides[3] = {cuuint64_t(rows > 1 ? 2 * st.s : fill),
                                 cuuint64_t(heads > 1 ? 2 * st.h : fill),
                                 cuuint64_t(batch > 1 ? 2 * st.b : fill)};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int S,
           int Tk, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           void* stream) {
  constexpr int kStages = 2;  // 3 measured no faster at gemma-2b's prefill shape
  using L = Layout<D, kStages>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, S, Hq, B, qs, kBQ);
  if (!err) err = make_map(&tk, k, D, Tk, Hkv, B, ks, kBK);
  if (!err) err = make_map(&tv, v, D, Tk, Hkv, B, vs, kBK);
  if (err) return err;
  auto kernel = flash_attention_wgmma<D, kStages>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(L::bytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hkv, S, Tk, os,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ============================ dispatch ============================

enum Variant { kScalar = 0, kWgmma = 1 };
const char* const kVariantNames[] = {"scalar_fp32", "wgmma_tma"};

// The fixed choice of kernel (ops.variant says the same).
Variant variant_of(int bf16, int D) {
  return bf16 && (D == 64 || D == 80 || D == 96 || D == 112 || D == 128 || D == 256) ? kWgmma
                                                                                       : kScalar;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
             int Hkv, int S, int Tk, int D, const long long* st, float scale,
             int causal, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  if (variant_of(sizeof(T) == 2, D) == kWgmma) {
    switch (D) {
      case 64: return wg::launch<64>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 80: return wg::launch<80>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 96: return wg::launch<96>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 112: return wg::launch<112>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 128: return wg::launch<128>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 256: return wg::launch<256>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    }
  }
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<32, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
  }
  if constexpr (sizeof(T) == 4) {  // bf16 at these head dims went to wgmma_tma
    switch (D) {
      case 64: return launch<64, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 80: return launch<80, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 96: return launch<96, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 112: return launch<112, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 128: return launch<128, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
      case 256: return launch<256, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, bound with ctypes.  q (B, Hq, S, D), k and v (B, Hkv, T, D),
// out (B, Hq, S, D), each addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, out in that order) with D contiguous, every
// base 16-byte aligned and every stride a multiple of 4 elements (of 8 for
// the wgmma_tma kernel, whose TMA needs 16-byte strides; a stride of a
// dimension of size 1 is not read there).  D is 16, 32, 64, 80, 96, 112,
// 128 or 256; Hq is a multiple of Hkv.  Returns 0, the cudaError_t of the
// launch, 100000 + the CUresult of a refused tensor map, or 99999 (no
// cuTensorMapEncodeTiled): flash_attention_error_string names each.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int S, int T, int D,
                                   const long long* strides, float scale, int causal,
                                   void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, S, T, D, strides, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int Hq, int Hkv, int S, int T, int D,
                                    const long long* strides, float scale, int causal,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, T, D, strides, scale, causal,
                                 stream);
}

// The kernel a call with this dtype (bf16 or fp32) and head dim runs.
extern "C" const char* flash_attention_variant(int bf16, int D) {
  return kVariantNames[variant_of(bf16, D)];
}

// CTAs of one launch: both kernels run one per (batch * q head, 64-row
// query tile).
extern "C" long long flash_attention_ctas(int B, int Hq, int S, int bf16, int D) {
  const int rows = variant_of(bf16, D) == kWgmma ? wg::kBQ : kBQ;
  return (long long)B * Hq * ((S + rows - 1) / rows);
}

extern "C" const char* flash_attention_error_string(int err) {
  static thread_local char buf[96];
  if (err == wg::kErrNoEncode) return "cuTensorMapEncodeTiled not found";
  if (err >= wg::kErrEncode) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - wg::kErrEncode);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
