// Causal / non-causal GQA flash attention for Hopper (sm_90a): online
// softmax over key tiles, never materialising the (S, T) logits.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py (and the padding rules of its
// wrapper, ops.py).  Semantics kept:
//   * query row r sees key c iff c <= r + (T - S) (bottom-right alignment);
//     key tiles wholly in the future of a query tile are never visited;
//   * the running max m, the running sum l and the output accumulator stay
//     in fp32; the probabilities are rounded to the input type before the
//     P V product (as `p.astype(v.dtype)`), l sums them unrounded;
//   * a row whose l is 0 outputs 0; the output is cast to the input type;
//   * q head h of batch b reads kv head h / group of batch b.
//
// What bounds it on this card: operations.  At the LM main path (gemma-2b
// prefill: B 4, Hq 8, Hkv 1, S = T = 2048, D 256, bf16, causal) one launch
// needs 6.9e10 flops against 75 MB of inputs and output, 0.069 ms at the
// 989 TFLOP/s bf16 tensor-core rate against 0.023 ms at 3.35 TB/s.
//
// Design (simple and right first; no tensor cores yet):
//   * one CTA of 256 threads per (batch * q head, 64-row query tile); it
//     loops over 64-key tiles up to the causal limit;
//   * the Q tile, and each K and V tile, are staged in shared memory as
//     fp32 (rows padded by 4 floats: conflict-free float4 reads); at D = 256
//     that is 3 x 66.5 KB plus the 17 KB probability tile, in dynamic shared
//     memory above 48 KB (cudaFuncSetAttribute);
//   * thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3:
//     its 4 x 4 logits (keys tx + 16 j) and its 4 x D/16 accumulator columns
//     (tx + 16 j) stay in registers (64 fp32 at D = 256); the 16 threads of a
//     row group reduce max and sum with half-warp shuffles;
//   * the scalar fp32 FMA path (IEEE, no TF32) serves both fp32 (the parity
//     tests) and bf16 (the model), so the kernel runs at the CUDA-core rate,
//     far from its tensor-core bound: wgmma with TMA-fed tiles is the known
//     way to close that gap (a later PR);
//   * ragged S and T are masked in the kernel (rows past S are not written,
//     keys past T are zero-filled and masked): nothing is padded;
//   * q, k, v and out are read and written through (batch, head, seq)
//     strides with D contiguous, so the model passes its (B, S, H, D)
//     projections without a transpose copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

struct Strides {
  long long b, h, s;  // elements; D is contiguous
};

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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
             int Hkv, int S, int Tk, int D, const long long* st, float scale,
             int causal, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<32, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 64: return launch<64, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<128, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    case 256: return launch<256, T>(q, k, v, o, B, Hq, Hkv, S, Tk, qs, ks, vs, os, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes.  q (B, Hq, S, D), k and v (B, Hkv, T, D),
// out (B, Hq, S, D), each addressed through `strides` (12 element strides:
// batch, head, seq for q, k, v, out in that order) with D contiguous, every
// stride and base 16-byte aligned.  D is 16, 32, 64, 128 or 256; Hq is a
// multiple of Hkv.  Returns the cudaError_t of the launch.
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

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
