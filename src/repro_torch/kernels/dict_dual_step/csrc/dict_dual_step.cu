// Fused dual step for Hopper (sm_90a): S = nu W_k, Y = T_gamma(S) / delta,
// G = Y W_k^T, for every agent k of an atom-sharded dictionary in one call.
//
// Replaces the Pallas TPU kernel `_kernel` / `dict_dual_step_pallas` in
// src/repro/kernels/dict_dual_step/kernel.py.  That kernel streams each W
// tile through VMEM once and keeps G resident across the atom sweep.  On
// Hopper a G tile at the production width (16 rows x M = 8192, fp32) is
// 512 KB, more than the 227 KB of shared memory a block may use, and a
// sweep in one block would run one block per (agent, batch tile): 16 on
// 132 SMs at the production shape.
//
// What bounds it on this card: bytes.  One call must read W (N x M x Kb)
// and write Y and G; at N = 16, M = 8192, Kb = 16384, B = 16 that is about
// 8.6 GB against 1.4e11 fp32 flops, so the least time is |W| / 3.35 TB/s
// (2.6 ms), with the flops (2.1 ms at 67 TFLOP/s) close behind: the kernel
// must stream W at full bandwidth and keep the FMA pipes busy.
//
// Design "two_pass": two launches on the caller's stream, each filling the
// card, W read from device memory twice by design (once a pass), every
// output owned by one thread (no atomics, no partial buffers: identical
// bits from run to run):
//   * pass 1 (S and Y): one CTA of 128 threads per (atom tile of 256,
//     agent, batch tile of 16): 1024 CTAs at the production shape.  It
//     streams its W column slab over M, 16 rows a stage, through a 3-stage
//     shared-memory ring fed by cp.async, with the matching nu columns
//     staged transposed ([m][b]) and read as broadcasts; thread t owns
//     atoms 2t, 2t + 1 for all 16 rows (32 fp32 sums in registers, 32 FMAs
//     per 5 shared-memory loads).  Y = T(S) / delta is written out (and in
//     fp32 to `scratch` for the bf16 instantiation);
//   * pass 2 (G): one CTA of 128 threads per (tile of 256 rows of M, agent,
//     batch tile of 16): 512 CTAs.  It streams its W rows, contiguous in
//     memory, 32 atoms a stage through a 2-stage ring (rows padded to 36
//     floats: conflict-free float4 reads), and the fp32 Y columns from L2
//     (1 MB per agent), staged [k][b]; thread t owns rows t and t + 128
//     for all 16 batch rows and writes G once.
// Both passes sum in fp32 FMAs (IEEE; no TF32), each output in one fixed
// order.  Ragged M, Kb and B are masked (zero-filled loads, guarded
// stores); nothing is padded.  The vector width of a W load is a template
// parameter: 4 elements (16 bytes of fp32 through cp.async, 8 of bf16)
// when Kb % 4 == 0 and W is so aligned, else 1 (rows of 132 or 196 bytes
// allow no wider access).  fp32 staging goes through cp.async; bf16 is
// loaded, widened to fp32 and stored by the threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBB = 16;             // batch rows per CTA (both passes)
// pass 1
constexpr int kTK = 2 * kThreads;   // atoms per CTA: 2 per thread
constexpr int kMC = 16;             // rows of W (and of nu) per stage
constexpr int kStages1 = 3;
// pass 2
constexpr int kTM = 2 * kThreads;   // rows of M per CTA: 2 per thread
constexpr int kKC = 32;             // atoms per stage
constexpr int kPitch = kKC + 4;     // floats per staged W row
constexpr int kStages2 = 2;

constexpr size_t kSmem1 = sizeof(float) * kStages1 * (kMC * kTK + kMC * kBB);
constexpr size_t kSmem2 = sizeof(float) * kStages2 * (kTM * kPitch + kKC * kBB);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage kVec elements at src into dst (fp32 in shared memory), zeros when
// !ok (src is then a valid address that is not read).
template <int kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, bool ok) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    static_assert(kVec == 1, "vector width 4 or 1");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

template <int kVec>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, bool ok) {
  if constexpr (kVec == 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    static_assert(kVec == 1, "vector width 4 or 1");
    *dst = ok ? __bfloat162float(*src) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float threshold(float s, float gamma, float delta, int nonneg) {
  if (nonneg) return fmaxf(s - gamma, 0.f) / delta;
  return copysignf(fmaxf(fabsf(s) - gamma, 0.f), s) / delta;
}

// ---- pass 1: Y[a, b, k] = T(sum_m nu[a, b, m] W[a, m, k]) / delta ----
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
dict_dual_step_sy(const T* __restrict__ W, const T* __restrict__ nu, T* __restrict__ Y,
                  float* __restrict__ yacc, int M, int Kb, int B, long long nu_agent_stride,
                  float gamma, float delta, int nonneg) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                            // [stage][kMC][kTK]
  float* sn = smem + kStages1 * kMC * kTK;     // [stage][kMC][kBB]

  const int t = threadIdx.x;
  const int k0 = blockIdx.x * kTK;
  const size_t agent = blockIdx.y;
  const int b0 = blockIdx.z * kBB;
  const int nb = min(kBB, B - b0);
  const T* Wa = W + agent * (size_t)M * Kb;
  const T* nua = nu + (long long)agent * nu_agent_stride + (size_t)b0 * M;

  auto load_chunk = [&](int chunk) {
    const int m0 = chunk * kMC;
    float* dw = sw + (chunk % kStages1) * kMC * kTK;
    constexpr int kPerRow = kTK / kVec;
    static_assert(kMC * kPerRow % kThreads == 0 && kMC * kBB % kThreads == 0, "even split");
#pragma unroll
    for (int j = 0; j < kMC * kPerRow / kThreads; ++j) {
      const int i = t + j * kThreads;
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < Kb;
      stage<kVec>(dw + r * kTK + c, ok ? Wa + (size_t)m * Kb + k : Wa, ok);
    }
    float* dn = sn + (chunk % kStages1) * kMC * kBB;
#pragma unroll
    for (int j = 0; j < kMC * kBB / kThreads; ++j) {
      const int i = t + j * kThreads;
      const int b = i / kMC, r = i % kMC;
      const int m = m0 + r;
      const bool ok = b < nb && m < M;
      stage<1>(dn + r * kBB + b, ok ? nua + (size_t)b * M + m : nua, ok);
    }
  };

  float acc[kBB][2];
#pragma unroll
  for (int b = 0; b < kBB; ++b) acc[b][0] = acc[b][1] = 0.f;

  const int n_chunks = (M + kMC - 1) / kMC;
#pragma unroll
  for (int c = 0; c < kStages1 - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages1 - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    if (c + kStages1 - 1 < n_chunks) load_chunk(c + kStages1 - 1);
    cp_async_commit();
    const float* w = sw + (c % kStages1) * kMC * kTK;
    const float* n = sn + (c % kStages1) * kMC * kBB;
#pragma unroll
    for (int r = 0; r < kMC; ++r) {
      const float2 wv = *reinterpret_cast<const float2*>(w + r * kTK + 2 * t);
      const float4* nr = reinterpret_cast<const float4*>(n + r * kBB);
#pragma unroll
      for (int q = 0; q < kBB / 4; ++q) {
        const float4 v = nr[q];
        acc[4 * q + 0][0] = fmaf(v.x, wv.x, acc[4 * q + 0][0]);
        acc[4 * q + 0][1] = fmaf(v.x, wv.y, acc[4 * q + 0][1]);
        acc[4 * q + 1][0] = fmaf(v.y, wv.x, acc[4 * q + 1][0]);
        acc[4 * q + 1][1] = fmaf(v.y, wv.y, acc[4 * q + 1][1]);
        acc[4 * q + 2][0] = fmaf(v.z, wv.x, acc[4 * q + 2][0]);
        acc[4 * q + 2][1] = fmaf(v.z, wv.y, acc[4 * q + 2][1]);
        acc[4 * q + 3][0] = fmaf(v.w, wv.x, acc[4 * q + 3][0]);
        acc[4 * q + 3][1] = fmaf(v.w, wv.y, acc[4 * q + 3][1]);
      }
    }
  }

  T* Ya = Y + (agent * B + b0) * (size_t)Kb;
  float* ya = yacc + (agent * B + b0) * (size_t)Kb;
  const bool widen = static_cast<const void*>(ya) != static_cast<const void*>(Ya);
#pragma unroll
  for (int b = 0; b < kBB; ++b) {
    if (b >= nb) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = k0 + 2 * t + e;
      if (k >= Kb) continue;
      const float y = threshold(acc[b][e], gamma, delta, nonneg);
      Ya[(size_t)b * Kb + k] = from_f<T>(y);
      if (widen) ya[(size_t)b * Kb + k] = y;
    }
  }
}

// ---- pass 2: G[a, b, m] = sum_k Y[a, b, k] W[a, m, k], Y in fp32 ----
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
dict_dual_step_g(const T* __restrict__ W, const float* __restrict__ yacc, T* __restrict__ G,
                 int M, int Kb, int B) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                            // [stage][kTM][kPitch]
  float* sy = smem + kStages2 * kTM * kPitch;  // [stage][kKC][kBB]

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kTM;
  const size_t agent = blockIdx.y;
  const int b0 = blockIdx.z * kBB;
  const int nb = min(kBB, B - b0);
  const T* Wa = W + agent * (size_t)M * Kb;
  const float* ya = yacc + (agent * B + b0) * (size_t)Kb;

  auto load_chunk = [&](int chunk) {
    const int k0 = chunk * kKC;
    float* dw = sw + (chunk % kStages2) * kTM * kPitch;
    constexpr int kPerRow = kKC / kVec;
    static_assert(kTM * kPerRow % kThreads == 0 && kKC * kBB % kThreads == 0, "even split");
#pragma unroll
    for (int j = 0; j < kTM * kPerRow / kThreads; ++j) {
      const int i = t + j * kThreads;
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < Kb;
      stage<kVec>(dw + r * kPitch + c, ok ? Wa + (size_t)m * Kb + k : Wa, ok);
    }
    float* dy = sy + (chunk % kStages2) * kKC * kBB;
#pragma unroll
    for (int j = 0; j < kKC * kBB / kThreads; ++j) {
      const int i = t + j * kThreads;
      const int b = i / kKC, c = i % kKC;
      const int k = k0 + c;
      const bool ok = b < nb && k < Kb;
      stage<1>(dy + c * kBB + b, ok ? ya + (size_t)b * Kb + k : ya, ok);
    }
  };

  float acc[2][kBB];
#pragma unroll
  for (int b = 0; b < kBB; ++b) acc[0][b] = acc[1][b] = 0.f;

  const int n_chunks = (Kb + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < kStages2 - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages2 - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    if (c + kStages2 - 1 < n_chunks) load_chunk(c + kStages2 - 1);
    cp_async_commit();
    const float* w = sw + (c % kStages2) * kTM * kPitch;
    const float* y = sy + (c % kStages2) * kKC * kBB;
#pragma unroll
    for (int c4 = 0; c4 < kKC; c4 += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(w + t * kPitch + c4);
      const float4 w1 = *reinterpret_cast<const float4*>(w + (t + kThreads) * kPitch + c4);
      const float wr[2][4] = {{w0.x, w0.y, w0.z, w0.w}, {w1.x, w1.y, w1.z, w1.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4* yr = reinterpret_cast<const float4*>(y + (c4 + e) * kBB);
#pragma unroll
        for (int q = 0; q < kBB / 4; ++q) {
          const float4 v = yr[q];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[i][4 * q + 0] = fmaf(v.x, wr[i][e], acc[i][4 * q + 0]);
            acc[i][4 * q + 1] = fmaf(v.y, wr[i][e], acc[i][4 * q + 1]);
            acc[i][4 * q + 2] = fmaf(v.z, wr[i][e], acc[i][4 * q + 2]);
            acc[i][4 * q + 3] = fmaf(v.w, wr[i][e], acc[i][4 * q + 3]);
          }
        }
      }
    }
  }

  T* Ga = G + (agent * B + b0) * (size_t)M;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + t + i * kThreads;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < kBB; ++b) {
      if (b >= nb) break;
      Ga[(size_t)b * M + m] = from_f<T>(acc[i][b]);
    }
  }
}

dim3 grid_sy(int N, int Kb, int B) { return dim3((Kb + kTK - 1) / kTK, N, (B + kBB - 1) / kBB); }
dim3 grid_g(int N, int M, int B) { return dim3((M + kTM - 1) / kTM, N, (B + kBB - 1) / kBB); }

template <typename T, int kVec>
int launch_vec(const T* W, const T* nu, T* Y, T* G, float* yacc, int N, int M, int Kb, int B,
               long long nu_agent_stride, float gamma, float delta, int nonneg,
               cudaStream_t stream) {
  auto sy = dict_dual_step_sy<T, kVec>;
  auto g = dict_dual_step_g<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(sy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(g, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  // An empty output (Kb = 0 for Y, M = 0 for G) takes no launch.
  const dim3 g1 = grid_sy(N, Kb, B), g2 = grid_g(N, M, B);
  if (g1.x * g1.y * g1.z > 0) {
    sy<<<g1, kThreads, kSmem1, stream>>>(W, nu, Y, yacc, M, Kb, B, nu_agent_stride, gamma,
                                         delta, nonneg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (g2.x * g2.y * g2.z > 0) g<<<g2, kThreads, kSmem2, stream>>>(W, yacc, G, M, Kb, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* W, const void* nu, void* Y, void* G, void* scratch, int N, int M,
           int Kb, int B, long long nu_agent_stride, float gamma, float delta, int nonneg,
           void* stream) {
  const T* w = static_cast<const T*>(W);
  const T* n = static_cast<const T*>(nu);
  T* y = static_cast<T*>(Y);
  T* g = static_cast<T*>(G);
  float* yacc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = Kb % 4 == 0 && reinterpret_cast<uintptr_t>(W) % (4 * sizeof(T)) == 0;
  return wide ? launch_vec<T, 4>(w, n, y, g, yacc, N, M, Kb, B, nu_agent_stride, gamma, delta,
                                 nonneg, s)
              : launch_vec<T, 1>(w, n, y, g, yacc, N, M, Kb, B, nu_agent_stride, gamma, delta,
                                 nonneg, s);
}

}  // namespace

// C interface, bound with ctypes.  W (N, M, Kb) contiguous; nu rows of agent
// a start at nu + a * nu_agent_stride (0 = one nu shared by all agents), each
// agent's (B, M) block contiguous; Y (N, B, Kb) and G (N, B, M) contiguous.
// scratch is an fp32 (N, B, Kb) buffer that carries Y in fp32 from pass 1 to
// pass 2: Y itself for fp32.  Two launches on `stream`; returns the
// cudaError_t of the first that failed, or 0.
extern "C" int dict_dual_step_f32(const void* W, const void* nu, void* Y, void* G,
                                  void* scratch, int N, int M, int Kb, int B,
                                  long long nu_agent_stride, float gamma, float delta,
                                  int nonneg, void* stream) {
  return launch<float>(W, nu, Y, G, scratch, N, M, Kb, B, nu_agent_stride, gamma, delta,
                       nonneg, stream);
}

extern "C" int dict_dual_step_bf16(const void* W, const void* nu, void* Y, void* G,
                                   void* scratch, int N, int M, int Kb, int B,
                                   long long nu_agent_stride, float gamma, float delta,
                                   int nonneg, void* stream) {
  return launch<__nv_bfloat16>(W, nu, Y, G, scratch, N, M, Kb, B, nu_agent_stride, gamma,
                               delta, nonneg, stream);
}

// CTAs of pass 1 (pass = 1) or pass 2 (pass = 2) at this shape.
extern "C" long long dict_dual_step_ctas(int N, int M, int Kb, int B, int pass) {
  const dim3 g = pass == 1 ? grid_sy(N, Kb, B) : grid_g(N, M, B);
  return (long long)g.x * g.y * g.z;
}

extern "C" const char* dict_dual_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
