// Fused dual step for Hopper (sm_90a): S = nu W_k, Y = T_gamma(S) / delta,
// G = Y W_k^T, for every agent k of an atom-sharded dictionary in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `dict_dual_step_pallas` in
// src/repro/kernels/dict_dual_step/kernel.py.  That kernel streams each W
// tile through VMEM once and keeps G resident across the atom sweep.  On
// Hopper a G tile at the production width (16 rows x M = 8192, fp32) is
// 512 KB, more than the 227 KB of shared memory a block may use, so G
// cannot stay on chip.
//
// What bounds it on this card: bytes.  One launch must read W (N x M x Kb)
// and write Y and G; at N = 16, M = 8192, Kb = 16384, B = 16 that is about
// 8.6 GB against 1.4e11 flops, so the least time is |W| / 3.35 TB/s.
//
// Design (simple, deterministic, no atomics):
//   * one CTA per (agent, tile of kBB batch rows); the CTA loops over atom
//     tiles of kTK columns;
//   * S phase: thread t owns atom k0 + t and all kBB rows.  Its W column is
//     read straight from device memory (neighbouring threads read
//     neighbouring atoms, so the reads coalesce) with one chunk prefetched
//     in registers, while the nu chunk is staged in shared memory and read
//     as a broadcast;
//   * Y = T(S) / delta is written out and kept, in fp32, in shared memory;
//   * G phase: thread t owns row m0 + t of an M chunk and all kBB rows.  W
//     is read a second time, staged (transposed) through shared memory so
//     the reads still coalesce, and the partial products are added into the
//     CTA's own fp32 G rows in device memory, in the same order every run.
// Ragged M, Kb and B are masked; nothing is padded.  Because G does not fit
// on chip, W is read twice per launch and only N * ceil(B / kBB) CTAs run
// (16 at the production shape, on 132 SMs): the kernel is far from its
// bound.  Splitting the atom sweep over more CTAs, wgmma and TMA are the
// known ways to close that gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBB = 16;         // batch rows per CTA
constexpr int kTK = kThreads;   // atoms per tile: one per thread in the S phase
constexpr int kTM1 = 32;        // M rows per staged nu chunk in the S phase
constexpr int kTM3 = kThreads;  // M rows per chunk in the G phase: one per thread
constexpr int kTK3 = 16;        // atoms per staged W sub-chunk in the G phase
constexpr int kLoad3 = kTM3 * kTK3 / kThreads;  // W values each thread stages

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
dict_dual_step_kernel(const T* __restrict__ W, const T* __restrict__ nu,
                      T* __restrict__ Y, T* __restrict__ G,
                      float* __restrict__ gacc, int M, int Kb, int B,
                      long long nu_agent_stride, float gamma, float delta,
                      int nonneg) {
  __shared__ float s_w[kTM3 * (kTK3 + 1)];           // G phase: W^T staging
  __shared__ __align__(16) float s_nu[kTM1 * kBB];   // S phase: nu chunk [m][b]
  __shared__ __align__(16) float s_y[kTK * kBB];     // Y tile in fp32 [k][b]

  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kBB;
  const int nb = min(kBB, B - b0);
  const size_t agent = blockIdx.y;
  const T* Wa = W + agent * (size_t)M * Kb;
  const T* nua = nu + (long long)agent * nu_agent_stride + (size_t)b0 * M;
  T* Ya = Y + (agent * B + b0) * (size_t)Kb;
  T* Ga = G + (agent * B + b0) * (size_t)M;
  float* Gacc = gacc + (agent * B + b0) * (size_t)M;

  for (int k0 = 0; k0 < Kb; k0 += kTK) {
    const int k = k0 + t;
    const bool k_ok = k < Kb;

    // ---- S phase: acc[b] = sum_m nu[b, m] * W[m, k] ----
    float acc[kBB];
#pragma unroll
    for (int b = 0; b < kBB; ++b) acc[b] = 0.f;

    float pw[kTM1];
    float pn[kTM1 * kBB / kThreads];
    auto load_s = [&](int m0) {
#pragma unroll
      for (int r = 0; r < kTM1; ++r) {
        const int m = m0 + r;
        pw[r] = (k_ok && m < M) ? to_f(Wa[(size_t)m * Kb + k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTM1 * kBB / kThreads; ++i) {
        const int idx = t + i * kThreads;
        const int b = idx / kTM1, r = idx % kTM1;
        const int m = m0 + r;
        pn[i] = (b < nb && m < M) ? to_f(nua[(size_t)b * M + m]) : 0.f;
      }
    };
    load_s(0);
    for (int m0 = 0; m0 < M; m0 += kTM1) {
      float w[kTM1];
#pragma unroll
      for (int r = 0; r < kTM1; ++r) w[r] = pw[r];
      __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
      for (int i = 0; i < kTM1 * kBB / kThreads; ++i) {
        const int idx = t + i * kThreads;
        s_nu[(idx % kTM1) * kBB + idx / kTM1] = pn[i];
      }
      __syncthreads();
      if (m0 + kTM1 < M) load_s(m0 + kTM1);  // in flight during the FMAs below
#pragma unroll
      for (int r = 0; r < kTM1; ++r) {
        const float4* nr = reinterpret_cast<const float4*>(s_nu + r * kBB);
#pragma unroll
        for (int q = 0; q < kBB / 4; ++q) {
          const float4 v = nr[q];
          acc[4 * q + 0] += v.x * w[r];
          acc[4 * q + 1] += v.y * w[r];
          acc[4 * q + 2] += v.z * w[r];
          acc[4 * q + 3] += v.w * w[r];
        }
      }
    }

    // ---- Y = T(S) / delta: written out, and kept in fp32 for G ----
#pragma unroll
    for (int b = 0; b < kBB; ++b) {
      float y = threshold(acc[b], gamma, delta, nonneg);
      if (b >= nb || !k_ok) y = 0.f;
      s_y[t * kBB + b] = y;
      if (b < nb && k_ok) Ya[(size_t)b * Kb + k] = from_f<T>(y);
    }
    __syncthreads();

    // ---- G phase: G[b, m] += sum_k Y[b, k] * W[m, k] over this tile ----
    const int tile_k = min(kTK, Kb - k0);
    for (int m0 = 0; m0 < M; m0 += kTM3) {
      float g[kBB];
#pragma unroll
      for (int b = 0; b < kBB; ++b) g[b] = 0.f;

      float pw3[kLoad3];
      auto load_g = [&](int ks) {
#pragma unroll
        for (int i = 0; i < kLoad3; ++i) {
          const int idx = t + i * kThreads;
          const int row = idx / kTK3, col = idx % kTK3;
          const int m = m0 + row, kk = k0 + ks + col;
          pw3[i] = (m < M && kk < Kb) ? to_f(Wa[(size_t)m * Kb + kk]) : 0.f;
        }
      };
      load_g(0);
      for (int ks = 0; ks < tile_k; ks += kTK3) {
        __syncthreads();  // every thread is done reading the previous sub-chunk
#pragma unroll
        for (int i = 0; i < kLoad3; ++i) {
          const int idx = t + i * kThreads;
          s_w[(idx / kTK3) * (kTK3 + 1) + idx % kTK3] = pw3[i];
        }
        __syncthreads();
        if (ks + kTK3 < tile_k) load_g(ks + kTK3);
#pragma unroll
        for (int c = 0; c < kTK3; ++c) {
          const float wv = s_w[t * (kTK3 + 1) + c];
          const float4* yr = reinterpret_cast<const float4*>(s_y + (ks + c) * kBB);
#pragma unroll
          for (int q = 0; q < kBB / 4; ++q) {
            const float4 v = yr[q];
            g[4 * q + 0] += v.x * wv;
            g[4 * q + 1] += v.y * wv;
            g[4 * q + 2] += v.z * wv;
            g[4 * q + 3] += v.w * wv;
          }
        }
      }
      const int m = m0 + t;
      if (m < M) {
        for (int b = 0; b < nb; ++b) {
          float* dst = Gacc + (size_t)b * M + m;
          *dst = (k0 == 0 ? 0.f : *dst) + g[b];
        }
      }
    }
    __syncthreads();  // s_y is rewritten by the next tile
  }

  // bf16 output: cast the fp32 G rows this thread accumulated.
  if ((const void*)Ga != (const void*)Gacc) {
    for (int m = t; m < M; m += kThreads)
      for (int b = 0; b < nb; ++b)
        Ga[(size_t)b * M + m] = from_f<T>(Gacc[(size_t)b * M + m]);
  }
}

template <typename T>
int launch(const void* W, const void* nu, void* Y, void* G, void* gacc, int N,
           int M, int Kb, int B, long long nu_agent_stride, float gamma,
           float delta, int nonneg, void* stream) {
  const dim3 grid((B + kBB - 1) / kBB, N);
  dict_dual_step_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const T*>(nu), static_cast<T*>(Y),
      static_cast<T*>(G), static_cast<float*>(gacc), M, Kb, B, nu_agent_stride,
      gamma, delta, nonneg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes.  W (N, M, Kb) contiguous; nu rows of agent
// a start at nu + a * nu_agent_stride (0 = one nu shared by all agents), each
// agent's (B, M) block contiguous; Y (N, B, Kb) and G (N, B, M) contiguous.
// gacc is an fp32 (N, B, M) accumulator: G itself for fp32.  Returns the
// cudaError_t of the launch.
extern "C" int dict_dual_step_f32(const void* W, const void* nu, void* Y, void* G,
                                  void* gacc, int N, int M, int Kb, int B,
                                  long long nu_agent_stride, float gamma, float delta,
                                  int nonneg, void* stream) {
  return launch<float>(W, nu, Y, G, gacc, N, M, Kb, B, nu_agent_stride, gamma,
                       delta, nonneg, stream);
}

extern "C" int dict_dual_step_bf16(const void* W, const void* nu, void* Y, void* G,
                                   void* gacc, int N, int M, int Kb, int B,
                                   long long nu_agent_stride, float gamma, float delta,
                                   int nonneg, void* stream) {
  return launch<__nv_bfloat16>(W, nu, Y, G, gacc, N, M, Kb, B, nu_agent_stride,
                               gamma, delta, nonneg, stream);
}

extern "C" const char* dict_dual_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
