// The stabilized sLSTM recurrence over a whole sequence, one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `slstm_seq_pallas` in
// src/repro/kernels/slstm_step/kernel.py.  Semantics kept (its oracle is
// ref.py beside this file's ops.py):
//   * raw_g[t] = (x_proj[g, t] + h_{t-1} . blockdiag(R_g)) + b_g for the
//     gates i, f, z, o, where rec[b, q] = sum_p h_{t-1}[b, head P + p] *
//     R[g, head, p, q]: R is indexed (in, out);
//   * m_t = max(logsig(f) + m_{t-1}, i), c, n and h as in ref.py, with the
//     stable logsig(x) = min(x, 0) - log1p(exp(-|x|)) and
//     h = sigmoid(o) c / max(n, 1e-6);
//   * state and arithmetic in fp32 from h = c = n = 0, m = -1e30; x_proj and
//     R are widened from their type (fp32 or bf16); h is written in fp32;
//   * unlike the TPU kernel, the final (c, n, m) are written too: the
//     decode cache needs them (the final h is the last row of h).
//
// What bounds it on this card: operations.  At the xLSTM main path
// (xlstm-1.3b prefill: B 4, S 2048, H 4, P 512, D 2048, bf16 inputs) one
// launch does 2 * 4 * B * D * P * S = 6.9e10 fp32 flops (1.03 ms at the
// 67 TFLOP/s of the CUDA cores' FMAs) against 2.1e8 bytes of x_proj, R, h
// and state (0.063 ms at 3.35 TB/s).  Its real floor is the dependency
// chain: S steps, each needing every h_{t-1} of its head, so at least one
// barrier across the head's blocks per step (a few microseconds each).
//
// Design (simple and right first):
//   * a persistent cooperative launch: block (head, tile) owns `cols`
//     output columns of one head for all four gates, and keeps those
//     columns of R (4 x P x cols, widened to fp32, rows padded so that the
//     reads are free of bank conflicts) in shared memory for the whole
//     sequence.  At P = 512: cols 16, 32 blocks per head, 128 blocks, 140 KB
//     of dynamic shared memory each.  The launch checks with the occupancy
//     API that every block is resident at once and returns
//     cudaErrorCooperativeLaunchTooLarge rather than risk a hang;
//   * per step and per tile of kBT batch rows, the block stages h_{t-1} of
//     its head from h_out[t - 1] (read through L2 with __ldcg: other SMs
//     wrote it), then `split` lanes share each column's dot products (every
//     lane holds kBT x 4 partial sums) and an xor-shuffle reduction leaves
//     every lane of the group with the column's four gate pre-activations
//     for each row; lane r updates row r (split >= kBT), owning that
//     (row, column)'s (c, n, m) for the whole sequence (kept in the state
//     outputs), and writes h_out[t];
//   * h_out is naturally double-buffered (step t reads row t - 1 and writes
//     row t), so one barrier per step suffices, and only the blocks of one
//     head meet there: a per-head arrival counter in device memory (release
//     by fence.acq_rel + red.relaxed, acquire by ld.acquire.gpu polling),
//     zeroed by the wrapper before each launch;
//   * scalar fp32 FMAs on the CUDA cores, R read from shared memory every
//     step: registers or a cluster's distributed shared memory holding R,
//     and a cheaper barrier, are the known ways to the bound (a later PR).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBT = 4;             // batch rows per tile (partial sums per lane)
constexpr int kMaxThreads = 256;
constexpr int kMaxCols = 16;       // output columns per block
constexpr int kBarrierStride = 32; // unsigned ints between two heads' counters
constexpr size_t kSmemLimit = 232448;
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Plan {
  int cols;      // output columns of one head per block (divides P)
  int split;     // lanes sharing one column's dot products (power of two <= 32)
  int threads;   // cols * split
  int r_stride;  // floats per (gate, column) row of R in shared memory
  int blocks;    // H * P / cols
  size_t smem;
};

Plan make_plan(int H, int P) {
  Plan pl{};
  pl.cols = 1;
  while (pl.cols * 2 <= kMaxCols && P % (pl.cols * 2) == 0) pl.cols *= 2;
  for (;;) {
    pl.split = kMaxThreads / pl.cols < 32 ? kMaxThreads / pl.cols : 32;
    // A warp reads rows ql of R at offsets ks + split j: a row stride equal
    // to split modulo 32 puts the warp's (ql, ks) on distinct banks.  With
    // split = 32 a warp reads one row, consecutive words: no padding.
    pl.r_stride = pl.split >= 32 ? P : P + ((pl.split - P % 32) % 32 + 32) % 32;
    pl.smem = sizeof(float) * (size_t(4) * pl.cols * pl.r_stride + size_t(kBT) * P);
    if (pl.smem <= kSmemLimit || pl.cols == 1) break;
    pl.cols /= 2;
  }
  pl.threads = pl.cols * pl.split;
  pl.blocks = H * (P / pl.cols);
  return pl;
}

struct Args {
  const void* xp;      // (4, S, B, D) of T
  const void* R;       // (4, H, P, P) of T
  const float* bias;   // (4, D)
  float* h;            // (S, B, D)
  float* c;            // (B, D): the running, then the final, state
  float* n;
  float* m;
  unsigned int* barrier;  // H counters, kBarrierStride apart, zeroed
  int S, B, H, P;
  int cols, split, r_stride;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Release: the block's writes before the __syncthreads are ordered before
// the arrival (the fence is cumulative), as CUTLASS's GenericBarrier does.
__device__ __forceinline__ void red_release(unsigned int* p) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;"
               :: "l"(p) : "memory");
}

// All blocks of one head meet here: each adds one to the head's counter and
// waits until all `target` arrivals (the head's blocks times the barriers
// passed so far) are in.  The launch is cooperative, so every block is
// resident and the wait ends; a wait far beyond any step's time (about
// 2^28 polls, tens of seconds) means a broken barrier, and traps, so that
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void head_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release(counter);
    unsigned int polls = 0;
    while (ld_acquire(counter) < target) {
      if (++polls == (1u << 28)) __trap();
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) slstm_seq_kernel(Args a) {
  extern __shared__ float smem[];
  const T* __restrict__ xp = static_cast<const T*>(a.xp);
  const T* __restrict__ R = static_cast<const T*>(a.R);
  const int S = a.S, B = a.B, P = a.P, D = a.H * a.P;
  const int cols = a.cols, split = a.split;
  const int tiles = P / cols;
  const int head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * cols;
  float* sR = smem;                                       // [4][cols][r_stride]
  float* sH = smem + size_t(4) * cols * a.r_stride;       // [kBT][P]

  // This block's columns of R, as (gate, column, in), widened to fp32.
  for (int idx = threadIdx.x; idx < 4 * P * cols; idx += blockDim.x) {
    const int ql = idx % cols, p = (idx / cols) % P, g = idx / (cols * P);
    sR[(g * cols + ql) * a.r_stride + p] =
        to_f(R[((size_t(g) * a.H + head) * P + p) * P + q0 + ql]);
  }
  for (int idx = threadIdx.x; idx < kBT * P; idx += blockDim.x) sH[idx] = 0.f;  // h_{-1}

  const int ql = threadIdx.x / split, ks = threadIdx.x % split;
  const int col = head * P + q0 + ql;
  const size_t gate_r = size_t(cols) * a.r_stride;
  const float* r_row = sR + size_t(ql) * a.r_stride;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = a.bias[g * D + col];
  unsigned int* counter = a.barrier + head * kBarrierStride;
  const size_t gate_x = size_t(S) * B * D;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = B - b0 < kBT ? B - b0 : kBT;
      if (t > 0) {
        const float* hp = a.h + (size_t(t - 1) * B + b0) * D + head * P;
        for (int idx = threadIdx.x; idx < nb * P; idx += blockDim.x)
          sH[idx] = __ldcg(hp + size_t(idx / P) * D + idx % P);
      }
      // Lane ks < nb of each column group updates batch row b0 + ks; its
      // operands are loaded ahead of the dot products so that their latency
      // overlaps them.
      const bool updater = ks < nb;
      const size_t row = size_t(b0 + (updater ? ks : 0)) * D + col;
      float x[4] = {0.f, 0.f, 0.f, 0.f}, cs = 0.f, ns = 0.f, ms = kNeg;
      if (updater) {
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = to_f(xp[g * gate_x + size_t(t) * B * D + row]);
        if (t > 0) {
          cs = a.c[row];
          ns = a.n[row];
          ms = a.m[row];
        }
      }
      __syncthreads();

      float acc[kBT][4];
#pragma unroll
      for (int bl = 0; bl < kBT; ++bl)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[bl][g] = 0.f;
      for (int p = ks; p < P; p += split) {
        const float r0 = r_row[p], r1 = r_row[gate_r + p];
        const float r2 = r_row[2 * gate_r + p], r3 = r_row[3 * gate_r + p];
#pragma unroll
        for (int bl = 0; bl < kBT; ++bl) {
          const float hv = sH[bl * P + p];
          acc[bl][0] = fmaf(hv, r0, acc[bl][0]);
          acc[bl][1] = fmaf(hv, r1, acc[bl][1]);
          acc[bl][2] = fmaf(hv, r2, acc[bl][2]);
          acc[bl][3] = fmaf(hv, r3, acc[bl][3]);
        }
      }
      for (int off = split / 2; off > 0; off >>= 1)
#pragma unroll
        for (int bl = 0; bl < kBT; ++bl)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[bl][g] += __shfl_xor_sync(0xffffffffu, acc[bl][g], off);

      // The xor butterfly left every lane of the group with the full sums;
      // pick this lane's row (unrolled selects, no indexed registers).
      if (updater) {
        float sum[4] = {acc[0][0], acc[0][1], acc[0][2], acc[0][3]};
#pragma unroll
        for (int bl = 1; bl < kBT; ++bl)
          if (ks == bl)
#pragma unroll
            for (int g = 0; g < 4; ++g) sum[g] = acc[bl][g];
        const float i_raw = (x[0] + sum[0]) + bias[0];
        const float f_raw = (x[1] + sum[1]) + bias[1];
        const float z_raw = (x[2] + sum[2]) + bias[2];
        const float o_raw = (x[3] + sum[3]) + bias[3];
        const float lf = fminf(f_raw, 0.f) - log1pf(expf(-fabsf(f_raw)));
        const float m_new = fmaxf(lf + ms, i_raw);
        const float i_s = expf(i_raw - m_new);
        const float f_s = expf(lf + ms - m_new);
        const float c_new = f_s * cs + i_s * tanhf(z_raw);
        const float n_new = f_s * ns + i_s;
        const float h_new = (1.f / (1.f + expf(-o_raw))) * c_new / fmaxf(n_new, 1e-6f);
        a.c[row] = c_new;
        a.n[row] = n_new;
        a.m[row] = m_new;
        a.h[size_t(t) * B * D + row] = h_new;
      }
      __syncthreads();  // the next tile restages sH
    }
    if (t + 1 < S) head_barrier(counter, static_cast<unsigned int>(t + 1) * tiles);
  }
}

template <typename T>
int launch(const void* xp, const void* R, const float* bias, float* h, float* c, float* n,
           float* m, unsigned int* barrier, int S, int B, int H, int P, void* stream) {
  if (S < 1 || B < 1 || H < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = make_plan(H, P);
  // split >= kBT: the first kBT lanes of a column group update its rows.
  if (pl.smem > kSmemLimit || pl.split < kBT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = slstm_seq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.blocks > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args args{xp, R, bias, h, c, n, m, barrier, S, B, H, P, pl.cols, pl.split, pl.r_stride};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(pl.blocks),
                                    dim3(pl.threads), params, pl.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes.  x_proj (4, S, B, D) and R (4, H, P, P)
// contiguous, of one type; bias (4, D) fp32; h (S, B, D) and c, n, m (B, D)
// fp32 outputs; barrier: H * 32 unsigned ints, zero.  D = H * P.  Returns
// the cudaError_t of the launch (cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident).
extern "C" int slstm_seq_f32(const void* xp, const void* R, const float* bias, float* h,
                             float* c, float* n, float* m, unsigned int* barrier, int S,
                             int B, int H, int P, void* stream) {
  return launch<float>(xp, R, bias, h, c, n, m, barrier, S, B, H, P, stream);
}

extern "C" int slstm_seq_bf16(const void* xp, const void* R, const float* bias, float* h,
                              float* c, float* n, float* m, unsigned int* barrier, int S,
                              int B, int H, int P, void* stream) {
  return launch<__nv_bfloat16>(xp, R, bias, h, c, n, m, barrier, S, B, H, P, stream);
}

extern "C" const char* slstm_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
