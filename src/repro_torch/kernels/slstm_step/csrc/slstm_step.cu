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
//     R are widened exactly from their type (fp32 or bf16); h is written in
//     fp32;
//   * unlike the TPU kernel, the final (c, n, m) are written too: the
//     decode cache needs them (the final h is the last row of h).
//
// What bounds it on this card: operations.  At the xLSTM main path
// (xlstm-1.3b prefill: B 4, S 2048, H 4, P 512, D 2048, bf16 inputs) one
// launch does 2 * 4 * B * D * P * S = 6.9e10 fp32 flops (1.03 ms at the
// 67 TFLOP/s of the CUDA cores' FMAs) against 2.1e8 bytes (0.063 ms).  Its
// real floor is the dependency chain: S steps, each needing all of h_{t-1}
// of its head, so one exchange of h and one barrier per step.
//
// Design ("cluster"): R is block-diagonal per head and batch rows do not
// interact, so one (head, group of kBT = 4 batch rows) is an independent
// recurrence, and it runs on one thread-block cluster of `cs` CTAs:
//   * R stays on chip for the whole sequence.  CTA `rank` of the cluster
//     owns `cols` = P / cs output columns of its head for all four gates,
//     at most kBudget = 64 Ki values of R (cs = 16 at P = 512: 32 columns,
//     128 KB in bf16).  Thread (column ql, slice ks) holds the inputs
//     p = 4 ks + 4 KS j + e (j < NJ, e < 4) of its column: bf16 R packed two
//     to a register (128 registers at the main shape, fully unrolled loops,
//     no indexed registers).  fp32 R is split exactly into its upper 16
//     bits, kept in registers as bf16 R is, and its lower 16 bits, kept in
//     shared memory (128 KB at P = 512).  Either way one byte permute per
//     value and step joins the upper half with its lower half (zero for
//     bf16) into the fp32 operand: one design for both types;
//   * h_{t-1} is read from the CTA's own shared memory, a (2, kBT, PP) fp32
//     double buffer (PP >= P, zero padded).  After its cell update at step
//     t a CTA stages its h_t columns in stage t & 1 (a (2, kBT, cols)
//     double buffer), then pushes them into buffer t & 1 of every CTA of
//     the cluster with `st.async` (16-byte stores into distributed shared
//     memory that count their bytes on the receiver's mbarrier t & 1), then
//     stores h_t to h_out.  The stage is read after the step's
//     __syncthreads and rewritten at step t + 2, after the next one, which
//     every warp reaches only after those reads.  Step t + 1 starts when
//     the CTA's mbarrier t & 1 has counted all kBT x P x 4 bytes of h_t (a
//     phase per use, armed by one thread with expect_tx).  No cluster
//     barrier is needed per step: a peer pushes h_t into buffer t & 1 only
//     after it has all of h_{t-1}, so after every CTA has finished step
//     t - 1, the last read of that buffer.  (A first version met at
//     barrier.cluster arrive / wait each step instead, with plain remote
//     stores; its release waits on a MEMBAR.ALL.GPU, and it ran slower.)
//     Every CTA passes one cluster barrier after setting its mbarriers and
//     zeroing its buffers, before any store, and one before it exits;
//   * the owner of a (row, column) keeps its c, n, m in registers for all
//     S steps and writes them once at the end; x_proj[t] is loaded at the
//     start of step t and used after the products, which hide its latency;
//   * the products are fp32 FMAs on the CUDA cores, h read from shared
//     memory as 16-byte loads that the lanes of one slice share and the
//     slices take from distinct banks.  The sum over P is each lane's
//     slice in order, then a fixed shuffle tree (reduce-scatter over the
//     batch rows, then a butterfly), so a repeated launch gives the same
//     bits;
//   * the grid is H x ceil(B / kBT) clusters of cs CTAs, launched with
//     cudaLaunchKernelEx and a cluster dimension; cs = 16 is a non-portable
//     cluster size (opted in per kernel).  Clusters never wait on each
//     other, so they need not be co-resident; the launch fails if not one
//     cluster fits (cudaOccupancyMaxActiveClusters, queried once per plan).
//
// Shapes: P a multiple of 4 and of 4 cs, at most 512, with NJ <= 16 (every
// power of two from 4 to 512; `make_plan` says which others); ops.py's
// `plan` mirrors `make_plan` and refuses the rest before a launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBT = 4;           // batch rows per cluster
constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 16;  // the largest cluster Hopper allows (non-portable)
constexpr int kBudget = 65536;   // values of R one CTA holds
constexpr int kSends = 2;        // 16-byte pieces of h_t a lane sends per step (P <= 2 threads)
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a CTA may opt into
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
  int cs;       // CTAs per cluster (power of two <= 16)
  int cols;     // output columns of one head per CTA, P / cs
  int ks;       // lanes sharing one column's products (KS)
  int nj;       // 4-input groups per lane (NJ), a power of two <= 16
  int pp;       // padded row length of the h buffer, 4 KS NJ >= P
  int threads;  // cols * KS rounded up to a warp
  int groups;   // ceil(B / kBT)
  int clusters; // H * groups
  int ctas;     // clusters * cs
  size_t smem;
};

bool make_plan(int B, int H, int P, bool fp32, Plan* pl) {
  if (B < 1 || H < 1 || P < 4 || P % 4) return false;
  Plan p{};
  p.cs = 1;
  while (4 * P * (P / p.cs) > kBudget) p.cs *= 2;
  if (p.cs > kMaxCluster || P % (4 * p.cs)) return false;
  p.cols = P / p.cs;
  int lim = kMaxThreads / p.cols < P / 4 ? kMaxThreads / p.cols : P / 4;
  if (lim > 8) lim = 8;
  p.ks = 1;
  while (p.ks * 2 <= lim) p.ks *= 2;
  const int need = (P + 4 * p.ks - 1) / (4 * p.ks);
  p.nj = 1;
  while (p.nj < need) p.nj *= 2;
  if (p.nj > 16) return false;
  p.pp = 4 * p.ks * p.nj;
  p.threads = (p.cols * p.ks + 31) / 32 * 32;
  if (P > kSends * p.threads) return false;  // kBT P / 4 pieces of h_t per step
  p.groups = (B + kBT - 1) / kBT;
  p.clusters = H * p.groups;
  p.ctas = p.clusters * p.cs;
  // Two mbarriers, fp32's lower halves of R (8 words per lane per j), the h
  // double buffer, the double-buffered stage of h_t's columns.
  p.smem = 16 + (fp32 ? size_t(p.threads) * p.nj * 32 : 0) +
           sizeof(float) * size_t(2) * kBT * (p.pp + p.cols);
  *pl = p;
  return true;
}

struct Args {
  const void* xp;      // (4, S, B, D) of T
  const void* R;       // (4, H, P, P) of T
  const float* bias;   // (4, D)
  float* h;            // (S, B, D)
  float* c;            // (B, D): the final state
  float* n;
  float* m;
  int S, B, H, P, cs, cols, pp;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of incoming stores for the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A 16-byte store into a peer's shared memory that counts its bytes on the
// peer's mbarrier when it lands.
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// One reduce-scatter level over the rows: the lane holds NR rows x 4 gates
// in v[0 .. 4 NR), keeps the upper or the lower half of the rows and adds
// its partner's (lane ^ off) share of them.
template <int NR>
__device__ __forceinline__ void split_rows(float (&v)[4 * kBT], int off, bool upper) {
#pragma unroll
  for (int i = 0; i < 2 * NR; ++i) {
    const float lo = v[i], hi = v[i + 2 * NR];
    const float send = upper ? lo : hi;
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The cell update of one (row, column): gate sums s, prefetched x, bias b.
__device__ __forceinline__ float cell(const float (&s)[4], const float (&x)[4],
                                      const float (&b)[4], float& c, float& n, float& m) {
  const float i_raw = (x[0] + s[0]) + b[0];
  const float f_raw = (x[1] + s[1]) + b[1];
  const float z_raw = (x[2] + s[2]) + b[2];
  const float o_raw = (x[3] + s[3]) + b[3];
  const float lf = fminf(f_raw, 0.f) - log1pf(expf(-fabsf(f_raw)));
  const float m_new = fmaxf(lf + m, i_raw);
  const float i_s = expf(i_raw - m_new);
  const float f_s = expf(lf + m - m_new);
  c = f_s * c + i_s * tanhf(z_raw);
  n = f_s * n + i_s;
  m = m_new;
  return (1.f / (1.f + expf(-o_raw))) * c / fmaxf(n, 1e-6f);
}

template <typename T, int KS, int NJ>
__global__ void __launch_bounds__(kMaxThreads) slstm_cluster_kernel(Args a) {
  constexpr bool kSplitR = std::is_same<T, float>::value;  // fp32: lower halves in smem
  constexpr int kSplits = KS >= 4 ? 2 : (KS == 2 ? 1 : 0);  // reduce-scatter levels
  constexpr int kRows = kBT >> kSplits;                     // rows a lane owns after them
  constexpr int kFull = KS >> kSplits;                      // lanes of the final butterfly
  using Bits = typename std::conditional<kSplitR, uint32_t, uint16_t>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int S = a.S, B = a.B, P = a.P, D = a.H * a.P, cols = a.cols, PP = a.pp;
  const int rank = blockIdx.x % a.cs, cid = blockIdx.x / a.cs;
  const int head = cid % a.H, b0 = (cid / a.H) * kBT;
  const int q0 = rank * cols;
  const int ql = tid / KS, ks = tid % KS;
  const bool active = ql < cols;
  const int col = head * P + q0 + (active ? ql : 0);

  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);  // [2]: h buffer b's arrivals
  uint4* sLo = reinterpret_cast<uint4*>(smem + 16);  // [NJ][2][nthreads] (fp32 only)
  float* sH = reinterpret_cast<float*>(smem + 16 + (kSplitR ? size_t(nthreads) * NJ * 32 : 0));
  float* sStage = sH + 2 * kBT * PP;            // [2][kBT][cols]: h_t in stage t & 1

  // This lane's inputs of R: word (j, g, e2) packs p0 = 4 ks + 4 KS j + 2 e2
  // (low half) and p0 + 1 (high half).
  uint32_t rw[NJ * 8];
  {
    const Bits* Rb = static_cast<const Bits*>(a.R);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t lo[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int g = w / 2, p0 = 4 * ks + 4 * KS * j + 2 * (w % 2);
        const size_t base = ((size_t(g) * a.H + head) * P) * P + q0 + ql;
        const uint32_t v0 = active && p0 < P ? Rb[base + size_t(p0) * P] : 0u;
        const uint32_t v1 = active && p0 + 1 < P ? Rb[base + size_t(p0 + 1) * P] : 0u;
        if constexpr (kSplitR) {
          rw[j * 8 + w] = (v0 >> 16) | (v1 & 0xffff0000u);
          lo[w] = (v0 & 0xffffu) | (v1 << 16);
        } else {
          rw[j * 8 + w] = v0 | (v1 << 16);
        }
      }
      if constexpr (kSplitR) {
        sLo[(j * 2) * nthreads + tid] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        sLo[(j * 2 + 1) * nthreads + tid] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      }
    }
  }
  for (int i = tid; i < 2 * kBT * PP; i += nthreads) sH[i] = 0.f;  // h_{-1} and the padding
  if (tid == 0) {
    mbar_init(&mbar[0], 1);
    mbar_init(&mbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The rows this lane owns after the reduce-scatter: row0 .. row0 + kRows - 1,
  // owned by the lanes whose final-butterfly bits are 0.
  int row0 = 0;
  if (kSplits >= 1 && (ks & (KS / 2))) row0 += 2;
  if (kSplits == 2 && (ks & (KS / 4))) row0 += 1;
  const bool owner = active && (ks & (kFull - 1)) == 0;
  // Offsets into x_proj and h in 32 bits (launch() checks that they fit),
  // added to the parameters' pointers where used: 64-bit pointers kept
  // live across the step loop would cost registers it does not have.
  const uint32_t gate_x = uint32_t(S) * B * D;
  float bias[4], c_st[kRows], n_st[kRows], m_st[kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = owner ? a.bias[g * D + col] : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c_st[r] = 0.f;
    n_st[r] = 0.f;
    m_st[r] = kNeg;
  }
  cluster.sync();  // every peer's buffers are zero and its mbarriers set before any store

  // The 16-byte pieces of the staged h_t (kBT rows of cols / 4) this lane
  // sends: piece i = tid + k nthreads (k < kSends) of cs x units, to peer
  // i / units.  Packed into one word each (registers are scarce): the
  // piece's offset in the stage (bits 0-9, in 16-byte units), its offset in
  // a row-major (kBT, PP) h buffer (bits 10-25, in floats) and the peer
  // (bits 26-30); -1 for none.  Lane tid < units also writes piece tid to
  // h_out.
  const int units = kBT * cols / 4, c4s = cols / 4;
  const uint32_t h_bytes = sizeof(float) * kBT * P;  // all of h_t, from every CTA
  int send[kSends];
#pragma unroll
  for (int k = 0; k < kSends; ++k) {
    const int i = tid + k * nthreads, peer = i / units, u = i % units;
    const int r = u / c4s, c4 = u % c4s;
    send[k] = i < a.cs * units ? u | ((r * PP + q0 + 4 * c4) << 10) | (peer << 26) : -1;
  }
  const int ur = tid / c4s, uc = tid % c4s;
  const bool writes = tid < units && b0 + ur < B;
  const uint32_t h_off = uint32_t(b0 + ur) * D + head * P + q0 + 4 * uc;
  for (int t = 0; t < S; ++t) {
    // h_{t-1}, written into buffer (t + 1) & 1 at step t - 1 (the
    // ((t - 1) / 2)-th phase of its mbarrier), has landed.  Then buffer
    // t & 1 may take h_t: its previous phase (step t - 2) completed before
    // step t - 1 began.
    if (t > 0) mbar_wait(&mbar[(t + 1) & 1], ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 1 < S) mbar_arrive_expect_tx(&mbar[t & 1], h_bytes);
    // x_proj[t], loaded now and used after the products: its latency is
    // hidden under them.  Kept in its own type until then.
    T x[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + row0 + r;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[r][g] = owner && b < B
                      ? static_cast<const T*>(a.xp)[g * gate_x + (uint32_t(t) * B + b) * D + col]
                      : T(0.f);
    }
    // The products with h_{t-1}.
    float acc[4 * kBT];
#pragma unroll
    for (int i = 0; i < 4 * kBT; ++i) acc[i] = 0.f;
    const float* hb = sH + ((t + 1) & 1) * kBT * PP + 4 * ks;
    // The lower 16 bits of a bf16 value widened to fp32: zero, from a
    // volatile move each step, so that the compiler cannot hoist the
    // widening of the loop-invariant R out of the step loop (it would need
    // twice the registers and spill).
    uint32_t zero;
    asm volatile("mov.u32 %0, 0;" : "=r"(zero));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float4 hv[kBT];
#pragma unroll
      for (int r = 0; r < kBT; ++r)
        hv[r] = *reinterpret_cast<const float4*>(hb + r * PP + 4 * KS * j);
      uint4 lo4[2];
      if constexpr (kSplitR) {
        lo4[0] = sLo[(j * 2) * nthreads + tid];
        lo4[1] = sLo[(j * 2 + 1) * nthreads + tid];
      }
      // Input by input (e), so that consecutive FMAs feed 16 different
      // accumulators; each accumulator still sums its inputs in order.
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float rv[4];  // R[g][p0 + e] for the four gates, upper and lower halves joined
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int w = g * 2 + e / 2;
          uint32_t lw = zero;
          if constexpr (kSplitR) {
            const uint4& l = lo4[w / 4];
            lw = (w % 4 == 0) ? l.x : (w % 4 == 1) ? l.y : (w % 4 == 2) ? l.z : l.w;
          }
          rv[g] = __uint_as_float(__byte_perm(lw, rw[j * 8 + w], e % 2 ? 0x7632 : 0x5410));
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int r = 0; r < kBT; ++r) {
            const float hx = e == 0 ? hv[r].x : e == 1 ? hv[r].y : e == 2 ? hv[r].z : hv[r].w;
            acc[r * 4 + g] = fmaf(hx, rv[g], acc[r * 4 + g]);
          }
      }
    }
    // Sum over the KS lanes of the column: reduce-scatter over the rows,
    // then a butterfly over the rest.
    if constexpr (kSplits >= 1) split_rows<kBT>(acc, KS / 2, (ks & (KS / 2)) != 0);
    if constexpr (kSplits == 2) split_rows<kBT / 2>(acc, KS / 4, (ks & (KS / 4)) != 0);
#pragma unroll
    for (int off = kFull / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4 * kRows; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);

    // Stage t & 1 was last read at step t - 2, before every warp reached
    // step t - 1's __syncthreads: a single stage could still be read for
    // h_{t-1} by a warp whose sends this CTA's wait does not depend on.
    float* stage = sStage + (t & 1) * kBT * cols;
    if (owner) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float s4[4] = {acc[r * 4], acc[r * 4 + 1], acc[r * 4 + 2], acc[r * 4 + 3]};
        const float x4[4] = {to_f(x[r][0]), to_f(x[r][1]), to_f(x[r][2]), to_f(x[r][3])};
        stage[(row0 + r) * cols + ql] = cell(s4, x4, bias, c_st[r], n_st[r], m_st[r]);
      }
    }
    __syncthreads();  // the staged h_t is complete

    // h_t into buffer t & 1 of every CTA of the cluster, and this lane's
    // piece of h_out[t].
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (writes) out = *reinterpret_cast<const float4*>(stage + ur * cols + 4 * uc);
    const bool more = t + 1 < S;
    if (more) {
      const uint32_t buf = smem_addr(sH + (t & 1) * kBT * PP), bar = smem_addr(&mbar[t & 1]);
#pragma unroll
      for (int k = 0; k < kSends; ++k)
        if (send[k] >= 0) {
          const int peer = send[k] >> 26;
          const float4 v = reinterpret_cast<const float4*>(stage)[send[k] & 1023];
          st_async(peer_addr(buf + sizeof(float) * ((send[k] >> 10) & 0xffff), peer), v,
                   peer_addr(bar, peer));
        }
    }
    if (writes) *reinterpret_cast<float4*>(a.h + h_off + uint32_t(t) * B * D) = out;
  }
  if (owner) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + row0 + r;
      if (b < B) {
        a.c[size_t(b) * D + col] = c_st[r];
        a.n[size_t(b) * D + col] = n_st[r];
        a.m[size_t(b) * D + col] = m_st[r];
      }
    }
  }
  cluster.sync();  // no CTA's shared memory goes away while a peer may still write it
}

template <typename T>
using KernelFn = void (*)(Args);

// The instantiations `make_plan` can ask for (KS, NJ).
template <typename T>
KernelFn<T> pick(int ks, int nj) {
  switch (ks * 100 + nj) {
    case 101: return slstm_cluster_kernel<T, 1, 1>;
    case 201: return slstm_cluster_kernel<T, 2, 1>;
    case 202: return slstm_cluster_kernel<T, 2, 2>;
    case 216: return slstm_cluster_kernel<T, 2, 16>;
    case 401: return slstm_cluster_kernel<T, 4, 1>;
    case 402: return slstm_cluster_kernel<T, 4, 2>;
    case 404: return slstm_cluster_kernel<T, 4, 4>;
    case 416: return slstm_cluster_kernel<T, 4, 16>;
    case 801: return slstm_cluster_kernel<T, 8, 1>;
    case 816: return slstm_cluster_kernel<T, 8, 16>;
    default: return nullptr;
  }
}

cudaLaunchConfig_t launch_config(const Plan& pl, cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.ctas);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes (once per kernel and device: the largest
// dynamic shared memory a CTA may opt into, so that no plan's setting
// limits another plan's launch of the same kernel; the non-portable
// cluster size) and returns how many of the plan's clusters fit on the
// card at once (0: none, the launch would fail), queried once per plan.
template <typename T>
cudaError_t prepare(KernelFn<T> kernel, const Plan& pl, int* max_clusters) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*>, bool> ready;
  static std::map<std::tuple<int, const void*, int, int, size_t>, int> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[std::make_tuple(dev, fn)]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kSmemLimit))) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                    1)) != cudaSuccess)
      return err;
    ready[std::make_tuple(dev, fn)] = true;
  }
  const auto key = std::make_tuple(dev, fn, pl.cs, pl.threads, pl.smem);
  auto it = fits.find(key);
  if (it == fits.end()) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(pl, &attr, nullptr);
    int n = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess) return err;
    it = fits.emplace(key, n).first;
  }
  *max_clusters = it->second;
  return cudaSuccess;
}

template <typename T>
int launch(const void* xp, const void* R, const float* bias, float* h, float* c, float* n,
           float* m, int S, int B, int H, int P, void* stream) {
  Plan pl;
  if (S < 1 || !make_plan(B, H, P, std::is_same<T, float>::value, &pl) ||
      size_t(4) * S * B * H * P > 0xffffffffull)  // 32-bit offsets into x_proj
    return static_cast<int>(cudaErrorInvalidValue);
  KernelFn<T> kernel = pick<T>(pl.ks, pl.nj);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;
  cudaError_t err = prepare<T>(kernel, pl, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args args{xp, R, bias, h, c, n, m, S, B, H, P, pl.cs, pl.cols, pl.pp};
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(pl, &attr, stream);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args)) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes.  x_proj (4, S, B, D) and R (4, H, P, P)
// contiguous, of one type; bias (4, D) fp32; h (S, B, D) and c, n, m (B, D)
// fp32 outputs.  D = H * P.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape without a plan,
// cudaErrorInvalidConfiguration when not one cluster fits on the card).
extern "C" int slstm_seq_f32(const void* xp, const void* R, const float* bias, float* h,
                             float* c, float* n, float* m, int S, int B, int H, int P,
                             void* stream) {
  return launch<float>(xp, R, bias, h, c, n, m, S, B, H, P, stream);
}

extern "C" int slstm_seq_bf16(const void* xp, const void* R, const float* bias, float* h,
                              float* c, float* n, float* m, int S, int B, int H, int P,
                              void* stream) {
  return launch<__nv_bfloat16>(xp, R, bias, h, c, n, m, S, B, H, P, stream);
}

// The plan of a launch at (B, H, P) in bf16 (bf16 = 1) or fp32: out[0..9] =
// cluster size, batch rows per cluster, clusters, CTAs, threads per CTA, KS,
// NJ, dynamic shared memory bytes, and the clusters that fit on the card at
// once (cudaOccupancyMaxActiveClusters).  Returns a cudaError_t.
extern "C" int slstm_seq_plan(int B, int H, int P, int bf16, long long* out) {
  Plan pl;
  if (!make_plan(B, H, P, !bf16, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;
  cudaError_t err = cudaSuccess;
  if (bf16) {
    KernelFn<__nv_bfloat16> k = pick<__nv_bfloat16>(pl.ks, pl.nj);
    err = k ? prepare<__nv_bfloat16>(k, pl, &fit) : cudaErrorInvalidValue;
  } else {
    KernelFn<float> k = pick<float>(pl.ks, pl.nj);
    err = k ? prepare<float>(k, pl, &fit) : cudaErrorInvalidValue;
  }
  const long long vals[9] = {pl.cs, kBT, pl.clusters, pl.ctas, pl.threads, pl.ks, pl.nj,
                             static_cast<long long>(pl.smem), fit};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}

extern "C" const char* slstm_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
