"""Where one step of the K3 sLSTM kernel spends its cycles, on the card.

Builds an instrumented copy of `csrc/slstm_step.cu` (into `build/`, beside
the kernels' own builds): every warp's lane 0 reads the SM clock at the
borders of the step's six parts and adds each part's cycles to a counter
in shared memory, which cluster 0 copies to device memory at the end.  The
parts of step t:

  wait     the mbarrier wait until all of h_{t-1} has landed;
  products the x_proj[t] loads and the FMAs of h_{t-1} with R;
  reduce   the shuffle tree over the lanes of a column;
  cell     the owners' cell update into the stage;
  sync     the __syncthreads after it (the stage is complete);
  send     the st.async pushes of h_t to every peer and the h_out store.

Runs the instrumented kernel once at the main path's shape (one
xlstm-1.3b sLSTM block: B 4, S 2048, D 2048, H 4, bf16 inputs made from a
seed as `chip_smoke.py` makes them) after a warm launch, checks that its
outputs equal the uninstrumented kernel's bit for bit, times both with CUDA
events, and prints cycles per step by part (the mean over the warps of
cluster 0 and the range over them) as one JSON line.  The clock reads sit
between instructions the compiler may move, so a border is approximate;
the instrumented kernel's own time says how much the reads cost.

    PYTHONPATH=src python -m repro_torch.kernels.slstm_step.step_split

Needs the card and nvcc (as every kernel of the port).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

PARTS = ("wait", "products", "reduce", "cell", "sync", "send")
MAIN = (4, 2048, 2048, 4)  # (B, S, D, H), chip_smoke.SL_MAIN
WARPS, MAX_CLUSTER = 8, 16  # the source's kMaxThreads / 32 and kMaxCluster

_COUNTERS = f"""
__device__ unsigned g_split[{MAX_CLUSTER}][{WARPS}][{len(PARTS)}];
#define SPLIT_MARK(i)                                                          \\
  {{                                                                            \\
    unsigned now_;                                                             \\
    asm volatile("mov.u32 %0, %%clock;" : "=r"(now_));                         \\
    if ((tid & 31) == 0) split_cyc[tid >> 5][i] += now_ - split_last;          \\
    split_last = now_;                                                         \\
  }}
"""

# (anchor in the source, text put in its place, after it, before it); each
# anchor occurs once.  The counters' static shared memory comes off the
# dynamic shared memory a CTA may opt into.
_REPLACE = (
    ("constexpr size_t kSmemLimit = 232448;", "constexpr size_t kSmemLimit = 232448 - 1024;"),
)
_AFTER = (
    ("namespace cg = cooperative_groups;\n", _COUNTERS),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     f"  __shared__ unsigned split_cyc[{WARPS}][{len(PARTS)}];\n"
     f"  if (threadIdx.x % 32 == 0)\n"
     f"    for (int i = 0; i < {len(PARTS)}; ++i) split_cyc[threadIdx.x / 32][i] = 0;\n"),
    ("  const uint32_t h_off = uint32_t(b0 + ur) * D + head * P + q0 + 4 * uc;\n",
     "  unsigned split_last;\n"
     "  asm volatile(\"mov.u32 %0, %%clock;\" : \"=r\"(split_last));\n"),
    ("    if (t > 0) mbar_wait(&mbar[(t + 1) & 1], ((t - 1) >> 1) & 1);\n", "    SPLIT_MARK(0)\n"),
    ("    __syncthreads();  // the staged h_t is complete\n", "    SPLIT_MARK(4)\n"),
    ("    if (writes) *reinterpret_cast<float4*>(a.h + h_off + uint32_t(t) * B * D) = out;\n",
     "    SPLIT_MARK(5)\n"),
)
_BEFORE = (
    ("    // Sum over the KS lanes of the column", "    SPLIT_MARK(1)\n"),
    ("    // Stage t & 1 was last read", "    SPLIT_MARK(2)\n"),
    ("    __syncthreads();  // the staged h_t is complete\n", "    SPLIT_MARK(3)\n"),
    ("  cluster.sync();  // no CTA's shared memory goes away",
     f"  if (cid == 0 && tid % 32 == 0)\n"
     f"    for (int i = 0; i < {len(PARTS)}; ++i) g_split[rank][tid / 32][i] = "
     f"split_cyc[tid / 32][i];\n"),
)
_READER = """
extern "C" int slstm_split_read(unsigned* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_split, sizeof(g_split)));
}
"""


def instrumented_source(src: str) -> str:
    """The kernel's source with the clock reads and counters put in."""
    for anchor, text in _REPLACE:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once in slstm_step.cu: {anchor!r}")
        src = src.replace(anchor, text)
    for anchor, text in _AFTER:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once in slstm_step.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    for anchor, text in _BEFORE:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once in slstm_step.cu: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    return src + _READER


def _build() -> tuple:
    from repro_torch.kernels import build

    out_dir = build.REPO_ROOT / "build" / "step_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "slstm_step_split.cu"
    cu.write_text(instrumented_source(build.SOURCES["slstm_step"].read_text()))
    lib = out_dir / "slstm_step_split.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented source:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def _ptxas(log: str, ks: int, nj: int) -> str:
    """ptxas's lines for the bf16 instantiation of the main shape's plan."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "bfloat16" in line and f"Li{ks}ELi{nj}E" in line:
            return " | ".join(x.strip() for x in lines[i + 1:i + 3])
    return "not found"


def main() -> int:
    import torch

    from repro_torch.kernels.slstm_step import ops

    if not torch.cuda.is_available():
        print("step_split: needs the card", file=sys.stderr)
        return 1
    lib, log = _build()
    b, s, d, h = MAIN
    p = d // h
    plan = ops.plan(torch.bfloat16, b, p, h)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    xp = torch.randn(4, s, b, d, generator=gen, device=dev).bfloat16()
    R = (torch.randn(4, h, p, p, generator=gen, device=dev) * p ** -0.5).bfloat16()
    bias = torch.tensor([0.0, 3.0, 0.0, 0.0], device=dev)[:, None].expand(4, d).contiguous()
    hs = torch.empty(s, b, d, device=dev)
    c, n, m = (torch.empty(b, d, device=dev) for _ in range(3))
    fn = lib.slstm_seq_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def instrumented():
        err = fn(xp.data_ptr(), R.data_ptr(), bias.data_ptr(), hs.data_ptr(), c.data_ptr(),
                 n.data_ptr(), m.data_ptr(), s, b, h, p, stream)
        if err:
            raise RuntimeError(f"instrumented slstm_seq launch failed ({err})")

    def timed(call, reps=5):
        call()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    kernel_ms, split_ms = timed(lambda: ops.slstm_seq(xp, R, bias)), timed(instrumented)
    want_h, want_state = ops.slstm_seq(xp, R, bias)
    instrumented()
    torch.cuda.synchronize()
    same = bool(torch.equal(hs, want_h) and all(torch.equal(u, v) for u, v in
                                                zip((c, n, m), want_state)))
    raw = (ctypes.c_uint * (MAX_CLUSTER * WARPS * len(PARTS)))()
    if lib.slstm_split_read(raw):
        raise RuntimeError("reading the step counters failed")
    warps = plan["threads"] // 32
    rows = [[raw[(r * WARPS + w) * len(PARTS) + i] / s for i in range(len(PARTS))]
            for r in range(plan["cs"]) for w in range(warps)]
    mean = {part: sum(row[i] for row in rows) / len(rows) for i, part in enumerate(PARTS)}
    spread = {part: [min(row[i] for row in rows), max(row[i] for row in rows)]
              for i, part in enumerate(PARTS)}
    total = sum(mean.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[step_split] ptxas, instrumented bf16 KS={plan['ks']} NJ={plan['nj']}: "
          f"{_ptxas(log, plan['ks'], plan['nj'])}")
    print(json.dumps({
        "shape": list(MAIN), "plan": plan, "card": card,
        "kernel_ms": kernel_ms, "instrumented_ms": split_ms,
        "step_us": kernel_ms / s * 1e3, "instrumented_step_us": split_ms / s * 1e3,
        "bit_identical": same, "warps": len(rows),
        "cycles_per_step": mean, "cycles_per_step_range": spread, "total_cycles": total,
        "mhz_implied": total / (split_ms / s * 1e3),
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
