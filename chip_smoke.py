#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port (src/repro_torch, never jax) on the card in four phases,
and fails (non-zero exit, no result line) if any of them fails:

1. Card and build: prints the card's name and power limit, builds every
   CUDA kernel from the sources in this checkout (one nvcc per source, all
   started together) and prints nvcc's -Xptxas -v register, shared-memory
   and spill lines.
2. Kernel against plain: each kernel's wrapper is called on tensors on the
   card and held against its plain PyTorch version on the same inputs, at
   the test shapes and at the shape the main path gives it, then timed
   there with CUDA events (kernel and plain in turns).  The whole coder is
   also held against the plain reference engine on a small input.
3. Main path: the port's serve_dict at the production dictionary
   (M = 8192, K = 262144, N = 16 agents, fp32, gamma 0.05, delta 0.1) with
   learning on, in `graph`
   mode (ring_metropolis, the paper's diffusion) and in `exact_fista` mode
   (the CLI default).  Each kernel's launch count is set to 0 just before a
   run and read just after; every sample must be coded, every code finite
   (and, in `exact_fista`, some nonzero), and one micro-batch re-solved on
   the final snapshot with the kernel swapped for its plain version must
   agree with the kernel path.
4. Result: one JSON line listing every kernel (launches on the main path,
   error against plain, times and bound), the card line, and last the
   device line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent

# Main-path size: the repository's production dictionary (launch/dryrun.py)
# served by the CLI's defaults (task, micro-batch, iterations).
M, ATOMS_PER_AGENT, N_AGENTS, MICRO_BATCH, ITERS, SAMPLES = 8192, 16384, 16, 16, 150, 64
# Regularizer weights of the production-scale config (launch/dryrun.py
# run_dictlearn).  serve_dict's defaults (0.25, 0.05) are tuned for M = 32:
# at M = 8192 a random unit atom correlates with a sample at about
# ||x|| / sqrt(M), far below 0.25, so every code would be exactly zero and
# the dictionary step a no-op.
GAMMA, DELTA = 0.05, 0.1

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Solve agreement, kernel path vs plain path on one micro-batch: both run
# the same 150 iterations with fp32 sums in different orders; the iteration
# is non-expansive, so the difference stays near iters x fp32 rounding of
# the 8192-term products.  Stated bound: 1e-3 of the largest magnitude.
SOLVE_RTOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(what, got, ref, rtol, atol) -> float:
    """Elementwise |got - ref| <= atol + rtol |ref| (np.allclose's rule)."""
    diff = (got.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, max |err| {float(diff.max())}"
        )
    return float(diff.max())


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over `reps` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} kernel(s) built for sm_90a in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "cached" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(torch):
    """dict_dual_step against its plain version; returns its kernel record
    (without `launches`, which the main path fills in)."""
    from repro_torch.kernels.dict_dual_step import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # The test shapes (tests/test_kernels.py DD_SHAPES): y rtol/atol 1e-4,
    # g rtol 1e-4 atol 2e-3, as the JAX sweep asserts.
    for (m, k, b) in [(128, 512, 128), (100, 49, 5), (96, 196, 1), (100, 196, 4),
                      (257, 33, 17), (8, 1024, 256)]:
        for nonneg in (False, True):
            W, nu = randn(m, k), randn(b, m)
            y, g = ops.dict_dual_step(W, nu, gamma=0.1, delta=0.1, nonneg=nonneg)
            yr, gr = ref.dict_dual_step_ref(W[None], nu[None], gamma=0.1, delta=0.1, nonneg=nonneg)
            check_close(f"y {(m, k, b, nonneg)}", y, yr[0], 1e-4, 1e-4)
            check_close(f"g {(m, k, b, nonneg)}", g, gr[0], 1e-4, 2e-3)
    # agents batched, stride-0 shared nu, vector nu, bf16 (tolerance 5e-2)
    W, nu = randn(3, 257, 300), randn(3, 33, 257)
    y, g = ops.dict_dual_step(W, nu, gamma=0.1, delta=0.1)
    yr, gr = ref.dict_dual_step_ref(W, nu, gamma=0.1, delta=0.1)
    check_close("y agents", y, yr, 1e-4, 1e-4)
    check_close("g agents", g, gr, 1e-4, 2e-3)
    y, g = ops.dict_dual_step(W, nu[0], gamma=0.1, delta=0.1)
    yr, gr = ref.dict_dual_step_ref(W, nu[0].expand(3, 33, 257), gamma=0.1, delta=0.1)
    check_close("y stride 0", y, yr, 1e-4, 1e-4)
    check_close("g stride 0", g, gr, 1e-4, 2e-3)
    y, g = ops.dict_dual_step(W[0], nu[0, 0], gamma=0.05, delta=0.1)
    assert y.shape == (300,) and g.shape == (257,), (y.shape, g.shape)
    yr, gr = ref.dict_dual_step_ref(W[:1], nu[:1, :1], gamma=0.05, delta=0.1)
    check_close("y vector", y, yr[0, 0], 1e-4, 1e-4)
    Wb, nub = randn(2, 64, 96).bfloat16(), randn(2, 16, 64).bfloat16()
    y, g = ops.dict_dual_step(Wb, nub, gamma=0.1, delta=0.1)
    yr, gr = ref.dict_dual_step_ref(Wb, nub, gamma=0.1, delta=0.1)
    check_close("y bf16", y, yr, 5e-2, 5e-2)
    check_close("g bf16", g, gr, 5e-2, 25e-2)
    torch.cuda.synchronize()
    print("[kernels] dict_dual_step agrees with plain at the test shapes, "
          "agent-batched, stride 0, vector nu and bf16")

    # The main-path shape: every agent's block (16, 8192, 16384), B = 16.
    n, m, kb, b = N_AGENTS, M, ATOMS_PER_AGENT, MICRO_BATCH
    W = torch.randn(n, m, kb, device=dev)
    W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
    nu = torch.randn(n, b, m, device=dev)
    y, g = ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)
    yr, gr = ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)
    s_inf = float(torch.matmul(nu, W).abs().max())
    y_err, g_err = max_err(y, yr), max_err(g, gr)
    y_tol = 1e-4 * s_inf / DELTA  # the threshold's slope is 1/delta
    g_rel = g_err / float(gr.abs().max())
    print(f"[kernels] main shape {(n, m, kb, b)}: max|dY| {y_err:.3e} (tol {y_tol:.3e} "
          f"= 1e-4 |S|_inf / delta), max|dG|/max|G| {g_rel:.3e} (tol 1e-4)")
    if not (y_err <= y_tol and g_rel <= 1e-4):
        raise AssertionError("dict_dual_step disagrees with plain at the main-path shape")
    del yr, gr, y, g

    def kernel():
        return ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)

    def plain():
        return ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)

    reps = 5
    k1, p1, p2, k2 = (time_ms(torch, kernel, reps), time_ms(torch, plain, reps),
                      time_ms(torch, plain, reps), time_ms(torch, kernel, reps))
    nbytes = 4 * (n * m * kb + n * b * m + n * b * kb + n * b * m)
    flops = 4 * n * b * m * kb
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    rec = {
        "name": "dict_dual_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dict_dual_step/csrc/dict_dual_step.cu",
        "replaces": "src/repro/kernels/dict_dual_step/kernel.py:59",
        "launches": None,
        "max_abs_err": max(y_err, g_err),
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes S -> T -> G
        "shape": [n, m, kb, b],
    }
    print(f"[kernels] dict_dual_step at {(n, m, kb, b)}: kernel_ms {k1:.3f} {k2:.3f}  "
          f"plain_ms {p1:.3f} {p2:.3f}  bound_ms {rec['bound_ms']:.3f} ({rec['bound_by']})")
    del W, nu
    torch.cuda.empty_cache()
    return rec


def phase_small_coder(torch):
    """The coder (kernel path) against the plain reference engine, small input."""
    import numpy as np

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.core.inference import DiffusionConfig, diffusion_infer, exact_infer

    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    rng = np.random.default_rng(0)
    W = rng.standard_normal((16, 32)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    graph = DistributedSparseCoder(4, res, reg, DistConfig(mode="graph", iters=300))
    Wb, xt = graph.shard(W, x)
    mu = graph.adaptive_mu(Wb)[0]
    A = torch.as_tensor(graph.combiner(), dtype=torch.float32, device=Wb.device)
    nu_ref, y_ref, _ = diffusion_infer(res, reg, Wb, xt, A, torch.ones(4, device=Wb.device),
                                       DiffusionConfig(iters=300), mu=mu)
    nu, y = graph.solve_per_agent(Wb, xt)
    errs = [max_err(nu, nu_ref), max_err(y, y_ref)]
    exact = DistributedSparseCoder(4, res, reg, DistConfig(mode="exact", iters=300))
    nu_ex = exact_infer(res, reg, torch.as_tensor(W, device=Wb.device), xt,
                        mu=exact.adaptive_mu(Wb)[0], iters=300)
    errs.append(max_err(exact.solve(Wb, xt)[0], nu_ex))
    print(f"[kernels] coder vs reference engine (graph nu, y; exact nu): "
          f"max|err| {[f'{e:.2e}' for e in errs]} (tol 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError("the coder disagrees with the reference engine")


def phase_main_path(torch, mode: str, card: str, must_code: bool):
    """The port's serve_dict at the slice's size; returns the kernel's
    launch count over the run.  `must_code`: fail if every code is zero."""
    from repro_torch.core import distributed
    from repro_torch.kernels.dict_dual_step import ops, ref
    from repro_torch.launch import serve_dict

    argv = ["--mode", mode, "--topology", "ring_metropolis", "--m", str(M),
            "--atoms-per-agent", str(ATOMS_PER_AGENT), "--mesh", f"1x{N_AGENTS}",
            "--samples", str(SAMPLES), "--micro-batch", str(MICRO_BATCH),
            "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta", str(DELTA),
            "--device", "cuda", "--json"]
    torch.cuda.reset_peak_memory_stats()
    ops.dict_dual_step.launches = 0
    out = serve_dict.run(serve_dict.parse_args(argv))
    launches = ops.dict_dual_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pay, results, svc = out["payload"], out["results"], out["service"]
    stats = svc.stats()

    import numpy as np

    if stats["coded"] != SAMPLES or len(results) != SAMPLES:
        raise AssertionError(f"{mode}: coded {stats['coded']} of {SAMPLES}")
    if stats["fit_steps"] < 1 or stats["fit_failures"]:
        raise AssertionError(f"{mode}: fit_steps {stats['fit_steps']}, "
                             f"failures {stats['fit_failures']} {stats['fit_first_error']}")
    for nu, y in results:
        if nu.shape != (M,) or y.shape != (ATOMS_PER_AGENT * N_AGENTS,):
            raise AssertionError(f"{mode}: code shapes {nu.shape} {y.shape}")
        if not (np.isfinite(nu).all() and np.isfinite(y).all()):
            raise AssertionError(f"{mode}: a code is not finite")
    nonzero = sum(int(np.count_nonzero(y)) for _, y in results) / (SAMPLES * ATOMS_PER_AGENT * N_AGENTS)
    if must_code and nonzero == 0.0:
        raise AssertionError(f"{mode}: every code is zero (the threshold never fires)")
    # Solves: the warmup solve and fit, one per coded micro-batch, one per fit.
    solves = 2 + math.ceil(SAMPLES / MICRO_BATCH) + stats["fit_steps"]
    if launches < (ITERS + 1) * solves:
        raise AssertionError(f"{mode}: {launches} kernel launches, expected at "
                             f">= {ITERS + 1} per solve x {solves} solves")

    # Re-solve the last micro-batch on the final snapshot, kernel vs plain.
    coder, snap = svc._coder, svc.snapshot()
    xb = out["X"][-MICRO_BATCH:]
    nu_k, y_k = coder.solve(snap, xb)

    def plain_step(W, nu, *, gamma, delta, nonneg=False):
        nu3 = nu.expand(W.shape[0], *nu.shape) if nu.dim() == 2 else nu
        return ref.dict_dual_step_ref(W, nu3, gamma=gamma, delta=delta, nonneg=nonneg)

    with mock.patch.object(distributed.ops, "dict_dual_step", plain_step):
        nu_p, y_p = coder.solve(snap, xb)
    nu_err = max_err(nu_k, nu_p) / float(nu_p.abs().max())
    y_err = max_err(y_k, y_p) / max(float(y_p.abs().max()), 1e-30)
    print(f"[main:{mode}] re-solve kernel vs plain: max|dnu|/max|nu| {nu_err:.2e}  "
          f"max|dy|/max|y| {y_err:.2e} (tol {SOLVE_RTOL})")
    if not (nu_err <= SOLVE_RTOL and y_err <= SOLVE_RTOL):
        raise AssertionError(f"{mode}: kernel path disagrees with plain path")

    lat = pay["latency_ms"]
    print(f"[main:{mode}] {card}: {pay['samples_per_s']:.4f} samples/s  p50 "
          f"{lat['p50']:.1f} ms  p99 {lat['p99']:.1f} ms  wall {pay['wall_s']:.1f} s  "
          f"fit_steps {stats['fit_steps']}  nonzero code share {nonzero:.3e}  "
          f"kernel launches {launches} over {solves} "
          f"solves  peak device memory {peak_gb:.2f} GB")
    print("MAIN " + json.dumps({
        "mode": mode, "card": card, "M": M, "K": ATOMS_PER_AGENT * N_AGENTS,
        "agents": N_AGENTS, "micro_batch": MICRO_BATCH, "iters": ITERS,
        "samples": SAMPLES, "samples_per_s": pay["samples_per_s"],
        "latency_ms": lat, "wall_s": pay["wall_s"], "fit_steps": stats["fit_steps"],
        "launches": launches, "solves": solves, "peak_mem_gb": peak_gb,
        "nonzero_code_share": nonzero, "gamma": GAMMA, "delta": DELTA,
        "resolve_rel_err": {"nu": nu_err, "y": y_err},
    }))
    del out, results, svc, coder, snap
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()

    phase_build()
    rec = phase_kernels(torch)
    phase_small_coder(torch)
    # The diffusion's step is bounded by the worst block's curvature
    # (sigma_max(W_k)^2 / delta, about 58 here) while its consensus term
    # contracts by only mu / N per iteration, so after 150 iterations at this
    # width an agent's nu is still a small fraction of x (1 - (1 - mu/N)^150,
    # about 0.13) and no atom passes the threshold: graph codes may all be
    # zero.  exact_fista converges in 150 iterations and must code.
    launches = {mode: phase_main_path(torch, mode, card, must_code=(mode == "exact_fista"))
                for mode in ("graph", "exact_fista")}
    rec["launches"] = launches["graph"] + launches["exact_fista"]
    rec["launches_by_mode"] = launches

    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [rec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
