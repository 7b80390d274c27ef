#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port (src/repro_torch, never jax) on the card in five phases,
and fails (non-zero exit, no result line) if any of them fails:

1. Card and build: prints the card's name and power limit, builds every
   CUDA kernel from the sources in this checkout (one nvcc per source, all
   started together) and prints nvcc's -Xptxas -v register, shared-memory
   and spill lines; fails unless flash_attention's wgmma_tma kernels show
   HGMMA (tensor-core) instructions in the built library's SASS
   (cuobjdump), spill no register, and are not serialized by ptxas, and
   unless every slstm_step cluster kernel spills nothing.
2. Kernel against plain: each kernel's wrapper is called on tensors on the
   card and held against its plain PyTorch version on the same inputs, at
   the test shapes and at the shape the main path gives it, then timed
   there with CUDA events (kernel and plain in turns; flash_attention also
   beside F.scaled_dot_product_attention, the library yardstick the port
   never calls).  The records name each kernel's variant (flash_attention's
   main shape must go to wgmma_tma) and its CTAs per launch
   (dict_dual_step's two passes at least 128 each; a repeated launch must
   give the same bits; slstm_seq's cluster plan as the library launches it
   must be the one ops.variant states, with at least one cluster fitting
   on the card (cudaOccupancyMaxActiveClusters), its time per step, and a
   repeated launch the same bits).  Planted faults (dict_dual_step's plain arithmetic
   with the threshold on S without the last M chunk, G without the last
   32-atom tile, or agent 0's G rows from agent 1; flash_attention's
   plain arithmetic under a wrong causal mask; the sLSTM recurrence's
   plain arithmetic with R transposed, x_proj a step late, the f and i
   gates swapped, the final state taken a step early, one CTA's columns
   of h read a step stale or as 0, or the last batch group's final state
   taken from the first group) must fail the same checks.  The whole coder is also held against the plain reference
   engine on a small input.
3. Main paths, each driven with every kernel's launch count set to 0 just
   before and read just after:
   - dense-LM serving: the port's serve at gemma-2b's full width (random
     weights), a batch of 4 prompts of 2048 tokens, 32 greedy tokens; one
     flash_attention launch per layer of the prefill.  Tokens must lie in
     the vocabulary, logits and cache be finite, and the prefill re-run
     with the kernel swapped for its plain version must agree (last-position
     logits and every layer's K/V cache), while one re-run with a planted
     wrong attention must not;
   - xLSTM serving: the port's serve at xlstm-1.3b's full width (random
     weights), the same traffic; one slstm_seq launch per sLSTM block of
     the prefill (6) and none in decode.  Tokens in the vocabulary, logits
     and every cache leaf finite, and in a re-run of the prefill every
     sLSTM block's recurrence must agree with its plain version on the
     inputs it got there, while a planted wrong recurrence must not (the
     end-to-end difference from the plain prefill is recorded beside a
     one-ulp noise control: the random-weight stack amplifies any
     difference, so it cannot be gated);
   - the dictionary service: serve_dict at the production dictionary
     (M = 8192, K = 262144, N = 16 agents, fp32, gamma 0.05, delta 0.1)
     with learning on, in `graph` mode (ring_metropolis, the paper's
     diffusion) and in `exact_fista` mode (the CLI default); every
     iteration is a dict_dual_step launch.  Every sample must be coded,
     every code finite (and, in `exact_fista`, some nonzero), and one
     micro-batch re-solved on the final snapshot with the kernel swapped
     for its plain version must agree with the kernel path.
4. The learner and the paper's applications, plain PyTorch on the card
   (no kernel of the port is on their path, and the script fails if one
   launches):
   - core/learner.DictionaryLearner at the production dictionary (M 8192,
     K 262144, N 16, sparse_svd, gamma 0.05, delta 0.1, 150 iterations,
     mu_w 0.1, batches of 16 from sparse_stream): engine fista, one warm
     fit_batch, 4 timed, then code(); every metric and code finite, some
     code nonzero, the step changing W, every column norm <= 1 + 1e-6.
     Engine diffusion (erdos p 0.5, the safe mu), 2 steps, recorded only.
     Seconds per fit_batch, samples/s, dual iterations/s, objectives and
     peak device memory are printed.  Then one fit_batch per engine on the
     card and on the CPU from one numpy state at M 512, K 16384, N 16: W
     and the four metrics within 1e-4 relative, while a planted fault (each
     agent's codes taken from the next agent) must fail the W check;
   - the experiment twins table3_auc (n_steps 2) and fig5_denoise
     (n_patches 1200) on the card: every AUC in [0, 1], every PSNR finite
     and each denoised PSNR above the noisy one.
5. Result: one JSON line listing every kernel (launches on its main path,
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

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32 outside the tensor
# cores, 989 TFLOP/s bf16 dense on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# The LM main path: the port's serve at gemma-2b's full width (18 layers,
# d 2048, 8 query heads over 1 KV head of 256, d_ff 16384, vocab 256000,
# bf16 compute), random weights from seed 0, a batch of 4 prompts of 2048
# tokens, then 32 greedy tokens.  Its attention, one K2 launch per layer:
# (B, Hq, Hkv, S, T, D), bf16, causal.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma_2b", 4, 2048, 32
FA_MAIN = (LM_BATCH, 8, 1, LM_PROMPT, LM_PROMPT, 256)

# K2's bf16 output against its plain version, element by element.  Both
# round one fp32 result to bf16, so one output ulp (2^-7 |ref|) is allowed;
# they also round each probability to bf16 at different points (K2 the
# unnormalised p, the plain version p / l), which moves an output by
# sum_j (d_j - d'_j) p_j v_j / l with |d_j|, |d'_j| <= 2^-8: allowed as
# BF16_ROW_ULPS x 2^-8 x the largest |ref| of the element's row.
BF16_ROW_ULPS = 4.0

# Prefill agreement, K2 path vs plain path: last-position logits and every
# layer's K and V cache, each as the largest over rows (the last axis) of
# max |diff| / max |plain| in the row.  The two paths differ only in each
# layer's attention core, whose bf16 output may round the other way (unit
# roundoff u = 2^-8) wherever the two fp32 sums differ; each of the L
# layers can add about u of relative difference to the residual stream, so
# the bound is L * u (0.070 at 18 layers).  The script also plants a wrong
# attention (its causal limit one key late) and requires the gate to
# reject it.
BF16_UNIT_ROUNDOFF = 2.0 ** -8

# The xLSTM main path: the port's serve at xlstm-1.3b's full width (48
# blocks, 42 mLSTM and 6 sLSTM; d 2048, 4 heads, mLSTM P 1024, sLSTM P 512,
# vocab 50304, bf16 compute), random weights from seed 0, the gemma path's
# traffic.  Its sLSTM recurrence, one K3 launch per sLSTM block:
# (B, S, D, H), bf16 x_proj and R.
XL_ARCH = "xlstm_1p3b"
SL_MAIN = (LM_BATCH, LM_PROMPT, 2048, 4)
# K3 at the shapes of tests/test_moe_a2a.py's sLSTM tests (B, S, D, H), and
# the smoke config's P 32 at B 4: fp32 within their 1e-5.
SL_TEST_SHAPES = [(2, 24, 32, 4), (1, 16, 64, 2), (3, 33, 16, 4), (2, 20, 32, 4), (4, 40, 64, 2)]
SL_TEST_TOL = 1e-5
# K3 at the main widths with three batch groups (the last ragged), for the
# planted fault that mixes groups: SL_MAIN has one group of 4 rows.
SL_GROUPS = (9, 256, 2048, 4)
# K3 at the main shape against its plain version.  Both widen the bf16
# x_proj and R exactly and run the same fp32 cell, so they differ only in
# the order of each step's 512-term sums of h * R (about sqrt(512) x 2^-24
# of a gate pre-activation, some 1e-6), carried by a recurrence whose h
# stays in [-1, 1] (c / n is a weighted mean of tanh values) and which the
# forget gate (bias 3) damps.  The block hands h on in bf16, where a
# difference below half an ulp at 1, 2^-9, flips at most one rounding.  So
# the gate: max |dh| <= 2^-9 over all S x B x D, and each final state
# (c, n, m) within 2^-9 of its row's largest |value| (row = one batch row,
# the last axis), the state being what the decode cache carries on.  The
# planted faults change h or the state by orders of magnitude more.
SL_TOL = 2.0 ** -9

# Solve agreement, kernel path vs plain path on one micro-batch: both run
# the same 150 iterations with fp32 sums in different orders; the iteration
# is non-expansive, so the difference stays near iters x fp32 rounding of
# the 8192-term products.  Stated bound: 1e-3 of the largest magnitude.
SOLVE_RTOL = 1e-3

# The learner (core/learner.DictionaryLearner, the paper's Alg. 1) at the
# production dictionary above, with serve_dict's --mu-w default: one warm
# fit_batch of MICRO_BATCH samples, LEARN_STEPS timed ones, then code() on a
# batch.  The fista engine is gated; the diffusion engine (erdos p 0.5, the
# safe mu) runs LEARN_DIFFUSION_STEPS steps and is recorded only: at this
# width 150 iterations leave nu far from converged (see main()), so its codes
# and its dictionary step may be 0.  The samples come from sparse_stream
# with a planted dictionary of LEARN_K_TRUE atoms (its width does not change
# the samples' statistics, and drawing 262144 planted atoms costs the host
# some 40 s).
LEARN_MU_W, LEARN_STEPS, LEARN_DIFFUSION_STEPS, LEARN_K_TRUE = 0.1, 4, 2, 4096
# Card against CPU: one fit_batch per engine from one numpy state at the
# production Kb/M = 2 (M 512, K 16384, N 16).  Both run the same fp32
# arithmetic with sums in another order (cuBLAS against the CPU's BLAS):
# W within 1e-4 of its largest |value|, each metric within 1e-4 relative
# (sparsity also within one coefficient, 1 / (B K), as one code may sit at
# the threshold).  A planted fault (the card's y rolled by one agent, so
# each agent steps with its neighbour's codes) must fail the W check under
# fista, whose codes are nonzero; under diffusion and exact it is recorded.
LEARN_PARITY_M, LEARN_PARITY_K, LEARN_PARITY_RTOL = 512, 16384, 1e-4


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


def bf16_reading(got, ref) -> float:
    """The largest elementwise |got - ref| beyond one output ulp (2^-7 |ref|),
    in units of 2^-8 x the largest |ref| of its row (the last axis); inf if
    any element is not finite."""
    g, r = got.float(), ref.float()
    excess = ((g - r).abs() - 2.0 ** -7 * r.abs()).clamp_min(0)
    unit = 2.0 ** -8 * r.abs().amax(-1, keepdim=True)
    reading = float((excess / unit.clamp_min(1e-30)).max())
    return reading if math.isfinite(reading) else math.inf


def check_bf16(what, got, ref) -> float:
    """Fail unless bf16_reading(got, ref) <= BF16_ROW_ULPS; returns the reading."""
    reading = bf16_reading(got, ref)
    if not reading <= BF16_ROW_ULPS:
        raise AssertionError(f"{what}: bf16 reading {reading:.3g} > {BF16_ROW_ULPS} "
                             f"(max |err| {max_err(got, ref):.3e})")
    return reading


def masked_attention(torch, q, k, v, visible, round_p: bool = True):
    """attention_ref's arithmetic under any (S, T) visibility mask (a row
    that sees no key gives 0), optionally with p left in fp32 before P V:
    the plain stand-in for a wrong kernel."""
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    logits = torch.matmul(q.float(), kx.transpose(-1, -2)) * q.shape[-1] ** -0.5
    probs = torch.softmax(logits.masked_fill(~visible, float("-inf")), dim=-1).nan_to_num(0.0)
    if round_p:
        probs = probs.to(v.dtype).float()
    return torch.matmul(probs, vx).to(q.dtype)


def causal_visible(torch, s: int, t: int, device, shift: int = 0):
    """(S, T) mask of key c visible to row r: c <= r + (T - S) + shift."""
    r = torch.arange(s, device=device)[:, None]
    c = torch.arange(t, device=device)[None, :]
    return c <= r + (t - s) + shift


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


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.dict_dual_step import ops as dd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slstm_step import ops as sl_ops

    dd_ops.dict_dual_step.launches = 0
    fa_ops.flash_attention.launches = 0
    sl_ops.slstm_seq.launches = 0


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: {"registers": n, "stack_bytes": frame,
    "spill_bytes": stores + loads}} from nvcc's -Xptxas -v output."""
    report, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            report[fn] = {"registers": None, "stack_bytes": 0, "spill_bytes": 0}
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()
            report[fn]["spill_bytes"] = sum(int(words[i - 2]) for i, w in enumerate(words)
                                            if w == "spill")
            if "stack" in words:
                report[fn]["stack_bytes"] = int(words[words.index("stack") - 2])
        elif fn and line.strip().startswith("ptxas info") and "Used" in line:
            report[fn]["registers"] = int(line.split("Used")[1].split()[0])
    return report


def sass_counts(lib_path, opcode: str) -> dict:
    """{mangled kernel name: instructions of `opcode`} in the library's SASS."""
    from repro_torch.kernels import build

    cuobjdump = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


def phase_build():
    """Builds every kernel; returns the evidence that K2's bf16 kernel runs on
    the tensor cores (its ptxas registers and spills and its HGMMA count in
    the SASS of the built library, per instantiation) and K3's ptxas report
    per instantiation (every one a cluster kernel, none may spill)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    print(f"[build] {len(logs)} kernel(s) built for sm_90a in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "cached" in line:
                print(f"[build] {name}: {line.strip()}")
    ptxas = ptxas_report(logs["flash_attention"])
    hgmma = sass_counts(build.library_path("flash_attention"), "HGMMA")
    wgmma = {fn: {"hgmma": n, **ptxas.get(fn, {})} for fn, n in hgmma.items()
             if "flash_attention_wgmma" in fn}
    print(f"[build] flash_attention wgmma_tma kernels (HGMMA in SASS, ptxas): {wgmma}")
    if len(wgmma) != 3 or min(r["hgmma"] for r in wgmma.values()) == 0:
        raise AssertionError("the wgmma_tma kernels (D = 64, 128, 256) lack HGMMA in their SASS")
    if logs["flash_attention"] != "cached":
        if any(r.get("spill_bytes") for r in wgmma.values()):
            raise AssertionError("a wgmma_tma kernel spills registers")
        # ptxas's C7514/C7515 notes: it made every wgmma wait for the one before.
        serialized = [line for line in logs["flash_attention"].splitlines()
                      if "wgmma.mma_async instructions are serialized" in line]
        if serialized:
            raise AssertionError(f"ptxas serialized the wgmma_tma kernels: {serialized}")
    slstm = ptxas_report(logs["slstm_step"])
    print(f"[build] slstm_step cluster kernels (ptxas: registers, stack frame, spills): "
          f"{slstm if slstm else 'cached'}")
    import torch

    from repro_torch.kernels.slstm_step import ops as sl_ops

    b, _, d, h = SL_MAIN
    print(f"[build] slstm_step plan at the main shape (cudaOccupancyMaxActiveClusters: "
          f"max_active_clusters): {sl_ops.library_plan(torch.bfloat16, b, d // h, h)}")
    if logs["slstm_step"] != "cached":
        if not any("slstm_cluster_kernel" in fn for fn in slstm):
            raise AssertionError("no slstm_step cluster kernel in the ptxas report")
        spilled = {fn: r for fn, r in slstm.items() if r["spill_bytes"]}
        if spilled:
            raise AssertionError(f"an slstm_step cluster kernel spills registers: {spilled}")
    return wgmma, slstm


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
    y2, g2 = ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)
    repeat_equal = bool(torch.equal(y, y2) and torch.equal(g, g2))
    del y2, g2
    yr, gr = ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)
    s_inf = float(torch.matmul(nu, W).abs().max())
    y_tol = 1e-4 * s_inf / DELTA  # the threshold's slope is 1/delta

    def readings(yk, gk):
        """(max |dY|, max |dG| / max |G|) against plain: the main-shape gate
        is y <= y_tol and g <= 1e-4."""
        return max_err(yk, yr), max_err(gk, gr) / float(gr.abs().max())

    y_err, g_rel = readings(y, g)
    g_err = max_err(g, gr)
    # Planted faults, the typical bugs of a split design, made by the plain
    # arithmetic: the threshold applied to a partial S (the last 16-row M
    # chunk, one pass-1 stage, left out); one 32-atom tile's contribution to
    # G dropped (one pass-2 stage); agent 0's G rows (its one batch tile)
    # written from agent 1's.
    s_part = torch.matmul(nu[:, :, :-16], W[:, :-16, :])
    y_part = ref.threshold(s_part, GAMMA, False) / DELTA
    del s_part
    y32 = yr.float()
    g_drop = torch.matmul(y32[:, :, :-32], W[:, :, :-32].transpose(-1, -2))
    faults = {
        "threshold on S without the last M chunk": (
            y_part, torch.matmul(y_part, W.transpose(-1, -2))),
        "G without the last 32-atom tile": (yr, g_drop),
        "agent 0's G rows from agent 1": (yr, torch.cat([gr[1:2], gr[1:]])),
    }
    fault_readings = {name: readings(*f) for name, f in faults.items()}
    del faults, y_part, g_drop, y32
    print(f"[kernels] main shape {(n, m, kb, b)}: max|dY| {y_err:.3e} (tol {y_tol:.3e} "
          f"= 1e-4 |S|_inf / delta), max|dG|/max|G| {g_rel:.3e} (tol 1e-4); repeated "
          f"launch bit-identical {repeat_equal}; planted faults (max|dY|, max|dG|/max|G|) "
          f"{fault_readings}")
    if not (y_err <= y_tol and g_rel <= 1e-4):
        raise AssertionError("dict_dual_step disagrees with plain at the main-path shape")
    if not repeat_equal:
        raise AssertionError("dict_dual_step: a repeated launch gave other bits")
    for name, (fy, fg) in fault_readings.items():
        if fy <= y_tol and fg <= 1e-4:
            raise AssertionError(f"the dict_dual_step gate passes a planted fault: {name}")
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
        "variant": ops.VARIANT,
        "grid": list(ops.ctas(n, m, kb, b)),  # CTAs of pass 1 and pass 2
        "shape": [n, m, kb, b],
        "repeat_bit_identical": repeat_equal,
        "planted_faults": fault_readings,
    }
    print(f"[kernels] dict_dual_step ({rec['variant']}, CTAs per pass {rec['grid']}) at "
          f"{(n, m, kb, b)}: kernel_ms {k1:.3f} {k2:.3f}  plain_ms {p1:.3f} {p2:.3f}  "
          f"bound_ms {rec['bound_ms']:.3f} ({rec['bound_by']})")
    if min(rec["grid"]) < 128:
        raise AssertionError(f"dict_dual_step launches {rec['grid']} CTAs per pass, < 128")
    del W, nu
    torch.cuda.empty_cache()
    return rec


def phase_flash_attention(torch):
    """flash_attention against its plain version; returns its kernel record
    (without `launches`, which the LM path fills in)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)

    def qkv(b, hq, hkv, s, t, d, dtype=None):
        dtype = dtype or torch.float32
        return (torch.randn(b, hq, s, d, generator=gen).to(dev, dtype),
                torch.randn(b, hkv, t, d, generator=gen).to(dev, dtype),
                torch.randn(b, hkv, t, d, generator=gen).to(dev, dtype))

    # fp32 at the JAX sweep's 2e-4: FA_SHAPES (tests/test_kernels.py), then
    # MQA at D = 256, ragged S = T = 1000, T > S, and the other head dims.
    shapes = [(1, 4, 4, 128, 128, 32), (2, 8, 2, 128, 128, 64), (1, 4, 1, 256, 256, 32),
              (2, 4, 4, 100, 100, 32), (1, 2, 2, 64, 192, 32),
              (2, 8, 1, 200, 200, 256), (1, 4, 2, 1000, 1000, 64),
              (2, 8, 1, 100, 1000, 128), (1, 4, 1, 77, 77, 16)]
    for shape in shapes:
        q, k, v = qkv(*shape)
        for causal in (True, False):
            check_close(f"fp32 {shape} causal={causal}",
                        ops.flash_attention(q, k, v, causal=causal),
                        ref.attention_ref(q, k, v, causal=causal), 2e-4, 2e-4)
    # bf16 to one output ulp plus BF16_ROW_ULPS x 2^-8 of the row's largest
    # value, and the model's layout: (B, S, H, D) projections read through
    # strides, at gemma's D = 256 with MQA.
    for shape in [(1, 4, 4, 128, 128, 32), (2, 8, 1, 300, 300, 256)]:
        q, k, v = qkv(*shape, dtype=torch.bfloat16)
        check_bf16(f"bf16 {shape}", ops.flash_attention(q, k, v, causal=True),
                   ref.attention_ref(q, k, v, causal=True))
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in qkv(2, 8, 1, 130, 130, 256))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.stride() == q.stride(), (out.stride(), q.stride())
    check_close("strided (B, S, H, D)", out, ref.attention_ref(q, k, v, causal=True), 2e-4, 2e-4)
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention agrees with plain over {len(shapes)} fp32 shapes "
          f"(causal and not, 2e-4), bf16 (reading <= {BF16_ROW_ULPS}) and the strided "
          f"(B, S, H, D) layout")

    # bf16 on the tensor-core kernel at each of its head dims: ragged S = T,
    # T > S, non-causal with ragged T, a seq stride of 4 (mod 8) elements
    # (copied: TMA needs 16-byte strides).
    for shape, causal in [((2, 4, 2, 1000, 1000, 64), True), ((1, 8, 1, 300, 1000, 128), True),
                          ((2, 4, 1, 1000, 1000, 256), True), ((2, 4, 2, 200, 333, 128), False),
                          ((1, 8, 1, 640, 640, 256), False)]:
        q, k, v = qkv(*shape, dtype=torch.bfloat16)
        check_bf16(f"bf16 {shape} causal={causal}", ops.flash_attention(q, k, v, causal=causal),
                   ref.attention_ref(q, k, v, causal=causal))
    q, k, v = (torch.nn.functional.pad(x, (0, 4))[..., :256]
               for x in qkv(1, 8, 1, 200, 200, 256, dtype=torch.bfloat16))
    check_bf16("bf16 seq stride 260", ops.flash_attention(q, k, v, causal=True),
               ref.attention_ref(q, k, v, causal=True))
    torch.cuda.synchronize()
    print("[kernels] flash_attention's wgmma_tma kernel agrees with plain at D = 64, 128, 256 "
          "(ragged, T > S, non-causal, a copied 4-mod-8 stride)")

    # The main-path shape: one gemma-2b prefill layer.  Planted faults, made
    # by the plain arithmetic under a wrong mask, must fail the same check.
    b, hq, hkv, s, t, d = FA_MAIN
    kind = ops.library_variant(torch.bfloat16, d)
    if not kind == ops.variant(torch.bfloat16, d) == "wgmma_tma":
        raise AssertionError(f"FA_MAIN goes to {kind} (wrapper: {ops.variant(torch.bfloat16, d)})")
    q, k, v = qkv(b, hq, hkv, s, t, d, dtype=torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    err = max_err(out, want)
    reading = bf16_reading(out, want)
    rows = torch.arange(s, device=dev)[:, None] >= s - 64
    late = causal_visible(torch, s, t, dev, 1)
    faults = {
        "causal limit one key late": late,
        "causal limit one key early": causal_visible(torch, s, t, dev, -1),
        "causal limit one tile late": causal_visible(torch, s, t, dev, 64),
        "last query tile one key late": torch.where(rows, late, causal_visible(torch, s, t, dev)),
    }
    fault_readings = {}
    for name, visible in faults.items():
        bad = masked_attention(torch, q, k, v, visible)
        fault_readings[name] = {
            "reading": bf16_reading(bad, want), "max_abs_err": max_err(bad, want),
            "passes_5e-2": bool(((bad.float() - want.float()).abs()
                                 <= 5e-2 + 5e-2 * want.float().abs()).all()),
        }
    print(f"[kernels] flash_attention bf16 main shape {FA_MAIN}: reading {reading:.3f} "
          f"(tol {BF16_ROW_ULPS}), max|err| {err:.3e}; planted faults {fault_readings}")
    if not reading <= BF16_ROW_ULPS:
        raise AssertionError(f"flash_attention disagrees with plain at {FA_MAIN}")
    for name, r in fault_readings.items():
        if r["reading"] <= BF16_ROW_ULPS:
            raise AssertionError(f"the bf16 check passes a planted fault: {name}")
    del out, want, bad, faults

    def kernel():
        return ops.flash_attention(q, k, v, causal=True)

    def plain():
        return ref.attention_ref(q, k, v, causal=True)

    def library():  # S = T, so SDPA's top-left causal mask is the same
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    sdpa_reading = check_bf16("SDPA yardstick", library(), plain())
    reps = 10
    k1, p1, l1, l2, p2, k2 = (time_ms(torch, fn, reps) for fn in
                              (kernel, plain, library, library, plain, kernel))
    pairs = b * hq * s * (s + 1) // 2  # visible (query, key) pairs, causal S = T
    flops = 4 * pairs * d              # q k^T and p v
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * t * d)  # q, out; k, v (bf16)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    rec = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": None,
        "max_abs_err": err,
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": (l1 + l2) / 2,  # F.scaled_dot_product_attention, causal, GQA
        "variant": kind,
        "grid": ops.ctas(b, hq, s, torch.bfloat16, d),
        "shape": list(FA_MAIN),
        "bf16_reading": reading,
        "bf16_reading_sdpa": sdpa_reading,
        "planted_faults": fault_readings,
    }
    print(f"[kernels] flash_attention ({kind}, {rec['grid']} CTAs) at {FA_MAIN} bf16 causal: "
          f"kernel_ms {k1:.3f} {k2:.3f}  "
          f"plain_ms {p1:.3f} {p2:.3f}  sdpa_ms {l1:.3f} {l2:.3f}  bound_ms "
          f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {flops:.3e} flops, {nbytes:.3e} bytes)  "
          f"max|err| {err:.3e}, bf16 reading {reading:.3f} (SDPA's {sdpa_reading:.3f})")
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def row_reading(got, want) -> float:
    """max over rows (the last axis) of max |got - want| / max |want| in the
    row; inf if anything is not finite."""
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    r = float((d.amax(-1) / w.amax(-1).clamp_min(1e-30)).max())
    return r if math.isfinite(r) else math.inf


def slstm_readings(h, state, h_ref, state_ref) -> dict:
    """K3's gate readings against plain: max |dh|, and per final-state
    tensor (c, n, m) the row reading."""
    dh = float((h - h_ref).abs().max())
    res = {"h": dh if math.isfinite(dh) else math.inf}
    res.update((name, row_reading(got, want)) for name, got, want in zip("cnm", state, state_ref))
    return res


def slstm_plain_seeing(torch, ref, x_proj, R, b, see):
    """ref.slstm_seq_ref's arithmetic, except that step t's products read
    see(h_{t-1}, h_{t-2}) (each (B, D)) in place of h_{t-1}: the plain
    stand-in for a kernel that reads the wrong h."""
    _, s, batch, d = x_proj.shape
    n_heads, p = R.shape[1], R.shape[2]
    Rf, bf = R.float(), b.float()[:, None, :]
    h = h2 = torch.zeros(batch, d, device=x_proj.device)
    c, n = torch.zeros_like(h), torch.zeros_like(h)
    m = torch.full_like(h, ref.NEG)
    hs = torch.empty(s, batch, d, device=x_proj.device)
    for t in range(s):
        rec = torch.einsum("bhp,ghpq->gbhq", see(h, h2).view(batch, n_heads, p), Rf)
        i_raw, f_raw, z_raw, o_raw = (x_proj[:, t].float() + rec.reshape(4, batch, d) + bf).unbind(0)
        lf = ref.log_sigmoid(f_raw)
        m_new = torch.maximum(lf + m, i_raw)
        i_s, f_s = torch.exp(i_raw - m_new), torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_raw)
        n = f_s * n + i_s
        h, h2 = torch.sigmoid(o_raw) * c / n.clamp_min(1e-6), h
        m = m_new
        hs[t] = h
    return hs, (c, n, m)


def phase_slstm(torch, build_report):
    """slstm_seq against its plain version; returns its kernel record
    (without `launches`, which the xLSTM path fills in)."""
    from repro_torch.kernels.slstm_step import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(b, s, d, h, dtype, r_scale, bias):
        p = d // h
        xp = torch.randn(4, s, b, d, generator=gen, device=dev).to(dtype)
        R = (torch.randn(4, h, p, p, generator=gen, device=dev) * r_scale).to(dtype)
        return xp, R, bias(d)

    def small_bias(d):
        return torch.randn(4, d, generator=gen, device=dev) * 0.1

    def check_tests(shape, dtype, r_scale):
        xp, R, b = inputs(*shape, dtype, r_scale, small_bias)
        h, state = ops.slstm_seq(xp, R, b)
        h_ref, state_ref = ref.slstm_seq_ref(xp, R, b)
        what = f"slstm {dtype} {shape}"
        check_close(f"{what} h", h, h_ref, SL_TEST_TOL, SL_TEST_TOL)
        for name, got, want in zip("cnm", state, state_ref):
            check_close(f"{what} {name}", got, want, SL_TEST_TOL, SL_TEST_TOL)

    # The plan the library launches is the one ops.variant states, and at
    # least one cluster of it fits on the card.
    plans = {}
    for (b, s, d, h) in [SL_MAIN, SL_GROUPS] + SL_TEST_SHAPES + list(ops.EDGE_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            got = ops.library_plan(dtype, b, d // h, h)
            kind, want = ops.variant(dtype, b, d // h, h)
            if kind != "cluster" or {k: got[k] for k in want} != want:
                raise AssertionError(f"slstm_seq plan at {(b, d // h, h, dtype)}: library "
                                     f"{got}, ops.variant {kind} {want}")
            if got["max_active_clusters"] < 1:
                raise AssertionError(f"slstm_seq: no cluster of {got} fits on the card")
            plans[(d // h, str(dtype))] = got
    print(f"[kernels] slstm_seq plans (library = ops.variant), by (P, dtype): {plans}")

    # The test shapes, fp32, R x 0.2 and b x 0.1 as tests/test_moe_a2a.py;
    # the plan's edges (ops.EDGE_SHAPES) in both types, R x P^-0.5 beyond
    # P = 25.
    for shape in SL_TEST_SHAPES:
        check_tests(shape, torch.float32, 0.2)
    for shape in ops.EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check_tests(shape, dtype, min(0.2, (shape[2] // shape[3]) ** -0.5))
    torch.cuda.synchronize()
    print(f"[kernels] slstm_seq agrees with plain at {len(SL_TEST_SHAPES)} fp32 test shapes "
          f"and {len(ops.EDGE_SHAPES)} edge shapes in fp32 and bf16 (h and final c, n, m "
          f"within {SL_TEST_TOL})")

    # The main-path shape: one xlstm-1.3b sLSTM block's recurrence, inputs
    # as the model makes them (x_proj of unit scale, R with 1/sqrt(P)
    # columns, the f bias 3 and the others 0), in bf16.
    b, s, d, h = SL_MAIN
    p = d // h
    kind, plan = ops.variant(torch.bfloat16, b, p, h)
    lib_plan = plans[(p, str(torch.bfloat16))]

    def model_bias(d):
        return torch.tensor([0.0, 3.0, 0.0, 0.0], device=dev)[:, None].expand(4, d).contiguous()

    xp, R, bias = inputs(b, s, d, h, torch.bfloat16, p ** -0.5, model_bias)
    hk, sk = ops.slstm_seq(xp, R, bias)
    hk2, sk2 = ops.slstm_seq(xp, R, bias)
    repeat_equal = bool(torch.equal(hk, hk2) and all(torch.equal(u, v) for u, v in zip(sk, sk2)))
    del hk2, sk2
    hp, sp = ref.slstm_seq_ref(xp, R, bias)
    torch.cuda.synchronize()
    readings = slstm_readings(hk, sk, hp, sp)
    shifted = torch.cat([torch.zeros_like(xp[:, :1]), xp[:, :-1]], dim=1)
    swap = [1, 0, 2, 3]
    # One CTA's columns: the last CTA of head 0's cluster.
    cta = slice(p - p // plan["cs"], p)

    def stale_cta(h1, h2):  # a missing or early wait: that CTA's slice of h_{t-2}
        seen = h1.clone()
        seen[:, cta] = h2[:, cta]
        return seen

    def lost_cta(h1, h2):  # its stores went to the wrong rank: that slice reads 0
        seen = h1.clone()
        seen[:, cta] = 0.0
        return seen

    faults = {
        "R transposed per head": ref.slstm_seq_ref(xp, R.transpose(-1, -2), bias),
        "x_proj read one step late": ref.slstm_seq_ref(shifted, R, bias),
        "f and i gates swapped": ref.slstm_seq_ref(xp[swap], R[swap], bias[swap]),
        "final state from step S-2": (hp, ref.slstm_seq_ref(xp[:, :-1], R, bias)[1]),
        "one CTA's columns read h_{t-2}": slstm_plain_seeing(torch, ref, xp, R, bias, stale_cta),
        "one CTA's columns of h_{t-1} read as 0": slstm_plain_seeing(torch, ref, xp, R, bias,
                                                                    lost_cta),
    }
    fault_readings = {name: slstm_readings(fh, fs, hp, sp) for name, (fh, fs) in faults.items()}
    del faults, shifted
    print(f"[kernels] slstm_seq bf16 main shape (B, S, D, H) {SL_MAIN}: readings {readings} "
          f"(gate: each <= {SL_TOL}); repeated launch bit-identical {repeat_equal}; planted "
          f"faults {fault_readings}")
    if not max(readings.values()) <= SL_TOL:
        raise AssertionError(f"slstm_seq disagrees with plain at {SL_MAIN}")
    if not repeat_equal:
        raise AssertionError("slstm_seq: a repeated launch gave other bits")

    # Three batch groups at the main widths: the same gate, and the fault
    # that hands the last group the first group's final state.
    gx, gR, gbias = inputs(*SL_GROUPS, torch.bfloat16, p ** -0.5, model_bias)
    gh, gs = ops.slstm_seq(gx, gR, gbias)
    gh_ref, gs_ref = ref.slstm_seq_ref(gx, gR, gbias)
    group_readings = slstm_readings(gh, gs, gh_ref, gs_ref)
    last = slice((SL_GROUPS[0] - 1) // ops.BT * ops.BT, SL_GROUPS[0])
    mixed = tuple(t.clone() for t in gs_ref)
    for t in mixed:
        t[last] = t[: last.stop - last.start]
    fault_readings["last group's state from the first group"] = slstm_readings(
        gh_ref, mixed, gh_ref, gs_ref)
    del gx, gR, gbias, gh, gs, gh_ref, gs_ref, mixed
    mixed_reading = fault_readings["last group's state from the first group"]
    print(f"[kernels] slstm_seq bf16 (B, S, D, H) {SL_GROUPS} (3 groups): readings "
          f"{group_readings} (gate: each <= {SL_TOL}); planted fault, the last group's state "
          f"from the first group: {mixed_reading}")
    if not max(group_readings.values()) <= SL_TOL:
        raise AssertionError(f"slstm_seq disagrees with plain at {SL_GROUPS}")
    for name, r in fault_readings.items():
        if max(r.values()) <= SL_TOL:
            raise AssertionError(f"the slstm_seq gate passes a planted fault: {name}")

    def kernel():
        return ops.slstm_seq(xp, R, bias)

    def plain():
        return ref.slstm_seq_ref(xp, R, bias)

    k1, p1, p2, k2 = (time_ms(torch, kernel, 5), time_ms(torch, plain, 1),
                      time_ms(torch, plain, 1), time_ms(torch, kernel, 5))
    flops = 2 * 4 * b * d * p * s  # h_{t-1} . R_g for 4 gates, every step
    nbytes = (xp.numel() * xp.element_size() + R.numel() * R.element_size()
              + 4 * bias.numel() + 4 * (s * b * d + 3 * b * d))  # x_proj, R, b; h, c, n, m
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    ms = (k1 + k2) / 2
    rec = {
        "name": "slstm_seq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/slstm_step/csrc/slstm_step.cu",
        "replaces": "src/repro/kernels/slstm_step/kernel.py:78",
        "launches": None,
        "max_abs_err": readings["h"],
        "ms": ms,
        "plain_ms": (p1 + p2) / 2,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        # No single PyTorch call computes this cell (torch.nn.LSTM is another cell).
        "library_ms": None,
        "variant": kind,
        "grid": {"ctas": plan["ctas"], "cluster_size": plan["cs"],
                 "clusters": plan["clusters"], "bt": plan["bt"], "threads": plan["threads"],
                 "max_active_clusters": lib_plan["max_active_clusters"]},
        "step_us": ms / s * 1e3,
        "shape": list(SL_MAIN),
        "readings": readings,
        "readings_3_groups": group_readings,
        "repeat_bit_identical": repeat_equal,
        "planted_faults": fault_readings,
        # The main shape's instantiation (phase_build prints them all).
        "ptxas": {fn: r for fn, r in build_report.items() if "bfloat16" in fn
                  and f"Li{plan['ks']}ELi{plan['nj']}E" in fn},
    }
    print(f"[kernels] slstm_seq ({kind}: {rec['grid']}) at (B, S, D, H) {SL_MAIN} bf16: "
          f"kernel_ms {k1:.3f} {k2:.3f} (step_us {rec['step_us']:.3f})  plain_ms {p1:.3f} "
          f"{p2:.3f}  bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}: {flops:.3e} flops, "
          f"{nbytes:.3e} bytes)  max|dh| {readings['h']:.3e}")
    del xp, R, bias, hk, sk, hp, sp
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
    reset_launch_counts()
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


def device_profile(torch, fn, top: int = 6):
    """One call of fn under torch.profiler: (host wall ms, device kernel ms
    summed over the kernels' own rows, [(kernel, ms)] of the `top` largest).
    The CPU operators' rows repeat their kernels' device time, so only the
    rows of device activity are summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:top]]


def phase_lm(torch, card: str):
    """The port's dense-LM serve at gemma-2b's full width; returns K2's
    launch count over the run."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import attention, model

    argv = ["--arch", LM_ARCH, "--full-config", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--device", "cuda"]
    # Warm-up at a short prompt (cuBLAS handles, the allocator's pools), not counted.
    serve.run(serve.parse_args(argv[:5] + ["--prompt-len", "64", "--gen", "2",
                                          "--device", "cuda"]))
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]

    if launches < cfg.n_layers:
        raise AssertionError(f"LM: {launches} flash_attention launches, expected >= "
                             f"{cfg.n_layers} (one per layer of the prefill)")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN):
        raise AssertionError(f"LM: generated tokens of shape {tuple(tokens.shape)}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"LM: a token outside [0, {cfg.vocab})")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("LM: prefill logits not finite")
    for name, t in out["cache"]["layers"].items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"LM: cache {name} not finite")

    # Re-run the prefill with K2 swapped for its plain version, and with two
    # planted wrong attentions: the causal limit one key late (which the
    # gate must reject) and p left in fp32 before P V (a rounding-level
    # change, read for the record).
    def prefill_with(attn):
        with mock.patch.object(attention.ops, "flash_attention", attn):
            logits, cache = model.prefill(cfg, out["params"], {"tokens": out["prompts"]})
        return logits[:, -1, :].clone(), cache["layers"]

    def planted(shift: int, round_p: bool):
        def attn(q, k, v, *, causal=True, scale=None):
            visible = causal_visible(torch, q.shape[2], k.shape[2], q.device, shift)
            return masked_attention(torch, q, k, v, visible, round_p)
        return attn

    def readings(got_last, got_cache):
        """{logits, k, v: (per-row reading, global reading)} against plain."""
        pairs = {"logits": (got_last, plain_last)}
        pairs.update((name, (got_cache[name], plain_cache[name])) for name in ("k", "v"))
        res = {}
        for name, (g, w) in pairs.items():
            d, w = (g.float() - w.float()).abs(), w.float().abs()
            row = float((d.amax(-1) / w.amax(-1).clamp_min(1e-30)).max())
            res[name] = (row if math.isfinite(row) else math.inf,
                         float(d.max()) / float(w.max()))
            del d, w
        return res

    plain_last, plain_cache = prefill_with(ref.attention_ref)
    tol = cfg.n_layers * BF16_UNIT_ROUNDOFF
    errs = readings(last, out["prefill_cache"]["layers"])
    planted_errs = {}
    for name, attn in (("causal limit one key late", planted(1, True)),
                       ("p unrounded", planted(0, False))):
        planted_errs[name] = readings(*prefill_with(attn))
    argmax_agree = float((last.argmax(-1) == plain_last.argmax(-1)).float().mean())
    print(f"[lm] prefill vs plain, (per-row, global) max|d|/max|plain| of logits, k, v "
          f"(gate: per-row <= {tol:.4f} = {cfg.n_layers} layers x 2^-8): K2 {errs}; "
          f"planted {planted_errs}; next-token argmax agreement {argmax_agree:.2f}")
    if not max(row for row, _ in errs.values()) <= tol:
        raise AssertionError("LM: the K2 prefill disagrees with the plain prefill")
    if max(row for row, _ in planted_errs["causal limit one key late"].values()) <= tol:
        raise AssertionError("LM: the prefill gate passes a planted wrong attention")

    # Where the time goes: one prefill and one decode step under the
    # profiler (the decode step rewrites the cache's last slot).
    params, prompts, cache = out["params"], out["prompts"], out["cache"]
    tok = tokens[:, -1:].to(prompts.device)
    # The busy share is the profiled device time over the unprofiled run's
    # time for the same work (the profiler slows the host).
    prof = {}
    for what, fn, run_ms in (
        ("prefill", lambda: model.prefill(cfg, params, {"tokens": prompts}), pay["prefill_ms"]),
        ("decode_step", lambda: model.decode_step(cfg, params, cache, tok, LM_PROMPT + LM_GEN - 1),
         pay["decode_ms_per_token"]),
    ):
        wall, dev_ms, top = device_profile(torch, fn)
        prof[what] = {"profiled_wall_ms": wall, "device_ms": dev_ms,
                      "busy_share": dev_ms / run_ms, "top": top}
        print(f"[lm] profile {what}: device kernels {dev_ms:.2f} ms, {run_ms:.2f} ms "
              f"unprofiled (busy share {dev_ms / run_ms:.3f}), {wall:.2f} ms under the "
              f"profiler; top {top}")

    print(f"[lm] {card}: {cfg.name} batch {LM_BATCH} prompt {LM_PROMPT} gen {LM_GEN}: "
          f"prefill {pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} tokens/s)  "
          f"decode {pay['decode_ms_per_token']:.3f} ms/token "
          f"({pay['decode_tokens_per_s']:.1f} tokens/s)  K2 launches {launches}  "
          f"peak device memory {peak_gb:.2f} GB")
    print("LM " + json.dumps({
        **pay, "card": card, "launches": launches, "peak_mem_gb": peak_gb,
        "prefill_rel_err": errs, "prefill_rel_tol": tol, "planted": planted_errs,
        "argmax_agree": argmax_agree,
        "first_row": tokens[0].tolist(), "profile": prof,
    }))
    del out, plain_cache, last, plain_last, params, prompts, cache
    torch.cuda.empty_cache()
    return launches


def phase_xlstm(torch, card: str):
    """The port's xLSTM serve at xlstm-1.3b's full width; returns K3's
    launch count over the run."""
    from repro_torch.kernels.slstm_step import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import model, xlstm

    argv = ["--arch", XL_ARCH, "--full-config", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--device", "cuda"]
    # Warm-up at a short prompt (cuBLAS handles, the allocator's pools), not counted.
    serve.run(serve.parse_args(argv[:5] + ["--prompt-len", "64", "--gen", "2",
                                          "--device", "cuda"]))
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.slstm_seq.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    params, prompts = out["params"], out["prompts"]
    n_slstm = cfg.n_layers // cfg.slstm_every

    if tuple(tokens.shape) != (LM_BATCH, LM_GEN):
        raise AssertionError(f"xLSTM: generated tokens of shape {tuple(tokens.shape)}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"xLSTM: a token outside [0, {cfg.vocab})")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError("xLSTM: prefill logits not finite")
    for kind, leaves in out["cache"].items():
        for name, t in leaves.items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"xLSTM: cache {kind}/{name} not finite")

    # The prefill again, each sLSTM block's recurrence held against plain on
    # the inputs it got there (the model goes on with the recurrence under
    # test): K3 (its launches alone: one per sLSTM block, so the serve's
    # decode made none), then a planted wrong recurrence (R transposed per
    # head), which the gate must reject.  The gate is K3's main-shape gate
    # (SL_TOL on h and on each final-state row) per block.  An end-to-end
    # gate cannot be used here: with random weights the 48-block stack
    # amplifies any difference in an sLSTM output, and a relative change of
    # 2^-23 (one fp32 ulp) in one block's h moves the last-position logits
    # by tenths of their row's scale (the control below records it), so the
    # K3 and plain prefills part by as much, while each block agrees.
    class Checked(Exception):
        """Ends a prefill once the blocks asked for are checked."""

    def checked(under_test, blocks=None):
        rows = []

        def seq(x_proj, R, b):
            if len(rows) == blocks:
                raise Checked
            h, state = under_test(x_proj, R, b)
            rows.append(slstm_readings(h, state, *ref.slstm_seq_ref(x_proj, R, b)))
            return h, state
        return seq, rows

    def prefill_with(seq):
        with mock.patch.object(xlstm.ops, "slstm_seq", seq):
            logits, cache = model.prefill(cfg, params, {"tokens": prompts})
        return logits[:, -1, :].clone(), cache

    def planted(x_proj, R, b):
        return ref.slstm_seq_ref(x_proj, R.transpose(-1, -2), b)

    reset_launch_counts()
    seq, k_rows = checked(ops.slstm_seq)
    k_last, k_cache = prefill_with(seq)
    prefill_launches = ops.slstm_seq.launches
    if launches != n_slstm or prefill_launches != n_slstm:
        raise AssertionError(f"xLSTM: {launches} slstm_seq launches in the serve and "
                             f"{prefill_launches} in a prefill, expected {n_slstm} in each "
                             f"(one per sLSTM block of the prefill, none in decode)")
    seq, planted_rows = checked(planted, blocks=1)  # its first block must fail the gate
    try:
        prefill_with(seq)
    except Checked:
        pass
    k_worst = max(max(r.values()) for r in k_rows)
    planted_worst = max(max(r.values()) for r in planted_rows)
    print(f"[xlstm] prefill, each sLSTM block against plain on its own inputs (gate: each "
          f"reading <= {SL_TOL}): K3 {k_rows}; planted R transposed {planted_rows}")
    if len(k_rows) != n_slstm or not k_worst <= SL_TOL:
        raise AssertionError("xLSTM: a K3 block of the prefill disagrees with plain")
    if not planted_worst > SL_TOL:
        raise AssertionError("xLSTM: the prefill gate passes a planted wrong recurrence")

    # End to end, recorded: per-row readings of the K3 prefill against the
    # plain prefill (last-position logits, every sLSTM state, the mLSTM states
    # of the groups after the first), and of a control: the plain prefill
    # with one fp32 ulp of noise on every sLSTM block's h.
    def readings(got_last, got_cache, want_last, want_cache):
        res = {"logits": row_reading(got_last, want_last)}
        for name, t in got_cache["slstm"].items():
            res[f"slstm/{name}"] = row_reading(t, want_cache["slstm"][name])
        for name, t in got_cache["mlstm"].items():
            res[f"mlstm/{name}"] = row_reading(t[1:], want_cache["mlstm"][name][1:])
        return res

    def ulp_noise(x_proj, R, b):
        h, state = ref.slstm_seq_ref(x_proj, R, b)
        noise = torch.randn(h.shape, generator=torch.Generator(h.device).manual_seed(3),
                            device=h.device)
        return h * (1 + 2.0 ** -23 * noise), state

    plain_last, plain_cache = prefill_with(ref.slstm_seq_ref)
    errs = readings(k_last, k_cache, plain_last, plain_cache)
    del k_cache
    control = readings(*prefill_with(ulp_noise), plain_last, plain_cache)
    del plain_cache
    argmax_agree = float((k_last.argmax(-1) == plain_last.argmax(-1)).float().mean())
    print(f"[xlstm] end to end, per-row max|d|/max|plain| (recorded): K3 vs plain {errs}; "
          f"control, plain with one fp32 ulp of noise on each sLSTM h, vs plain {control}; "
          f"next-token argmax agreement K3 vs plain {argmax_agree:.2f}")

    # Where the time goes: one prefill and one decode step under the
    # profiler (the decode step advances the serving cache once more).
    cache = out["cache"]
    tok = tokens[:, -1:].to(prompts.device)
    prof = {}
    for what, fn, run_ms in (
        ("prefill", lambda: model.prefill(cfg, params, {"tokens": prompts}), pay["prefill_ms"]),
        ("decode_step", lambda: model.decode_step(cfg, params, cache, tok, LM_PROMPT + LM_GEN - 1),
         pay["decode_ms_per_token"]),
    ):
        wall, dev_ms, top = device_profile(torch, fn)
        prof[what] = {"profiled_wall_ms": wall, "device_ms": dev_ms,
                      "busy_share": dev_ms / run_ms, "top": top}
        print(f"[xlstm] profile {what}: device kernels {dev_ms:.2f} ms, {run_ms:.2f} ms "
              f"unprofiled (busy share {dev_ms / run_ms:.3f}), {wall:.2f} ms under the "
              f"profiler; top {top}")

    print(f"[xlstm] {card}: {cfg.name} batch {LM_BATCH} prompt {LM_PROMPT} gen {LM_GEN}: "
          f"prefill {pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} tokens/s)  "
          f"decode {pay['decode_ms_per_token']:.3f} ms/token "
          f"({pay['decode_tokens_per_s']:.1f} tokens/s)  K3 launches {launches}  "
          f"peak device memory {peak_gb:.2f} GB")
    print("XLSTM " + json.dumps({
        **pay, "card": card, "launches": launches, "prefill_launches": prefill_launches,
        "peak_mem_gb": peak_gb, "block_readings": k_rows, "block_tol": SL_TOL,
        "planted_block_readings": planted_rows, "end_to_end_rel_err": errs,
        "end_to_end_ulp_noise_control": control, "argmax_agree": argmax_agree,
        "first_row": tokens[0].tolist(), "profile": prof,
    }))
    del out, cache, last, k_last, plain_last, params, prompts
    torch.cuda.empty_cache()
    return launches


def learner_step(torch, learner, state, x):
    """One fit_batch, synchronized: (new state, metrics as floats, seconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, metrics = learner.fit_batch(state, x)
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in metrics._asdict().items()}, time.perf_counter() - t


def max_abs_step(torch, before, after) -> float:
    """max |after - before| over (N, M, Kb) blocks, one agent at a time."""
    return max(float((a - b).abs().max()) for a, b in zip(after, before))


def phase_learner(torch, card: str):
    """The learner at the production dictionary (fista gated, diffusion
    recorded), then card against CPU at the production Kb/M."""
    import dataclasses

    import numpy as np

    from repro_torch.convert import learner_state_from_numpy
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import sparse_stream

    X = sparse_stream(MICRO_BATCH * (LEARN_STEPS + 2), m=M, k_true=LEARN_K_TRUE, seed=1)
    batches = [X[i * MICRO_BATCH:(i + 1) * MICRO_BATCH] for i in range(LEARN_STEPS + 2)]
    base = LearnerConfig(m=M, k=ATOMS_PER_AGENT * N_AGENTS, n_agents=N_AGENTS,
                         task="sparse_svd", gamma=GAMMA, delta=DELTA, mu=-1.0,
                         inference_iters=ITERS, mu_w=LEARN_MU_W, seed=0)
    out = {}
    for engine, steps in (("fista", LEARN_STEPS), ("diffusion", LEARN_DIFFUSION_STEPS)):
        learner = DictionaryLearner(dataclasses.replace(base, engine=engine))
        state = learner.init_state()
        warm = engine == "fista"
        if warm:
            state, _, _ = learner_step(torch, learner, state, batches[0])
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(steps):
            before = state.W_blocks
            state, metrics, dt = learner_step(torch, learner, state, batches[1 + i])
            secs.append(dt)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dW = max_abs_step(torch, before, state.W_blocks)
        del before
        col_max = float(torch.linalg.vector_norm(state.W_blocks, dim=1).max())
        y = learner.code(state, batches[-1])
        code_share = float((y != 0).float().mean())
        # Where a step's time goes: one more fit_batch under torch.profiler.
        wall_ms, dev_ms, top = device_profile(torch, lambda: learner.fit_batch(state, batches[-1]))
        finite = all(math.isfinite(v) for v in metrics.values()) and bool(torch.isfinite(y).all())
        timed = secs if warm else secs[1:]  # diffusion's first step is its warm-up
        s_step = sum(timed) / len(timed)
        rec = {"engine": engine, "card": card, "M": M, "K": base.k, "agents": N_AGENTS,
               "batch": MICRO_BATCH, "iters": ITERS, "steps_timed": len(timed),
               "s_per_fit_batch": s_step, "step_s": secs,
               "samples_per_s": MICRO_BATCH / s_step, "dual_iters_per_s": ITERS / s_step,
               "metrics": metrics, "code_nonzero_share": code_share,
               "max_abs_dW": dW, "max_col_norm": col_max, "peak_mem_gb": peak_gb,
               "profile": {"wall_ms": wall_ms, "device_ms": dev_ms, "busy": dev_ms / wall_ms,
                           "top": top}}
        print(f"[learner:{engine}] {card}: {s_step:.4f} s per fit_batch "
              f"({MICRO_BATCH / s_step:.2f} samples/s, {ITERS / s_step:.1f} dual iterations/s)  "
              f"primal {metrics['primal_obj']:.6f} dual {metrics['dual_obj']:.6f} "
              f"residual {metrics['residual_norm']:.6f} sparsity {metrics['sparsity']:.3e}  "
              f"code() nonzero {code_share:.3e}  max|dW| {dW:.3e}  max col norm {col_max:.7f}  "
              f"peak device memory {peak_gb:.2f} GB")
        print(f"[learner:{engine}] profiled step: {dev_ms:.1f} ms of kernels over "
              f"{wall_ms:.1f} ms (busy {dev_ms / wall_ms:.3f}); top {top}")
        print("LEARNER " + json.dumps(rec))
        if engine == "fista":
            if not finite:
                raise AssertionError(f"learner fista: a metric or code is not finite {metrics}")
            if not (metrics["sparsity"] > 0 and code_share > 0):
                raise AssertionError("learner fista: every code is zero")
            if not dW > 0:
                raise AssertionError("learner fista: the dictionary step changed nothing")
            if not col_max <= 1.0 + 1e-6:
                raise AssertionError(f"learner fista: a column norm is {col_max}")
        out[engine] = rec
        del learner, state, y
        torch.cuda.empty_cache()

    # Card against CPU at the production Kb/M.
    m, k = LEARN_PARITY_M, LEARN_PARITY_K
    rng = np.random.default_rng(0)
    W = rng.standard_normal((m, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    A = make_topology("erdos", N_AGENTS, p=0.5, seed=0)
    x = sparse_stream(MICRO_BATCH, m=m, k_true=1024, seed=2)
    small = dataclasses.replace(base, m=m, k=k)

    def parity_readings(got, want):
        (Wg, mg), (Ww, mw) = got, want
        r = {"W": max_err(Wg.cpu(), Ww) / float(Ww.abs().max())}
        for name, v in mw.items():
            floor = 1.0 / (MICRO_BATCH * k) if name == "sparsity" else 0.0
            r[name] = max(abs(mg[name] - v) - floor, 0.0) / max(abs(v), 1e-30)
        return r

    def one_step(engine, device, fault=False):
        learner = DictionaryLearner(dataclasses.replace(small, engine=engine), device=device)
        state = learner_state_from_numpy(W, A, np.ones(N_AGENTS), 0, N_AGENTS, device=device)
        if fault:
            infer = learner._infer

            def rolled(*args):
                nu, y = infer(*args)
                return nu, torch.roll(y, 1, dims=0)

            learner._infer = rolled
        state, metrics = learner.fit_batch(state, x)
        return state.W_blocks, {k_: float(v) for k_, v in metrics._asdict().items()}

    for engine in ("fista", "exact", "diffusion"):
        want = one_step(engine, "cpu")
        r = parity_readings(one_step(engine, "cuda"), want)
        planted = parity_readings(one_step(engine, "cuda", fault=True), want)
        print(f"[learner:parity] {engine} card vs CPU at M {m}, K {k}, N {N_AGENTS}: "
              + "  ".join(f"{n_} {v:.2e}" for n_, v in r.items())
              + f" (tol {LEARN_PARITY_RTOL}); planted y from the next agent: W {planted['W']:.2e}"
              + f"  sparsity (CPU) {want[1]['sparsity']:.3e}")
        if max(r.values()) > LEARN_PARITY_RTOL:
            raise AssertionError(f"learner {engine}: card and CPU disagree {r}")
        if engine == "fista" and not planted["W"] > LEARN_PARITY_RTOL:
            raise AssertionError(f"learner {engine}: the planted fault passed the W check")
        out[f"parity_{engine}"] = {"readings": r, "planted_W": planted["W"]}
    return out


def phase_experiments(torch, card: str):
    """The table3_auc and fig5_denoise twins on the card at cut sizes."""
    from repro_torch.experiments import fig5_denoise, table3_auc

    cuts = {"table3_auc": {"n_steps": 2}, "fig5_denoise": {"n_patches": 1200}}
    out = {}
    for name, run in (("table3_auc", table3_auc.run), ("fig5_denoise", fig5_denoise.run)):
        t = time.perf_counter()
        result = run(device="cuda", **cuts[name])
        wall = time.perf_counter() - t
        out[name] = {"cut": cuts[name], "wall_s": wall, "result": result}
        print(f"[experiments:{name}] {card}: wall {wall:.1f} s at {cuts[name]} "
              f"(other arguments the JAX script's defaults): {result}")
    aucs = [a for v in out["table3_auc"]["result"].values() for a in v.values()]
    if not aucs or not all(0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"table3_auc: an AUC outside [0, 1] or none: {aucs}")
    psnrs = out["fig5_denoise"]["result"]
    if not all(math.isfinite(v) for v in psnrs.values()):
        raise AssertionError(f"fig5_denoise: a PSNR is not finite: {psnrs}")
    noisy = psnrs["noisy_psnr_db"]
    low = {k: v for k, v in psnrs.items() if k != "noisy_psnr_db" and not v > noisy}
    if low:
        raise AssertionError(f"fig5_denoise: not above the noisy PSNR {noisy}: {low}")
    print("EXPERIMENTS " + json.dumps({"card": card, **{k: v for k, v in out.items()}},
                                      default=str))
    return out


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

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f}s")
        return res

    wgmma_build, slstm_build = timed("build", phase_build)
    rec = timed("dict_dual_step", phase_kernels, torch)
    fa_rec = timed("flash_attention", phase_flash_attention, torch)
    fa_rec["wgmma_build"] = wgmma_build  # HGMMA in the SASS, ptxas registers and spills
    sl_rec = timed("slstm_seq", phase_slstm, torch, slstm_build)
    timed("small coder", phase_small_coder, torch)
    fa_rec["launches"] = timed("gemma-2b serve", phase_lm, torch, card)
    sl_rec["launches"] = timed("xlstm-1.3b serve", phase_xlstm, torch, card)
    # The diffusion's step is bounded by the worst block's curvature
    # (sigma_max(W_k)^2 / delta, about 58 here) while its consensus term
    # contracts by only mu / N per iteration, so after 150 iterations at this
    # width an agent's nu is still a small fraction of x (1 - (1 - mu/N)^150,
    # about 0.13) and no atom passes the threshold: graph codes may all be
    # zero.  exact_fista converges in 150 iterations and must code.
    launches = {mode: timed(f"serve_dict {mode}", phase_main_path, torch, mode, card,
                            must_code=(mode == "exact_fista"))
                for mode in ("graph", "exact_fista")}
    rec["launches"] = launches["graph"] + launches["exact_fista"]
    rec["launches_by_mode"] = launches
    # The learner and the experiments are plain PyTorch (no kernel of the
    # port is on their path, as in the JAX package): none may launch one.
    reset_launch_counts()
    timed("learner", phase_learner, torch, card)
    timed("experiments", phase_experiments, torch, card)
    from repro_torch.kernels.dict_dual_step import ops as dd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slstm_step import ops as sl_ops

    stray = dd_ops.dict_dual_step.launches + fa_ops.flash_attention.launches \
        + sl_ops.slstm_seq.launches
    if stray:
        raise AssertionError(f"the learner or experiments launched {stray} kernels")

    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [rec, fa_rec, sl_rec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
