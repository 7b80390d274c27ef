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
   taken from the first group) must fail the same checks.
   K2's gradient (ops.FlashAttention: K2 forward, attention_backward in
   plain PyTorch) against autograd through attention_ref at four fp32
   shapes (GRAD_FP32_TOL) and at olmo-1b's training shape FA_TRAIN in bf16
   (GRAD_BF16_TOL), with three planted faults rejected (the wrapper
   without the Function, a backward without the causal mask, one without
   the D term); the backward timed beside K2 + Function, the plain twin
   and F.scaled_dot_product_attention (forward and backward).
   K2 at the MoE family's shapes: granite-moe's FA_MOE (wgmma_tma) and
   kimi-k2's FA_KIMI at head dim 112 (scalar_fp32) against plain, timed
   beside SDPA with their bounds (K2's `moe_shapes`), two planted faults
   at D 112 rejected (logits from the first 64 columns, the causal limit
   one key late); K2's gradient at FA_MOE (GRAD_BF16_TOL).
   The MoE layer (models/moe.apply_moe): against moe_ref at granite-moe's
   width on 4 x 2048 tokens with nothing dropped (fp32 at MOE_FP32_RTOL,
   bf16 at MOE_ROW_ULPS); two launches bit-identical, forward and
   backward; the dispatch tables against the CPU's on the same fp32
   inputs with drops (MOE_SMALL, top-k margins above MOE_MARGIN); planted
   faults rejected (a combine without the gate renormalisation, a dispatch
   ignoring the capacity, positions counted slot-major).
   The whole coder (kernel path) on small inputs, every gossip mode:
   graph and exact against the plain reference engines, graph_tv (also
   with link failures from t0 = 3) against diffusion_infer under the
   schedule's A_t, push on the directed star against push_sum_infer, hier
   and an fp32 chain with a stride-2 level against diffusion_infer under
   the chain's A_t, ring_async and graph_async against one-step-stale
   diffusion and their plain twins (all 1e-4), every q8 mode against its
   plain twin (Q8_RTOL of max |nu|).  Planted faults (graph_tv stuck on
   A_0, push without the division by its weight, the stride-2 level firing
   every iteration, graph_async combining fresh messages) must fail them.
   Elastic growth and drain on small inputs with nonzero codes: the grown
   and the drained coders of exact_fista, graph on erdos, graph_tv_q8
   with link failures and a three-level chain (each fp32 twin too) against
   their plain twins and the single-host references (FISTA at the coder's
   mu, diffusion_infer under the new combiners; 1e-4, Q8_RTOL on the int8
   wire), old and survivor blocks bit for bit, fresh blocks unit-norm, the
   grown erdos graph keeping every old edge, a graph_tv_q8 service on the
   card whose clock runs on across a grow and a drain, and a two-replica
   router that re-routes a killed replica's queued work.  Planted faults
   (a grow that draws the whole erdos graph afresh, a drain that
   renormalises the survivors, a drain that resets the clock, a router
   without re-route) must fail them.  K1 against plain at the agent counts
   growth gives the production dictionary, N 18 and N 20, with the main
   shape's gate.
   Then every mode of the engine once at the production dictionary (M
   8192, K 262144, N 16, one micro-batch of 16, GOSSIP_CASES): exactly
   iters + 1 K1 launches per solve, nu and y finite, the solve timed (mean
   of 3 after a warm one) and re-solved with K1's plain version within
   SOLVE_RTOL (Q8_RTOL on the int8 wire); one GOSSIP line each.
3. Main paths, each driven with every kernel's launch count set to 0 just
   before and read just after:
   - dense-LM serving: the port's serve at gemma-2b's full width (random
     weights), a batch of 4 prompts of 2048 tokens, 32 greedy tokens; one
     flash_attention launch per layer of the prefill.  Tokens must lie in
     the vocabulary, logits and cache be finite, and the prefill re-run
     with the kernel swapped for its plain version must agree (last-position
     logits and every layer's K/V cache), while one re-run with a planted
     wrong attention must not;
   - dense-LM training: the port's launch/train at olmo-1b's full width,
     depth cut to TRAIN_LAYERS (random weights, AdamW, batches of 4 x 2048
     tokens, TRAIN_STEPS steps
     through TrainRunner with a checkpoint, a fault injected, restored and
     replayed, and the rescale reload; 2 K2 launches a layer a step,
     forward and remat recompute).  The first step's loss and every
     gradient leaf against its plain-attention twin (L x 2^-8), the first
     replayed loss exactly the first pass's (the rest REPLAY_RTOL), one
     step profiled by kernel category; step ms, tokens/s, the model-flops
     share of the bf16 peak, peak memory and checkpoint seconds printed
     (TRAIN line).  Then three steps of the olmo smoke config, fp32, on the
     card against the CPU (SGD params at 1e-4, AdamW losses at 1e-5);
   - MoE serving: the port's serve at granite-moe-1b-a400m's full width,
     the gemma path's traffic; 24 K2 launches a prefill (gated), each
     layer's K2 against plain on its own inputs (gated, a planted wrong
     attention rejected), the end-to-end logits against the
     plain-attention twin and the share of routes that differ (printed:
     a route one ulp flips moves its token by O(1)), the prefill and a
     decode step profiled by range (router, dispatch tables, gathers,
     expert GEMMs, attention, unembedding; MOE_SERVE line);
   - MoE training: launch/train at granite-moe's full width, MOE_STEPS
     steps of 4 x 2048 tokens (AdamW, cosine warmup), checkpoints every
     MOE_CKPT_EVERY, a fault at MOE_FAULT_AT, the rescale reload: 48 K2
     launches a step, the first replayed loss exactly the first pass's,
     the first step's loss against its plain-attention twin
     (MOE_LOSS_RTOL; its gradients and routes printed), one step
     profiled; step ms, tokens/s, the model-flops share (active params)
     and checkpoint seconds printed (MOE_TRAIN line);
   - kimi-k2 at full width cut to KIMI_LAYERS layers (serve --n-layers):
     a 4 x 2048 prefill and KIMI_GEN tokens, bf16 params; 2 K2 launches
     at D 112, each against plain on its inputs, and the MoE layer at
     kimi's width against moe_ref on MOE_KIMI_TOKENS of its own inputs
     (KIMI line);
   - three SGD steps of the granite-moe smoke config on the card against
     the CPU: the first step's routes compared, params at 1e-4, a planted
     combine without renormalisation rejected (MOE_CHECKS line);
   - xLSTM serving: the port's serve at xlstm-1.3b's full width, depth cut
     to XL_LAYERS (random weights), the same traffic; one slstm_seq launch
     per sLSTM block of the prefill (3) and none in decode.  Tokens in the vocabulary, logits
     and every cache leaf finite, and in a re-run of the prefill every
     sLSTM block's recurrence must agree with its plain version on the
     inputs it got there, while a planted wrong recurrence must not (the
     end-to-end difference from the plain prefill is recorded beside a
     one-ulp noise control: the random-weight stack amplifies any
     difference, so it cannot be gated);
   - the dictionary service: serve_dict at the production dictionary
     (M = 8192, K = 262144, N = 16 agents, fp32, gamma 0.05, delta 0.1)
     with learning on, in `graph` mode (ring_metropolis, the paper's
     diffusion), in `exact_fista` mode (the CLI default), and on the two
     schedule-driven paths: `graph_tv_q8` with link failures (--fail-p
     0.25) and the three-level `chain` (mesh 2x2x1x4); every iteration is
     a dict_dual_step launch.  Every sample must be coded, every code
     finite (and, in `exact_fista`, some nonzero), the service's schedule
     clock advanced by iters per execution (0 for a static mode), and one
     micro-batch re-solved on the final snapshot with the kernel swapped
     for its plain version must agree with the kernel path;
   - the elastic drills (DRILLS): serve_dict at the same size growing at
     sample 16 and draining at sample 40, exact_fista and graph on erdos
     to N 18 and back, graph_tv_q8 with link failures, the chain +1 on its
     model level (N 20) and back: every sample coded and finite, the y
     dims in era order, both events, the clock at iters per execution
     across both swaps, and (exact_fista) a batch re-solved at N 18 with
     K1 against plain, nonzero codes required; the swaps' latency
     (request to resolved Future) printed;
   - the serving plane: serve_dict --replicas 2 --publish-at 32 (graph):
     every sample coded, none failed, the rolling publish reaching both
     replicas, K1 against plain on r0's final snapshot; and the kill drill:
     two graph replicas behind the Router, r1 killed at sample 32 with
     work queued: failed 0, at least one request re-routed.
4. The learner and the paper's applications, plain PyTorch on the card
   (no kernel of the port is on their path, and the script fails if one
   launches), then the twins of examples/, each with its exact launches:
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
   - the twins of examples/ at the JAX scripts' sizes: quickstart,
     denoise_image and novel_docs launch no kernel; graph_gossip and
     multi_pod run the port's coder, exactly iters + 1 K1 calls a solve;
     train_lm (LM_100M, fp32) exactly 2 K2 launches a layer a step and its
     loss falling by more than 1.0.  Every result finite (TWINS line).
5. Result: one JSON line listing every kernel (launches on its main path,
   error against plain, times and bound), the card line, and last the
   device line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import pathlib
import statistics
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

# The xLSTM main path: the port's serve at xlstm-1.3b's full width (d 2048,
# 4 heads, mLSTM P 1024, sLSTM P 512, vocab 50304, bf16 compute), depth cut
# from 48 blocks to XL_LAYERS (3 groups: 21 mLSTM and 3 sLSTM blocks) to
# keep the whole script well inside its time limit, random weights from
# seed 0, the gemma path's traffic.  Its sLSTM recurrence, one K3 launch
# per sLSTM block: (B, S, D, H), bf16 x_proj and R.
XL_ARCH, XL_LAYERS = "xlstm_1p3b", 24
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
# The same on the int8 wire: one int8 level flipped by the other path's
# rounding moves a message by its row's max / 127, which the iteration
# carries on: 1e-2 of the largest |nu| (the JAX suite's q8 tolerance).
Q8_RTOL = 1e-2

# The gossip modes at the production dictionary above (serve_dict's flags as
# DistConfig fields), one micro-batch, each with its agents per level,
# innermost first: a hier mesh 2x1x8 is (8, 2), a chain mesh 2x2x1x4 is
# (4, 2, 2).  The chain is parse_level_specs' own example.
GOSSIP_CASES = [
    ("exact", dict(mode="exact"), N_AGENTS),
    ("exact_fista", dict(mode="exact_fista"), N_AGENTS),
    ("ring", dict(mode="ring"), N_AGENTS),
    ("ring_q8", dict(mode="ring_q8"), N_AGENTS),
    ("ring_async", dict(mode="ring_async"), N_AGENTS),
    ("graph", dict(mode="graph"), N_AGENTS),
    ("graph_q8", dict(mode="graph_q8"), N_AGENTS),
    ("graph_async", dict(mode="graph_async"), N_AGENTS),
    ("graph_async torus", dict(mode="graph_async", topology="torus"), N_AGENTS),
    ("graph_tv", dict(mode="graph_tv"), N_AGENTS),
    ("graph_tv_q8", dict(mode="graph_tv_q8"), N_AGENTS),
    ("graph_tv_q8 fail", dict(mode="graph_tv_q8", failure_p=0.25, failure_steps=6), N_AGENTS),
    ("push", dict(mode="push", topology="distar"), N_AGENTS),
    ("push_q8", dict(mode="push_q8", topology="distar"), N_AGENTS),
    ("hier", dict(mode="hier", pod_topology="ring_metropolis", pod_gossip_every=2), (8, 2)),
    ("hier_q8", dict(mode="hier_q8", pod_topology="ring_metropolis", pod_gossip_every=2),
     (8, 2)),
    ("chain", dict(mode="chain", levels="torus,ring_metropolis:2:q8,ring:4:q8:stale"),
     (4, 2, 2)),
]
GOSSIP_TIMED = 3  # timed solves per mode, after a warm one

# The elastic drills at the production dictionary: serve_dict with a grow at
# sample DRILL_GROW_AT and a drain at DRILL_DRAIN_AT (mode, flags, agents a
# grow adds, ranks a drain takes): exact_fista (the CLI default) and graph on
# erdos to N 18 and back, graph_tv_q8 with link failures, the chain of the
# gossip phase +1 on its model level (N 20) and back.  Then a fleet of two
# graph replicas with a rolling publish at FLEET_PUBLISH_AT, and the kill
# drill: r1 killed at KILL_AT with work in flight.
DRILL_GROW_AT, DRILL_DRAIN_AT = 16, 40
DRILLS = [
    ("exact_fista", (), 2, "0,17", True),
    ("graph", ("--topology", "erdos"), 2, "0,17", False),
    ("graph_tv_q8", ("--topology", "ring_metropolis", "--fail-p", "0.25"), 2, "0,17", False),
    ("chain", ("--mesh", "2x2x1x4", "--levels", "torus,ring_metropolis:2:q8,ring:4:q8:stale"),
     1, "0", False),
]
FLEET_PUBLISH_AT, KILL_AT = 32, 32
# The kill drill's router seed: its first tie-break (both replicas idle at
# the first admission batch of 32) picks r1 (numpy's default_rng(0).integers(2)
# is 1), so r1 is solving half of it, the other half queued, when the stream
# reaches KILL_AT (a solve takes about a second there).
KILL_SEED = 0

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

# The LM-training main path: the port's launch/train at olmo-1b's full width
# (d 2048, 16 heads of 128, d_ff 8192, vocab 50304, bf16 compute; remat on),
# depth cut from 16 layers to TRAIN_LAYERS to keep the whole script well
# inside its time limit (6.4e8 fp32 params and AdamW's two fp32 moments,
# 7.7 GB of state), random weights from seed 0, batches of TRAIN_BATCH x TRAIN_SEQ tokens
# from the Markov stream, TRAIN_STEPS steps through TrainRunner with a
# checkpoint every TRAIN_CKPT_EVERY, a fault injected at TRAIN_FAULT_AT
# (restore TRAIN_CKPT_EVERY, replay), then the rescale reload.  K2 runs
# forward in each layer and again in its recompute: 2 x TRAIN_LAYERS
# launches a step at FA_TRAIN (B, Hq, Hkv, S, T, D), bf16, causal.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "olmo_1b", 8, 4, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT = 12, 6, 8
FA_TRAIN = (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128)
# K2's gradient (its Function: K2 forward, attention_backward) against
# autograd through attention_ref, per gradient max |d| / max |plain|: fp32
# at GRAD_FP32_TOL (both fp32, sums in other orders); bf16 at GRAD_BF16_TOL:
# the plain path rounds its probabilities and their cotangent to bf16 and
# each output and gradient to bf16 (2^-9 relative each), some 2^-8 in all
# (measured 3.5e-3 to 7.2e-3 against JAX's bf16 vjp on the CPU,
# tests/test_torch_attention_grad.py); 2^-5 leaves 4x that, and the three
# planted faults (no Function, no causal mask, no D term) move a gradient
# by order 1.
GRAD_FP32_TOL, GRAD_BF16_TOL = 1e-4, 2.0 ** -5
# The first replayed step is gated exactly (the same checkpoint bytes
# through the same forward); the later ones, which follow a replayed
# update, within REPLAY_RTOL relative (a quarter of one bf16 ulp, 2^-8).
# The one operation of the step that PyTorch lists as nondeterministic on
# CUDA is the backward of torch.gather in the cross-entropy (a scatter_add_
# with atomics), whose writes never collide (one gold logit per row); the
# embedding's backward (index_put_ with accumulate) sorts its indices on
# CUDA.  Every replayed loss matched bit for bit on the card (PERF.md).
REPLAY_RTOL = 1e-3
# AdamW's updates, card against CPU, on the scale of lr: all but
# ADAMW_SHARE of the elements within 1e-3 lr, and none past ADAMW_FLIP lr.
# m_hat / sqrt(v_hat) maps a gradient of any size to about +-1, so where an
# element's gradients are small against its leaf's largest (sqrt(v) a few
# % of the leaf's) a rounding-level gradient difference moves its update by
# a few % of lr (0.060 lr on the card's first run, 0.024 lr against JAX on
# the CPU); a flipped or wrong update moves it by order lr.
ADAMW_SHARE, ADAMW_FLIP = 1e-3, 0.5

# The MoE family.  granite-moe-1b-a400m at full width (24 layers, d 1024,
# 16 query heads over 8 KV heads of 64, 32 experts top-8 of d_ff 512, vocab
# 49155; fp32 params, bf16 compute; 1.335e9 params, 4.29e8 active), random
# weights from seed 0: served with the gemma path's traffic, and trained
# through launch/train with the olmo path's batches (AdamW, cosine warmup)
# for MOE_STEPS steps, a checkpoint every MOE_CKPT_EVERY, a fault at
# MOE_FAULT_AT, the rescale reload.  Its attention: one K2 launch a layer
# a prefill, two a layer a step; FA_MOE, bf16, causal, on wgmma_tma.  It
# dispatches 16 groups of 512 tokens, 160 places an expert a group; a
# decode step one group of 4 tokens, 1 place.
MOE_ARCH = "granite_moe_1b_a400m"
MOE_STEPS, MOE_CKPT_EVERY, MOE_FAULT_AT = 8, 4, 6
FA_MOE = (LM_BATCH, 16, 8, LM_PROMPT, LM_PROMPT, 64)
# kimi-k2-1t-a32b at full width (d 7168, 64 query heads over 8 KV heads of
# 112, 384 experts top-8 of d_ff 2048 and one shared expert, a dense first
# layer of d_ff 18432, vocab 163840; bf16 params), depth cut from 61 layers
# to KIMI_LAYERS (the dense first layer and one MoE layer: 1.88e10 params,
# 37.5 GB), the gemma path's prompts, KIMI_GEN greedy tokens.  Its
# attention at head dim 112: FA_KIMI on the scalar_fp32 kernel.
KIMI_ARCH, KIMI_LAYERS, KIMI_GEN = "kimi_k2_1t_a32b", 2, 8
FA_KIMI = (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 112)
# The MoE layer against moe_ref with nothing dropped (capacity factor E /
# k): fp32 at MOE_FP32_RTOL of the largest |ref| (both fp32, sums in other
# orders); bf16 at one output ulp plus MOE_ROW_ULPS x 2^-8 of the row's
# largest |ref| (bf16_reading): the port rounds each gated expert output
# to bf16 (2^-9) before its fp32 sum, moe_ref sums the products in fp32,
# and each of the k = 8 expert outputs may sit an ulp apart where GEMMs of
# other shapes round h and the output the other way.  moe_ref at kimi's
# width holds (T, E, F) and (T, E, D) tensors: MOE_KIMI_TOKENS tokens.
MOE_FP32_RTOL, MOE_ROW_ULPS, MOE_KIMI_TOKENS = 1e-4, 8.0, 256
# The dispatch tables, card against CPU, at a small width with drops
# (capacity factor 1.0): inputs whose gaps between each token's k + 1
# largest router probabilities exceed MOE_MARGIN, so no route can flip on
# the two devices' fp32 rounding (the check is of the dispatch logic, not of
# rounding): the ids, slots, token_of_slot and filled tables equal, the
# gates within MOE_GATE_RTOL (a few fp32 ulps: the two devices' exp).
MOE_SMALL = dict(d=64, f=32, e=8, top_k=2, groups=2, shape=(4, 64), factor=1.0)
MOE_MARGIN, MOE_GATE_RTOL = 1e-4, 1e-6
# The first training step's loss, K2 against its plain-attention twin: the
# mean of 8192 per-token cross-entropies (about ln 49155 = 10.8 each at
# random weights); rounding moves it by far less than 2^-8 relative, and a
# route that flips on a one-ulp difference moves only its own token's term
# (if 1 % of the tokens moved by a whole nat the mean would move by 1e-3
# relative), so the gate is 2^-8 (BF16_UNIT_ROUNDOFF).  The gradients are
# printed per leaf, not gated: a flipped route moves its expert's gradient
# by O(1).
MOE_LOSS_RTOL = BF16_UNIT_ROUNDOFF


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


def plain_dict_dual_step(W, nu, *, gamma, delta, nonneg=False):
    """K1's plain version behind ops.dict_dual_step's signature: patched in
    for `ops.dict_dual_step` to run a coder's plain twin."""
    from repro_torch.kernels.dict_dual_step import ref

    nu3 = nu.expand(W.shape[0], *nu.shape) if nu.dim() == 2 else nu
    return ref.dict_dual_step_ref(W, nu3, gamma=gamma, delta=delta, nonneg=nonneg)


def plain_twin():
    """Context in which every coder runs K1's plain version."""
    from repro_torch.core import distributed

    return mock.patch.object(distributed.ops, "dict_dual_step", plain_dict_dual_step)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (0 when both are 0)."""
    return max_err(got, ref) / max(float(ref.abs().max()), 1e-30) if max_err(got, ref) else 0.0


def is_q8(coder) -> bool:
    """Whether any level of the coder's gossip ships int8 messages."""
    return any(lv["wire"] == "q8" for lv in coder.combiner_info()["levels"])


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
    scalar = {fn.split("flash_attention_kernelI")[1].split("EEv")[0]: r
              for fn, r in ptxas.items() if "flash_attention_kernelI" in fn}
    print(f"[build] flash_attention scalar_fp32 kernels by (D, type) (ptxas): {scalar}")
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


def autograd_grads(torch, attn, q, k, v, dout, causal=True):
    """(dq, dk, dv) of attn(q, k, v) by autograd; zeros for an input the
    output does not depend on in the graph (a wrapper outside autograd)."""
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = attn(qq, kk, vv, causal=causal)
    if not out.requires_grad:
        return tuple(torch.zeros_like(x) for x in (q, k, v))
    return torch.autograd.grad(out, (qq, kk, vv), dout)


def grad_readings(got, want) -> dict:
    """{dq, dk, dv: max |got - want| / max |want|}."""
    return {name: rel_err(g, w) for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def phase_flash_attention_grad(torch):
    """K2's gradient (ops.FlashAttention: K2 forward, attention_backward)
    against autograd through attention_ref, with planted faults; returns the
    backward's readings and times for K2's record."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import backward, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(2)

    def inputs(b, hq, hkv, s, t, d, dtype):
        return tuple(torch.randn(*shape, generator=gen).to(dev, dtype)
                     for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, hq, s, d)))

    shapes = [((2, 4, 2, 100, 100, 64), True), ((1, 4, 1, 77, 130, 32), True),
              ((2, 2, 2, 90, 60, 64), False), ((1, 8, 2, 300, 300, 128), True)]
    small = {}
    for shape, causal in shapes:
        q, k, v, do = inputs(*shape, torch.float32)
        r = grad_readings(autograd_grads(torch, ops.flash_attention, q, k, v, do, causal),
                          autograd_grads(torch, ref.attention_ref, q, k, v, do, causal))
        small[str((shape, causal))] = r
        if not max(r.values()) <= GRAD_FP32_TOL:
            raise AssertionError(f"K2 gradient fp32 {shape} causal={causal}: {r}")
    print(f"[kernels] flash_attention gradient (Function) agrees with autograd through "
          f"plain at {len(shapes)} fp32 shapes (<= {GRAD_FP32_TOL}): {small}")

    b, hq, hkv, s, t, d = FA_TRAIN
    scale = d ** -0.5
    q, k, v, do = inputs(b, hq, hkv, s, t, d, torch.bfloat16)
    got = autograd_grads(torch, ops.flash_attention, q, k, v, do)
    want = autograd_grads(torch, ref.attention_ref, q, k, v, do)
    readings = grad_readings(got, want)
    err = max(max_err(g, w) for g, w in zip(got, want))
    del got

    def no_function(qq, kk, vv, *, causal=True):
        return ops._forward(qq, kk, vv, causal, scale)  # today's fault: outside autograd

    def no_mask(qq, kk, vv, oo, dd, *, causal, scale):
        return backward.attention_backward(qq, kk, vv, oo, dd, causal=False, scale=scale)

    def no_delta(qq, kk, vv, oo, dd, *, causal, scale):  # D = rowsum(dO * 0) = 0
        return backward.attention_backward(qq, kk, vv, torch.zeros_like(oo), dd,
                                           causal=causal, scale=scale)

    planted = {"wrapper without the Function":
               grad_readings(autograd_grads(torch, no_function, q, k, v, do), want)}
    for name, bwd in (("backward without the causal mask", no_mask),
                      ("backward without the D term", no_delta)):
        with mock.patch.object(ops, "attention_backward", bwd):
            planted[name] = grad_readings(autograd_grads(torch, ops.flash_attention, q, k, v, do),
                                          want)
    del want
    print(f"[kernels] flash_attention gradient bf16 at {FA_TRAIN}: {readings} (gate "
          f"{GRAD_BF16_TOL}), max|err| {err:.3e}; planted {planted}")
    if not max(readings.values()) <= GRAD_BF16_TOL:
        raise AssertionError(f"K2 gradient disagrees with plain at {FA_TRAIN}: {readings}")
    for name, r in planted.items():
        if max(r.values()) <= GRAD_BF16_TOL:
            raise AssertionError(f"the K2 gradient check passes a planted fault: {name}")

    out = ops.flash_attention(q, k, v, causal=True)
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))

    def bwd_only():
        return backward.attention_backward(q, k, v, out, do, causal=True, scale=scale)

    def fwd_bwd(attn):
        def fn():
            o = attn(qr, kr, vr)
            return torch.autograd.grad(o, (qr, kr, vr), do)
        return fn

    kernel = fwd_bwd(lambda a, b_, c: ops.flash_attention(a, b_, c, causal=True))
    plain = fwd_bwd(lambda a, b_, c: ref.attention_ref(a, b_, c, causal=True))
    library = fwd_bwd(lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, is_causal=True))
    reps = 5
    b1 = time_ms(torch, bwd_only, reps)
    k1, p1, l1, l2, p2, k2 = (time_ms(torch, fn, reps) for fn in
                              (kernel, plain, library, library, plain, kernel))
    b2 = time_ms(torch, bwd_only, reps)
    flops = backward.backward_flops(b, hq, s, t, d, True)
    nbytes = 2 * (4 * b * hq * s * d + 4 * b * hkv * t * d)  # q, o, dO, dq; k, v, dk, dv
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    rec = {
        "shape": list(FA_TRAIN), "max_abs_err": err, "grad_readings": readings,
        "grad_readings_fp32": small, "planted_faults": planted,
        "ms": (b1 + b2) / 2, "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "flops": flops, "chunk_rows": backward.chunk_rows(b, hq, s, t),
        "fwd_bwd_ms": (k1 + k2) / 2, "plain_fwd_bwd_ms": (p1 + p2) / 2,
        "library_fwd_bwd_ms": (l1 + l2) / 2,  # F.scaled_dot_product_attention, causal
    }
    print(f"[kernels] flash_attention backward (attention_backward, fp32, "
          f"{rec['chunk_rows']} query rows a chunk) at {FA_TRAIN} bf16 causal: bwd_ms "
          f"{b1:.3f} {b2:.3f}  bound_ms {rec['bound_ms']:.3f} ({rec['bound_by']}: "
          f"{flops:.3e} fp32 flops, {nbytes:.3e} bytes); forward + backward: K2 + Function "
          f"{k1:.3f} {k2:.3f}  plain {p1:.3f} {p2:.3f}  sdpa {l1:.3f} {l2:.3f} ms")
    del q, k, v, do, out, qr, kr, vr
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


def stale_diffusion(torch, res, reg, Wb, x, A, mu, iters):
    """One-step-stale diffusion, the plain reference of the async modes:
    nu_k <- project(a_kk psi_k + sum_{l != k} a_lk psi_l of the previous
    iteration), no neighbor at the first."""
    from repro_torch.core.inference import agent_grad

    n = Wb.shape[0]
    A = torch.as_tensor(A, dtype=torch.float32, device=Wb.device)
    diag = torch.diagonal(A).reshape(n, 1, 1)
    off_t = (A - torch.diag(torch.diagonal(A))).T
    nu = torch.zeros((n,) + tuple(x.shape), device=Wb.device)
    prev = torch.zeros_like(nu)
    theta = torch.ones(n, 1, 1, device=Wb.device)
    for _ in range(iters):
        psi = nu - mu * agent_grad(res, reg, Wb, nu, x, theta, n, float(n))
        nu = res.project_dual(diag * psi + torch.tensordot(off_t, prev, dims=1))
        prev = psi
    return nu, reg.ystar(nu @ Wb)


def phase_small_coder(torch):
    """The coder (kernel path) against the plain reference engines and its
    plain twin on small inputs, every gossip mode; planted faults of the
    time-varying, push, async and chain logic must be rejected."""
    import dataclasses

    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.core.inference import (
        DiffusionConfig, diffusion_infer, exact_infer, push_sum_infer,
    )
    from repro_torch.core.topology import make_topology, ring_weights

    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    rng = np.random.default_rng(0)
    W = rng.standard_normal((16, 32)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    W16 = rng.standard_normal((16, 64)).astype(np.float32)  # 16 agents of 4 atoms
    W16 /= np.linalg.norm(W16, axis=0)
    iters, dcfg = 300, DiffusionConfig(iters=300)
    graph = DistributedSparseCoder(4, res, reg, DistConfig(mode="graph", iters=iters))
    Wb, xt = graph.shard(W, x)
    dev = Wb.device
    mu = graph.adaptive_mu(Wb)[0]
    A = torch.as_tensor(graph.combiner(), dtype=torch.float32, device=dev)
    nu_ref, y_ref, _ = diffusion_infer(res, reg, Wb, xt, A, torch.ones(4, device=dev),
                                       dcfg, mu=mu)
    nu, y = graph.solve_per_agent(Wb, xt)
    errs = [max_err(nu, nu_ref), max_err(y, y_ref)]
    exact = DistributedSparseCoder(4, res, reg, DistConfig(mode="exact", iters=iters))
    nu_ex = exact_infer(res, reg, torch.as_tensor(W, device=dev), xt,
                        mu=exact.adaptive_mu(Wb)[0], iters=iters)
    errs.append(max_err(exact.solve(Wb, xt)[0], nu_ex))
    print(f"[kernels] coder vs reference engine (graph nu, y; exact nu): "
          f"max|err| {[f'{e:.2e}' for e in errs]} (tol 1e-4)")
    if max(errs) > 1e-4:
        raise AssertionError("the coder disagrees with the reference engine")

    def coder(agents, **cfg):
        return DistributedSparseCoder(agents, res, reg, DistConfig(iters=iters, **cfg))

    def blocks(c):
        return c.shard(W if c.n_agents == 4 else W16, x)[0]

    ones = {4: torch.ones(4, device=dev), 16: torch.ones(16, device=dev)}
    readings, faults = {}, {}

    def held(name, c, ref, t0=0, tol=1e-4, into=readings):
        """The kernel path's (nu, y) against ref: max |err| over both."""
        nu_k, y_k = c.solve_per_agent(blocks(c), xt, t0)
        into[name] = (max(max_err(nu_k, ref[0]), max_err(y_k, ref[1])), tol)

    # graph_tv against diffusion_infer under the schedule's A_t, also with
    # link failures from t0 = 3; the fault: stuck on A_0.
    tv = coder(4, mode="graph_tv")
    tv_ref = diffusion_infer(res, reg, Wb, xt, tv.topology_schedule.as_callable(dev),
                             ones[4], dcfg, mu=mu)
    held("graph_tv vs diffusion_infer(A_t)", tv, tv_ref)
    tvf = coder(4, mode="graph_tv", topology_schedule="fixed:erdos", failure_p=0.25,
                failure_steps=6)
    a_t = tvf.topology_schedule.as_callable(dev)
    held("graph_tv fixed:erdos fail 0.25 t0 3 vs diffusion_infer(A_t+3)", tvf,
         diffusion_infer(res, reg, Wb, xt, lambda t: a_t(t + 3), ones[4], dcfg, mu=mu), t0=3)
    stuck = coder(4, mode="graph_tv")
    stuck._gscheds, stuck._gweights = stuck._gscheds[:1], stuck._gweights[:1]
    held("graph_tv stuck on A_0", stuck, tv_ref, into=faults)

    # push on the directed star against push_sum_infer; the fault: no
    # division by the weight.
    push = coder(4, mode="push", topology="distar")
    push_ref = push_sum_infer(res, reg, Wb, xt, torch.as_tensor(
        make_topology("distar", 4), dtype=torch.float32, device=dev), ones[4], dcfg, mu=mu)
    held("push distar vs push_sum_infer", push, push_ref)
    real_push = distributed.comm.push_graph_combine
    with mock.patch.object(distributed.comm, "push_graph_combine",
                           lambda *a: (real_push(*a)[0], torch.ones_like(a[1]))):
        held("push without the division by the weight", push, push_ref, into=faults)

    # hier and an fp32 chain with a stride-2 level against diffusion_infer
    # under the chain's A_t; the fault: the stride-2 level firing every
    # iteration.
    hier = coder((2, 2), mode="hier", pod_topology="ring_metropolis", pod_gossip_every=2)
    held("hier vs diffusion_infer(chain A_t)", hier, diffusion_infer(
        res, reg, Wb, xt, hier.chain.as_callable(dev), ones[4], dcfg, mu=mu))
    chain = coder((4, 2, 2), mode="chain", levels="ring_metropolis,ring_metropolis:2,ring")
    W16b = blocks(chain)
    chain_ref = diffusion_infer(res, reg, W16b, xt, chain.chain.as_callable(dev), ones[16],
                                dcfg, mu=chain.adaptive_mu(W16b)[0])
    held("chain (stride 2 on level 1) vs diffusion_infer(chain A_t)", chain, chain_ref)
    every = coder((4, 2, 2), mode="chain", levels="ring_metropolis,ring_metropolis:2,ring")
    every._csched = dataclasses.replace(every._csched, levels=tuple(
        dataclasses.replace(lvl, gossip_every=1) for lvl in every._csched.levels))
    held("the stride-2 chain level firing every iteration", every, chain_ref, into=faults)

    # the async modes against one-step-stale diffusion and their plain twin;
    # the fault: graph_async combining fresh messages (graph's arithmetic).
    for mode, A_k in (("ring_async", ring_weights(4)),
                      ("graph_async", make_topology("ring_metropolis", 4))):
        c = coder(4, mode=mode)
        held(f"{mode} vs stale diffusion", c,
             stale_diffusion(torch, res, reg, Wb, xt, A_k, mu, iters))
        with plain_twin():
            twin = c.solve_per_agent(Wb, xt)
        held(f"{mode} vs its plain twin", c, twin)
    held("graph_async with a fresh combine", graph, stale_diffusion(
        torch, res, reg, Wb, xt, make_topology("ring_metropolis", 4), mu, iters), into=faults)

    # every q8 mode against its plain twin, on nu at Q8_RTOL of max |nu|.
    for agents, cfg in ((4, dict(mode="ring_q8")), (4, dict(mode="graph_q8")),
                        (4, dict(mode="graph_tv_q8", failure_p=0.25)),
                        (4, dict(mode="push_q8", topology="distar")),
                        ((2, 2), dict(mode="hier_q8", pod_topology="ring_metropolis")),
                        ((4, 2, 2), dict(mode="chain",
                                         levels="torus,ring_metropolis:2:q8,ring:4:q8:stale"))):
        c = coder(agents, **cfg)
        nu_k, _ = c.solve_per_agent(blocks(c), xt, 1)
        with plain_twin():
            nu_p, _ = c.solve_per_agent(blocks(c), xt, 1)
        readings[f"{cfg['mode']} {agents} vs its plain twin (nu / max|nu|)"] = (
            rel_err(nu_k, nu_p), Q8_RTOL)
    torch.cuda.synchronize()
    for name, (r, tol) in readings.items():
        print(f"[small coder] {name}: {r:.3e} (tol {tol})")
    for name, (r, tol) in faults.items():
        print(f"[small coder] planted fault, {name}: {r:.3e} (must exceed {tol})")
    bad = [n for n, (r, tol) in readings.items() if not r <= tol]
    if bad:
        raise AssertionError(f"the gossip modes disagree with their references: {bad}")
    passed = [n for n, (r, tol) in faults.items() if r <= tol]
    if passed:
        raise AssertionError(f"the small-coder gates pass planted faults: {passed}")


def phase_gossip_modes(torch, card: str):
    """Every gossip mode once at the production dictionary (GOSSIP_CASES):
    iters + 1 K1 launches per solve, nu and y finite, the solve timed, and a
    re-solve with K1's plain version within SOLVE_RTOL (Q8_RTOL on the int8
    wire) on nu (and y, fp32 modes).  Returns {"gossip <label>": launches}."""
    import numpy as np

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.dictionary import blocks_from_full, init_dictionary
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.data.synthetic import sparse_stream
    from repro_torch.kernels.dict_dual_step import ops

    res, reg = make_task("sparse_svd", gamma=GAMMA, delta=DELTA)
    gen = torch.Generator(device="cuda").manual_seed(0)
    W = blocks_from_full(init_dictionary(gen, M, ATOMS_PER_AGENT * N_AGENTS, device="cuda"),
                         N_AGENTS)
    x = torch.as_tensor(sparse_stream(MICRO_BATCH, m=M, k_true=LEARN_K_TRUE, seed=1),
                        device="cuda")
    launches = {}
    for label, cfg, agents in GOSSIP_CASES:
        coder = DistributedSparseCoder(agents, res, reg, DistConfig(iters=ITERS, **cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        secs = []
        for _ in range(1 + GOSSIP_TIMED):
            t = time.perf_counter()
            nu, y = coder.solve_per_agent(W, x)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            if ops.dict_dual_step.launches != len(secs) * (ITERS + 1):
                raise AssertionError(f"gossip {label}: {ops.dict_dual_step.launches} K1 "
                                     f"launches after {len(secs)} solves, expected "
                                     f"{ITERS + 1} per solve")
        launches[f"gossip {label}"] = ops.dict_dual_step.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not (bool(torch.isfinite(nu).all()) and bool(torch.isfinite(y).all())):
            raise AssertionError(f"gossip {label}: nu or y is not finite")
        with plain_twin():
            nu_p, y_p = coder.solve_per_agent(W, x)
        q8 = is_q8(coder)
        tol = Q8_RTOL if q8 else SOLVE_RTOL
        nu_err, y_err = rel_err(nu, nu_p), rel_err(y, y_p)
        info = coder.combiner_info()
        wire = dict(coder.wire_bytes_per_iter(MICRO_BATCH, M))
        row = {
            "label": label, "mode": cfg["mode"], "card": card, "config": cfg,
            "agents": list(agents) if isinstance(agents, tuple) else [agents],
            "ms_per_solve": 1e3 * sum(secs[1:]) / GOSSIP_TIMED,
            "solve_ms": [1e3 * v for v in secs], "k1_calls": launches[f"gossip {label}"],
            "solves": len(secs), "wire_bytes_per_iter": wire,
            "wire_bytes_per_iter_total": sum(wire.values()),
            "mixing_rate": info["mixing_rate"], "schedule_period": info["schedule_period"],
            "nonzero_code_share": float((y != 0).float().mean()),
            "peak_mem_gb": peak_gb, "plain_resolve_rel_err": {"nu": nu_err, "y": y_err},
            "tol": tol, "M": M, "K": ATOMS_PER_AGENT * N_AGENTS, "B": MICRO_BATCH,
            "iters": ITERS,
        }
        print("GOSSIP " + json.dumps(row))
        if not nu_err <= tol or (not q8 and not y_err <= tol):
            raise AssertionError(f"gossip {label}: kernel path vs plain nu {nu_err:.3e}, "
                                 f"y {y_err:.3e} (tol {tol})")
        del coder, nu, y, nu_p, y_p
    del W
    torch.cuda.empty_cache()
    return launches


def phase_main_path(torch, mode: str, card: str, must_code: bool, stream, extra=()):
    """The port's serve_dict at the slice's size (serve_dict flags `extra`
    after the defaults); returns the kernel's launch count over the run.
    `must_code`: fail if every code is zero.  `stream` stands in for
    serve_dict's `sparse_stream` (the memoized one of main())."""
    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict

    argv = ["--mode", mode, "--topology", "ring_metropolis", "--m", str(M),
            "--atoms-per-agent", str(ATOMS_PER_AGENT), "--mesh", f"1x{N_AGENTS}",
            "--samples", str(SAMPLES), "--micro-batch", str(MICRO_BATCH),
            "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta", str(DELTA),
            "--device", "cuda", "--json", *extra]
    args = serve_dict.parse_args(argv)
    with mock.patch.object(serve_dict, "sparse_stream", stream):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out = serve_dict.run(args)
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
    if launches < (ITERS + 1) * solves or launches % (ITERS + 1):
        raise AssertionError(f"{mode}: {launches} kernel launches, expected "
                             f"{ITERS + 1} per solve x >= {solves} solves")
    # The schedule clock: every execution but the warmup's two claimed ITERS
    # iterations of a time-varying coder's sequence; a static one claims none.
    coder, snap = svc._coder, svc.snapshot()
    executions = launches // (ITERS + 1) - 2
    want_t = ITERS * executions if coder.is_time_varying else 0
    print(f"[main:{mode}] schedule clock {svc._sched_t} after {executions} executions "
          f"(period {coder.schedule_period}, expected {want_t}); active_schedule "
          f"{stats['active_schedule']}")
    if svc._sched_t != want_t or stats["active_schedule"] != want_t % coder.schedule_period:
        raise AssertionError(f"{mode}: the schedule clock reads {svc._sched_t}, "
                             f"expected {want_t}")

    # Re-solve the last micro-batch on the final snapshot, kernel vs plain;
    # on the int8 wire nu at Q8_RTOL (y recorded: the codes may be 0).
    xb = out["X"][-MICRO_BATCH:]
    nu_k, y_k = coder.solve(snap, xb)
    with plain_twin():
        nu_p, y_p = coder.solve(snap, xb)
    nu_err, y_err = rel_err(nu_k, nu_p), rel_err(y_k, y_p)
    q8 = is_q8(coder)
    tol = Q8_RTOL if q8 else SOLVE_RTOL
    print(f"[main:{mode}] re-solve kernel vs plain: max|dnu|/max|nu| {nu_err:.2e}  "
          f"max|dy|/max|y| {y_err:.2e} (tol {tol})")
    if not nu_err <= tol or (not q8 and not y_err <= tol):
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
        "resolve_rel_err": {"nu": nu_err, "y": y_err}, "flags": list(extra),
        "schedule_period": coder.schedule_period, "sched_t": svc._sched_t,
        "topology": stats["topology"], "mixing_rate": stats["mixing_rate"],
    }))
    del out, results, svc, coder, snap
    torch.cuda.empty_cache()
    return launches


def fista_at_mu(torch, res, reg, W_full, x, mu, iters):
    """exact_fista's arithmetic on the full (M, K) dictionary with plain
    matmuls, at the coder's mu: the single-host reference of the elastic
    phase (core/inference.fista_infer takes its own step)."""
    from repro_torch.core.inference import full_dual_grad

    c_f = res.grad_fstar(torch.ones((1,), device=x.device))[0]
    L = 1.0 / mu
    beta = (torch.sqrt(L) - torch.sqrt(c_f)) / (torch.sqrt(L) + torch.sqrt(c_f))
    nu = prev = torch.zeros_like(x)
    for _ in range(iters):
        z = nu + beta * (nu - prev)
        z = res.project_dual(z - mu * full_dual_grad(res, reg, W_full, z, x))
        nu, prev = z, nu
    return nu


def is_subsequence(seq, of) -> bool:
    """Whether seq is `of` with some entries left out, in order."""
    it = iter(of)
    return all(any(a == b for b in it) for a in seq)


def eras(results):
    """The y dims of a stream in order, one entry per era."""
    return [k for k, _ in itertools.groupby(int(y.shape[0]) for _, y in results)]


def clocked(coder_class):
    """Patches of the coder class's solve and fit_batch that record every
    claimed offset (the t0 the service passes) with the coder's period;
    returns (the list, the patch contexts)."""
    claims = []
    patches = []
    for name, pos in (("solve", 0), ("fit_batch", 1)):
        real = getattr(coder_class, name)

        def wrapped(self, W, x, *rest, _real=real, _pos=pos):
            if len(rest) > _pos:
                claims.append((int(rest[_pos]), self.schedule_period))
            return _real(self, W, x, *rest)

        patches.append(mock.patch.object(coder_class, name, wrapped))
    return claims, patches


def clock_reading(claims, iters, sched_t):
    """Claims off the continuous clock (each t0 must be the running clock
    mod the then-current period), plus |final clock - iters x claims|."""
    clock, off = 0, 0
    for t0, period in claims:
        off += int(t0 != clock % period)
        clock += iters
    return off + abs(sched_t - iters * len(claims))


def phase_elastic_small(torch):
    """Grown and drained coders (kernel path) on small inputs with nonzero
    codes against their plain twins and the single-host references; the
    survivor and old blocks bit for bit; the clock across a drain and the
    router's re-route on the card.  Four planted faults must be rejected."""
    import threading

    import numpy as np

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.core.inference import DiffusionConfig, diffusion_infer
    from repro_torch.runtime.service import DictionaryService, ServiceConfig
    from repro_torch.runtime.serving import ReplicaSet, Router, RouterConfig, device_pools

    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    rng = np.random.default_rng(3)
    m, kb, iters = 16, 4, 300

    def w_full(n):
        """Unit columns shrunk to norms in [0.6, 1), as learning leaves
        them, so a renormalisation shows."""
        W = rng.standard_normal((m, kb * n)).astype(np.float32)
        return W / np.linalg.norm(W, axis=0) * rng.uniform(0.6, 1.0, (1, kb * n)).astype(
            np.float32)

    x = torch.as_tensor(rng.standard_normal((4, m)).astype(np.float32), device="cuda")
    dcfg = DiffusionConfig(iters=iters)
    readings, faults = {}, {}

    def coder(agents, **cfg):
        return DistributedSparseCoder(agents, res, reg, DistConfig(iters=iters, **cfg))

    def ref_of(c, W, t0=0):
        """The single-host reference of coder c on blocks W: FISTA at its mu
        for exact_fista, else diffusion_infer under its combiner(s)."""
        mu = c.adaptive_mu(W)[0]
        if c.cfg.mode == "exact_fista":
            nu = fista_at_mu(torch, res, reg, W.permute(1, 0, 2).reshape(m, -1), x, mu, iters)
            return nu.expand(c.n_agents, *nu.shape), reg.ystar(torch.matmul(nu, W))
        seq = torch.as_tensor(np.stack(c.combiner_sequence()), dtype=torch.float32,
                              device="cuda")
        A = (lambda t: seq[(t + t0) % len(seq)]) if len(seq) > 1 else seq[0]
        nu, y, _ = diffusion_infer(res, reg, W, x, A, torch.ones(c.n_agents, device="cuda"),
                                   dcfg, mu=mu)
        return nu, y

    def held(name, c, W, ref=None, t0=0, tol=1e-4, into=readings):
        """Kernel path against ref (default: the plain twin, at Q8_RTOL of
        max |nu| on the int8 wire); codes must be nonzero."""
        nu, y = c.solve_per_agent(W, x, t0)
        if ref is None:
            with plain_twin():
                nu_p, _ = c.solve_per_agent(W, x, t0)
            into[name] = (rel_err(nu, nu_p), Q8_RTOL if is_q8(c) else SOLVE_RTOL)
        else:
            into[name] = (max(max_err(nu, ref[0]), max_err(y, ref[1])), tol)
        if into is readings and not bool((y != 0).any()):
            raise AssertionError(f"elastic {name}: every code is zero")

    def blocks_gate(label, c, W, g, W2, s, W3, drain):
        n_old, n_new = c.level_sizes[0], g.level_sizes[0]
        outer = c.n_agents // n_old
        old = max_err(W2.view(outer, n_new, m, kb)[:, :n_old], W.view(outer, n_old, m, kb))
        fresh = W2.view(outer, n_new, m, kb)[:, n_old:]
        norm = float((torch.linalg.vector_norm(fresh, dim=2) - 1).abs().max())
        keep = [r for r in range(n_new) if r not in drain]
        surv = max_err(W3.view(outer, len(keep), m, kb), W2.view(outer, n_new, m, kb)[:, keep])
        readings[f"{label}: old blocks after the grow (bit for bit)"] = (old, 0.0)
        readings[f"{label}: fresh blocks, max |norm - 1|"] = (norm, 1e-6)
        readings[f"{label}: survivor blocks after the drain (bit for bit)"] = (surv, 0.0)
        return keep

    gen = torch.Generator().manual_seed(4)
    cases = [
        ("exact_fista", 4, dict(mode="exact_fista"), 2, [0, 5], None),
        ("graph erdos", 4, dict(mode="graph", topology="erdos", topology_seed=1), 2, [0, 5],
         None),
        ("graph_tv_q8 fail 0.25", 4, dict(mode="graph_tv_q8", failure_p=0.25, failure_steps=6),
         2, [1, 2], dict(mode="graph_tv", failure_p=0.25, failure_steps=6)),
        ("chain", (2, 2, 2),
         dict(mode="chain", levels="torus,ring_metropolis:2:q8,ring:4:q8:stale"), 1, [1],
         dict(mode="chain", levels="erdos,ring_metropolis:2,ring")),
    ]
    grown_erdos = None
    for label, agents, cfg, extra, drain, fp32 in cases:
        for variant, vcfg in (("", cfg), (" fp32 twin", fp32)):
            if vcfg is None:
                continue
            c = coder(agents, **vcfg)
            W = c.snapshot(w_full(c.n_agents))
            g, W2 = c.grown(W, extra, gen)
            s, W3 = g.shrunk(W2, drain)
            name = label + variant
            if not variant:
                blocks_gate(name, c, W, g, W2, s, W3, drain)
            for stage, cc, WW in (("grown", g, W2), ("drained", s, W3)):
                tag = f"{name} {stage} N {cc.n_agents}"
                if variant or not is_q8(cc):  # fp32: the single-host reference
                    held(f"{tag} vs the single-host reference", cc, WW, ref_of(cc, WW, 3), t0=3)
                held(f"{tag} vs its plain twin", cc, WW, t0=3)
            if label == "graph erdos":
                grown_erdos = (c, g, W2)
                kept = int((g._adj[:4, :4] != c._adj).sum())
                readings[f"{name}: old edges rewired by the grow"] = (float(kept), 0.0)
            if label == "graph_tv_q8 fail 0.25" and not variant:
                drain_svc = (agents, vcfg, W)

    # Planted fault 1: a grow that draws the whole erdos graph afresh.
    c, g, W2 = grown_erdos
    bad = coder(g.n_agents, mode="graph", topology="erdos", topology_seed=1)
    faults["grow resampling the whole erdos adjacency: old edges rewired"] = (
        float((bad._adj[:4, :4] != c._adj).sum()), 0.0)
    held("grow resampling the whole erdos adjacency: solve vs the grown reference", bad, W2,
         ref_of(g, W2), into=faults)
    # Planted fault 2: a drain that renormalises the survivor blocks.
    s, W3 = g.shrunk(W2, [0, 5])
    W3_bad = W3 / torch.linalg.vector_norm(W3, dim=1, keepdim=True)
    faults["drain renormalising the survivors: survivor blocks (bit for bit)"] = (
        max_err(W3_bad, W3), 0.0)

    # The clock across a drain, a service on the card; planted fault 3: a
    # drain that resets it.
    agents, vcfg, W = drain_svc
    X = rng.standard_normal((48, m)).astype(np.float32)

    def drill(reset):
        c = DistributedSparseCoder(agents, res, reg, DistConfig(iters=20, **vcfg))
        claims, patches = clocked(DistributedSparseCoder)
        svc = DictionaryService(c, W, ServiceConfig(micro_batch=8, mu_w=0.1))
        if reset:
            real = svc._maybe_swap

            def resetting(q, build):
                drained = q is svc._drain_q and not q.empty()
                real(q, build)
                if drained:
                    with svc._lock:
                        svc._sched_t = 0

            svc._maybe_swap = resetting
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            with svc:
                [f.result(timeout=120) for f in svc.submit_many(X[:16])]
                svc.grow(2, torch.Generator().manual_seed(5)).result(timeout=120)
                [f.result(timeout=120) for f in svc.submit_many(X[16:32])]
                svc.drain([1, 2]).result(timeout=120)
                [f.result(timeout=120) for f in svc.submit_many(X[32:])]
        if svc.stats()["coded"] != 48 or svc.stats()["fit_failures"]:
            raise AssertionError(f"elastic service drill: {svc.stats()}")
        return float(clock_reading(claims, 20, svc._sched_t)), len(claims)

    r, n_claims = drill(False)
    readings[f"graph_tv_q8 service: clock across grow and drain ({n_claims} executions)"] = (
        r, 0.0)
    faults["drain resetting the schedule clock: the clock reading"] = (drill(True)[0], 0.0)

    # The router's re-route after a kill, two replicas on the card; planted
    # fault 4: a router that does not re-route (no retries).
    def kill_drill(retries):
        cfg = DistConfig(iters=20, mode="graph")
        pools = device_pools(2)
        W0 = w_full(4)
        services = [DictionaryService(DistributedSparseCoder(4, res, reg, cfg), W0,
                                      ServiceConfig(micro_batch=8, learn=False), stream=p.stream)
                    for p in pools]
        fleet = ReplicaSet(services)
        victim = fleet["r1"].service
        victim.start()  # r0 not yet up: the router places everything on r1
        router = Router(fleet, RouterConfig(micro_batch=8, max_wait_s=0.005,
                                            max_retries=retries)).start()
        victim._exec_lock.acquire()  # r1's first batch in flight, the rest queued
        futs = router.submit_many(X[:32])
        for _ in range(1000):
            if victim.load()["queue_depth"] >= 8:
                break
            time.sleep(0.01)
        fleet["r0"].service.start()
        killer = threading.Thread(target=fleet.kill, args=("r1",))
        killer.start()
        for _ in range(1000):
            if victim.load()["queue_depth"] == 0:
                break
            time.sleep(0.01)
        victim._exec_lock.release()
        killer.join(120)
        ok = [f for f in futs if f.exception(timeout=120) is None]
        st = router.stats()
        router.stop()
        fleet.stop()
        return st["failed"], st["rerouted"], len(ok)

    failed, rerouted, ok = kill_drill(2)
    readings[f"kill drill (small): failed {failed}, rerouted {rerouted}, resolved {ok}/32"] = (
        float(failed + (rerouted < 1) + (32 - ok)), 0.0)
    failed_b, rerouted_b, _ = kill_drill(0)
    faults[f"router without re-route: failed {failed_b}, rerouted {rerouted_b}"] = (
        float(failed_b + (rerouted_b < 1)), 0.0)

    torch.cuda.synchronize()
    for name, (r, tol) in readings.items():
        print(f"[elastic small] {name}: {r:.3e} (tol {tol})")
    for name, (r, tol) in faults.items():
        print(f"[elastic small] planted fault, {name}: {r:.3e} (must exceed {tol})")
    bad = [n for n, (r, tol) in readings.items() if not r <= tol]
    if bad:
        raise AssertionError(f"the elastic gates fail: {bad}")
    passed = [n for n, (r, tol) in faults.items() if r <= tol]
    if passed:
        raise AssertionError(f"the elastic gates pass planted faults: {passed}")


def phase_k1_grown_shapes(torch):
    """K1 against its plain version at the agent counts growth gives the
    production dictionary, N 18 (+2) and N 20 (the chain's +1 per group),
    random W and nu (nonzero codes), the main shape's gate."""
    from repro_torch.kernels.dict_dual_step import ops, ref

    out = {}
    for n in (18, 20):
        W = torch.randn(n, M, ATOMS_PER_AGENT, device="cuda")
        W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
        nu = torch.randn(n, MICRO_BATCH, M, device="cuda")
        y, g = ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)
        yr, gr = ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)
        y_tol = 1e-4 * float(torch.matmul(nu, W).abs().max()) / DELTA
        y_err, g_rel = max_err(y, yr), max_err(g, gr) / float(gr.abs().max())
        nonzero = float((yr != 0).float().mean())
        grid = list(ops.ctas(n, M, ATOMS_PER_AGENT, MICRO_BATCH))
        print(f"[k1 grown] N {n} {(n, M, ATOMS_PER_AGENT, MICRO_BATCH)} (CTAs per pass {grid}): "
              f"max|dY| {y_err:.3e} (tol {y_tol:.3e}), max|dG|/max|G| {g_rel:.3e} (tol 1e-4), "
              f"nonzero codes {nonzero:.3e}")
        if not (y_err <= y_tol and g_rel <= 1e-4 and nonzero > 0):
            raise AssertionError(f"dict_dual_step disagrees with plain at N {n}")
        out[n] = {"max_dY": y_err, "max_dG_rel": g_rel, "grid": grid, "nonzero": nonzero}
        del W, nu, y, g, yr, gr
        torch.cuda.empty_cache()
    return out


def phase_drill(torch, mode: str, card: str, stream, extra, grow: int, drain: str,
                resolve_grown: bool):
    """serve_dict at the production dictionary with a grow at sample
    DRILL_GROW_AT and a drain at DRILL_DRAIN_AT: every sample coded and
    finite, the eras in order, the grow and drain events, K1's launches in
    whole solves, the schedule clock at iters per execution across both
    swaps; `resolve_grown`: one batch re-solved on the grown snapshot with
    K1 against plain (nonzero codes required).  Returns K1's launches."""
    import numpy as np

    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict

    argv = ["--mode", mode, "--m", str(M), "--atoms-per-agent", str(ATOMS_PER_AGENT),
            "--mesh", f"1x{N_AGENTS}", "--samples", str(SAMPLES), "--micro-batch",
            str(MICRO_BATCH), "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta",
            str(DELTA), "--device", "cuda", "--json", "--grow-at", str(DRILL_GROW_AT),
            "--grow-model", str(grow), "--drain-at", str(DRILL_DRAIN_AT), "--drain", drain,
            *extra]
    args = serve_dict.parse_args(argv)
    with mock.patch.object(serve_dict, "sparse_stream", stream):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out = serve_dict.run(args)
        launches = ops.dict_dual_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pay, results, svc = out["payload"], out["results"], out["service"]
    stats = svc.stats()
    label = " ".join([mode] + list(extra))
    k0 = ATOMS_PER_AGENT * N_AGENTS
    (g_ev,), (d_ev,) = stats["grow_events"], stats["drain_events"]
    want_eras = [k0, g_ev["k_new"], d_ev["k_new"]]
    seen = eras(results)
    if stats["coded"] != SAMPLES or len(results) != SAMPLES or stats["fit_failures"]:
        raise AssertionError(f"drill {label}: coded {stats['coded']}, fit failures "
                             f"{stats['fit_failures']} {stats['fit_first_error']}")
    if not all(np.isfinite(nu).all() and np.isfinite(y).all() for nu, y in results):
        raise AssertionError(f"drill {label}: a code is not finite")
    if seen[0] != k0 or len(seen) < 2 or not is_subsequence(seen, want_eras):
        raise AssertionError(f"drill {label}: y dims {seen}, eras {want_eras}")
    if launches % (ITERS + 1):
        raise AssertionError(f"drill {label}: {launches} K1 launches, not whole solves")
    # Six warmup executions claim nothing: a solve and a fit at start and
    # after each swap.
    executions = launches // (ITERS + 1) - 6
    coder = svc._coder
    want_t = ITERS * executions if coder.is_time_varying else 0
    if svc._sched_t != want_t or d_ev["sched_t"] > svc._sched_t:
        raise AssertionError(f"drill {label}: the schedule clock reads {svc._sched_t}, "
                             f"expected {want_t} (drain at {d_ev['sched_t']})")
    row = {"mode": mode, "flags": list(extra), "card": card, "M": M, "agents": N_AGENTS,
           "grow": grow, "drain": drain, "grow_at": DRILL_GROW_AT, "drain_at": DRILL_DRAIN_AT,
           "samples": SAMPLES, "samples_per_s": pay["samples_per_s"],
           "latency_ms": pay["latency_ms"], "wall_s": pay["wall_s"], "swap_s": out["swap_s"],
           "y_dims_eras": seen, "model_sizes": [g_ev["model_old"], g_ev["model_new"],
                                                d_ev["model_new"]],
           "k1_calls": launches, "executions": executions, "fit_steps": stats["fit_steps"],
           "peak_mem_gb": peak_gb, "sched_t": svc._sched_t,
           "drain_sched_t": d_ev["sched_t"], "schedule_period": coder.schedule_period}
    if resolve_grown:
        # The final coder grown again as the drill grew it (+grow, fresh atoms
        # from the CLI's seed): its first batch re-solved with K1 and plain.
        g_coder, W2 = coder.grown(svc.snapshot(), grow, torch.Generator().manual_seed(2))
        xb = out["X"][-MICRO_BATCH:]
        nu_k, y_k = g_coder.solve(W2, xb)
        with plain_twin():
            nu_p, y_p = g_coder.solve(W2, xb)
        nu_err, y_err = rel_err(nu_k, nu_p), rel_err(y_k, y_p)
        nonzero = float((y_p != 0).float().mean())
        tol = Q8_RTOL if is_q8(g_coder) else SOLVE_RTOL
        row["grown_resolve"] = {"agents": g_coder.n_agents, "nu": nu_err, "y": y_err,
                                "nonzero": nonzero, "tol": tol}
        print(f"[drill:{label}] re-solve at N {g_coder.n_agents} kernel vs plain: nu {nu_err:.2e} "
              f"y {y_err:.2e} (tol {tol}), nonzero codes {nonzero:.3e}")
        if not (nu_err <= tol and y_err <= tol and nonzero > 0):
            raise AssertionError(f"drill {label}: the grown coder's kernel path disagrees with "
                                 f"plain or codes nothing")
        del g_coder, W2
    lat = pay["latency_ms"]
    print(f"[drill:{label}] {card}: {pay['samples_per_s']:.4f} samples/s  p50 {lat['p50']:.1f} "
          f"ms  p99 {lat['p99']:.1f} ms  swaps (request to resolved) grow "
          f"{out['swap_s']['grow']:.2f} s drain {out['swap_s']['drain']:.2f} s  y dims {seen}  "
          f"K1 calls {launches}  peak device memory {peak_gb:.2f} GB  clock {svc._sched_t}")
    print("DRILL " + json.dumps(row))
    del out, results, svc, coder
    torch.cuda.empty_cache()
    return launches


def phase_fleet(torch, card: str, stream):
    """serve_dict --replicas 2 --publish-at FLEET_PUBLISH_AT (graph) at the
    production dictionary: every sample coded, none failed, one rolling
    publish reaching both replicas; a batch re-solved on r0's final
    snapshot with K1 against plain.  Returns K1's launches."""
    import numpy as np

    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict

    argv = ["--mode", "graph", "--m", str(M), "--atoms-per-agent", str(ATOMS_PER_AGENT),
            "--mesh", f"1x{N_AGENTS}", "--samples", str(SAMPLES), "--micro-batch",
            str(MICRO_BATCH), "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta",
            str(DELTA), "--device", "cuda", "--json", "--replicas", "2", "--publish-at",
            str(FLEET_PUBLISH_AT)]
    with mock.patch.object(serve_dict, "sparse_stream", stream):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out = serve_dict.run(serve_dict.parse_args(argv))
        launches = ops.dict_dual_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pay, results, fleet = out["payload"], out["results"], out["fleet"]
    if len(results) != SAMPLES or pay["failed"] or sum(pay["routed"].values()) != SAMPLES:
        raise AssertionError(f"fleet: {pay}")
    if pay["publishes"] != 1 or pay["publish_versions"] != {"r0": 1, "r1": 1}:
        raise AssertionError(f"fleet: publish {pay['publish_versions']}")
    if not all(np.isfinite(nu).all() and np.isfinite(y).all() for nu, y in results):
        raise AssertionError("fleet: a code is not finite")
    if launches % (ITERS + 1) or launches < (ITERS + 1) * (2 + SAMPLES // MICRO_BATCH):
        raise AssertionError(f"fleet: {launches} K1 launches")
    svc = fleet["r0"].service
    xb = out["X"][-MICRO_BATCH:]
    nu_k, y_k = svc._coder.solve(svc.snapshot(), xb)
    with plain_twin():
        nu_p, y_p = svc._coder.solve(svc.snapshot(), xb)
    nu_err, y_err = rel_err(nu_k, nu_p), rel_err(y_k, y_p)
    if not (nu_err <= SOLVE_RTOL and y_err <= SOLVE_RTOL):
        raise AssertionError(f"fleet: kernel vs plain nu {nu_err}, y {y_err}")
    lat = pay["latency_ms"]
    row = {"mode": "graph", "card": card, "replicas": 2, "publish_at": FLEET_PUBLISH_AT,
           "samples": SAMPLES, "agg_samples_per_s": pay["agg_samples_per_s"],
           "latency_ms": lat, "wall_s": pay["wall_s"], "routed": pay["routed"],
           "rerouted": pay["rerouted"], "failed": pay["failed"],
           "publish_versions": pay["publish_versions"], "per_replica": pay["per_replica"],
           "k1_calls": launches, "peak_mem_gb": peak_gb, "publish_s": out["publish_s"],
           "y_dims": sorted({int(y.shape[0]) for _, y in results}),
           "resolve_rel_err": {"nu": nu_err, "y": y_err}}
    print(f"[fleet] {card}: {pay['agg_samples_per_s']:.4f} samples/s over 2 replicas  p50 "
          f"{lat['p50']:.1f} ms  p99 {lat['p99']:.1f} ms  wall {pay['wall_s']:.1f} s  routed "
          f"{pay['routed']}  publish {pay['publish_versions']} (waited "
          f"{out['publish_s']['draw_wait']:.1f} s for the host's draw, installed in "
          f"{out['publish_s']['install']:.1f} s)  K1 calls {launches}  peak device memory "
          f"{peak_gb:.2f} GB")
    print("FLEET " + json.dumps(row))
    del out, results, fleet, svc
    torch.cuda.empty_cache()
    return launches


def phase_kill_drill(torch, card: str, stream):
    """Two graph replicas at the production dictionary behind the Router,
    r1 killed at sample KILL_AT while it has work in flight: every request
    resolved (failed 0), at least one re-routed.  Returns K1's launches."""
    import numpy as np

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.dictionary import blocks_from_full, init_dictionary
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.runtime.service import DictionaryService, ServiceConfig
    from repro_torch.runtime.serving import (
        ReplicaSet, Router, RouterConfig, device_pools, replica_bytes,
    )

    if int(np.random.default_rng(KILL_SEED).integers(2)) != 1:
        raise AssertionError("KILL_SEED's first tie-break does not pick r1")
    res, reg = make_task("sparse_svd", gamma=GAMMA, delta=DELTA)
    k = ATOMS_PER_AGENT * N_AGENTS
    X = stream(SAMPLES, m=M, k_true=k, nonneg=False, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    pools = device_pools(2, replica_bytes(N_AGENTS, M, ATOMS_PER_AGENT, learn=False))
    gen = torch.Generator(device="cuda").manual_seed(0)
    W0 = blocks_from_full(init_dictionary(gen, M, k, device="cuda"), N_AGENTS)
    cfg = DistConfig(mode="graph", iters=ITERS)
    services = [DictionaryService(DistributedSparseCoder(N_AGENTS, res, reg, cfg), W0,
                                  ServiceConfig(micro_batch=MICRO_BATCH, learn=False),
                                  stream=p.stream) for p in pools]
    del W0
    in_flight = queued = None
    t0 = time.perf_counter()
    with ReplicaSet(services) as fleet:
        # The router admits two service micro-batches at a time, so the
        # replica it picks has one batch solving and one queued.
        router_cfg = RouterConfig(micro_batch=2 * MICRO_BATCH, seed=KILL_SEED)
        with Router(fleet, router_cfg) as router:
            futs = []
            for i in range(SAMPLES):
                if i == KILL_AT:
                    victim = fleet["r1"].service
                    for _ in range(3000):  # r1 must hold queued work
                        queued = victim.load()["queue_depth"]
                        in_flight = router.stats()["routed"]["r1"] - victim.load()["coded"]
                        if queued > 0:
                            break
                        time.sleep(0.01)
                    fleet.kill("r1")
                futs.append(router.submit(X[i]))
            results = [f.result(timeout=3600) for f in futs]
            st = router.stats()
    wall = time.perf_counter() - t0
    launches = ops.dict_dual_step.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok = len(results) == SAMPLES and all(np.isfinite(nu).all() for nu, _ in results)
    row = {"card": card, "replicas": 2, "kill_at": KILL_AT, "in_flight_at_kill": in_flight,
           "queued_at_kill": queued,
           "failed": st["failed"], "rerouted": st["rerouted"], "routed": st["routed"],
           "latency_ms": st["latency_ms"], "wall_s": wall, "samples_per_s": SAMPLES / wall,
           "k1_calls": launches, "peak_mem_gb": peak_gb}
    print(f"[kill drill] {card}: r1 killed at sample {KILL_AT} with {in_flight} request(s) "
          f"placed and not coded ({queued} queued): failed {st['failed']}, rerouted "
          f"{st['rerouted']}, routed {st['routed']}  {SAMPLES / wall:.4f} samples/s  p50 "
          f"{st['latency_ms']['p50']:.1f} ms  p99 {st['latency_ms']['p99']:.1f} ms  K1 calls "
          f"{launches}  peak device memory {peak_gb:.2f} GB")
    print("KILL " + json.dumps(row))
    if not (ok and st["failed"] == 0 and st["rerouted"] >= 1 and in_flight and in_flight > 0):
        raise AssertionError(f"kill drill: {row}")
    del services, fleet, router
    torch.cuda.empty_cache()
    return launches


def profile_rows(torch, fn):
    """One call of fn under torch.profiler: (host wall ms, [(kernel, device
    ms)] largest first).  The CPU operators' rows repeat their kernels'
    device time, so only the rows of device activity are kept."""
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
    return wall_ms, rows


def device_profile(torch, fn, top: int = 6):
    """profile_rows as (host wall ms, device kernel ms summed, [(kernel, ms)]
    of the `top` largest)."""
    wall_ms, rows = profile_rows(torch, fn)
    return wall_ms, sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:top]]


# Kernel names of a train step by what launched them, first match wins:
# K2; fp32 GEMMs (SIMT sgemm: attention_backward's einsums and the fp32
# unembedding); bf16 GEMMs (cuBLAS's nvjet / xmma: the projections and the
# MLP); softmax; everything else (norms, rotary, SwiGLU, casts, the
# optimizer's elementwise passes, reductions, copies).
STEP_CATEGORIES = (("K2 forward", ("flash_attention",)),
                   ("fp32 GEMMs", ("sgemm", "f32f32")),
                   ("bf16 GEMMs", ("nvjet", "bf16", "xmma", "gemm")),
                   ("softmax", ("softmax",)))


def step_categories(rows) -> dict:
    """Device ms of profile rows summed by STEP_CATEGORIES (else "other")."""
    out = {name: 0.0 for name, _ in STEP_CATEGORIES}
    out["other"] = 0.0
    for key, ms in rows:
        name = next((n for n, subs in STEP_CATEGORIES if any(x in key for x in subs)), "other")
        out[name] += ms
    return {k: round(v, 3) for k, v in out.items()}


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

    argv = ["--arch", XL_ARCH, "--full-config", "--n-layers", str(XL_LAYERS),
            "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN),
            "--device", "cuda"]
    # Warm-up at a short prompt (cuBLAS handles, the allocator's pools), not counted.
    serve.run(serve.parse_args(argv[:7] + ["--prompt-len", "64", "--gen", "2",
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
    # gate cannot be used here: with random weights the deep block stack
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


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """6 N tokens (every active parameter's multiply-add forward, twice
    backward; N counts the tied embedding once and, for MoE, the router and
    the top-k experts a token runs, not the capacity's padding) + 6 L B S^2
    H Dh (causal attention's q k^T and p v over half the S x S pairs, 2 B
    S^2 H Dh a layer forward, twice that backward); the remat recompute is
    not model work."""
    n = cfg.param_counts()["active"]
    width = cfg.n_heads * cfg.resolved_head_dim
    return 6.0 * n * batch * seq + 6.0 * cfg.n_layers * batch * seq * seq * width


def phase_olmo_train(torch, card: str):
    """The port's training at olmo-1b's full width through launch/train
    (TrainRunner: checkpoint, injected fault, replay, rescale reload), the
    first step against its plain-attention twin, one step profiled; returns
    the run's record (K2 launches and per step)."""
    import shutil

    from repro_torch.checkpoint import manager
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import attention, model
    from repro_torch.optim import for_arch
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    cfg = cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS)
    n_params = cfg.param_counts()["total"]
    state_gb = 3 * 4 * n_params / 1e9  # fp32 params, m, v
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    # keep 3 at steps 6 and 12: the committed step 6 beside step 12 being written
    need_gb = 2 * state_gb + 2.0
    print(f"[train] {cfg.name}: {n_params:.4e} params, train state {state_gb:.2f} GB; "
          f"free disk under build/ {free_gb:.1f} GB (need {need_gb:.1f})")
    if free_gb < need_gb:
        raise AssertionError(f"train: {free_gb:.1f} GB free under build/, need {need_gb:.1f}")

    # (1) The first step's loss and gradient, K2 against a plain-attention
    # twin (K2 and its Function swapped for autograd through attention_ref).
    batch = train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(0)
    params = model.init(cfg, 0, "cuda")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)

    def loss_and_grads():
        loss, _ = model.loss_fn(cfg, params, batch)
        return loss.item(), torch.autograd.grad(loss, flat)

    reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    first_launches = ops.flash_attention.launches
    with mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        loss_p, grads_p = loss_and_grads()
    grad_rel = [rel_err(g, w) for g, w in zip(grads_k, grads_p)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    del grads_k, grads_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    tol = cfg.n_layers * BF16_UNIT_ROUNDOFF
    print(f"[train] first step, K2 vs plain-attention twin: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.2e}, gate {BF16_UNIT_ROUNDOFF:.2e}); per-leaf max|dg|/max|g| "
          f"max {max(grad_rel):.3e} (gate {tol:.4f} = {cfg.n_layers} layers x 2^-8): "
          f"{[round(r, 5) for r in grad_rel]}; K2 launches {first_launches}")
    if first_launches != 2 * cfg.n_layers:
        raise AssertionError(f"train: {first_launches} K2 launches in one loss and gradient, "
                             f"expected {2 * cfg.n_layers} (forward + remat recompute)")
    if not (finite and loss_rel <= BF16_UNIT_ROUNDOFF and max(grad_rel) <= tol):
        raise AssertionError("train: the first step's loss or gradient disagrees with the "
                             "plain-attention twin")

    # (2) One step under the profiler (after a warm one), on this state.
    opt = for_arch(cfg, lr=cosine_warmup(3e-4, warmup=20, total=TRAIN_STEPS))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step_fn = steps.make_train_step(cfg, opt)
    step_fn(state, batch)
    wall_ms, rows = profile_rows(torch, lambda: step_fn(state, batch))
    dev_ms, top = sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:10]]
    categories = step_categories(rows)
    print(f"[train] profile of one step: device kernels {dev_ms:.1f} ms, {wall_ms:.1f} ms under "
          f"the profiler; by category {categories}; top {top}")
    del state, params, flat, step_fn
    torch.cuda.empty_cache()

    # (3) The CLI: TRAIN_STEPS steps, a checkpoint every TRAIN_CKPT_EVERY, a
    # fault at TRAIN_FAULT_AT, the rescale reload; checkpoint I/O timed.
    io = {"save_s": [], "restore_s": [], "host_copy_s": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                io[key].append(time.perf_counter() - t)
        return wrapper

    argv = ["--arch", TRAIN_ARCH, "--full-config", "--n-layers", str(TRAIN_LAYERS),
            "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--inject-fault-at", str(TRAIN_FAULT_AT),
            "--rescale-mesh", "1x1", "--ckpt-dir", str(ckpt_dir), "--device", "cuda"]
    with mock.patch.object(manager, "save_pytree", timed(manager.save_pytree, "save_s")), \
            mock.patch.object(manager, "load_pytree", timed(manager.load_pytree, "restore_s")), \
            mock.patch.object(manager.CheckpointManager, "save",
                              timed(manager.CheckpointManager.save, "host_copy_s")):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train.run(train.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner, losses = out["runner"], out["losses"]
    executed = len(out["history"])
    replayed = TRAIN_FAULT_AT - TRAIN_CKPT_EVERY
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    if out["faults"] != 1 or executed != TRAIN_STEPS + replayed:
        raise AssertionError(f"train: {out['faults']} faults, {executed} steps run")
    if launches != 2 * cfg.n_layers * executed:
        raise AssertionError(f"train: {launches} K2 launches over {executed} steps, expected "
                             f"{2 * cfg.n_layers} a step")
    if out["ckpt_steps"] != [TRAIN_CKPT_EVERY, TRAIN_STEPS] or out["rescaled_step"] != TRAIN_STEPS:
        raise AssertionError(f"train: checkpoints {out['ckpt_steps']}, rescale resumed at "
                             f"{out['rescaled_step']}")
    if not all(math.isfinite(x) for _, x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    first = dict(losses[:TRAIN_FAULT_AT])
    replay = losses[TRAIN_FAULT_AT:TRAIN_FAULT_AT + replayed]
    replay_rel = [abs(x - first[st]) / abs(first[st]) for st, x in replay]
    print(f"[train] replay from step {TRAIN_CKPT_EVERY}: first pass "
          f"{[first[st] for st, _ in replay]}, replayed {[x for _, x in replay]} (the first "
          f"exactly, the rest within {REPLAY_RTOL} relative: {replay_rel})")
    if replay[0][1] != first[replay[0][0]]:
        raise AssertionError("train: the first replayed loss differs from the first pass's")
    if not max(replay_rel) <= REPLAY_RTOL:
        raise AssertionError(f"train: a replayed loss parts from the first pass: {replay_rel}")

    times = runner.step_times
    step_s = statistics.median(times[1:])
    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    rec = {
        "card": card, "arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps_run": executed, "step_ms": step_s * 1e3,
        "first_step_ms": times[0] * 1e3, "step_ms_all": [x * 1e3 for x in times],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "model_flops_per_step": flops, "mfu_bf16": flops / step_s / BF16_FLOPS_PER_S,
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_step": launches / executed, "losses": losses,
        "replay_rel": replay_rel, "first_step": {"loss": loss_k, "plain_loss": loss_p,
                                                 "loss_rel": loss_rel, "grad_rel": grad_rel},
        "profile": {"profiled_wall_ms": wall_ms, "device_ms": dev_ms,
                    "busy_share": dev_ms / (step_s * 1e3), "categories": categories,
                    "top": top},
        "checkpoint_io_s": io, "state_gb": state_gb, "wall_s": wall,
        "events": [{k: v for k, v in e.items() if k != "error"} for e in runner.events],
    }
    print(f"[train] {card}: {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step "
          f"{rec['step_ms']:.1f} ms (median of {len(times) - 1} after the first, "
          f"{rec['first_step_ms']:.1f}), {rec['tokens_per_s']:.1f} tokens/s, model-flops share "
          f"of the bf16 peak {rec['mfu_bf16']:.4f} ({flops:.4e} flops a step / "
          f"{BF16_FLOPS_PER_S:.3e}), peak device memory {peak_gb:.2f} GB, K2 launches "
          f"{launches} ({rec['launches_per_step']:.0f} a step); checkpoint save "
          f"{io['save_s']} s, host copy {io['host_copy_s']} s, restore {io['restore_s']} s; "
          f"busy share {rec['profile']['busy_share']:.3f}; wall {wall:.1f} s")
    print("TRAIN " + json.dumps(rec))
    del out, runner
    gc.collect()  # free whatever a reference cycle still holds of the train states
    torch.cuda.empty_cache()
    return rec


def phase_train_card_vs_cpu(torch):
    """Three steps of the olmo smoke config (fp32) on the card and on the
    CPU from one state: SGD params within 1e-4 of each leaf's largest
    |value|, losses within 1e-5 relative; AdamW losses within 1e-5 relative
    and the updates on the scale of lr (ADAMW_SHARE, ADAMW_FLIP:
    tests/test_torch_train.py's gates)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches
    from repro_torch.optim import adamw, sgd
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.runtime import steps

    cfg = get_smoke_config(TRAIN_ARCH)
    batches = make_batches(cfg, 4, 64, 0)
    out = {}
    for name, make, lr in (("sgd", lambda: sgd(0.5), 0.5), ("adamw", lambda: adamw(1e-3), 1e-3)):
        start = steps.init_train_state(cfg, make(), 0, "cpu")
        p0 = [t.clone() for t in leaves(start["params"])]
        runs = {}
        for dev in ("cuda", "cpu"):
            state = tree_map(lambda t: t.clone().to(dev), start)
            step, losses = steps.make_train_step(cfg, make()), []
            for i in range(3):
                state, m = step(state, batches(i))
                losses.append(m["loss"].item())
            runs[dev] = ([t.detach().cpu() for t in leaves(state["params"])], losses)
        (pc, lc), (pp, lp) = runs["cuda"], runs["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        if name == "sgd":
            reading = max(rel_err(a, b) for a, b in zip(pc, pp))
            ok = reading <= 1e-4 and loss_rel <= 1e-5
        else:
            d = [((a - s) - (b - s)).abs() for a, b, s in zip(pc, pp, p0)]
            reading = max(float(x.max()) for x in d) / lr
            share = sum(int((x > 1e-3 * lr).sum()) for x in d) / sum(x.numel() for x in d)
            ok = reading <= ADAMW_FLIP and share <= ADAMW_SHARE and loss_rel <= 1e-5
        out[name] = {"param_reading": reading, "loss_rel": loss_rel, "losses_card": lc,
                     "losses_cpu": lp}
        if name == "adamw":
            out[name]["share_past_1e-3_lr"] = share
        print(f"[train card vs cpu] {name}: params {reading:.3e} "
              f"({'max|d|/max|cpu|' if name == 'sgd' else 'max |d update| / lr'}), losses "
              f"rel {loss_rel:.2e}: card {lc}, cpu {lp}; {out[name]}")
        if not ok:
            raise AssertionError(f"train card vs cpu ({name}) disagrees: {out[name]}")
    return out


def record_routes():
    """(list, context): inside the context every MoE layer's expert ids
    ((g, tg, k) int64) are appended to the list as apply_moe routes them."""
    from repro_torch.models import moe

    routes = []
    real = moe._route

    def recording(router, xg, top_k):
        probs, gates, ids = real(router, xg, top_k)
        routes.append(ids.detach().clone())
        return probs, gates, ids

    return routes, mock.patch.object(moe, "_route", recording)


def route_share_differing(a, b) -> float:
    """Share of assignments (token, expert) in one routing and not the
    other, over lists of (g, tg, k) expert ids of equal shapes."""
    if len(a) != len(b):
        return math.nan
    diff = total = 0
    for x, y in zip(a, b):
        hit = (x[..., :, None] == y[..., None, :]).any(-1)  # x's experts among y's, per token
        diff += int((~hit).sum())
        total += hit.numel()
    return diff / max(total, 1)


def attention_bound(b, hq, hkv, s, t, d):
    """(flops, bytes, bound ms, bound_by) of one causal S = T bf16 K2 launch:
    q k^T and p v over the visible pairs at the bf16 tensor rate, q, k, v
    read and out written once."""
    pairs = b * hq * s * (s + 1) // 2
    flops = 4 * pairs * d
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * t * d)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return flops, nbytes, max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def first_columns_attention(torch, q, k, v, cols: int):
    """Causal attention whose logits read only the first `cols` columns of
    q and k (the plain stand-in for a kernel that stages part of D)."""
    s, t = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    logits = torch.matmul(q[..., :cols].float(), kx[..., :cols].transpose(-1, -2)) * scale
    logits = logits.masked_fill(~causal_visible(torch, s, t, q.device), float("-inf"))
    return torch.matmul(torch.softmax(logits, -1).to(v.dtype).float(), vx).to(q.dtype)


def phase_flash_attention_moe(torch):
    """K2 at the MoE family's shapes: granite-moe's FA_MOE (wgmma_tma) and
    kimi-k2's FA_KIMI (head dim 112, scalar_fp32) against the plain
    version, timed beside SDPA with their bounds, planted faults at D 112
    rejected; K2's gradient at granite-moe's training shape.  Returns the
    records for K2's `moe_shapes`."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(3)
    recs = []
    for name, shape, want_kind in (("granite-moe", FA_MOE, "wgmma_tma"),
                                   ("kimi-k2", FA_KIMI, "scalar_fp32")):
        b, hq, hkv, s, t, d = shape
        kind = ops.library_variant(torch.bfloat16, d)
        if not kind == ops.variant(torch.bfloat16, d) == want_kind:
            raise AssertionError(f"{shape} goes to {kind} (wrapper: "
                                 f"{ops.variant(torch.bfloat16, d)}), expected {want_kind}")
        q, k, v = (torch.randn(*sh, generator=gen).to(dev, torch.bfloat16)
                   for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
        out = ops.flash_attention(q, k, v, causal=True)
        want = ref.attention_ref(q, k, v, causal=True)
        err, reading = max_err(out, want), bf16_reading(out, want)
        faults = {}
        if d == 112:
            faults["logits from the first 64 columns"] = first_columns_attention(
                torch, q, k, v, 64)
            faults["causal offset one key late"] = masked_attention(
                torch, q, k, v, causal_visible(torch, s, t, dev, 1))
        fault_readings = {n: bf16_reading(bad, want) for n, bad in faults.items()}
        print(f"[kernels] flash_attention {name} {shape} bf16 ({kind}): reading {reading:.3f} "
              f"(tol {BF16_ROW_ULPS}), max|err| {err:.3e}; planted faults {fault_readings}")
        if not reading <= BF16_ROW_ULPS:
            raise AssertionError(f"flash_attention disagrees with plain at {shape}")
        for fname, r in fault_readings.items():
            if r <= BF16_ROW_ULPS:
                raise AssertionError(f"the bf16 check passes a planted fault at D {d}: {fname}")
        del out, want, faults

        def kernel():
            return ops.flash_attention(q, k, v, causal=True)

        def plain():
            return ref.attention_ref(q, k, v, causal=True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        reps = 5 if d == 112 else 10
        k1, p1, l1, l2, p2, k2 = (time_ms(torch, fn, reps) for fn in
                                  (kernel, plain, library, library, plain, kernel))
        flops, nbytes, bound_ms, bound_by = attention_bound(*shape)
        rec = {"path": name, "shape": list(shape), "variant": kind,
               "grid": ops.ctas(b, hq, s, torch.bfloat16, d), "max_abs_err": err,
               "bf16_reading": reading, "planted_faults": fault_readings,
               "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2,
               "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes}
        print(f"[kernels] flash_attention ({kind}, {rec['grid']} CTAs) at {shape} bf16 causal: "
              f"kernel_ms {k1:.3f} {k2:.3f}  plain_ms {p1:.3f} {p2:.3f}  sdpa_ms {l1:.3f} "
              f"{l2:.3f}  bound_ms {bound_ms:.4f} ({bound_by}: {flops:.3e} flops, {nbytes:.3e} "
              f"bytes)")
        recs.append(rec)
        del q, k, v
        torch.cuda.empty_cache()

    # K2's gradient at granite-moe's training shape (FA_MOE, bf16).
    b, hq, hkv, s, t, d = FA_MOE
    q, k, v, do = (torch.randn(*sh, generator=gen).to(dev, torch.bfloat16)
                   for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, hq, s, d)))
    readings = grad_readings(autograd_grads(torch, ops.flash_attention, q, k, v, do),
                             autograd_grads(torch, ref.attention_ref, q, k, v, do))
    print(f"[kernels] flash_attention gradient bf16 at {FA_MOE}: {readings} (gate "
          f"{GRAD_BF16_TOL})")
    if not max(readings.values()) <= GRAD_BF16_TOL:
        raise AssertionError(f"K2 gradient disagrees with plain at {FA_MOE}: {readings}")
    recs[0]["grad_readings"] = readings
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def moe_layer_params(torch, d, f, e, dtype, seed, n_shared=0):
    """Random MoE params (models/moe.init_moe) on the card in `dtype`."""
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return moe.init_moe(gen, d, f, e, n_shared=n_shared, dtype=dtype)


def route_margins(torch, router, x, top_k) -> float:
    """The smallest gap between consecutive probabilities among each
    token's k + 1 largest (fp32 router, as apply_moe)."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router.float(), -1)
    top = torch.topk(probs, top_k + 1, dim=-1).values
    return float((top[:, :-1] - top[:, 1:]).min())


def faulty_slots(flat_ids, pos, cap, n_experts):
    """Planted: a dispatch that ignores the capacity (positions past cap
    spill into the next expert's slots; the last expert's into the pad)."""
    return (flat_ids * cap + pos).clamp(max=n_experts * cap)


def faulty_positions(flat_ids, n_experts):
    """Planted: positions counted over the assignments slot-major (every
    token's first choice, then every token's second, ...)."""
    import torch
    import torch.nn.functional as F

    g, n = flat_ids.shape
    tg = n // MOE_SMALL["top_k"]
    slot_major = flat_ids.view(g, tg, -1).transpose(1, 2).reshape(g, n)
    onehot = F.one_hot(slot_major, n_experts).to(torch.int32)
    running = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = torch.gather(running, 2, slot_major[..., None])[..., 0] - 1
    pos = pos.view(g, -1, tg).transpose(1, 2).reshape(g, n)
    return pos, running[:, -1, :]


def phase_moe_layer(torch):
    """The MoE layer (models/moe.apply_moe) on the card: against moe_ref at
    granite-moe's width on 8192 tokens with nothing dropped (fp32 at
    MOE_FP32_RTOL, bf16 at MOE_ROW_ULPS); the dispatch tables against the
    CPU's on the same fp32 inputs with drops (MOE_SMALL; inputs whose top-k
    margins exceed MOE_MARGIN); two launches the same bits, forward and
    backward; three planted faults rejected.  Returns its readings."""
    from repro_torch.models import moe

    dev = torch.device("cuda")
    d, f, e, k = 1024, 512, 32, 8
    gen = torch.Generator(device="cpu").manual_seed(4)
    x32 = torch.randn(LM_BATCH, LM_PROMPT, d, generator=gen).to(dev)
    kw = dict(top_k=k, n_groups=16, capacity_factor=e / k)  # capacity = tokens per group
    out = {}
    p32 = moe_layer_params(torch, d, f, e, torch.float32, 5)

    def fp32_reading():
        got, _, tables = moe.apply_moe(p32, x32, return_tables=True, **kw)
        if not bool(tables["filled"].sum() == x32.shape[0] * x32.shape[1] * k):
            raise AssertionError("MoE layer: assignments dropped at factor E / k")
        return rel_err(got, moe.moe_ref(p32, x32, top_k=k))

    out["fp32_rel"] = fp32_reading()
    with mock.patch.object(moe, "_renormalise", lambda gv: gv):
        out["planted_no_renormalisation_rel"] = fp32_reading()
    pb = {key: t.to(torch.bfloat16) for key, t in p32.items()}
    xb = x32.to(torch.bfloat16)
    got, _ = moe.apply_moe(pb, xb, **kw)
    out["bf16_reading"] = bf16_reading(got, moe.moe_ref(pb, xb, top_k=k))
    print(f"[moe layer] granite-moe width (d {d}, f {f}, E {e}, top-{k}), {LM_BATCH} x "
          f"{LM_PROMPT} tokens, nothing dropped: apply_moe vs moe_ref fp32 max|d|/max|ref| "
          f"{out['fp32_rel']:.3e} (tol {MOE_FP32_RTOL}), bf16 reading {out['bf16_reading']:.3f} "
          f"(tol {MOE_ROW_ULPS}); planted combine without renormalisation "
          f"{out['planted_no_renormalisation_rel']:.3e}")
    if not out["fp32_rel"] <= MOE_FP32_RTOL or not out["bf16_reading"] <= MOE_ROW_ULPS:
        raise AssertionError(f"MoE layer disagrees with moe_ref: {out}")
    if out["planted_no_renormalisation_rel"] <= MOE_FP32_RTOL:
        raise AssertionError("the MoE layer check passes a combine without renormalisation")

    # Two launches of the same layer (bf16, granite's groups and capacity):
    # the output and every gradient bit for bit.
    def fwd_bwd():
        leaves = {key: t.detach().requires_grad_(True) for key, t in pb.items()}
        xx = xb.detach().requires_grad_(True)
        o, aux = moe.apply_moe(leaves, xx, top_k=k, n_groups=16)
        grads = torch.autograd.grad((o.float() * 1e-2).sum() + aux, [xx, *leaves.values()])
        return [o.detach(), aux.detach(), *grads]

    first, second = fwd_bwd(), fwd_bwd()
    out["repeat_bit_identical"] = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[moe layer] two launches (forward and backward) bit-identical: "
          f"{out['repeat_bit_identical']}")
    if not out["repeat_bit_identical"]:
        raise AssertionError("MoE layer: two launches gave different bits")
    del p32, pb, x32, xb, got, first, second

    # The dispatch tables, card against CPU, at MOE_SMALL with drops.
    sm = MOE_SMALL
    for seed in range(64):
        g_cpu = torch.Generator().manual_seed(100 + seed)
        params = moe.init_moe(g_cpu, sm["d"], sm["f"], sm["e"])
        x = torch.randn(*sm["shape"], sm["d"], generator=g_cpu)
        margin = route_margins(torch, params["router"], x, sm["top_k"])
        if margin > MOE_MARGIN:
            break
    else:
        raise AssertionError(f"no input of 64 has top-k margins above {MOE_MARGIN}")
    skw = dict(top_k=sm["top_k"], n_groups=sm["groups"], capacity_factor=sm["factor"])
    _, _, want = moe.apply_moe(params, x, return_tables=True, **skw)
    dropped = int((want["slot"] == sm["e"] * want["cap"]).sum())

    def card_tables():
        pc = {key: t.to(dev) for key, t in params.items()}
        _, _, tables = moe.apply_moe(pc, x.to(dev), return_tables=True, **skw)
        return tables

    def table_reading(tables):
        """(every int/bool table equal, max gate |d| / max gate)."""
        same = all(torch.equal(tables[key].cpu(), want[key])
                   for key in ("expert_ids", "slot", "token_of_slot", "filled"))
        return same, rel_err(tables["gate_of_slot"].cpu(), want["gate_of_slot"])

    same, gate_rel = table_reading(card_tables())
    planted = {}
    for name, attr, fault in (("dispatch ignoring the capacity", "_slots", faulty_slots),
                              ("positions counted slot-major", "_positions", faulty_positions)):
        with mock.patch.object(moe, attr, fault):
            planted[name] = table_reading(card_tables())
    out.update(tables_equal=same, gate_rel=gate_rel, margin=margin, seed=100 + seed,
               dropped=dropped, planted_tables=planted)
    print(f"[moe layer] dispatch tables, card vs CPU on fp32 inputs (d {sm['d']}, E {sm['e']}, "
          f"top-{sm['top_k']}, {sm['groups']} groups, capacity {want['cap']}, {dropped} "
          f"assignments dropped; input seed {100 + seed}, smallest top-{sm['top_k'] + 1} "
          f"probability gap {margin:.2e} > {MOE_MARGIN}): ids, slots, token_of_slot and filled "
          f"equal {same}, gate_of_slot max|d|/max {gate_rel:.2e} (tol {MOE_GATE_RTOL}); planted "
          f"{planted}")
    if not (same and gate_rel <= MOE_GATE_RTOL and dropped > 0):
        raise AssertionError(f"MoE dispatch tables differ between the card and the CPU: {out}")
    for name, (eq, _) in planted.items():
        if eq:
            raise AssertionError(f"the dispatch-table check passes a planted fault: {name}")
    torch.cuda.empty_cache()
    return out


def prefill_checked(torch, cfg, params, prompts):
    """A prefill whose every K2 launch is held against the plain version on
    that launch's inputs: (last-position logits, [bf16 reading per layer],
    the first layer's planted reading (causal limit one key late))."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import attention, model

    real = ops.flash_attention
    layers, planted = [], []

    def checked(q, k, v, *, causal=True, scale=None):
        out = real(q, k, v, causal=causal, scale=scale)
        want = ref.attention_ref(q, k, v, causal=causal, scale=scale)
        layers.append(bf16_reading(out, want))
        if not planted:
            late = causal_visible(torch, q.shape[2], k.shape[2], q.device, 1)
            planted.append(bf16_reading(masked_attention(torch, q, k, v, late), want))
        return out

    # _launch counts on the module's `flash_attention`, this wrapper while
    # patched: the check's launches stay off the wrapper's real count.
    checked.launches = 0
    with mock.patch.object(attention.ops, "flash_attention", checked):
        logits, _ = model.prefill(cfg, params, {"tokens": prompts})
    return logits[:, -1, :].clone(), layers, planted[0]


# Forward ranges of the MoE profile: (range, module, attribute).  K2's own
# kernels are read by name ("attention (K2)"): a launch through ctypes has
# no PyTorch operator for the profiler to hang it under.
MOE_RANGES = (("router and top-k", "moe", "_route"), ("dispatch tables", "moe", "dispatch_tables"),
              ("slot maps", "moe", "_expert_major"), ("gathers", "moe", "_gather_rows"),
              ("combine sums", "moe", "_sum_rows"), ("expert GEMMs", "moe", "_experts"),
              ("shared expert", "moe", "_shared"), ("unembedding", "model", "_logits"))


def profile_moe(torch, fn):
    """One call of fn under torch.profiler with a range around each of
    MOE_RANGES: (host wall ms, device kernel ms, {range: device ms of the
    kernels launched inside it, "attention (K2)": K2's kernels, "other":
    the rest}, [(kernel, ms)] of the 8 largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model, moe

    mods = {"moe": moe, "model": model}

    def ranged(name, fn_):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name, mod, attr in MOE_RANGES:
            stack.enter_context(mock.patch.object(
                mods[mod], attr, ranged(name, getattr(mods[mod], attr))))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    names = {name for name, _, _ in MOE_RANGES}
    avg = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in avg
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and e.key not in names), key=lambda r: -r[1])
    ranges = {e.key: round(e.device_time_total / 1e3, 3) for e in avg
              if e.key in names and e.device_type == DeviceType.CPU}
    ranges["attention (K2)"] = round(sum(ms for k_, ms in kernels if "flash_attention" in k_), 3)
    dev_ms = sum(ms for _, ms in kernels)
    ranges["other"] = round(dev_ms - sum(ranges.values()), 3)
    return wall_ms, dev_ms, ranges, [(k_[:60], round(ms, 3)) for k_, ms in kernels[:8]]


def phase_moe_serve(torch, card: str):
    """The port's serve at granite-moe-1b-a400m's full width; returns K2's
    launch count over the run."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import attention, model

    argv = ["--arch", MOE_ARCH, "--full-config", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--device", "cuda"]
    serve.run(serve.parse_args(argv[:5] + ["--prompt-len", "64", "--gen", "2",
                                          "--device", "cuda"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    if launches != cfg.n_layers:
        raise AssertionError(f"MoE serve: {launches} K2 launches, expected {cfg.n_layers} "
                             f"(one per layer of the prefill)")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"MoE serve: tokens {tuple(tokens.shape)} or outside the vocabulary")
    if not bool(torch.isfinite(last).all()) or not all(
            bool(torch.isfinite(t).all()) for t in out["cache"]["layers"].values()):
        raise AssertionError("MoE serve: logits or cache not finite")

    # Each layer's attention, K2 against plain on that layer's own inputs
    # (gated); the end-to-end prefill against its plain-attention twin and
    # the share of routes that differ (printed: a route one ulp flips moves
    # its token by O(1), so no end-to-end gate is valid).
    params, prompts = out["params"], out["prompts"]
    routes_k, rec_k = record_routes()
    with rec_k:
        last_k, layers, planted = prefill_checked(torch, cfg, params, prompts)
    routes_p, rec_p = record_routes()
    with rec_p, mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        logits_p, _ = model.prefill(cfg, params, {"tokens": prompts})
    last_p = logits_p[:, -1, :].clone()
    del logits_p
    e2e = {"logits_row_reading": row_reading(last_k, last_p),
           "argmax_agree": float((last_k.argmax(-1) == last_p.argmax(-1)).float().mean()),
           "routes_differing": route_share_differing(routes_k, routes_p),
           "rerun_bit_identical": bool(torch.equal(last_k, last))}
    print(f"[moe serve] each layer's K2 vs plain on its inputs, bf16 readings (gate "
          f"{BF16_ROW_ULPS}): {[round(r, 3) for r in layers]}; planted (layer 0, causal "
          f"limit one key late) {planted:.3f}; end to end vs the plain-attention twin "
          f"(printed, not gated): {e2e}")
    if len(layers) != cfg.n_layers or not max(layers) <= BF16_ROW_ULPS:
        raise AssertionError(f"MoE serve: a layer's K2 disagrees with plain: {layers}")
    if planted <= BF16_ROW_ULPS:
        raise AssertionError("MoE serve: the per-layer gate passes a planted wrong attention")

    cache, tok = out["cache"], tokens[:, -1:].to(prompts.device)
    prof = {}
    for what, fn, run_ms in (
        ("prefill", lambda: model.prefill(cfg, params, {"tokens": prompts}), pay["prefill_ms"]),
        ("decode_step", lambda: model.decode_step(cfg, params, cache, tok,
                                                  LM_PROMPT + LM_GEN - 1),
         pay["decode_ms_per_token"]),
    ):
        wall, dev_ms, ranges, top = profile_moe(torch, fn)
        prof[what] = {"profiled_wall_ms": wall, "device_ms": dev_ms,
                      "busy_share": dev_ms / run_ms, "ranges_ms": ranges, "top": top}
        print(f"[moe serve] profile {what}: device kernels {dev_ms:.2f} ms, {run_ms:.2f} ms "
              f"unprofiled (busy share {dev_ms / run_ms:.3f}); by range {ranges}; top {top}")
    print(f"[moe serve] {card}: {cfg.name} batch {LM_BATCH} prompt {LM_PROMPT} gen {LM_GEN}: "
          f"prefill {pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} tokens/s)  "
          f"decode {pay['decode_ms_per_token']:.3f} ms/token "
          f"({pay['decode_tokens_per_s']:.1f} tokens/s)  K2 launches {launches}  "
          f"peak device memory {peak_gb:.2f} GB")
    print("MOE_SERVE " + json.dumps({
        **pay, "card": card, "launches": launches, "peak_mem_gb": peak_gb,
        "layer_readings": layers, "planted_layer0": planted, "end_to_end": e2e,
        "first_row": tokens[0].tolist(), "profile": prof}))
    del out, params, prompts, cache, last, last_k, last_p
    torch.cuda.empty_cache()
    return launches


def phase_moe_train(torch, card: str):
    """The port's training at granite-moe-1b-a400m's full width through
    launch/train (AdamW, cosine warmup; MOE_STEPS steps, checkpoints every
    MOE_CKPT_EVERY, a fault at MOE_FAULT_AT, the rescale reload): 48 K2
    launches a step, the first replayed loss exact, the first step's loss
    against its plain-attention twin; returns the run's record."""
    import shutil

    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import attention, model
    from repro_torch.optim import for_arch
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    cfg = get_config(MOE_ARCH)
    counts = cfg.param_counts()
    state_gb = 3 * 4 * counts["total"] / 1e9
    ckpt_dir = ROOT / "build" / "chip_smoke_moe_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    need_gb = 2 * state_gb + 2.0
    print(f"[moe train] {cfg.name}: {counts['total']:.4e} params ({counts['active']:.4e} "
          f"active), train state {state_gb:.2f} GB; free disk under build/ {free_gb:.1f} GB "
          f"(need {need_gb:.1f})")
    if free_gb < need_gb:
        raise AssertionError(f"MoE train: {free_gb:.1f} GB free under build/, need {need_gb:.1f}")

    # (1) The first step, K2 against its plain-attention twin.
    batch = train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(0)
    params = model.init(cfg, 0, "cuda")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)

    def loss_and_grads():
        loss, metrics = model.loss_fn(cfg, params, batch)
        return loss.item(), float(metrics["moe_aux"]), torch.autograd.grad(loss, flat)

    reset_launch_counts()
    routes_k, rec_k = record_routes()
    with rec_k:
        loss_k, aux_k, grads_k = loss_and_grads()
    first_launches = ops.flash_attention.launches
    routes_p, rec_p = record_routes()
    with rec_p, mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        loss_p, aux_p, grads_p = loss_and_grads()
    grad_rel = [rel_err(g, w) for g, w in zip(grads_k, grads_p)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    del grads_k, grads_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    routes = route_share_differing(routes_k, routes_p)
    del routes_k, routes_p
    print(f"[moe train] first step, K2 vs plain-attention twin: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}, gate {MOE_LOSS_RTOL:.2e}), moe_aux {aux_k:.6f} vs "
          f"{aux_p:.6f}; routes differing {routes:.3e}; per-leaf max|dg|/max|g| (printed, not "
          f"gated) max {max(grad_rel):.3e}: {[round(r, 5) for r in grad_rel]}; K2 launches "
          f"{first_launches}")
    if first_launches != 2 * cfg.n_layers:
        raise AssertionError(f"MoE train: {first_launches} K2 launches in one loss and "
                             f"gradient, expected {2 * cfg.n_layers}")
    if not (finite and loss_rel <= MOE_LOSS_RTOL):
        raise AssertionError("MoE train: the first step's loss disagrees with the "
                             "plain-attention twin, or a gradient is not finite")

    # (2) One step under the profiler, after a warm one.
    opt = for_arch(cfg, lr=cosine_warmup(3e-4, warmup=20, total=MOE_STEPS))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step_fn = steps.make_train_step(cfg, opt)
    step_fn(state, batch)
    wall_ms, rows = profile_rows(torch, lambda: step_fn(state, batch))
    dev_ms, top = sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:10]]
    categories = step_categories(rows)
    _, _, ranges, _ = profile_moe(torch, lambda: step_fn(state, batch))
    print(f"[moe train] profile of one step: device kernels {dev_ms:.1f} ms, {wall_ms:.1f} ms "
          f"under the profiler; by category {categories}; forward ranges {ranges}; top {top}")
    del state, params, flat, step_fn
    torch.cuda.empty_cache()

    # (3) The CLI, with the checkpoint I/O timed.
    io = {"save_s": [], "restore_s": [], "host_copy_s": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                io[key].append(time.perf_counter() - t)
        return wrapper

    argv = ["--arch", MOE_ARCH, "--full-config", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(MOE_STEPS),
            "--ckpt-every", str(MOE_CKPT_EVERY), "--inject-fault-at", str(MOE_FAULT_AT),
            "--rescale-mesh", "1x1", "--ckpt-dir", str(ckpt_dir), "--device", "cuda"]
    with mock.patch.object(manager, "save_pytree", timed(manager.save_pytree, "save_s")), \
            mock.patch.object(manager, "load_pytree", timed(manager.load_pytree, "restore_s")), \
            mock.patch.object(manager.CheckpointManager, "save",
                              timed(manager.CheckpointManager.save, "host_copy_s")):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train.run(train.parse_args(argv))
        wall = time.perf_counter() - t0
        launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner, losses, history = out["runner"], out["losses"], out["history"]
    executed = len(history)
    replayed = MOE_FAULT_AT - MOE_CKPT_EVERY
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if out["faults"] != 1 or executed != MOE_STEPS + replayed:
        raise AssertionError(f"MoE train: {out['faults']} faults, {executed} steps run")
    if launches != 2 * cfg.n_layers * executed:
        raise AssertionError(f"MoE train: {launches} K2 launches over {executed} steps, "
                             f"expected {2 * cfg.n_layers} a step")
    if out["ckpt_steps"] != [MOE_CKPT_EVERY, MOE_STEPS] or out["rescaled_step"] != MOE_STEPS:
        raise AssertionError(f"MoE train: checkpoints {out['ckpt_steps']}, rescale resumed at "
                             f"{out['rescaled_step']}")
    if not all(math.isfinite(x) for _, x in losses) or not all(m["moe_aux"] > 0 for m in history):
        raise AssertionError(f"MoE train: a loss is not finite or a moe_aux not positive")
    first = dict(losses[:MOE_FAULT_AT])
    replay = losses[MOE_FAULT_AT:MOE_FAULT_AT + replayed]
    replay_rel = [abs(x - first[st]) / abs(first[st]) for st, x in replay]
    print(f"[moe train] replay from step {MOE_CKPT_EVERY}: first pass "
          f"{[first[st] for st, _ in replay]}, replayed {[x for _, x in replay]} (the first "
          f"exactly, the rest within {REPLAY_RTOL}: {replay_rel})")
    if replay[0][1] != first[replay[0][0]]:
        raise AssertionError("MoE train: the first replayed loss differs from the first pass's")
    if not max(replay_rel) <= REPLAY_RTOL:
        raise AssertionError(f"MoE train: a replayed loss parts from the first pass: {replay_rel}")

    times = runner.step_times
    step_s = statistics.median(times[1:])
    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    rec = {
        "card": card, "arch": cfg.name, "params": counts["total"],
        "active_params": counts["active"], "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps_run": executed, "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
        "step_ms_all": [x * 1e3 for x in times], "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "model_flops_per_step": flops, "mfu_bf16": flops / step_s / BF16_FLOPS_PER_S,
        "peak_mem_gb": peak_gb, "launches": launches, "launches_per_step": launches / executed,
        "losses": losses, "moe_aux": [m["moe_aux"] for m in history], "replay_rel": replay_rel,
        "first_step": {"loss": loss_k, "plain_loss": loss_p, "loss_rel": loss_rel,
                       "grad_rel": grad_rel, "routes_differing": routes},
        "profile": {"profiled_wall_ms": wall_ms, "device_ms": dev_ms,
                    "busy_share": dev_ms / (step_s * 1e3), "categories": categories,
                    "forward_ranges_ms": ranges, "top": top},
        "checkpoint_io_s": io, "state_gb": state_gb, "wall_s": wall,
        "events": [{k: v for k, v in e.items() if k != "error"} for e in runner.events],
    }
    print(f"[moe train] {card}: {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step "
          f"{rec['step_ms']:.1f} ms (median of {len(times) - 1} after the first, "
          f"{rec['first_step_ms']:.1f}), {rec['tokens_per_s']:.1f} tokens/s, model-flops share "
          f"of the bf16 peak {rec['mfu_bf16']:.4f} ({flops:.4e} flops a step, active params), "
          f"peak device memory {peak_gb:.2f} GB, K2 launches {launches} "
          f"({rec['launches_per_step']:.0f} a step); checkpoint save {io['save_s']} s, host "
          f"copy {io['host_copy_s']} s, restore {io['restore_s']} s; busy share "
          f"{rec['profile']['busy_share']:.3f}; wall {wall:.1f} s")
    print("MOE_TRAIN " + json.dumps(rec))
    del out, runner
    gc.collect()  # free whatever a reference cycle still holds of the train states
    torch.cuda.empty_cache()
    return rec


def phase_kimi(torch, card: str):
    """The port's serve at kimi-k2's full width, depth cut to KIMI_LAYERS:
    2 K2 launches at head dim 112 a prefill, each held against plain on its
    inputs; the MoE layer against moe_ref on MOE_KIMI_TOKENS of its own
    inputs.  Returns K2's launch count over the run."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import model, moe
    from repro_torch.models.layers import apply_norm

    argv = ["--arch", KIMI_ARCH, "--full-config", "--n-layers", str(KIMI_LAYERS),
            "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen", str(KIMI_GEN),
            "--device", "cuda"]
    # 37.5 GB of weights: nothing of an earlier phase may still hold memory.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    n_params = cfg.param_counts()
    if launches != KIMI_LAYERS:
        raise AssertionError(f"kimi: {launches} K2 launches, expected {KIMI_LAYERS}")
    if tuple(tokens.shape) != (LM_BATCH, KIMI_GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab or not bool(torch.isfinite(last).all()):
        raise AssertionError("kimi: tokens outside the vocabulary or logits not finite")
    for stack in ("dense", "layers"):
        if not all(bool(torch.isfinite(t).all()) for t in out["cache"][stack].values()):
            raise AssertionError(f"kimi: the {stack} cache is not finite")
    params, prompts = out["params"], out["prompts"]
    del out
    _, layers, planted = prefill_checked(torch, cfg, params, prompts)
    if len(layers) != KIMI_LAYERS or not max(layers) <= BF16_ROW_ULPS \
            or planted <= BF16_ROW_ULPS:
        raise AssertionError(f"kimi: K2 at D 112 vs plain per layer {layers}, planted {planted}")

    # The MoE layer at kimi's width on the first tokens of its own input.
    lp = params["layers"][0]
    captured = []
    real = moe.apply_moe

    def capture(p_, x, **kw):
        captured.append(x[:1, :MOE_KIMI_TOKENS].clone())
        return real(p_, x, **kw)

    with mock.patch("repro_torch.models.transformer.apply_moe", capture):
        model.prefill(cfg, params, {"tokens": prompts[:1, :MOE_KIMI_TOKENS]})
    x = captured[0]
    k, e = cfg.top_k, cfg.n_experts
    got, _ = moe.apply_moe(lp["moe"], x, top_k=k, n_groups=1, capacity_factor=e / k)
    moe_read = bf16_reading(got, moe.moe_ref(lp["moe"], x, top_k=k))
    del got, captured, x
    print(f"[kimi] K2 at D 112 vs plain per layer {[round(r, 3) for r in layers]} (gate "
          f"{BF16_ROW_ULPS}; planted causal limit one key late {planted:.3f}); MoE layer at "
          f"kimi's width (E {e}, top-{k}, shared expert) on {MOE_KIMI_TOKENS} tokens vs "
          f"moe_ref, nothing dropped: bf16 reading {moe_read:.3f} (tol {MOE_ROW_ULPS})")
    if not moe_read <= MOE_ROW_ULPS:
        raise AssertionError(f"kimi: the MoE layer disagrees with moe_ref ({moe_read})")
    print(f"[kimi] {card}: {cfg.name} cut to {cfg.n_layers} layers ({n_params['total']:.4e} "
          f"params, bf16) batch {LM_BATCH} prompt {LM_PROMPT} gen {KIMI_GEN}: prefill "
          f"{pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} tokens/s)  decode "
          f"{pay['decode_ms_per_token']:.3f} ms/token  K2 launches {launches} (D 112)  peak "
          f"device memory {peak_gb:.2f} GB")
    print("KIMI " + json.dumps({**pay, "card": card, "n_layers": cfg.n_layers,
                                "params": n_params["total"], "launches": launches,
                                "peak_mem_gb": peak_gb, "layer_readings": layers,
                                "planted_layer0": planted, "moe_reading": moe_read,
                                "first_row": tokens[0].tolist()}))
    del params, prompts, last, lp
    torch.cuda.empty_cache()
    return launches


def phase_moe_card_vs_cpu(torch):
    """Three SGD steps of the granite-moe smoke config (fp32) on the card
    and on the CPU from one state: the first step's routing tables compared
    first, then the params within 1e-4 of each leaf's largest |value| and
    the losses within 1e-5 relative; a planted fault (the card's combine
    without the gate renormalisation) must fail."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches
    from repro_torch.models import moe
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.runtime import steps

    cfg = get_smoke_config(MOE_ARCH)
    batches = make_batches(cfg, 4, 64, 0)
    start = steps.init_train_state(cfg, sgd(0.5), 0, "cpu")

    def run(dev, fault=False):
        state = tree_map(lambda t: t.clone().to(dev), start)
        step, losses = steps.make_train_step(cfg, sgd(0.5)), []
        routes, rec = record_routes()
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(mock.patch.object(moe, "_renormalise", lambda gv: gv))
            for i in range(3):
                if i == 0:
                    with rec:
                        state, m = step(state, batches(i))
                else:
                    state, m = step(state, batches(i))
                losses.append(m["loss"].item())
        return [t.detach().cpu() for t in leaves(state["params"])], losses, routes

    pc, lc, rc = run("cuda")
    pp, lp, rp = run("cpu")
    routes_equal = len(rc) == len(rp) and all(torch.equal(a.cpu(), b) for a, b in zip(rc, rp))
    reading = max(rel_err(a, b) for a, b in zip(pc, pp))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    pf, _, _ = run("cuda", fault=True)
    planted = max(rel_err(a, b) for a, b in zip(pf, pp))
    print(f"[moe card vs cpu] first step's routes equal {routes_equal} (share differing "
          f"{route_share_differing([r.cpu() for r in rc], rp):.3e}); SGD params "
          f"max|d|/max|cpu| {reading:.3e} (tol 1e-4), losses rel {loss_rel:.2e} (tol 1e-5): "
          f"card {lc}, cpu {lp}; planted combine without renormalisation {planted:.3e}")
    if not (reading <= 1e-4 and loss_rel <= 1e-5):
        raise AssertionError("MoE card vs cpu: the SGD steps disagree")
    if planted <= 1e-4:
        raise AssertionError("MoE card vs cpu: the check passes a planted fault")
    return {"routes_equal": routes_equal, "param_reading": reading, "loss_rel": loss_rel,
            "planted": planted}


def numbers(obj):
    """Every float in a nest of dicts and lists."""
    if isinstance(obj, float):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from numbers(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from numbers(v)


def phase_twins(torch, card: str):
    """The torch twins of examples/ at the JAX scripts' sizes on the card.
    quickstart, denoise_image and novel_docs are plain PyTorch (no kernel);
    graph_gossip and multi_pod run the port's coder, whose every iteration
    is a K1 call (iters + 1 a solve); train_lm trains LM_100M through K2
    (fp32, scalar_fp32: 2 launches a layer a step) and must lower its loss
    by more than 1.0.  Returns the launches by twin."""
    import shutil

    from repro_torch.experiments import (denoise_image, graph_gossip, multi_pod, novel_docs,
                                         quickstart, train_lm)
    from repro_torch.kernels.dict_dual_step import ops as dd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slstm_step import ops as sl_ops

    solve_calls = sum(it + 1 for it in (400, 1600))  # a coder solve is iters + 1 K1 calls
    expected = {
        "quickstart": (0, 0), "denoise_image": (0, 0), "novel_docs": (0, 0),
        "graph_gossip": ((len(graph_gossip.TOPOLOGIES) + len(graph_gossip.SCHEDULES))
                         * solve_calls, 0),
        "multi_pod": ((len(multi_pod.FLAT_AND_HIER) + len(multi_pod.POD_KNOBS)) * solve_calls
                      + len(multi_pod.CHAINS) * 1601, 0),
        "train_lm": (0, 2 * train_lm.LM_100M.n_layers * 300),
    }
    out = {}
    for name, mod in (("quickstart", quickstart), ("denoise_image", denoise_image),
                      ("novel_docs", novel_docs), ("graph_gossip", graph_gossip),
                      ("multi_pod", multi_pod), ("train_lm", train_lm)):
        reset_launch_counts()
        t = time.perf_counter()
        result = mod.run(device="cuda")
        wall = time.perf_counter() - t
        got = (dd_ops.dict_dual_step.launches, fa_ops.flash_attention.launches,
               sl_ops.slstm_seq.launches)
        if name == "train_lm":
            shutil.rmtree(result["ckpt_dir"], ignore_errors=True)
            result = {k: v for k, v in result.items() if k != "losses"}
        out[name] = {"wall_s": wall, "launches": {"dict_dual_step": got[0],
                                                   "flash_attention": got[1],
                                                   "slstm_seq": got[2]}, "result": result}
        print(f"[twins:{name}] {card}: wall {wall:.1f} s, launches (K1, K2, K3) {got}: {result}")
        if got != (*expected[name], 0):
            raise AssertionError(f"twin {name}: launches (K1, K2, K3) {got}, expected "
                                 f"{(*expected[name], 0)}")
        # novel_docs' AUC is nan at a step without novel documents, as JAX's
        vals = [x for x in numbers(result) if not (name == "novel_docs" and math.isnan(x))]
        if not all(math.isfinite(x) for x in vals):
            raise AssertionError(f"twin {name}: a result is not finite: {result}")
    den = out["denoise_image"]["result"]
    if not min(den["denoised_all_psnr_db"], den["denoised_one_psnr_db"]) > den["noisy_psnr_db"]:
        raise AssertionError(f"denoise_image: not above the noisy PSNR: {den}")
    if not out["quickstart"]["result"]["eq53_snr_db"] > 60:
        raise AssertionError(f"quickstart: nu is not the residual: {out['quickstart']}")
    lm = out["train_lm"]["result"]
    print("TWINS " + json.dumps({"card": card, **out}, default=str))
    if not lm["last10_loss"] < lm["first_loss"] - 1.0:  # run() raises first; kept explicit
        raise AssertionError(f"train_lm did not learn: {lm}")
    return {name: r["launches"] for name, r in out.items()}


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
    fa_rec["backward"] = timed("flash_attention gradient", phase_flash_attention_grad, torch)
    fa_rec["moe_shapes"] = timed("flash_attention MoE shapes", phase_flash_attention_moe, torch)
    moe_layer = timed("MoE layer", phase_moe_layer, torch)
    sl_rec = timed("slstm_seq", phase_slstm, torch, slstm_build)
    timed("small coder", phase_small_coder, torch)
    timed("elastic small", phase_elastic_small, torch)
    rec["grown_shapes"] = timed("dict_dual_step at N 18, 20", phase_k1_grown_shapes, torch)
    gossip = timed("gossip modes", phase_gossip_modes, torch, card)
    fa_rec["launches"] = timed("gemma-2b serve", phase_lm, torch, card)
    sl_rec["launches"] = timed("xlstm-1.3b serve", phase_xlstm, torch, card)
    train = timed("olmo-1b train", phase_olmo_train, torch, card)
    timed("train card vs cpu", phase_train_card_vs_cpu, torch)
    moe_serve = timed("granite-moe serve", phase_moe_serve, torch, card)
    moe_train = timed("granite-moe train", phase_moe_train, torch, card)
    kimi = timed("kimi-k2 cut serve", phase_kimi, torch, card)
    moe_cpu = timed("MoE card vs cpu", phase_moe_card_vs_cpu, torch)
    fa_rec["launches_by_path"] = {"gemma-2b serve": fa_rec["launches"],
                                  "olmo-1b train": train["launches"],
                                  "granite-moe serve": moe_serve,
                                  "granite-moe train": moe_train["launches"],
                                  "kimi-k2 cut serve": kimi}
    fa_rec["launches"] += train["launches"] + moe_serve + moe_train["launches"] + kimi
    fa_rec["train_launches_per_step"] = train["launches_per_step"]
    fa_rec["moe_train_launches_per_step"] = moe_train["launches_per_step"]
    print("MOE_CHECKS " + json.dumps({"layer": moe_layer, "card_vs_cpu": moe_cpu}))
    # The diffusion's step is bounded by the worst block's curvature
    # (sigma_max(W_k)^2 / delta, about 58 here) while its consensus term
    # contracts by only mu / N per iteration, so after 150 iterations at this
    # width an agent's nu is still a small fraction of x (1 - (1 - mu/N)^150,
    # about 0.13) and no atom passes the threshold: graph codes may all be
    # zero.  exact_fista converges in 150 iterations and must code.
    # The two schedule-driven paths run the service too: graph_tv_q8 with
    # link failures and the three-level chain of the gossip phase.
    # Every run codes the same planted stream (the same M, K and seed), whose
    # 262144 planted atoms take the host some 40 s to draw: draw it once.
    from repro_torch.data.synthetic import sparse_stream

    stream = functools.lru_cache(maxsize=1)(sparse_stream)
    serve_runs = {"graph": (), "exact_fista": (),
                  "graph_tv_q8": ("--fail-p", "0.25"),
                  "chain": ("--mesh", "2x2x1x4", "--levels",
                            "torus,ring_metropolis:2:q8,ring:4:q8:stale")}
    launches = {mode: timed(f"serve_dict {mode}", phase_main_path, torch, mode, card,
                            must_code=(mode == "exact_fista"), stream=stream, extra=flags)
                for mode, flags in serve_runs.items()}
    # The elastic drills, the fleet and the kill drill at the same size.
    for mode, flags, grow, drain, resolve in DRILLS:
        launches[f"drill {mode}"] = timed(f"drill {mode}", phase_drill, torch, mode, card,
                                          stream, flags, grow, drain, resolve)
    launches["fleet"] = timed("fleet", phase_fleet, torch, card, stream)
    launches["kill drill"] = timed("kill drill", phase_kill_drill, torch, card, stream)
    launches.update(gossip)
    rec["launches"] = sum(launches.values())
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
    twins = timed("twins", phase_twins, torch, card)
    fa_rec["launches_by_path"]["train_lm twin"] = twins["train_lm"]["flash_attention"]
    rec["twin_launches"] = {name: twins[name]["dict_dual_step"]
                            for name in ("graph_gossip", "multi_pod")}

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
