#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port (src/repro_torch, never jax) on the card in five phases,
and fails (non-zero exit, no result line) if any of them fails:

1. Card and build: prints the card's name and power limit, builds every
   CUDA kernel from the sources in this checkout (one nvcc per source, all
   started together) and prints nvcc's -Xptxas -v register, shared-memory
   and spill lines; fails unless flash_attention's six wgmma_tma kernels
   (bf16 at D 64, 80, 96, 112, 128, 256) each show HGMMA (tensor-core)
   instructions in the built library's SASS (cuobjdump), spill no
   register, and are not serialized by ptxas (its C7511/C7514/C7515
   notes), and unless every slstm_step cluster kernel spills nothing.
   The build runs on a thread while the card runs the learner and the
   experiment twins of phase 4 (they launch no kernel), and while the
   host draws the serving phases' planted stream and the fleet's publish
   dictionary.
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
   K2's forward at FA_TRAIN (D 128) timed beside its plain version and
   SDPA, with its bound.
   K3's gradient (ops.SlstmSeq: K3 forward, backward.slstm_backward, BPTT
   in plain PyTorch) against autograd through slstm_seq_ref in fp64 at
   SL_MAIN and SL_GRAD_SMALL in bf16 (dx_proj, dR, db each within
   SLSTM_GRAD_RTOL beyond bf16 rounding), with three planted faults
   rejected (R not transposed in the recurrent term, the dc carry
   dropped, h_{t-1} read one step late); the backward timed beside K3 +
   the Function and autograd through the plain recurrence, with its
   bound (K3's record, `backward`).
   K2 at the MoE family's shapes, both on wgmma_tma: granite-moe's FA_MOE
   and kimi-k2's FA_KIMI at head dim 112 (a zero-filled tail chunk)
   against plain, timed beside SDPA with their bounds (K2's
   `moe_shapes`), three planted faults at D 112 rejected (logits from the
   first 64 columns, P V without its tail chunk, the causal limit one key
   late); K2's gradient at FA_MOE (GRAD_BF16_TOL).
   K2 at the VLM and audio shapes, all on wgmma_tma with a zero-filled
   tail chunk: phi-3-vision's FA_VLM prefill (576 image + 2048 text
   positions) and FA_VLM_TRAIN at D 96, causal, and hubert-xlarge's
   FA_AUDIO at D 80, non-causal, against plain, timed
   beside SDPA (is_causal as the model asks) with their bounds (K2's
   `vlm_audio_shapes`); planted faults rejected (at D 96 and at D 80
   logits from the first 64 columns and P V without its tail chunk, at D
   80 a causal mask where none was asked); K2's gradient at FA_AUDIO,
   non-causal (GRAD_BF16_TOL).
   K2 at zamba2-1.2b's shared-block shape FA_HYBRID (D 64, 32 over 32
   heads, causal) on wgmma_tma against plain, timed beside SDPA with its
   bound (K2's `hybrid_shape`), a planted wrong causal mask rejected.
   K2 at the per-rank shapes of the sharded serves (FA_SERVE_MESH:
   gemma-2b's (2, 4 / 1, 2048, 256) at 2x2, granite-moe's (4, 8 / 4,
   2048, 64) at 1x2) on wgmma_tma against plain, timed beside SDPA with
   their bounds (K2's `serve_mesh_shapes`), a planted causal limit one key
   late rejected.  K2 at zamba2's per-rank shape of its 2x2 runs
   (FA_HYBRID_RANK, (2, 16 / 16, 2048, 64); `hybrid_shape`'s
   "per_rank_2x2") and K3 at a rank's two rows (SL_RANK; K3's
   "per_rank_shape") the same way, timed beside plain (K2 also SDPA).
   K2 at head dim 128 at granite-8b's FA_GRANITE8B, qwen3-32b's FA_QWEN32B
   and the 2x2 FSDP runs' per-rank FA_FSDP_RANK on wgmma_tma against
   plain, timed beside SDPA with their bounds (K2's `fsdp_shapes`), a
   planted causal limit one key late rejected at granite-8b's.
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
   iters + 1 K1 launches per solve, nu and y finite, the solve timed (the
   first mode's after a warm one) and re-solved with K1's plain version within
   SOLVE_RTOL (Q8_RTOL on the int8 wire); one GOSSIP line each.
3. Main paths, each driven with every kernel's launch count set to 0 just
   before and read just after:
   - dense-LM serving: the port's serve at gemma-2b's full width (random
     weights), a batch of 4 prompts of 2048 tokens, 16 greedy tokens; one
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
     gradient leaf against its plain-attention twin (L x 2^-8), and each
     layer's attention gradient in that step against plain on its own
     inputs (GRAD_BF16_TOL, a planted wrong attention rejected; every
     family's training phase holds these), the first
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
   - MoE training: launch/train at granite-moe's full width, depth cut to
     MOE_TRAIN_LAYERS, MOE_STEPS steps of 4 x 2048 tokens (AdamW, cosine
     warmup), checkpoints every MOE_CKPT_EVERY, a fault at MOE_FAULT_AT,
     the rescale reload: 2 K2 launches a layer a step (4 at 2 layers),
     the first replayed loss exactly the first pass's,
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
   - granite-8b served at full width and depth (36 layers, 8.05e9 params)
     and qwen3-32b at full width cut to QWEN_LAYERS (the first qk-norm
     model on the card), the LM traffic with a few greedy tokens: one K2
     launch a layer a prefill (gated), each layer's K2 against plain on its
     own inputs (gated, a planted wrong attention rejected), tokens in the
     vocabulary, logits and cache finite (GRANITE8B, QWEN32B lines); then
     granite-8b cut to FSDP_LAYERS at 1x1, SERVE_MESH's reference for its
     FSDP case;
   - sharded training over a (data, model) mesh, the ranks sharing the
     card over gloo_staged (runtime/mesh.py: NCCL takes one rank a card):
     one spawned world of 4 ranks runs launch/train's rank body (what
     --mesh runs) for olmo-1b at full width cut to SHARD_LAYERS, 2x2,
     SHARD_STEPS SGD steps, held against the same run on one device without a mesh
     (first loss 2^-7, the last step's params within bf16 rounding, their updates
     within GRAD_BF16_TOL), K2 on every rank on its 8 local heads
     (wgmma_tma); the same run through the CLI on a 1x1 mesh over nccl
     (its one rank this process) bit for bit the run without a mesh;
     granite-moe at full width cut to SHARD_MOE_LAYERS, 1x2 (16
     experts a rank through moe_a2a), AdamW, a fault, an exact replay and
     the reload at 2x1 (its loss against the same checkpoint's on one
     device, 2^-7; and against the saved run's); the a2a layer at
     granite's widths against moe_ref (output and gradients); at the olmo
     SMOKE config 2x2 against 1x1 on the card, with the attention's
     row-parallel output without its psum and the data-parallel
     gradients unaveraged each rejected (SHARDED line; step times beside
     the transport, which they measure); every run here and every
     SERVE_MESH prefill with the sequence-parallel residual (S % tp ==
     0), one olmo-1b 2x2 step held against the same step under {"seq":
     None} (SP line: the loss and every update, remat's kept bytes 1/tp,
     the device memory its forward holds less by nearly that difference,
     K2 launches equal; a residual kept gathered and, at
     granite-8b's SMOKE config, the norms' gradients unsummed, both
     planted and rejected); granite-8b at full width cut to
     FSDP_LAYERS on 2x2 with `embed` over `data` (FSDP: every weight
     gathered before use), launch/train's rank body, AdamW, FSDP_STEPS
     steps, against the same run on one device (the losses within
     2^-7, the params within bf16 rounding, at most FSDP_ADAMW_SHARE of
     a leaf's updates parting by more than ADAMW_FLIP x the summed lr),
     K2 on every rank at FA_FSDP_RANK, each rank's peak and a step's wire
     per axis printed; one Adafactor update on its FSDP-sharded embedding
     table and a layer against the whole leaves' (FSDP_ADAFACTOR_RTOL),
     the means left local rejected; one SGD step at SHARD_LR of the same
     cut from seed 0 at 2x2, its update (lr x the gradient averaged over
     `data`) against one device's leaf by leaf (GRAD_BF16_TOL), with the
     FSDP leaves' gradient left unaveraged over `data` rejected;
   - the hybrid and xlstm families on a mesh, in the same world
     (RECURRENT, recurrent_world / recurrent_report): zamba2-1.2b and
     xlstm-1.3b at full width cut to one group each (REC_CASES) on 2x2,
     launch/train's rank body, REC_STEPS SGD steps: the first loss against
     one device's (SHARD_LOSS_RTOL), K2 per rank at FA_HYBRID_RANK and K3
     per rank counted, remat's kept bytes exactly 1/tp, the step's wire
     printed beside S; every block fed the 1x1 block's input
     (recurrent_blocks): output within BF16_ROW_ULPS, the input's and
     parameters' gradients within GRAD_BF16_TOL; each rank's K3 against
     plain (SL_TOL); the Mamba2 gated norm's sum with the identity
     backward planted and rejected (RECURRENT line);
   - the paper's engine one agent a rank, in the same world (DICT_MESH,
     dict_mesh_world / phase_dict_mesh): `graph` at 1x4 with each rank's
     block (1, 8192, 16384), B 16, 150 iterations, `exact_fista` at 2x2
     (the samples over two data ranks) and `hier` at 2x1x2 (pod x model),
     each against the one-process coder on the card in this process (nu,
     y and W after fit_batch at DM_RTOL; at 2x2 W's update beside its
     fp32 rounding), K1 launched (iters + 1) times a solve on every rank,
     every rank's wire bytes a solve equal to wire_bytes_per_iter, and two
     planted faults rejected (a dropped graph round; fit_batch without its
     data sum); serve_dict's rank body at 1x4 over gloo_staged, 32
     samples, learning on: every code finite, some nonzero, the final
     dictionary a one-process replay of rank 0's fits, K1 per rank (iters
     + 1) x engine calls; serve_dict on a 1x1 mesh over nccl (its rank
     this process) bit for bit the run without a mesh (codes; the learned
     dictionary against its replay).  Times of the mesh beside the one
     process measure the transport and four contexts time-slicing the
     card;
   - sharded serving, in the same world (SERVE_MESH, serve_mesh_world /
     phase_serve_mesh): launch/serve's rank body (what --mesh runs) for
     gemma-2b at full width and depth on 2x2 and granite-moe-1b-a400m at
     full width and depth on 1x2 (ranks 0-1), the LM traffic, each held
     against its 1x1 serve above (the same argv and seed, saved by
     serve_mesh_reference): K2 launched once a layer on every rank, only
     at FA_SERVE_MESH on wgmma_tma; layer 0's prefill K/V and the cache
     laid from it bit for bit the 1x1's on every rank; each layer's decode
     attention (the cache sharded on its sequence, the parts combined by
     their log-sum-exp) and granite's MoE decode FFN (the experts sharded
     over `model`) on the 1x1 run's inputs within BF16_ROW_ULPS of its
     outputs, the cache after that step changed only in the owner's slot;
     the tokens and each teacher-forced step's greedy pick identical on
     every model rank; four planted faults rejected (the combine without
     its l e^(m_r - m) weights, the new K/V written on every rank, the
     argmax over the rank's own vocabulary shard, the MoE combine without
     its psum); the teacher-forced logits against the 1x1 steps, the
     greedy tokens' agreement, prefill ms, decode ms/token, a decode
     step's wire per axis and each rank's peak memory printed; then gemma
     cut to SERVE_MESH_NCCL_LAYERS on a 1x1 mesh over nccl (its rank this
     process) bit for bit the serve without a mesh (tokens, logits,
     cache); and granite-8b cut to FSDP_LAYERS on 2x2 with `embed` over
     `data`, FSDP_GEN greedy tokens, with the same gates against its 1x1
     serve (each layer's weights gathered before the per-layer checks),
     and a fifth planted fault, a layer's weights used without their
     gather (each shard zero-padded to the whole width), rejected; and
     zamba2 (2x2) and xlstm (1x2) at RECURRENT's cuts, REC_GEN greedy
     tokens, against their 1x1 serves (recurrent_serve_reference): K2
     and K3 per rank counted, every block's prefill on the 1x1 block's
     input (the residual after it and every leaf of its cache, the rank's
     part) and every mixer's decode step on the 1x1 inputs and state
     within BF16_ROW_ULPS, the first block's state in the serve's own
     prefill cache within BF16_ROW_ULPS of the 1x1's and laid into the
     decode cache bit for bit, the picks identical over `model`, zamba2's
     attention cache sharded on its sequence, a planted norm without its
     sum over `model` rejected; the teacher-forced and prefill logits and
     the first tokens printed;
   - VLM serving: the port's serve at phi-3-vision-4.2b's full width and
     depth (3.73e9 params, bf16), 4 prompts of 2048 tokens after 576
     image positions, VLM_GEN greedy tokens, a cache of 576 + 2048 +
     VLM_GEN positions: 32 K2 launches a prefill (gated), each layer's K2
     against plain on its own inputs (gated, a planted wrong attention
     rejected), the end-to-end logits against the plain-attention twin
     printed, the prefill and a decode step profiled (VLM_SERVE line);
   - VLM training: launch/train at phi-3-vision's full width cut to
     VLM_TRAIN_LAYERS layers, 4 x 2048 positions a step (the loss over
     the 1472 text tokens), the olmo path's gates: 2 K2 launches a layer
     a step, the first step against its plain-attention twin, the first
     replayed loss exact (VLM_TRAIN line);
   - the audio encoder: hubert-xlarge at full width (48 layers, 9.45e8
     params) encodes 4 x 2048 frames through model.prefill: 48 K2
     launches, every one non-causal, no cache, each layer's K2 against
     plain on its own inputs (a planted causal mask rejected), profiled
     (AUDIO_ENCODE line); then trained through launch/train, depth cut
     to AUDIO_TRAIN_LAYERS, with the olmo path's gates (AUDIO_TRAIN
     line);
   - both SMOKE configs on the card against the CPU: forward logits at
     1e-4, loss at 1e-5, three SGD steps (params 1e-4, losses 1e-5); two
     planted faults (the image tokens after the text, hubert's attention
     causal) rejected (VLM_AUDIO_CHECKS line);
   - hybrid serving: the port's serve at zamba2-1.2b's full width and
     depth (38 Mamba2 blocks, 6 applications of the weight-tied shared
     block; 1.10e9 params, bf16), the gemma path's traffic: exactly 6 K2
     launches a prefill and none in decode (gated), each application's K2
     against plain on its own inputs (gated, a planted wrong attention
     rejected), tokens in the vocabulary, logits, K/V and the Mamba2
     states finite, the end-to-end logits against the plain-attention
     twin printed, the prefill profiled by range (SSD, convolution, gated
     norm, unembedding) and by kernel category, a decode step profiled
     (HYBRID_SERVE line);
   - hybrid training: launch/train at zamba2-1.2b's full width cut to
     HYBRID_TRAIN_LAYERS (2 groups, so the tied block's gradient sums two
     applications), the olmo path's gates: 2 K2
     launches an application a step, the first step against its
     plain-attention twin (the loss gated, each application's attention
     gradient gated on its own inputs, the gradient leaves printed: the
     random-weight Mamba2 stack carries a rounding-sized change far), the
     first replayed loss exact (HYBRID_TRAIN line); then the SMOKE config
     cut to 5 layers on the card against the CPU in fp32: prefill logits
     and every cache leaf, three decode steps and the final cache at 1e-4,
     three SGD steps (losses 1e-5, params against an fp64 run of the same
     steps), two planted faults (the Mamba2 states without their decay,
     one layer's conv_b update skipped) rejected (HYBRID_CHECKS line);
   - xLSTM training: launch/train at xlstm-1.3b's full width cut to
     XL_TRAIN_LAYERS (2 groups: 14 mLSTM and 2 sLSTM blocks), XL_STEPS
     steps of 4 x 2048 tokens, a fault at XL_FAULT_AT, the rescale reload:
     exactly one K3 launch an sLSTM block a step (the mLSTM blocks under
     remat, the sLSTM block not, as JAX's), every replayed loss exact; in
     the first step each sLSTM block's K3 against plain on its own inputs
     (SL_TOL, a planted R transposed rejected) and the gradient the step
     computed against the exact one (SLSTM_GRAD_RTOL); the step against its
     plain-K3 twin printed, not gated (the random-weight stack amplifies
     noise); one step profiled; step ms, tokens/s, the model-flops share
     (the mLSTM's chunk products counted, no attention), peak memory and
     checkpoint seconds (XLSTM_TRAIN line).  Then the SMOKE config on the
     card against the CPU: the forward's loss 1e-5 (its logits against an
     fp64 forward printed), three SGD steps (losses 1e-5, params against
     an fp64 run), a backward without its dc carry rejected (XLSTM_CHECKS
     line);
   - xLSTM serving: the port's serve at xlstm-1.3b's full width, depth cut
     to XL_LAYERS (random weights), the same traffic; one slstm_seq launch
     per sLSTM block of the prefill (2) and none in decode.  Tokens in the vocabulary, logits
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
   launches; they run beside the build of phase 1), then the twins of
   examples/, each with its exact launches:
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
   - the experiment twins at EXPERIMENT_CUTS (table3_auc n_steps 1,
     fig5_denoise n_patches 150) on the card: every AUC in [0, 1], every
     PSNR finite and each denoised PSNR above the noisy one.
   - the twins of examples/, at the JAX scripts' sizes but for the depth
     TWIN_CUTS sets (quickstart 2 epochs, denoise_image 1000 patches,
     novel_docs 1 step, train_lm 2 of 12 layers): quickstart,
     denoise_image and novel_docs launch no kernel; graph_gossip and
     multi_pod run the port's coder, exactly iters + 1 K1 calls a solve;
     train_lm (LM_100M, fp32, 300 steps) exactly 2 K2 launches a layer a
     step and its loss falling by more than 1.0.  Every result finite
     (TWINS line).
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
import shutil
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
# tokens, then 16 greedy tokens (the mesh serves' decode loops over
# host-staged gloo take 0.34-0.46 s a step).  Its attention, one K2 launch
# per layer: (B, Hq, Hkv, S, T, D), bf16, causal.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma_2b", 4, 2048, 16
FA_MAIN = (LM_BATCH, 8, 1, LM_PROMPT, LM_PROMPT, 256)
# K2's bf16 head dims on its tensor-core kernel, wgmma_tma: one instance
# each in the build (D 80, 96 and 112 with a zero-filled tail chunk).
WGMMA_HEAD_DIMS = (64, 80, 96, 112, 128, 256)

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
# from 48 blocks to XL_LAYERS (2 groups: 14 mLSTM and 2 sLSTM blocks; 24
# before xLSTM training needed the room) to keep the whole script well
# inside its time limit, random weights from seed 0, the gemma path's
# traffic.  Its sLSTM recurrence, one K3 launch per sLSTM block: (B, S, D,
# H), bf16 x_proj and R.
XL_ARCH, XL_LAYERS = "xlstm_1p3b", 16
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
# K3's gradient (ops.SlstmSeq: K3 forward, backward.slstm_backward in plain
# PyTorch) against the exact gradient, autograd through slstm_seq_ref in
# fp64 on the same inputs widened, at SL_MAIN and at SL_GRAD_SMALL (S 1 and
# 2, a ragged batch of 5 rows: one full group of K3's 4 and one row), bf16
# x_proj and R.  Per gradient (dx_proj, dR, db) the largest |got - exact|
# beyond the rounding of the gradient to its dtype (bf16: 2^-8 |exact|),
# over the largest |exact|: the backward runs fp32 from K3's h, which is
# within SL_TOL of plain, so fp32 rounding over 2048 steps and K3's h leave
# some 1e-5; a wrong transpose, a dropped carry or a late h move a gradient
# by order 1.  Gate SLSTM_GRAD_RTOL.
SL_GRAD_SMALL = [(5, 1, 2048, 4), (5, 2, 2048, 4)]
SLSTM_GRAD_RTOL = 1e-3

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
# Timed solves per mode; only the first mode runs a warm solve before them:
# a later mode's first solve, on kernels and allocator blocks the earlier
# modes warmed, ran within 0.5 % of its second (on the H100 80GB HBM3 at
# 700 W: e.g. ring 1023.5 / 1023.9 ms, push 1091.5 / 1087.3).
GOSSIP_TIMED = 1

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
FLEET_SEED = 0  # serve_dict's --seed default: its W0, and the publish's draw at FLEET_SEED + 3
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
LEARN_MU_W, LEARN_STEPS, LEARN_DIFFUSION_STEPS, LEARN_K_TRUE = 0.1, 2, 2, 4096
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
# 7.7 GB of state; at 4 layers, on an H100 80GB HBM3 at 700 W, the first
# step's gradient leaves part from the plain twin by 0.0191 of their
# largest, past the depth-scaled gate of 4 x 2^-8, so the depth stays),
# random weights from seed 0, batches of TRAIN_BATCH x TRAIN_SEQ tokens
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
# MOE_FAULT_AT, the rescale reload, with the depth cut to MOE_TRAIN_LAYERS
# (full depth until xLSTM training needed the room: 100.2 s of the script,
# its 16.0 GB state written twice and read twice; 12 layers until the
# sharded phase needed it, 6 until DICT_MESH did, 4 until the
# sequence-parallel checks did: its gates do not scale with depth).  Its
# attention: one K2
# launch a layer a prefill, two a layer a step; FA_MOE, bf16, causal, on
# wgmma_tma.  It
# dispatches 16 groups of 512 tokens, 160 places an expert a group; a
# decode step one group of 4 tokens, 1 place.
MOE_ARCH = "granite_moe_1b_a400m"
MOE_STEPS, MOE_CKPT_EVERY, MOE_FAULT_AT, MOE_TRAIN_LAYERS = 8, 4, 6, 2
FA_MOE = (LM_BATCH, 16, 8, LM_PROMPT, LM_PROMPT, 64)
# kimi-k2-1t-a32b at full width (d 7168, 64 query heads over 8 KV heads of
# 112, 384 experts top-8 of d_ff 2048 and one shared expert, a dense first
# layer of d_ff 18432, vocab 163840; bf16 params), depth cut from 61 layers
# to KIMI_LAYERS (the dense first layer and one MoE layer: 1.88e10 params,
# 37.5 GB), the gemma path's prompts, KIMI_GEN greedy tokens.  Its
# attention at head dim 112: FA_KIMI on wgmma_tma (a zero-filled tail chunk).
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

# The VLM family: phi-3-vision-4.2b at full width (a phi3-mini backbone of
# 32 layers, d 3072, 32 heads of 96 (MHA), d_ff 8192, vocab 32064; the
# CLIP front end a stub: 576 precomputed patch embeddings of 1024 through
# the 2-layer projector, before the text; fp32 params, bf16 compute;
# 3.73e9 params, 7.5 GB cast to bf16), random weights from seed 0.  Served
# at full depth: LM_BATCH prompts of LM_PROMPT tokens after the 576 image
# positions, VLM_GEN greedy tokens, a cache of 576 + 2048 + VLM_GEN
# positions; one K2 launch a layer a prefill at FA_VLM, bf16, causal, on
# wgmma_tma (D 96).  Trained through launch/train with depth cut to
# VLM_TRAIN_LAYERS (params, gradients and AdamW's moments at full depth
# are some 60 GB): TRAIN_BATCH x TRAIN_SEQ positions a step (576 image
# positions and 1472 text tokens, the loss over the text), VLM_STEPS
# steps, a checkpoint every VLM_CKPT_EVERY, a fault at VLM_FAULT_AT; two K2
# launches a layer a step at FA_VLM_TRAIN.
VLM_ARCH, VLM_GEN, VLM_IMG = "phi3_vision_4p2b", 8, 576
VLM_TRAIN_LAYERS, VLM_STEPS, VLM_CKPT_EVERY, VLM_FAULT_AT = 4, 6, 3, 4
FA_VLM = (LM_BATCH, 32, 32, VLM_IMG + LM_PROMPT, VLM_IMG + LM_PROMPT, 96)
FA_VLM_TRAIN = (TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 96)
# The audio-encoder family: hubert-xlarge at full width (48 layers, d 1280,
# 16 heads of 80, d_ff 5120, GELU, 504 cluster targets through an untied
# head, non-causal; the conv waveform front end a stub: precomputed frame
# features of 512 through one projection; fp32 params, bf16 compute; 9.45e8
# params), random weights from seed 0.  One encode (model.prefill) of
# LM_BATCH x LM_PROMPT frames from audio_batches: one non-causal K2 launch
# a layer at FA_AUDIO (wgmma_tma, D 80); then trained through
# launch/train (masked prediction over TRAIN_BATCH x TRAIN_SEQ frames),
# AUDIO_STEPS steps, a checkpoint every AUDIO_CKPT_EVERY, a fault at
# AUDIO_FAULT_AT, with the depth cut from 48 layers to AUDIO_TRAIN_LAYERS
# to keep the whole script well inside its time limit (at 48 layers the
# phase took 75.9 s and the script 1094.2 s of its 1200; at 24, 38.9 s and
# 1162.0 with xLSTM training; 12 until the sharded phase needed the room,
# 6 until DICT_MESH did).
AUDIO_ARCH, AUDIO_TRAIN_LAYERS = "hubert_xlarge", 4
AUDIO_STEPS, AUDIO_CKPT_EVERY, AUDIO_FAULT_AT = 4, 2, 3
FA_AUDIO = (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 80)
# The first training step's gradient against its plain-attention twin,
# per leaf, for these two families: GRAD_BF16_TOL (what one attention's
# bf16 gradient may differ by, the K2-gradient gate) + L x 2^-8 (the
# residual stream's rounding, the olmo phase's rule, which its 8 layers
# are held to alone).  A leaf's difference does not grow with depth as L x
# 2^-8 does: it read 0.0141 at phi-3's 4 layers, 0.0156 at hubert's 48,
# 0.0254 at olmo's 8 (my chip runs), so at 4 layers L x 2^-8 (0.0156) alone
# would sit on the reading.  A gradient without the Function or without
# the causal mask moves a leaf by order 1.
TWIN_GRAD_FLOOR = GRAD_BF16_TOL

# The twins of examples/ and of experiments/ are plain PyTorch loops over
# small matrices (train_lm excepted), bound by the host, whose speed varies
# by a third from machine to machine: each runs at the JAX script's sizes
# but cut in depth (epochs, patches, time steps, train steps) to keep the
# script inside its limit on a slow host.  Every check is kept.  train_lm
# keeps the script's 300 steps (at 100 its loss fell only 7.41 -> 6.79,
# short of the twin's gate, a fall of more than 1.0: the cosine schedule
# is set by the steps) and is cut to 2 of LM_100M's 12 layers instead (4
# until DICT_MESH needed the room).  novel_docs 2 -> 1 step and fig5_denoise
# 300 -> 150 patches paid for SERVE_MESH.
TWIN_CUTS = {"quickstart": {"epochs": 2}, "denoise_image": {"n_patches": 1000},
             "novel_docs": {"n_steps": 1}, "graph_gossip": {}, "multi_pod": {},
             "train_lm": {"n_layers": 2}}
TWIN_LM_STEPS = 300  # train_lm.run's default
EXPERIMENT_CUTS = {"table3_auc": {"n_steps": 1}, "fig5_denoise": {"n_patches": 150}}

# The hybrid family: zamba2-1.2b at full width (38 Mamba2 blocks of d 2048,
# d_inner 4096, 64 SSM heads of 64, state 64, chunk 128: 6 groups of 6,
# each followed by one application of the weight-tied shared transformer
# block, 32 heads of 64 (MHA), d_ff 8192; then a 2-block tail; vocab 32000;
# fp32 params, bf16 compute; 1.10e9 params), random weights from seed 0.
# Served at full depth with the gemma path's traffic: one K2 launch an
# application a prefill (6) at FA_HYBRID, bf16, causal, on wgmma_tma (D
# 64), none in decode (plain flash_decode).  Trained through launch/train
# with the depth cut to HYBRID_TRAIN_LAYERS: 2 groups (the tied block's
# gradient sums two applications; the 2-block tail runs in serving, at
# full depth), TRAIN_BATCH x
# TRAIN_SEQ tokens a step, HYBRID_STEPS steps, a checkpoint every
# HYBRID_CKPT_EVERY, a fault at HYBRID_FAULT_AT; two K2 launches an
# application a step (forward and remat recompute).  The SSD is plain
# PyTorch, as it is plain jnp in the JAX package (no kernel is owed).
HYBRID_ARCH, HYBRID_TRAIN_LAYERS = "zamba2_1p2b", 12
HYBRID_STEPS, HYBRID_CKPT_EVERY, HYBRID_FAULT_AT = 4, 2, 3
FA_HYBRID = (LM_BATCH, 32, 32, LM_PROMPT, LM_PROMPT, 64)

# xLSTM training: launch/train at xlstm-1.3b's full width (above), depth cut
# from 48 blocks to XL_TRAIN_LAYERS: 2 groups, 14 mLSTM and 2 sLSTM blocks,
# the least depth at which one sLSTM block's input gradient flows into
# another's parameters (6.7e8 params, 8.1 GB of state); TRAIN_BATCH x
# TRAIN_SEQ tokens a step, XL_STEPS steps, a checkpoint every XL_CKPT_EVERY,
# a fault at XL_FAULT_AT.  The mLSTM blocks run under remat, the sLSTM
# block does not (as JAX's forward): one K3 launch an sLSTM block a step,
# its gradient the plain BPTT backward.
XL_TRAIN_LAYERS, XL_STEPS, XL_CKPT_EVERY, XL_FAULT_AT = 16, 4, 2, 3


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


def phase_build(say=print):
    """Builds every kernel; returns the evidence that K2's bf16 kernel runs on
    the tensor cores (its ptxas registers and spills and its HGMMA count in
    the SASS of the built library, per instantiation: bf16 at D 64, 80, 96,
    112, 128 and 256) and K3's ptxas report per instantiation (every one a
    cluster kernel, none may spill); prints K2's scalar_fp32 ptxas report
    by (D, type) (fp32 at every D, bf16 at 16 and 32).  Its lines go to
    `say` (main() prints them after the phases that run beside the build)."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    say(f"[build] {len(logs)} kernel(s) built for sm_90a in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "cached" in line:
                say(f"[build] {name}: {line.strip()}")
    ptxas = ptxas_report(logs["flash_attention"])
    hgmma = sass_counts(build.library_path("flash_attention"), "HGMMA")
    wgmma = {fn: {"d": int(fn.split("flash_attention_wgmmaILi")[1].split("E")[0]), "hgmma": n,
                  **ptxas.get(fn, {})}
             for fn, n in hgmma.items() if "flash_attention_wgmma" in fn}
    say(f"[build] flash_attention wgmma_tma kernels (HGMMA in SASS, ptxas): {wgmma}")
    scalar = {fn.split("flash_attention_kernelI")[1].split("EEv")[0]: r
              for fn, r in ptxas.items() if "flash_attention_kernelI" in fn}
    say(f"[build] flash_attention scalar_fp32 kernels by (D, type) (ptxas): {scalar}")
    if sorted(r["d"] for r in wgmma.values()) != sorted(WGMMA_HEAD_DIMS) \
            or min(r["hgmma"] for r in wgmma.values()) == 0:
        raise AssertionError(f"the wgmma_tma kernels (D = {WGMMA_HEAD_DIMS}) lack HGMMA in "
                             f"their SASS: {wgmma}")
    if logs["flash_attention"] != "cached":
        if any(r.get("spill_bytes") for r in wgmma.values()):
            raise AssertionError("a wgmma_tma kernel spills registers")
        # ptxas's C7511/C7514/C7515 notes: it made every wgmma wait for the
        # one before (C7511 for "insufficient register resources").
        serialized = [line for line in logs["flash_attention"].splitlines()
                      if "wgmma.mma_async instructions are serialized" in line]
        if serialized:
            raise AssertionError(f"ptxas serialized the wgmma_tma kernels: {serialized}")
    slstm = ptxas_report(logs["slstm_step"])
    say(f"[build] slstm_step cluster kernels (ptxas: registers, stack frame, spills): "
          f"{slstm if slstm else 'cached'}")
    import torch

    from repro_torch.kernels.slstm_step import ops as sl_ops

    b, _, d, h = SL_MAIN
    say(f"[build] slstm_step plan at the main shape (cudaOccupancyMaxActiveClusters: "
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
    rec["per_rank"] = k1_per_rank(torch)
    return rec


def k1_per_rank(torch) -> dict:
    """K1 at the block one rank of a mesh holds (DICT_MESH: one agent a
    rank, (1, M, ATOMS_PER_AGENT), B = MICRO_BATCH) against its plain
    version on the same inputs (the main shape's gates), timed, with its
    CTAs per pass and its bound; printed, and not held to the 128-CTA
    floor of the main shape (one agent launches 1/16 of its CTAs)."""
    from repro_torch.kernels.dict_dual_step import ops, ref

    shape = (1, M, ATOMS_PER_AGENT, MICRO_BATCH)
    n, m, kb, b = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    W = torch.randn(n, m, kb, device="cuda", generator=gen)
    W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
    nu = torch.randn(n, b, m, device="cuda", generator=gen)
    y, g = ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)
    yr, gr = ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)
    y_tol = 1e-4 * float(torch.matmul(nu, W).abs().max()) / DELTA
    y_err, g_rel = max_err(y, yr), max_err(g, gr) / float(gr.abs().max())
    if not (y_err <= y_tol and g_rel <= 1e-4):
        raise AssertionError(f"dict_dual_step at a rank's block {shape}: max|dY| {y_err}, "
                             f"max|dG|/max|G| {g_rel}")
    del y, g, yr, gr

    def kernel():
        return ops.dict_dual_step(W, nu, gamma=GAMMA, delta=DELTA)

    def plain():
        return ref.dict_dual_step_ref(W, nu, gamma=GAMMA, delta=DELTA)

    k1, p1, p2, k2 = (time_ms(torch, kernel, 20), time_ms(torch, plain, 5),
                      time_ms(torch, plain, 5), time_ms(torch, kernel, 20))
    nbytes = 4 * (n * m * kb + 2 * n * b * m + n * b * kb)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = 4 * n * b * m * kb / FP32_FLOPS_PER_S * 1e3
    out = {"shape": list(shape), "grid": list(ops.ctas(*shape)), "ms": (k1 + k2) / 2,
           "plain_ms": (p1 + p2) / 2, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "max_abs_err": y_err}
    print(f"[kernels] dict_dual_step at a rank's block {shape} (DICT_MESH): CTAs per pass "
          f"{out['grid']}, kernel_ms {k1:.4f} {k2:.4f}  plain_ms {p1:.4f} {p2:.4f}  bound_ms "
          f"{out['bound_ms']:.4f} ({out['bound_by']})")
    del W, nu
    torch.cuda.empty_cache()
    return out


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
                          ((1, 8, 1, 640, 640, 256), False), ((2, 4, 2, 1000, 1000, 80), True),
                          ((1, 8, 1, 300, 1000, 96), True), ((2, 4, 2, 200, 333, 112), False)]:
        q, k, v = qkv(*shape, dtype=torch.bfloat16)
        check_bf16(f"bf16 {shape} causal={causal}", ops.flash_attention(q, k, v, causal=causal),
                   ref.attention_ref(q, k, v, causal=causal))
    for d in (256, 80):
        q, k, v = (torch.nn.functional.pad(x, (0, 4))[..., :d]
                   for x in qkv(1, 8, 1, 200, 200, d, dtype=torch.bfloat16))
        check_bf16(f"bf16 seq stride {d + 4}", ops.flash_attention(q, k, v, causal=True),
                   ref.attention_ref(q, k, v, causal=True))
    # D 80, 96, 112 (a zero-filled tail chunk) on the model's (B, S, H, D)
    # layout, where columns D .. 127 of head h are head h + 1's: each head
    # held on its own, so a store past D fails.
    for d in (80, 96, 112):
        for causal in (True, False):
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in qkv(2, 8, 2, 300, 333, d, dtype=torch.bfloat16))
            out = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            for h in range(q.shape[1]):
                check_bf16(f"bf16 (B, S, H, D) D {d} head {h} causal={causal}", out[:, h],
                           want[:, h])
    torch.cuda.synchronize()
    print("[kernels] flash_attention's wgmma_tma kernel agrees with plain at D = 64, 80, 96, "
          "112, 128, 256 (ragged, T > S, non-causal, copied 4-mod-8 strides; D 80, 96, 112 "
          "head by head on the (B, S, H, D) layout)")

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
    backward's readings and times for K2's record, and (its `forward`) the
    forward's reading, times and bound at FA_TRAIN."""
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

    def no_mask(qq, kk, vv, dd, *, causal, scale):
        return backward.attention_backward(qq, kk, vv, dd, causal=False, scale=scale)

    planted = {"wrapper without the Function":
               grad_readings(autograd_grads(torch, no_function, q, k, v, do), want)}
    for name, target, attr, fault in (
            ("backward without the causal mask", ops, "attention_backward", no_mask),
            ("backward without the D term", backward, "softmax_grad", lambda p, dp: dp.mul_(p))):
        with mock.patch.object(target, attr, fault):
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
        return backward.attention_backward(q, k, v, do, causal=True, scale=scale)

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
    nbytes = 2 * (3 * b * hq * s * d + 4 * b * hkv * t * d)  # q, dO, dq; k, v, dk, dv
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

    # K2's forward alone here (D 128, wgmma_tma), the olmo path's 16
    # launches a step, against plain and beside SDPA.
    def fwd_kernel():
        return ops.flash_attention(q, k, v, causal=True)

    def fwd_plain():
        return ref.attention_ref(q, k, v, causal=True)

    def fwd_library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    fwd_reading = check_bf16(f"K2 forward at {FA_TRAIN}", out, fwd_plain())
    f1, fp1, fl1, fl2, fp2, f2 = (time_ms(torch, fn, reps) for fn in
                                  (fwd_kernel, fwd_plain, fwd_library, fwd_library, fwd_plain,
                                   fwd_kernel))
    fwd_flops, fwd_bytes, fwd_bound, fwd_by = attention_bound(*FA_TRAIN)
    rec["forward"] = {
        "variant": ops.library_variant(torch.bfloat16, d),
        "grid": ops.ctas(b, hq, s, torch.bfloat16, d), "bf16_reading": fwd_reading,
        "ms": (f1 + f2) / 2, "plain_ms": (fp1 + fp2) / 2, "library_ms": (fl1 + fl2) / 2,
        "bound_ms": fwd_bound, "bound_by": fwd_by, "flops": fwd_flops, "bytes": fwd_bytes,
    }
    print(f"[kernels] flash_attention forward ({rec['forward']['variant']}, "
          f"{rec['forward']['grid']} CTAs) at {FA_TRAIN} bf16 causal: reading {fwd_reading:.3f}"
          f"  kernel_ms {f1:.3f} {f2:.3f}  plain_ms {fp1:.3f} {fp2:.3f}  sdpa_ms {fl1:.3f} "
          f"{fl2:.3f}  bound_ms {fwd_bound:.4f} ({fwd_by})")
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

    # A rank's sLSTM on a data axis of 2 (SL_RANK: RECURRENT's 2x2 runs and
    # SERVE_MESH's xlstm 1x2 prefill): against plain, timed beside it.
    rb, rs, rd, rh = SL_RANK
    xp, R, bias = inputs(rb, rs, rd, rh, torch.bfloat16, p ** -0.5, model_bias)
    hk, sk = ops.slstm_seq(xp, R, bias)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    hp, sp = ref.slstm_seq_ref(xp, R, bias)  # timed here, warm from the main shape's
    end.record()
    torch.cuda.synchronize()
    p1 = start.elapsed_time(end)
    rank_readings = slstm_readings(hk, sk, hp, sp)
    if not max(rank_readings.values()) <= SL_TOL:
        raise AssertionError(f"slstm_seq disagrees with plain at {SL_RANK}: {rank_readings}")
    k1, k2 = time_ms(torch, kernel, 5), time_ms(torch, kernel, 5)
    flops = 2 * 4 * rb * rd * p * rs
    nbytes = (xp.numel() * xp.element_size() + R.numel() * R.element_size()
              + 4 * bias.numel() + 4 * (rs * rb * rd + 3 * rb * rd))
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    rkind, rplan = ops.variant(torch.bfloat16, rb, p, rh)
    rec["per_rank_shape"] = {
        "shape": list(SL_RANK), "variant": rkind, "ctas": rplan["ctas"],
        "clusters": rplan["clusters"], "readings": rank_readings,
        "max_abs_err": rank_readings["h"], "ms": (k1 + k2) / 2, "plain_ms": p1,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations", "library_ms": None}
    print(f"[kernels] slstm_seq ({rkind}, {rplan['clusters']} clusters) at a rank's (B, S, D, H) "
          f"{SL_RANK} bf16: readings {rank_readings} (gate {SL_TOL}); kernel_ms {k1:.3f} {k2:.3f}"
          f"  plain_ms {p1:.3f}  bound_ms {rec['per_rank_shape']['bound_ms']:.4f} "
          f"({rec['per_rank_shape']['bound_by']}: {flops:.3e} flops, {nbytes:.3e} bytes)")
    del xp, R, bias, hk, sk, hp, sp
    torch.cuda.empty_cache()
    return rec


def slstm_exact_grads(torch, x_proj, R, b, dh):
    """(dx_proj, dR, db) of h by autograd through ref.slstm_seq_ref in fp64
    on the inputs widened: the exact gradient."""
    from repro_torch.kernels.slstm_step import ref

    args = [t.detach().double().requires_grad_(True) for t in (x_proj, R, b)]
    h, _ = ref.slstm_seq_ref(*args)
    return torch.autograd.grad(h, args, dh.double())


def slstm_grad_reading(got, exact) -> float:
    """max |got - exact| / max |exact| beyond the rounding of the gradient
    to its dtype (bf16's unit roundoff, 2^-8 |exact| per element; none for
    fp32); 0 for an exact gradient of 0 that got matches, inf if anything is
    off there or not finite."""
    g, e = got.double(), exact.double()
    allow = BF16_UNIT_ROUNDOFF if str(got.dtype) == "torch.bfloat16" else 0.0
    excess = ((g - e).abs() - allow * e.abs()).clamp_min(0)
    scale = float(e.abs().max())
    if scale == 0.0:
        return 0.0 if float(g.abs().max()) == 0.0 else math.inf
    r = float(excess.max()) / scale
    return r if math.isfinite(r) else math.inf


def slstm_grad_readings(torch, x_proj, R, b, dh, exact=None) -> dict:
    """K3's gradient through its Function (slstm_seq under grad: K3 forward,
    backward.slstm_backward) against the exact gradient: {dx_proj, dR, db:
    slstm_grad_reading}."""
    from repro_torch.kernels.slstm_step import ops

    args = [t.detach().requires_grad_(True) for t in (x_proj, R, b)]
    h, _ = ops.slstm_seq(*args)
    got = torch.autograd.grad(h, args, dh)
    exact = exact if exact is not None else slstm_exact_grads(torch, x_proj, R, b, dh)
    return {name: slstm_grad_reading(g, e) for name, g, e in zip(("dx_proj", "dR", "db"), got,
                                                                 exact)}


def phase_slstm_grad(torch):
    """K3's gradient (ops.SlstmSeq: K3 forward, the plain BPTT backward)
    against the exact gradient (autograd through slstm_seq_ref in fp64 on
    the same inputs widened) at SL_MAIN and SL_GRAD_SMALL in bf16, each of
    dx_proj, dR and db within SLSTM_GRAD_RTOL; three planted faults of the
    backward rejected at SL_MAIN (R not transposed in the recurrent term,
    the dc carry dropped, h_{t-1} read one step late); the backward timed
    beside K3 + the Function and autograd through the plain recurrence
    (fp32), with its bound.  Returns the record K3's gets as `backward`
    (without `launches_per_step`, which XLSTM_TRAIN fills in)."""
    from repro_torch.kernels.slstm_step import backward, ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, s, d, h):
        p = d // h
        xp = torch.randn(4, s, b, d, generator=gen, device=dev).bfloat16()
        R = (torch.randn(4, h, p, p, generator=gen, device=dev) * p ** -0.5).bfloat16()
        bias = torch.tensor([0.0, 3.0, 0.0, 0.0], device=dev)[:, None].repeat(1, d)
        bias = bias + 0.1 * torch.randn(4, d, generator=gen, device=dev)
        dh = torch.randn(s, b, d, generator=gen, device=dev)
        return xp, R, bias, dh

    readings = {}
    for shape in SL_GRAD_SMALL:
        readings[str(shape)] = slstm_grad_readings(torch, *inputs(*shape))
    b, s, d, h = SL_MAIN
    xp, R, bias, dh = inputs(*SL_MAIN)
    exact = slstm_exact_grads(torch, xp, R, bias, dh)
    readings[str(SL_MAIN)] = slstm_grad_readings(torch, xp, R, bias, dh, exact)

    def late(hs):  # h_{t-2} where h_{t-1} belongs
        return torch.cat([torch.zeros_like(hs[:2]), hs[:-2]])

    def untransposed(Rf):
        return Rf.permute(1, 0, 2, 3).reshape(Rf.shape[1], 4 * Rf.shape[2], Rf.shape[3])

    def no_dc(dcn, f_s):
        out = dcn.mul_(f_s)
        out[:, :, 0] = 0.0
        return out

    faults = {"R not transposed in the recurrent term": ("transposed", untransposed),
              "the dc carry dropped": ("carried", no_dc),
              "h_{t-1} read one step late": ("previous", late)}
    planted = {}
    for name, (attr, fn) in faults.items():
        with mock.patch.object(backward, attr, fn):
            planted[name] = slstm_grad_readings(torch, xp, R, bias, dh, exact)
    del exact
    print(f"[kernels] slstm_seq gradient (K3 forward, plain backward) vs autograd through the "
          f"plain recurrence in fp64, max|d|/max|exact| beyond the bf16 rounding (gate "
          f"{SLSTM_GRAD_RTOL}): {readings}; planted faults at {SL_MAIN}: {planted}")
    if not max(max(r.values()) for r in readings.values()) <= SLSTM_GRAD_RTOL:
        raise AssertionError(f"slstm_seq's gradient disagrees with the exact one: {readings}")
    for name, r in planted.items():
        if max(r.values()) <= SLSTM_GRAD_RTOL:
            raise AssertionError(f"the slstm_seq gradient gate passes a planted fault: {name}")

    # Timed at SL_MAIN: the backward alone (on K3's h), K3 + the Function's
    # backward, and autograd through the plain recurrence (fp32), in turns.
    h_k, _ = ops.slstm_seq(xp, R, bias)
    args = [t.detach().requires_grad_(True) for t in (xp, R, bias)]

    def bwd():
        return backward.slstm_backward(xp, R, bias, h_k, dh)

    def function():
        return torch.autograd.grad(ops.slstm_seq(*args)[0], args, dh)

    def plain():
        return torch.autograd.grad(ref.slstm_seq_ref(*args)[0], args, dh)

    # (the plain version, some 10x slower, once)
    b1, f1, p1, f2, b2 = (time_ms(torch, bwd, 2), time_ms(torch, function, 2),
                          time_ms(torch, plain, 1), time_ms(torch, function, 2),
                          time_ms(torch, bwd, 2))
    flops = backward.backward_flops(b, s, d, h)
    nbytes = (xp.numel() * xp.element_size() * 2 + R.numel() * R.element_size() * 2
              + 4 * bias.numel() * 2 + 4 * 2 * s * b * d)  # x_proj, R, b in and out; h, dh
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    rec = {
        "route": "plain PyTorch (BPTT)",
        "source": "src/repro_torch/kernels/slstm_step/backward.py",
        "shape": list(SL_MAIN),
        "ms": (b1 + b2) / 2,
        "function_ms": (f1 + f2) / 2,  # K3 forward + the backward, through autograd
        "plain_ms": p1,  # autograd through slstm_seq_ref, forward + backward
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "readings": readings, "tol": SLSTM_GRAD_RTOL, "planted_faults": planted,
    }
    print(f"[kernels] slstm_seq backward at (B, S, D, H) {SL_MAIN} bf16: backward_ms {b1:.1f} "
          f"{b2:.1f}  K3 + Function (forward and backward) {f1:.1f} {f2:.1f}  autograd through "
          f"plain (fp32) {p1:.1f}  bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}: "
          f"{flops:.3e} flops, {nbytes:.3e} bytes)")
    del xp, R, bias, dh, h_k, args
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
    for i, (label, cfg, agents) in enumerate(GOSSIP_CASES):
        coder = DistributedSparseCoder(agents, res, reg, DistConfig(iters=ITERS, **cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        secs, warm = [], int(i == 0)
        for _ in range(warm + GOSSIP_TIMED):
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
            "ms_per_solve": 1e3 * sum(secs[warm:]) / GOSSIP_TIMED,
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


def fleet_w0(torch):
    """The fleet's W0 on the host, as serve_dict makes it at --seed
    FLEET_SEED (init_dictionary on the card, blocks_from_full, host_full):
    main() draws the fleet's publish dictionary from it ahead,
    serve_dict.perturbed(W0, FLEET_SEED + 3, nonneg False), what the
    rolling publish installs (0.01 N(0, 1) from numpy, 40-80 s of the host
    at this size)."""
    from repro_torch.core.dictionary import blocks_from_full, init_dictionary
    from repro_torch.launch import serve_dict

    gen = torch.Generator(device="cuda").manual_seed(FLEET_SEED)
    W0 = serve_dict.host_full(blocks_from_full(
        init_dictionary(gen, M, ATOMS_PER_AGENT * N_AGENTS, device="cuda"), N_AGENTS))
    torch.cuda.empty_cache()
    return W0


def phase_fleet(torch, card: str, stream, publish):
    """serve_dict --replicas 2 --publish-at FLEET_PUBLISH_AT (graph) at the
    production dictionary: every sample coded, none failed, one rolling
    publish reaching both replicas; a batch re-solved on r0's final
    snapshot with K1 against plain.  `publish` is (fleet_w0's W0, the
    future of its publish dictionary drawn ahead): the run's publish takes
    that draw when its W0 is that one (else it draws its own, and the line
    says so).  Returns K1's launches."""
    import numpy as np

    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict

    W0_ahead, W1_ahead = publish
    ahead = []

    def perturbed(W0, seed, nonneg):
        if seed == FLEET_SEED + 3 and not nonneg and np.array_equal(W0, W0_ahead):
            ahead.append(True)
            return W1_ahead.result()
        ahead.append(False)
        return serve_dict.perturbed(W0, seed, nonneg)

    argv = ["--mode", "graph", "--m", str(M), "--atoms-per-agent", str(ATOMS_PER_AGENT),
            "--mesh", f"1x{N_AGENTS}", "--samples", str(SAMPLES), "--micro-batch",
            str(MICRO_BATCH), "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta",
            str(DELTA), "--device", "cuda", "--json", "--replicas", "2", "--publish-at",
            str(FLEET_PUBLISH_AT)]
    with mock.patch.object(serve_dict, "sparse_stream", stream), \
            mock.patch.object(serve_dict, "perturbed", perturbed):
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
           "resolve_rel_err": {"nu": nu_err, "y": y_err}, "publish_drawn_ahead": ahead == [True]}
    print(f"[fleet] {card}: {pay['agg_samples_per_s']:.4f} samples/s over 2 replicas  p50 "
          f"{lat['p50']:.1f} ms  p99 {lat['p99']:.1f} ms  wall {pay['wall_s']:.1f} s  routed "
          f"{pay['routed']}  publish {pay['publish_versions']} (waited "
          f"{out['publish_s']['draw_wait']:.1f} s for the host's draw, "
          f"{'drawn beside the build' if ahead == [True] else 'drawn in this run'}; installed in "
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
    ms)] largest first).  Only device activity is traced (the CPU
    operators' rows would repeat their kernels' device time), and the
    kernels are summed by name straight from the trace's events: the
    per-event objects of key_averages() took 19 s for the some 45k
    launches of an xlstm-1.3b step (56 s with CPU activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            totals[e.name()] = totals.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return wall_ms, sorted(totals.items(), key=lambda r: -r[1])


def device_profile(torch, fn, top: int = 6):
    """profile_rows as (host wall ms, device kernel ms summed, [(kernel, ms)]
    of the `top` largest)."""
    wall_ms, rows = profile_rows(torch, fn)
    return wall_ms, sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:top]]


# Kernel names of a train step by what launched them, first match wins:
# K2; K3; fp32 GEMMs (SIMT sgemm: attention_backward's einsums and the fp32
# unembedding); bf16 GEMMs (cuBLAS's nvjet / xmma: the projections and the
# MLP); softmax; everything else (norms, rotary, SwiGLU, casts, the
# optimizer's elementwise passes, reductions, copies).
STEP_CATEGORIES = (("K2 forward", ("flash_attention",)),
                   ("K3 forward", ("slstm_cluster",)),
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


# SERVE_MESH (serve_mesh_world, phase_serve_mesh): launch/serve's rank body
# (`serve._serve_ranks`, what --mesh runs) in the SHARDED phase's world of 4
# ranks sharing the card over gloo_staged, the LM traffic: gemma-2b at full
# width and depth on 2x2 (the world's mesh) and granite-moe-1b-a400m at
# full width and depth on 1x2 (ranks 0-1), each held against its 1x1 serve
# in this process (phase_lm's and phase_moe_serve's runs, the same argv and
# seed), which serve_mesh_reference saves under SERVE_MESH_DIR; then gemma
# cut to SERVE_MESH_NCCL_LAYERS on a 1x1 mesh over nccl (its rank this
# process) against the serve without a mesh, bit for bit.  K2 on each rank
# at FA_SERVE_MESH: (B / D, Hq / M, Hkv (whole for gemma's one kv head, / M
# for granite's eight), S, T, D).
SERVE_MESH_DIR = ROOT / "build" / "chip_smoke_serve_mesh"
SERVE_MESH_NCCL_LAYERS = 2
# Teacher-forced decode steps past the first whose greedy input differs
# from the 1x1 run's (before it, the greedy steps are the forced ones).
SERVE_MESH_FORCED = 8

# FSDP of `embed` over `data` (cfg.fsdp_embed), and the two dense archs at
# head dim 128 that no other phase runs.  granite-8b (36 layers, d 4096, 32
# query heads over 8 kv heads of 128, d_ff 14336, vocab 49152; 8.05e9
# params: 32.2 GB fp32, 16.1 GB cast to bf16) is served at 1x1 at full
# width and depth, GRANITE8B_GEN greedy tokens; qwen3-32b (64 layers, d
# 5120, 64 query heads over 8 kv heads of 128, d_ff 25600, vocab 151936,
# qk-norm; 3.20e10 params, 128 GB fp32, more than the card) at full width
# cut to QWEN_LAYERS (8.58e9 params, 34.3 GB fp32), QWEN_GEN tokens.  Then
# granite-8b at full width cut to FSDP_LAYERS on the SHARDED world's 2x2
# mesh with `embed` over `data` (every rank draws the whole global tree
# first, four copies on the card: hence the cut): launch/train's rank body
# for FSDP_STEPS steps (AdamW, for_arch's choice) against the same run on
# one device, one SGD step's update (its gradient) leaf by leaf against one
# device's (fsdp_sgd_step: AdamW's updates hardly see the gradient's
# scale), one Adafactor update on its FSDP-sharded embedding table and
# a layer against the whole leaves' update, and launch/serve's rank body
# (SERVE_MESH's "granite8b" case, FSDP_GEN greedy tokens; a decode step
# gathers every layer's weights over `data`) against its 1x1 serve.  K2 at
# FA_GRANITE8B, FA_QWEN32B and the 2x2 runs' per-rank FA_FSDP_RANK.
# kimi-k2's FSDP path (a2a with its experts FSDP-sharded, the int8 wire,
# Adafactor) runs on the CPU only: one of its MoE layers is 33.8 GB of
# bf16, and four ranks' gathers of it do not fit the card.
FSDP_ARCH, QWEN_ARCH = "granite_8b", "qwen3_32b"
GRANITE8B_GEN, QWEN_LAYERS, QWEN_GEN = 4, 16, 4
FSDP_LAYERS, FSDP_STEPS, FSDP_GEN = 2, 3, 2
FA_GRANITE8B = (LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128)
FA_QWEN32B = (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 128)
FA_FSDP_RANK = (LM_BATCH // 2, 16, 4, LM_PROMPT, LM_PROMPT, 128)
# AdamW at 2x2 against one device: m_hat / sqrt(v_hat) maps a gradient of
# any size to about +-1, so an element whose gradient is rounding-sized
# (the bf16 partial sums of TP and DP, summed in another order) may take
# the other sign, and its update parts from the 1x1 run's by up to twice
# the summed lr: the per-leaf max reading is order 1 whatever the path.
# Gated instead: at most FSDP_ADAMW_SHARE of any leaf's elements part by
# more than ADAMW_FLIP x the summed lr (a gradient summed over the wrong
# ranks or cut to the wrong chunk parts half of them).
FSDP_ADAMW_SHARE = 1e-2
# Adafactor on the card, the sharded update against the whole leaves'
# (fp32 means summed in another order), max |d| / max |whole| per leaf.
FSDP_ADAFACTOR_RTOL = 1e-5

# The hybrid and xlstm families on a mesh (RECURRENT, in the SHARDED
# world): zamba2-1.2b cut to one group (6 Mamba2 blocks and one
# application of the shared attention block) and xlstm-1.3b cut to one
# group (7 mLSTM blocks and one sLSTM block), at full width on the world's
# 2x2 mesh: launch/train's rank body for REC_STEPS SGD steps at SHARD_LR
# (the first loss against the same state and batch on one device within
# SHARD_LOSS_RTOL; K2 and K3 launches per rank; remat's kept bytes a block
# exactly 1/tp of the replicated layout's (B/dp, S, D) bf16; the step's
# wire per axis printed beside S); then every block on the mesh fed the
# 1x1 block's input (`recurrent_blocks`): its output within BF16_ROW_ULPS
# of the 1x1 block's, its parameters' and input's gradients under a drawn
# cotangent within GRAD_BF16_TOL; each rank's K3 on its rows' sLSTM input
# against the plain recurrence (SL_TOL); planted, the Mamba2 gated norm's
# sum of squares with the identity backward (g alone) rejected.  A
# random-weight recurrent stack turns one bf16 ulp into a quarter of a
# logit row (ROADMAP section 3), so end-to-end outputs are printed and the
# gates are per block on their own inputs.  SERVE_MESH serves the same
# cuts, zamba2 at 2x2 and xlstm at 1x2, REC_GEN greedy tokens each,
# against their 1x1 serves (recurrent_serve_reference).
REC_CASES = {"zamba2": ("zamba2_1p2b", 6), "xlstm": ("xlstm_1p3b", 8)}
REC_STEPS, REC_GEN = 2, 8
REC_PLANTED = "Mamba2 gated norm's sum of squares with the identity backward (g alone)"
# SERVE_MESH's planted recurrent fault: the first mixer block's prefill
# with its norm's sum of squares left the rank's own (no sum over `model`).
REC_SERVE_PLANTED = "the first mixer's norm without its sum of squares over model"
# K2 a rank at zamba2's 2x2 (2 rows, 16 of 32 query and kv heads) and K3
# a rank at a data axis of 2 (2 rows of xlstm-1.3b's sLSTM input)
FA_HYBRID_RANK = (LM_BATCH // 2, 16, 16, LM_PROMPT, LM_PROMPT, 64)
SL_RANK = (LM_BATCH // 2, LM_PROMPT, 2048, 4)

# SERVE_MESH's cases: tag -> (arch, mesh, depth (None: the config's), greedy tokens).
SERVE_MESH_CASES = {"gemma": (LM_ARCH, (2, 2), None, LM_GEN),
                    "granite": ("granite_moe_1b_a400m", (1, 2), None, LM_GEN),
                    "granite8b": (FSDP_ARCH, (2, 2), FSDP_LAYERS, FSDP_GEN),
                    "zamba2": (REC_CASES["zamba2"][0], (2, 2), REC_CASES["zamba2"][1], REC_GEN),
                    "xlstm": (REC_CASES["xlstm"][0], (1, 2), REC_CASES["xlstm"][1], REC_GEN)}
REC_SERVE = ("zamba2", "xlstm")  # the SERVE_MESH cases of the recurrent families
FA_SERVE_MESH = {"gemma": (LM_BATCH // 2, 4, 1, LM_PROMPT, LM_PROMPT, 256),
                 "granite": (LM_BATCH, 8, 4, LM_PROMPT, LM_PROMPT, 64),
                 "granite8b": FA_FSDP_RANK, "zamba2": FA_HYBRID_RANK}


def serve_mesh_reference(torch, tag: str, out: dict) -> None:
    """Save what SERVE_MESH holds a mesh's serve against, from the 1x1
    serve's run `out` (serve.run's dict): its tokens, prefill and step
    logits, layer 0's prefill K/V, and one more decode step (the last
    token, at position LM_PROMPT + gen - 1) with every layer's
    decode-attention input and output, every MoE FFN's input and output,
    and every layer's cache after that step's write."""
    from repro_torch.models import attention, model, transformer

    cfg, cache = out["cfg"], out["cache"]
    pos = LM_PROMPT + out["tokens"].shape[1] - 1
    rec = {"attn_in": [], "attn_out": [], "moe_in": [], "moe_out": []}
    real_attn, real_moe = attention.decode_attention, transformer._moe_ffn

    def attn(params, x, layer_cache, at, **kw):
        y, c = real_attn(params, x, layer_cache, at, **kw)
        rec["attn_in"].append(x.cpu())
        rec["attn_out"].append(y.cpu())
        return y, c

    def moe(params, f_in, c, n_groups, **kw):
        y, aux = real_moe(params, f_in, c, n_groups, **kw)
        rec["moe_in"].append(f_in.cpu())
        rec["moe_out"].append(y.cpu())
        return y, aux

    tok = out["tokens"][:, -1:].to(out["prompts"].device)
    with torch.no_grad(), mock.patch.object(attention, "decode_attention", attn), \
            mock.patch.object(transformer, "_moe_ffn", moe):
        model.decode_step(cfg, out["params"], cache, tok, pos)
    pre = out["prefill_cache"]["layers"]
    ref = {"pos": pos, "tokens": out["tokens"], "last_logits": out["last_logits"].cpu(),
           "step_logits": torch.stack(out["step_logits"]).cpu(),
           "prefill_k0": pre["k"][0].cpu(), "prefill_v0": pre["v"][0].cpu(),
           "cache_k": cache["layers"]["k"].cpu(), "cache_v": cache["layers"]["v"].cpu(),
           **{k: torch.stack(v) for k, v in rec.items() if v}}
    SERVE_MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(ref, SERVE_MESH_DIR / f"{tag}.pt")


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
    serve_mesh_reference(torch, "gemma", out)
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


def attention_applications(cfg) -> int:
    """How many times a forward applies attention (one K2 launch each): one
    a layer, for hybrid one a group (the shared block), none for xlstm."""
    if cfg.family == "xlstm":
        return 0
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def residual_blocks(cfg) -> int:
    """The residual stream's depth: every layer, and hybrid's shared-block
    applications besides its Mamba2 blocks."""
    return cfg.n_layers + (attention_applications(cfg) if cfg.family == "hybrid" else 0)


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """6 N tokens (every active parameter's multiply-add forward, twice
    backward; N counts the tied embedding once, hybrid's shared block once
    an application and, for MoE, the router and the top-k experts a token
    runs, not the capacity's padding) + 6 A B S^2 H Dh over the A attention
    applications (causal attention's q k^T and p v over half the S x S
    pairs, 2 B S^2 H Dh forward, twice that backward; twice that again over
    all the pairs of a non-causal encoder) + for hybrid the SSD's products,
    6 B S (Q / 2 (N + H P) + 2 N H P) a Mamba2 block (C B^T and att x over
    the causal half of each chunk of Q, the chunk summaries and the state
    read-out), and for xlstm the mLSTM's, 6 B S H (Q P + 2 P^2) an mLSTM
    block (q k^T and w v over the causal half of each chunk of Q, the state
    read-out q C and the update k^T v; the sLSTM's h R is a product with
    parameters, in 6 N); the remat recompute is not model work."""
    n = cfg.param_counts()["active"]
    width = cfg.n_heads * cfg.resolved_head_dim
    attn = 6.0 * attention_applications(cfg) * batch * seq * seq * width
    flops = 6.0 * n * batch * seq + (attn if cfg.causal else 2 * attn)
    if cfg.family == "hybrid":
        q, nst = min(cfg.ssm_chunk, seq), cfg.ssm_state
        hp = cfg.ssm_expand * cfg.d_model
        flops += 6.0 * cfg.n_layers * batch * seq * (q / 2 * (nst + hp) + 2 * nst * hp)
    if cfg.family == "xlstm":
        q, di = min(cfg.ssm_chunk, seq), cfg.mlstm_proj_factor * cfg.d_model
        n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
        flops += 6.0 * n_mlstm * batch * seq * di * (q + 2 * di // cfg.n_heads)
    return flops


def check_disk(tag: str, cfg) -> None:
    """Fail unless build/ has room for two train states of cfg (keep 3 at
    two checkpoints: the committed one beside the one being written)."""
    import shutil

    n_params = cfg.param_counts()["total"]
    state_gb = 3 * 4 * n_params / 1e9  # fp32 params, m, v
    (ROOT / "build").mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(ROOT / "build").free / 1e9
    need_gb = 2 * state_gb + 2.0
    print(f"[{tag}] {cfg.name}: {n_params:.4e} params, train state {state_gb:.2f} GB; "
          f"free disk under build/ {free_gb:.1f} GB (need {need_gb:.1f})")
    if free_gb < need_gb:
        raise AssertionError(f"{tag}: {free_gb:.1f} GB free under build/, need {need_gb:.1f}")


def profile_train_step(torch, tag: str, cfg, params, batch, n_steps: int) -> dict:
    """One train step of params (AdamW on a cosine warmup, as launch/train)
    under the profiler, after a warm one: {profiled_wall_ms, device_ms,
    categories, top}."""
    from repro_torch.optim import for_arch
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime import steps

    opt = for_arch(cfg, lr=cosine_warmup(3e-4, warmup=20, total=n_steps))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step_fn = steps.make_train_step(cfg, opt)
    step_fn(state, batch)
    wall_ms, rows = profile_rows(torch, lambda: step_fn(state, batch))
    dev_ms, top = sum(ms for _, ms in rows), [(k[:60], round(ms, 3)) for k, ms in rows[:10]]
    categories = step_categories(rows)
    print(f"[{tag}] profile of one step: device kernels {dev_ms:.1f} ms, {wall_ms:.1f} ms under "
          f"the profiler; by category {categories}; top {top}")
    del state, step_fn
    return {"profiled_wall_ms": wall_ms, "device_ms": dev_ms, "categories": categories,
            "top": top}


def train_cli(torch, card: str, tag: str, arch: str, n_layers: int, n_steps: int,
              ckpt_every: int, fault_at: int, launches_of, per_step: int, kernel: str,
              exact_replay: bool = False) -> dict:
    """launch/train at arch's full width cut to n_layers: n_steps steps of
    TRAIN_BATCH x TRAIN_SEQ positions, a checkpoint every ckpt_every, a
    fault at fault_at (restore, replay), the rescale reload, checkpoint I/O
    timed.  Fails unless the kernel counted by launches_of() (set to 0
    just before) launched per_step times a step run, the checkpoints and
    the rescale are where they belong, every loss is finite and the first
    replayed loss equals the first pass's (with exact_replay every one; else
    the rest within REPLAY_RTOL).  Returns the run's record."""
    import shutil

    from repro_torch.checkpoint import manager
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import train

    cfg = cut_depth(get_config(arch), n_layers)
    ckpt_dir = ROOT / "build" / f"chip_smoke_{tag.replace(' ', '_')}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    io = {"save_s": [], "restore_s": [], "host_copy_s": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                io[key].append(time.perf_counter() - t)
        return wrapper

    argv = ["--arch", arch, "--full-config", "--n-layers", str(n_layers),
            "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(n_steps),
            "--ckpt-every", str(ckpt_every), "--inject-fault-at", str(fault_at),
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
        launches = launches_of()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner, losses = out["runner"], out["losses"]
    executed = len(out["history"])
    replayed = fault_at - ckpt_every
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    if out["faults"] != 1 or executed != n_steps + replayed:
        raise AssertionError(f"{tag}: {out['faults']} faults, {executed} steps run")
    if launches != per_step * executed:
        raise AssertionError(f"{tag}: {launches} {kernel} launches over {executed} steps, "
                             f"expected {per_step} a step")
    if out["ckpt_steps"] != [ckpt_every, n_steps] or out["rescaled_step"] != n_steps:
        raise AssertionError(f"{tag}: checkpoints {out['ckpt_steps']}, rescale resumed at "
                             f"{out['rescaled_step']}")
    if not all(math.isfinite(x) for _, x in losses):
        raise AssertionError(f"{tag}: a loss is not finite: {losses}")
    first = dict(losses[:fault_at])
    replay = losses[fault_at:fault_at + replayed]
    replay_rel = [abs(x - first[st]) / abs(first[st]) for st, x in replay]
    rule = "every one exactly" if exact_replay else f"the first exactly, the rest within " \
        f"{REPLAY_RTOL} relative"
    print(f"[{tag}] replay from step {ckpt_every}: first pass "
          f"{[first[st] for st, _ in replay]}, replayed {[x for _, x in replay]} ({rule}: "
          f"{replay_rel})")
    if replay[0][1] != first[replay[0][0]]:
        raise AssertionError(f"{tag}: the first replayed loss differs from the first pass's")
    if not max(replay_rel) <= (0.0 if exact_replay else REPLAY_RTOL):
        raise AssertionError(f"{tag}: a replayed loss parts from the first pass: {replay_rel}")

    times = runner.step_times
    step_s = statistics.median(times[1:])
    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    n_params = cfg.param_counts()["total"]
    rec = {
        "card": card, "arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps_run": executed,
        "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
        "step_ms_all": [x * 1e3 for x in times],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "model_flops_per_step": flops, "mfu_bf16": flops / step_s / BF16_FLOPS_PER_S,
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_step": launches / executed, "losses": losses,
        "replay_rel": replay_rel, "checkpoint_io_s": io, "state_gb": 3 * 4 * n_params / 1e9,
        "wall_s": wall,
        "events": [{k: v for k, v in e.items() if k != "error"} for e in runner.events],
    }
    print(f"[{tag}] {card}: {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} positions: step "
          f"{rec['step_ms']:.1f} ms (median of {len(times) - 1} after the first, "
          f"{rec['first_step_ms']:.1f}), {rec['tokens_per_s']:.1f} tokens/s, model-flops share "
          f"of the bf16 peak {rec['mfu_bf16']:.4f} ({flops:.4e} flops a step / "
          f"{BF16_FLOPS_PER_S:.3e}), peak device memory {peak_gb:.2f} GB, {kernel} launches "
          f"{launches} ({rec['launches_per_step']:.0f} a step); checkpoint save "
          f"{io['save_s']} s, host copy {io['host_copy_s']} s, restore {io['restore_s']} s; "
          f"wall {wall:.1f} s")
    del out, runner
    gc.collect()  # free whatever a reference cycle still holds of the train states
    torch.cuda.empty_cache()
    return rec


def phase_train(torch, card: str, tag: str, arch: str, n_layers: int, n_steps: int,
                ckpt_every: int, fault_at: int, grad_floor: float | None = 0.0):
    """The port's training of `arch` at full width, depth cut to n_layers,
    through launch/train (TrainRunner: checkpoints every ckpt_every, a fault
    injected at fault_at, replay, the rescale reload; TRAIN_BATCH x
    TRAIN_SEQ positions a step), two K2 launches an attention application a
    step, one step profiled, and the first step: every attention
    application held on its own inputs (each K2 launch, forward and remat
    recompute, within BF16_ROW_ULPS of plain; the dq, dk, dv the step
    computed within GRAD_BF16_TOL of the exact gradient, autograd through
    fp32 attention; a wrong visibility at the first application, the
    causal limit one key late or causal where it is not, outside both);
    against its plain-attention twin, the loss within 2^-8 and each gradient leaf
    within grad_floor + the residual stream's depth x 2^-8, or with
    grad_floor None printed, not gated (the hybrid: its random-weight
    Mamba2 stack carries a one-ulp change of an attention output to some
    0.3 of a leaf, HYBRID_SERVE's noise control).  Prints "[tag]" lines
    and one tag.upper() JSON line (TRAIN for olmo-1b); returns the run's
    record (K2 launches and per step)."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import attention, model
    from repro_torch.pytree import leaves

    cfg = cut_depth(get_config(arch), n_layers)
    check_disk(tag, cfg)

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

    # Each attention application of the step, held on its own inputs:
    # every K2 launch (forward and remat recompute) against plain, and the
    # dq, dk, dv the step computed against the exact gradient (autograd
    # through fp32 attention); a wrong visibility (the causal limit one
    # key late, or causal where the call asked for none) planted at the
    # first of each.
    real, backward = ops.flash_attention, ops.attention_backward
    forwards, planted, applied = [], {}, []

    def wrong(q, k, causal):
        return causal_visible(torch, q.shape[2], k.shape[2], q.device, int(causal))

    def checked(q, k, v, *, causal=True, scale=None):
        out = real(q, k, v, causal=causal, scale=scale)
        with torch.no_grad():
            want = ref.attention_ref(q, k, v, causal=causal, scale=scale)
            forwards.append(bf16_reading(out, want))
            planted.setdefault("forward", bf16_reading(
                masked_attention(torch, q, k, v, wrong(q, k, causal)), want))
        return out

    def recorded(q, k, v, dout, *, causal, scale):
        grads = backward(q, k, v, dout, causal=causal, scale=scale)
        applied.append((q, k, v, dout, causal, scale, grads))
        return grads

    checked.launches = 0  # _launch counts on the patched name while patched
    with mock.patch.object(ops, "flash_attention", checked), \
            mock.patch.object(ops, "attention_backward", recorded):
        loss_k, grads_k = loss_and_grads()
    first_launches = checked.launches

    def gradient_reading(q, k, v, dout, causal, scale, got):
        g = q.shape[1] // k.shape[1]
        want = autograd_grads(torch, lambda a, b, c, causal: exact_attention(
            a, b.repeat_interleave(g, 1), c.repeat_interleave(g, 1), causal=causal,
            scale=scale), *(x.float() for x in (q, k, v, dout)), causal)
        if "gradient" not in planted:
            planted["gradient"] = max(grad_readings(autograd_grads(
                torch, lambda a, b, c, causal: masked_attention(torch, a, b, c, wrong(a, b, causal)),
                q, k, v, dout, causal), want).values())
        return max(grad_readings(got, want).values())

    app_readings = [gradient_reading(*a) for a in applied]
    del applied
    with mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        loss_p, grads_p = loss_and_grads()
    grad_rel = [rel_err(g, w) for g, w in zip(grads_k, grads_p)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    del grads_k, grads_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    depth, per_step = residual_blocks(cfg), 2 * attention_applications(cfg)
    if grad_floor is None:
        tol, rule = None, "printed, not gated"
    else:
        tol = grad_floor + depth * BF16_UNIT_ROUNDOFF
        rule = f"gate {tol:.4f} = {grad_floor:g} + {depth} residual blocks x 2^-8"
    print(f"[{tag}] first step, each attention application on its own inputs: K2 vs plain, "
          f"bf16 readings (gate {BF16_ROW_ULPS}) {[round(r, 3) for r in forwards]}; dq, dk, dv "
          f"vs the exact gradient (gate {GRAD_BF16_TOL}) {[round(r, 5) for r in app_readings]}; "
          f"planted (the first application's visibility "
          f"{'one key late' if cfg.causal else 'causal'}) {planted}")
    print(f"[{tag}] first step, K2 vs plain-attention twin: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.2e}, gate {BF16_UNIT_ROUNDOFF:.2e}); per-leaf max|dg|/max|g| "
          f"max {max(grad_rel):.3e} ({rule}): {[round(r, 5) for r in grad_rel]}; K2 launches "
          f"{first_launches}")
    if first_launches != per_step or len(forwards) != per_step \
            or len(app_readings) != per_step // 2:
        raise AssertionError(f"{tag}: {first_launches} K2 launches and {len(app_readings)} "
                             f"backwards in one loss and gradient, expected {per_step} "
                             f"(forward + remat recompute) and {per_step // 2}")
    if not (max(forwards) <= BF16_ROW_ULPS and max(app_readings) <= GRAD_BF16_TOL):
        raise AssertionError(f"{tag}: an application's attention or its gradient disagrees "
                             f"on its inputs: {forwards}, {app_readings}")
    if not (planted["forward"] > BF16_ROW_ULPS and planted["gradient"] > GRAD_BF16_TOL):
        raise AssertionError(f"{tag}: a per-application gate passes a planted wrong "
                             f"attention: {planted}")
    if not (finite and loss_rel <= BF16_UNIT_ROUNDOFF and (tol is None or max(grad_rel) <= tol)):
        raise AssertionError(f"{tag}: the first step's loss or gradient disagrees with the "
                             "plain-attention twin")

    profile = profile_train_step(torch, tag, cfg, params, batch, n_steps)
    del params, flat
    torch.cuda.empty_cache()
    rec = train_cli(torch, card, tag, arch, n_layers, n_steps, ckpt_every, fault_at,
                    lambda: ops.flash_attention.launches, per_step, "K2")
    rec["first_step"] = {"loss": loss_k, "plain_loss": loss_p, "loss_rel": loss_rel,
                         "grad_rel": grad_rel, "grad_tol": tol,
                         "application_forwards": forwards, "application_grads": app_readings,
                         "planted": planted}
    rec["profile"] = {**profile, "busy_share": profile["device_ms"] / rec["step_ms"]}
    print(f"[{tag}] busy share {rec['profile']['busy_share']:.3f}")
    print(tag.upper().replace(" ", "_") + " " + json.dumps(rec))
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


def attention_bound(b, hq, hkv, s, t, d, causal=True):
    """(flops, bytes, bound ms, bound_by) of one bf16 K2 launch, causal at
    S = T or not: q k^T and p v over the visible pairs at the bf16 tensor
    rate, q, k, v read and out written once."""
    pairs = b * hq * s * (s + 1) // 2 if causal else b * hq * s * t
    flops = 4 * pairs * d
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * t * d)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return flops, nbytes, max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def first_columns_attention(torch, q, k, v, cols: int, causal: bool = True):
    """Attention whose logits read only the first `cols` columns of q and k
    (the plain stand-in for a kernel whose Q K^T drops the tail chunk)."""
    s, t = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    logits = torch.matmul(q[..., :cols].float(), kx[..., :cols].transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(~causal_visible(torch, s, t, q.device), float("-inf"))
    return torch.matmul(torch.softmax(logits, -1).to(v.dtype).float(), vx).to(q.dtype)


def without_tail_chunk(out, cols: int = 64):
    """The plain output with columns `cols` and past zeroed (the stand-in for
    a kernel whose P V drops the tail chunk, or whose epilogue never stores
    it)."""
    bad = out.clone()
    bad[..., cols:] = 0
    return bad


def phase_flash_attention_moe(torch):
    """K2 at the MoE family's shapes, both on wgmma_tma: granite-moe's
    FA_MOE and kimi-k2's FA_KIMI (head dim 112, a zero-filled tail chunk)
    against the plain version, timed beside SDPA with their bounds, planted
    faults at D 112 rejected; K2's gradient at granite-moe's training
    shape.  Returns the records for K2's `moe_shapes`."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(3)
    recs = []
    for name, shape in (("granite-moe", FA_MOE), ("kimi-k2", FA_KIMI)):
        b, hq, hkv, s, t, d = shape
        kind = ops.library_variant(torch.bfloat16, d)
        if not kind == ops.variant(torch.bfloat16, d) == "wgmma_tma":
            raise AssertionError(f"{shape} goes to {kind} (wrapper: "
                                 f"{ops.variant(torch.bfloat16, d)}), expected wgmma_tma")
        q, k, v = (torch.randn(*sh, generator=gen).to(dev, torch.bfloat16)
                   for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
        out = ops.flash_attention(q, k, v, causal=True)
        want = ref.attention_ref(q, k, v, causal=True)
        err, reading = max_err(out, want), bf16_reading(out, want)
        faults = {}
        if d == 112:
            faults["logits from the first 64 columns"] = first_columns_attention(
                torch, q, k, v, 64)
            faults["P V without its tail chunk"] = without_tail_chunk(want)
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


def prefill_checked(torch, cfg, params, batch):
    """A prefill of `batch` whose every K2 launch is held against the plain
    version on that launch's inputs: (the logits, [bf16 reading per layer],
    the first layer's planted reading: the causal limit one key late, or a
    causal mask where the call asked for none; [causal flag per layer])."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import attention, model

    real = ops.flash_attention
    layers, planted, flags = [], [], []

    def checked(q, k, v, *, causal=True, scale=None):
        flags.append(causal)
        out = real(q, k, v, causal=causal, scale=scale)
        want = ref.attention_ref(q, k, v, causal=causal, scale=scale)
        layers.append(bf16_reading(out, want))
        if not planted:
            wrong = causal_visible(torch, q.shape[2], k.shape[2], q.device, 1 if causal else 0)
            planted.append(bf16_reading(masked_attention(torch, q, k, v, wrong), want))
        return out

    # _launch counts on the module's `flash_attention`, this wrapper while
    # patched: the check's launches stay off the wrapper's real count.
    checked.launches = 0
    with mock.patch.object(attention.ops, "flash_attention", checked):
        logits, _ = model.prefill(cfg, params, batch)
    return logits, layers, planted[0], flags


# Forward ranges of the MoE profile: (range, module, attribute).  K2's own
# kernels are read by name ("attention (K2)"): a launch through ctypes has
# no PyTorch operator for the profiler to hang it under.
MOE_RANGES = (("router and top-k", "moe", "_route"), ("dispatch tables", "moe", "dispatch_tables"),
              ("slot maps", "moe", "_expert_major"), ("gathers", "moe", "_gather_rows"),
              ("combine sums", "moe", "_sum_rows"), ("expert GEMMs", "moe", "_experts"),
              ("shared expert", "moe", "_shared"), ("unembedding", "model", "_logits"))


def profile_ranges(torch, fn, ranges=MOE_RANGES):
    """One call of fn under torch.profiler with a range around each of
    `ranges` ((name, module, attribute) of models/): (host wall ms, device
    kernel ms, {range: device ms of the kernels launched inside it,
    "attention (K2)": K2's kernels, "other": the rest}, [(kernel, ms)] of
    the 8 largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model, moe, ssm

    mods = {"moe": moe, "model": model, "ssm": ssm}

    def ranged(name, fn_):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name, mod, attr in ranges:
            stack.enter_context(mock.patch.object(
                mods[mod], attr, ranged(name, getattr(mods[mod], attr))))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    names = {name for name, _, _ in ranges}
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
        logits_k, layers, planted, _ = prefill_checked(torch, cfg, params, {"tokens": prompts})
        last_k = logits_k[:, -1, :].clone()
        del logits_k
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
        wall, dev_ms, ranges, top = profile_ranges(torch, fn)
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
    serve_mesh_reference(torch, "granite", out)
    del out, params, prompts, cache, last, last_k, last_p
    torch.cuda.empty_cache()
    return launches


def phase_moe_train(torch, card: str):
    """The port's training at granite-moe-1b-a400m's full width through
    launch/train, depth cut to MOE_TRAIN_LAYERS (AdamW, cosine warmup;
    MOE_STEPS steps, checkpoints every MOE_CKPT_EVERY, a fault at
    MOE_FAULT_AT, the rescale reload): 2 K2 launches a layer a step, the
    first replayed loss exact, the first step's loss against its
    plain-attention twin; returns the run's record."""
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

    cfg = cut_depth(get_config(MOE_ARCH), MOE_TRAIN_LAYERS)
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
    _, _, ranges, _ = profile_ranges(torch, lambda: step_fn(state, batch))
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

    argv = ["--arch", MOE_ARCH, "--full-config", "--n-layers", str(MOE_TRAIN_LAYERS),
            "--batch", str(TRAIN_BATCH),
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
    _, layers, planted, _ = prefill_checked(torch, cfg, params, {"tokens": prompts})
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


def k2_at_shape(torch, gen, name: str, shape, causal: bool, faults) -> dict:
    """K2 at one bf16 shape (B, Hq, Hkv, S, T, D) on wgmma_tma: against the
    plain version (BF16_ROW_ULPS), each planted fault that faults(q, k, v,
    plain output) returns ({name: wrong output}) rejected by the same
    check, then timed beside the plain version and SDPA (is_causal as asked)
    with its bound.  Returns the shape's record."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    b, hq, hkv, s, t, d = shape
    kind = ops.library_variant(torch.bfloat16, d)
    if not kind == ops.variant(torch.bfloat16, d) == "wgmma_tma":
        raise AssertionError(f"{shape} goes to {kind} (wrapper: "
                             f"{ops.variant(torch.bfloat16, d)}), expected wgmma_tma")
    q, k, v = (torch.randn(*sh, generator=gen).to(dev, torch.bfloat16)
               for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    err, reading = max_err(out, want), bf16_reading(out, want)
    fault_readings = {n: bf16_reading(bad, want) for n, bad in faults(q, k, v, want).items()}
    print(f"[kernels] flash_attention {name} {shape} bf16 {'causal' if causal else 'non-causal'}"
          f" ({kind}): reading {reading:.3f} (tol {BF16_ROW_ULPS}), max|err| {err:.3e}; "
          f"planted faults {fault_readings}")
    if not reading <= BF16_ROW_ULPS:
        raise AssertionError(f"flash_attention disagrees with plain at {shape}")
    for fname, r in fault_readings.items():
        if r <= BF16_ROW_ULPS:
            raise AssertionError(f"the bf16 check passes a planted fault at {shape}: {fname}")
    del out, want

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal)

    def plain():
        return ref.attention_ref(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    k1, p1, l1, l2, p2, k2 = (time_ms(torch, fn, 5) for fn in
                              (kernel, plain, library, library, plain, kernel))
    flops, nbytes, bound_ms, bound_by = attention_bound(*shape, causal=causal)
    rec = {"path": name, "shape": list(shape), "causal": causal, "variant": kind,
           "grid": ops.ctas(b, hq, s, torch.bfloat16, d), "max_abs_err": err,
           "bf16_reading": reading, "planted_faults": fault_readings,
           "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes}
    print(f"[kernels] flash_attention ({kind}, {rec['grid']} CTAs) at {shape} bf16 "
          f"{'causal' if causal else 'non-causal'}: kernel_ms {k1:.3f} {k2:.3f}  plain_ms "
          f"{p1:.3f} {p2:.3f}  sdpa_ms {l1:.3f} {l2:.3f}  bound_ms {bound_ms:.4f} "
          f"({bound_by}: {flops:.3e} flops, {nbytes:.3e} bytes)")
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def phase_flash_attention_vlm_audio(torch):
    """K2 at the VLM and audio shapes, all on wgmma_tma with a zero-filled
    tail chunk: phi-3-vision's prefill FA_VLM and training shape
    FA_VLM_TRAIN (D 96, causal) and hubert-xlarge's FA_AUDIO (D 80,
    non-causal) against the plain version, timed beside SDPA (is_causal as
    the model asks) with their bounds; planted faults rejected (at D 96 and
    D 80 logits from the first 64 columns and P V without its tail chunk,
    at D 80 a causal mask where none was asked); K2's gradient at FA_AUDIO,
    non-causal (GRAD_BF16_TOL).  Returns the records for K2's
    `vlm_audio_shapes`."""
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    recs = []
    for name, shape, causal in (("phi-3-vision prefill", FA_VLM, True),
                                ("phi-3-vision train", FA_VLM_TRAIN, True),
                                ("hubert-xlarge", FA_AUDIO, False)):

        def faults(q, k, v, want, shape=shape, causal=causal):
            bad = {}
            if shape is not FA_VLM_TRAIN:  # once at each head dim
                bad["logits from the first 64 columns"] = first_columns_attention(
                    torch, q, k, v, 64, causal)
                bad["P V without its tail chunk"] = without_tail_chunk(want)
            if not causal:
                bad["a causal mask where none was asked"] = masked_attention(
                    torch, q, k, v, causal_visible(torch, q.shape[2], k.shape[2], dev))
            return bad

        recs.append(k2_at_shape(torch, gen, name, shape, causal, faults))

    # K2's gradient at hubert's shape, non-causal (FA_AUDIO, bf16).
    b, hq, hkv, s, t, d = FA_AUDIO
    q, k, v, do = (torch.randn(*sh, generator=gen).to(dev, torch.bfloat16)
                   for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, hq, s, d)))
    readings = grad_readings(autograd_grads(torch, ops.flash_attention, q, k, v, do, False),
                             autograd_grads(torch, ref.attention_ref, q, k, v, do, False))
    print(f"[kernels] flash_attention gradient bf16 non-causal at {FA_AUDIO}: {readings} (gate "
          f"{GRAD_BF16_TOL})")
    if not max(readings.values()) <= GRAD_BF16_TOL:
        raise AssertionError(f"K2 gradient disagrees with plain at {FA_AUDIO}: {readings}")
    recs[-1]["grad_readings"] = readings
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def phase_flash_attention_serve_mesh(torch):
    """K2 at the per-rank shapes of SERVE_MESH's prefills (FA_SERVE_MESH:
    gemma-2b's 2 rows and 4 of 8 query heads over its one kv head at 2x2,
    granite-moe's 8 of 16 query heads over 4 of 8 kv heads at 1x2), causal,
    on wgmma_tma: against plain, a planted causal limit one key late
    rejected, timed beside the plain version and SDPA with their bounds.
    Returns the records for K2's `serve_mesh_shapes`."""
    gen = torch.Generator(device="cpu").manual_seed(9)

    def faults(q, k, v, want):
        wrong = causal_visible(torch, q.shape[2], k.shape[2], q.device, 1)
        return {"causal limit one key late": masked_attention(torch, q, k, v, wrong)}

    return [k2_at_shape(torch, gen, f"{tag} per rank, {'x'.join(map(str, mesh))}",
                        FA_SERVE_MESH[tag], True, faults)
            for tag, (_, mesh, _, _) in SERVE_MESH_CASES.items() if tag in ("gemma", "granite")]


def phase_flash_attention_fsdp(torch):
    """K2 at granite-8b's FA_GRANITE8B and qwen3-32b's FA_QWEN32B prefill
    shapes and at the per-rank shape of granite-8b's 2x2 FSDP runs
    (FA_FSDP_RANK), causal bf16 at head dim 128 on wgmma_tma: against plain,
    a planted causal limit one key late rejected at granite-8b's, timed
    beside the plain version and SDPA with their bounds.  Returns the
    records for K2's `fsdp_shapes`."""
    gen = torch.Generator(device="cpu").manual_seed(13)

    def faults(q, k, v, want):
        wrong = causal_visible(torch, q.shape[2], k.shape[2], q.device, 1)
        return {"causal limit one key late": masked_attention(torch, q, k, v, wrong)}

    return [k2_at_shape(torch, gen, name, shape, True,
                        faults if shape is FA_GRANITE8B else lambda *a: {})
            for name, shape in (("granite-8b", FA_GRANITE8B), ("qwen3-32b", FA_QWEN32B),
                                ("granite-8b per rank, 2x2 FSDP", FA_FSDP_RANK))]


def phase_dense_serve(torch, card: str, tag: str, arch: str, n_layers, gen: int) -> int:
    """The port's serve at `arch`'s full width, depth cut to n_layers (None:
    the config's), the LM traffic with `gen` greedy tokens: one K2 launch a
    layer a prefill (gated), each layer's K2 against plain on its own inputs
    (gated, a planted wrong attention rejected), tokens in the vocabulary,
    logits and cache finite; prefill ms, decode ms/token and peak memory
    printed (the `tag` line).  Returns K2's launch count over the run."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve

    argv = (["--arch", arch, "--full-config", "--batch", str(LM_BATCH), "--prompt-len",
             str(LM_PROMPT), "--gen", str(gen), "--device", "cuda", "--json"]
            + (["--n-layers", str(n_layers)] if n_layers else []))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    n_params = cfg.param_counts()["total"]
    if launches != cfg.n_layers:
        raise AssertionError(f"{tag}: {launches} K2 launches, expected {cfg.n_layers}")
    if tuple(tokens.shape) != (LM_BATCH, gen) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{tag}: tokens outside the vocabulary or logits not finite")
    if not all(bool(torch.isfinite(t).all()) for t in out["cache"]["layers"].values()):
        raise AssertionError(f"{tag}: the cache is not finite")
    params, prompts = out["params"], out["prompts"]
    del out
    _, layers, planted, _ = prefill_checked(torch, cfg, params, {"tokens": prompts})
    del params, prompts
    torch.cuda.empty_cache()
    if len(layers) != cfg.n_layers or not max(layers) <= BF16_ROW_ULPS \
            or planted <= BF16_ROW_ULPS:
        raise AssertionError(f"{tag}: K2 vs plain per layer {layers}, planted {planted}")
    print(f"[{tag.lower()}] {card}: {cfg.name}, {cfg.n_layers} layers ({n_params:.4e} params, "
          f"bf16) batch {LM_BATCH} prompt {LM_PROMPT} gen {gen}: prefill "
          f"{pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} tokens/s)  decode "
          f"{pay['decode_ms_per_token']:.3f} ms/token  K2 launches {launches}; K2 vs plain per "
          f"layer max {max(layers):.3f} (gate {BF16_ROW_ULPS}; planted causal limit one key late "
          f"{planted:.3f})  peak device memory {peak_gb:.2f} GB")
    print(f"{tag} " + json.dumps({**pay, "card": card, "n_layers": cfg.n_layers,
                                  "params": n_params, "launches": launches,
                                  "peak_mem_gb": peak_gb, "layer_readings": layers,
                                  "planted_layer0": planted, "first_row": tokens[0].tolist()}))
    return launches


def phase_granite8b(torch, card: str) -> int:
    """granite-8b served at full width and depth (phase_dense_serve)."""
    return phase_dense_serve(torch, card, "GRANITE8B", FSDP_ARCH, None, GRANITE8B_GEN)


def phase_qwen32b(torch, card: str) -> int:
    """qwen3-32b served at full width cut to QWEN_LAYERS (phase_dense_serve)."""
    return phase_dense_serve(torch, card, "QWEN32B", QWEN_ARCH, QWEN_LAYERS, QWEN_GEN)


def phase_fsdp_reference(torch) -> int:
    """SERVE_MESH's granite8b case without a mesh: granite-8b cut to
    FSDP_LAYERS served at 1x1 with the case's argv and seed, saved by
    serve_mesh_reference (what the 2x2 FSDP serve is held against).
    Returns K2's launches."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve

    argv = serve_mesh_argv("granite8b", "1x1", "auto")
    argv = [a for a in argv if a not in ("--mesh", "1x1", "--transport", "auto")]
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv))
    launches = ops.flash_attention.launches
    if launches != FSDP_LAYERS:
        raise AssertionError(f"granite-8b cut to {FSDP_LAYERS}: {launches} K2 launches")
    serve_mesh_reference(torch, "granite8b", out)
    del out
    torch.cuda.empty_cache()
    return launches


def profile_split(torch, fn, run_ms: float) -> dict:
    """One call of fn under torch.profiler: device ms by STEP_CATEGORIES,
    the busy share against an unprofiled run of run_ms, the largest
    kernels."""
    wall, rows = profile_rows(torch, fn)
    dev_ms = sum(ms for _, ms in rows)
    return {"profiled_wall_ms": wall, "device_ms": dev_ms, "busy_share": dev_ms / run_ms,
            "categories": step_categories(rows),
            "top": [(k[:60], round(ms, 3)) for k, ms in rows[:8]]}


def phase_vlm_serve(torch, card: str):
    """The port's serve at phi-3-vision-4.2b's full width and depth: LM_BATCH
    prompts of LM_PROMPT tokens after VLM_IMG image positions, VLM_GEN greedy
    tokens, a cache of VLM_IMG + LM_PROMPT + VLM_GEN positions.  Gates: one
    K2 launch a layer (32), tokens in the vocabulary, logits and cache
    finite, each layer's K2 against plain on its own inputs (a planted
    wrong attention rejected); the end-to-end logits against the
    plain-attention twin printed; the prefill and a decode step profiled.
    Returns K2's launch count over the run."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import attention, model

    argv = ["--arch", VLM_ARCH, "--full-config", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(VLM_GEN), "--device", "cuda"]
    serve.run(serve.parse_args(argv[:3] + ["--n-layers", "2", "--prompt-len", "64", "--gen", "2",
                                          "--device", "cuda"]))  # warm, at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    n_pos = cfg.n_img_tokens + LM_PROMPT
    if launches != cfg.n_layers:
        raise AssertionError(f"VLM serve: {launches} K2 launches, expected {cfg.n_layers} "
                             f"(one per layer of the prefill)")
    if tuple(tokens.shape) != (LM_BATCH, VLM_GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"VLM serve: tokens {tuple(tokens.shape)} or outside the vocabulary")
    cache = out["cache"]["layers"]
    if cache["k"].shape[2] != n_pos + VLM_GEN or not bool(torch.isfinite(last).all()) \
            or not all(bool(torch.isfinite(t).all()) for t in cache.values()):
        raise AssertionError(f"VLM serve: a cache of {cache['k'].shape[2]} positions (expected "
                             f"{n_pos + VLM_GEN}), or logits or cache not finite")

    params, batch = out["params"], out["batch"]
    logits_k, layers, planted, _ = prefill_checked(torch, cfg, params, batch)
    last_k = logits_k[:, -1, :].clone()
    del logits_k
    with mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        logits_p, _ = model.prefill(cfg, params, batch)
    last_p = logits_p[:, -1, :].clone()
    del logits_p
    e2e = {"logits_row_reading": row_reading(last_k, last_p),
           "argmax_agree": float((last_k.argmax(-1) == last_p.argmax(-1)).float().mean()),
           "rerun_bit_identical": bool(torch.equal(last_k, last))}
    print(f"[vlm serve] each layer's K2 (D 96) vs plain on its inputs, bf16 readings (gate "
          f"{BF16_ROW_ULPS}): {[round(r, 3) for r in layers]}; planted (layer 0, causal limit one "
          f"key late) {planted:.3f}; end to end vs the plain-attention twin (printed): {e2e}")
    if len(layers) != cfg.n_layers or not max(layers) <= BF16_ROW_ULPS:
        raise AssertionError(f"VLM serve: a layer's K2 disagrees with plain: {layers}")
    if planted <= BF16_ROW_ULPS:
        raise AssertionError("VLM serve: the per-layer gate passes a planted wrong attention")

    tok = tokens[:, -1:].to(last.device)
    prof = {"prefill": profile_split(torch, lambda: model.prefill(cfg, params, batch),
                                     pay["prefill_ms"]),
            "decode_step": profile_split(
                torch, lambda: model.decode_step(cfg, params, out["cache"], tok,
                                                 n_pos + VLM_GEN - 1),
                pay["decode_ms_per_token"])}
    for what, p in prof.items():
        print(f"[vlm serve] profile {what}: device kernels {p['device_ms']:.2f} ms (busy share "
              f"{p['busy_share']:.3f}); by category {p['categories']}; top {p['top']}")
    n_params = cfg.param_counts()["total"]
    print(f"[vlm serve] {card}: {cfg.name} ({n_params:.4e} params, bf16) batch {LM_BATCH} "
          f"image {cfg.n_img_tokens} + prompt {LM_PROMPT} gen {VLM_GEN}: prefill "
          f"{pay['prefill_ms']:.1f} ms ({pay['prefill_tokens_per_s']:.1f} positions/s)  decode "
          f"{pay['decode_ms_per_token']:.3f} ms/token  K2 launches {launches} (D 96)  peak "
          f"device memory {peak_gb:.2f} GB")
    print("VLM_SERVE " + json.dumps({
        **pay, "card": card, "params": n_params, "launches": launches, "peak_mem_gb": peak_gb,
        "cache_positions": n_pos + VLM_GEN, "layer_readings": layers, "planted_layer0": planted,
        "end_to_end": e2e, "first_row": tokens[0].tolist(), "profile": prof}))
    del out, params, batch, cache, last, last_k, last_p
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_audio_encode(torch, card: str):
    """hubert-xlarge at full width and depth: one encode (model.prefill, the
    entry point of an encoder-only arch) of LM_BATCH x LM_PROMPT frames from
    audio_batches, after a short warm one.  Gates: one K2 launch a layer,
    every one non-causal, no cache, logits (B, S, 504) finite, each layer's
    K2 against plain on its own inputs (a planted causal mask rejected); the
    logits against the plain-attention twin printed; the encode profiled.
    Returns K2's launch count over the encode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch.train import make_batches
    from repro_torch.models import attention, model

    cfg = get_config(AUDIO_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.cast_params(cfg, model.init(cfg, 0, "cuda"))
    feats = torch.as_tensor(make_batches(cfg, LM_BATCH, LM_PROMPT, 0)(0)["features"],
                            device="cuda")
    model.prefill(cfg, params, {"features": feats[:, :64]})  # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(cfg, params, {"features": feats})
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers:
        raise AssertionError(f"audio encode: {launches} K2 launches, expected {cfg.n_layers}")
    if cache is not None or tuple(logits.shape) != (LM_BATCH, LM_PROMPT, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"audio encode: logits {tuple(logits.shape)} not finite or a cache")

    batch = {"features": feats}
    logits_k, layers, planted, flags = prefill_checked(torch, cfg, params, batch)
    with mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        logits_p, _ = model.prefill(cfg, params, batch)
    e2e = {"logits_row_reading": row_reading(logits_k, logits_p),
           "argmax_agree": float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean()),
           "rerun_bit_identical": bool(torch.equal(logits_k, logits))}
    del logits_k, logits_p
    print(f"[audio encode] each layer's K2 (D 80) vs plain on its inputs, bf16 readings (gate "
          f"{BF16_ROW_ULPS}): {[round(r, 3) for r in layers]}; causal flags {set(flags)}; "
          f"planted (layer 0, a causal mask) {planted:.3f}; end to end vs the plain-attention "
          f"twin (printed): {e2e}")
    if len(layers) != cfg.n_layers or not max(layers) <= BF16_ROW_ULPS or any(flags):
        raise AssertionError(f"audio encode: a layer's K2 disagrees with plain or was causal: "
                             f"{layers}, {flags}")
    if planted <= BF16_ROW_ULPS:
        raise AssertionError("audio encode: the per-layer gate passes a planted causal mask")
    prof = profile_split(torch, lambda: model.prefill(cfg, params, batch), encode_ms)
    n_params = cfg.param_counts()["total"]
    rec = {"card": card, "arch": cfg.name, "params": n_params, "batch": LM_BATCH,
           "frames": LM_PROMPT, "encode_ms": encode_ms,
           "frames_per_s": LM_BATCH * LM_PROMPT / encode_ms * 1e3, "launches": launches,
           "peak_mem_gb": peak_gb, "layer_readings": layers, "planted_layer0": planted,
           "end_to_end": e2e, "profile": prof}
    print(f"[audio encode] {card}: {cfg.name} ({n_params:.4e} params, bf16) {LM_BATCH} x "
          f"{LM_PROMPT} frames: encode {encode_ms:.1f} ms ({rec['frames_per_s']:.1f} frames/s), "
          f"K2 launches {launches} (D 80, non-causal), peak device memory {peak_gb:.2f} GB; "
          f"profile: device kernels {prof['device_ms']:.2f} ms (busy share "
          f"{prof['busy_share']:.3f}), by category {prof['categories']}; top {prof['top']}")
    print("AUDIO_ENCODE " + json.dumps(rec))
    del params, feats, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def image_after_text(cfg, params, batch):
    """Planted: the VLM's projected image tokens placed after the text."""
    import torch

    from repro_torch.models import model, transformer

    h = model._embed_tokens(cfg, params, batch["tokens"])
    img = transformer.apply_vlm_projector(params["projector"], batch["img_embeds"], cfg.cdtype)
    return torch.cat([h, img], dim=1)


def phase_vlm_audio_card_vs_cpu(torch):
    """The phi-3-vision and hubert-xlarge SMOKE configs (fp32) on the card
    and on the CPU from one CPU init: the forward's logits within 1e-4 of
    their largest |value| and the loss within 1e-5 relative, then three SGD
    steps (params within 1e-4 of each leaf's largest |value|, losses within
    1e-5 relative).  Planted faults must fail the forward check: the VLM's
    image tokens after the text, hubert's attention causal."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.runtime import steps

    out = {}
    for arch in (VLM_ARCH, AUDIO_ARCH):
        cfg = get_smoke_config(arch)
        batches = make_batches(cfg, 4, 64, 0)
        start = steps.init_train_state(cfg, sgd(0.5), 0, "cpu")

        def forward(dev, fault=False):
            params = tree_map(lambda t: t.clone().to(dev), start["params"])
            batch = steps.batch_to_device(batches(0), dev)
            c = dataclasses.replace(cfg, causal=True) if fault and cfg.family == "audio" else cfg
            with contextlib.ExitStack() as stack:
                if fault and cfg.family == "vlm":
                    stack.enter_context(mock.patch.object(model, "_embed_inputs",
                                                          image_after_text))
                logits, _ = model.forward(c, params, batch)
                loss, _ = model.loss_fn(c, params, batch)
            return logits.cpu(), loss.item()

        (lc, loss_c), (lp, loss_p) = forward("cuda"), forward("cpu")
        logits_rel, loss_rel = rel_err(lc, lp), abs(loss_c - loss_p) / abs(loss_p)
        planted = rel_err(forward("cuda", fault=True)[0], lp)

        def run(dev):
            state = tree_map(lambda t: t.clone().to(dev), start)
            step, losses = steps.make_train_step(cfg, sgd(0.5)), []
            for i in range(3):
                state, m = step(state, batches(i))
                losses.append(m["loss"].item())
            return [t.detach().cpu() for t in leaves(state["params"])], losses

        (pc, sc), (pp, sp) = run("cuda"), run("cpu")
        reading = max(rel_err(a, b) for a, b in zip(pc, pp))
        step_rel = max(abs(a - b) / abs(b) for a, b in zip(sc, sp))
        out[arch] = {"logits_rel": logits_rel, "loss_rel": loss_rel, "planted": planted,
                     "param_reading": reading, "step_loss_rel": step_rel}
        print(f"[vlm/audio card vs cpu] {cfg.name} smoke: forward max|d|/max|cpu| "
              f"{logits_rel:.3e} (tol 1e-4), loss rel {loss_rel:.2e} (tol 1e-5); planted "
              f"({'image tokens after the text' if cfg.family == 'vlm' else 'causal attention'}) "
              f"{planted:.3e}; 3 SGD steps: params {reading:.3e} (tol 1e-4), losses rel "
              f"{step_rel:.2e} (tol 1e-5): card {sc}, cpu {sp}")
        if not (logits_rel <= 1e-4 and loss_rel <= 1e-5 and reading <= 1e-4 and step_rel <= 1e-5):
            raise AssertionError(f"{cfg.name}: card and CPU disagree: {out[arch]}")
        if planted <= 1e-4:
            raise AssertionError(f"{cfg.name}: the forward check passes a planted fault")
    return out


def phase_flash_attention_hybrid(torch):
    """K2 at zamba2-1.2b's shared-block shape FA_HYBRID (D 64, 32 query over
    32 KV heads, causal) on wgmma_tma against the plain version, a planted
    wrong causal mask (the limit one key late) rejected, timed beside SDPA
    with its bound; K2's gradient there (GRAD_BF16_TOL); then at the
    per-rank shape of zamba2's 2x2 runs, FA_HYBRID_RANK (RECURRENT and
    SERVE_MESH), the same way.  Returns the record for K2's
    `hybrid_shape` (the per-rank shape's under "per_rank_2x2")."""
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device="cpu").manual_seed(6)

    def faults(q, k, v, want):
        late = causal_visible(torch, q.shape[2], k.shape[2], q.device, 1)
        return {"causal limit one key late": masked_attention(torch, q, k, v, late)}

    rec = k2_at_shape(torch, gen, "zamba2-1.2b shared block", FA_HYBRID, True, faults)
    b, hq, hkv, s, t, d = FA_HYBRID
    q, k, v, do = (torch.randn(*sh, generator=gen).to("cuda", torch.bfloat16)
                   for sh in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, hq, s, d)))
    readings = grad_readings(autograd_grads(torch, ops.flash_attention, q, k, v, do),
                             autograd_grads(torch, ref.attention_ref, q, k, v, do))
    print(f"[kernels] flash_attention gradient bf16 causal at {FA_HYBRID}: {readings} (gate "
          f"{GRAD_BF16_TOL})")
    if not max(readings.values()) <= GRAD_BF16_TOL:
        raise AssertionError(f"K2 gradient disagrees with plain at {FA_HYBRID}: {readings}")
    rec["grad_readings"] = readings
    del q, k, v, do
    torch.cuda.empty_cache()
    rec["per_rank_2x2"] = k2_at_shape(torch, gen, "zamba2-1.2b shared block per rank, 2x2",
                                      FA_HYBRID_RANK, True, faults)
    return rec


def ulp_noise_attention(torch, seed: int = 7):
    """The plain attention with one bf16 ulp of noise on its output (each
    element times 1 + 2^-8 n, n standard normal, fixed by `seed` so a remat
    recompute draws the same): the control for how far a random-weight
    stack carries a rounding-sized difference in one attention's output."""
    from repro_torch.kernels.flash_attention import ref

    def attn(q, k, v, *, causal=True, scale=None):
        out = ref.attention_ref(q, k, v, causal=causal, scale=scale)
        noise = torch.randn(out.shape, device=out.device,
                            generator=torch.Generator(out.device).manual_seed(seed))
        return (out.float() * (1 + 2.0 ** -8 * noise)).to(out.dtype)

    return attn


# Forward ranges of the hybrid prefill's profile (see MOE_RANGES): the SSD
# (einsums and elementwise work in fp32), the convolution, the gated norm
# with out_proj, the fp32 unembedding; K2 by name; the rest is the in_proj
# GEMMs, the shared block's GEMMs and MLP, the norms.
HYBRID_RANGES = (("SSD chunked scan (fp32)", "ssm", "_ssd_chunked"),
                 ("Mamba2 convolution", "ssm", "_causal_conv"),
                 ("gated norm and out_proj", "ssm", "_gated_out"),
                 ("unembedding (fp32)", "model", "_logits"))


def phase_hybrid_serve(torch, card: str):
    """The port's serve at zamba2-1.2b's full width and depth (38 Mamba2
    blocks, 6 applications of the shared block), the gemma path's traffic.
    Gates: one K2 launch an application of the prefill (6) and none in
    decode, tokens in the vocabulary, logits, K/V and the Mamba2 states
    finite, each application's K2 against plain on its own inputs (a
    planted wrong attention rejected); the end-to-end logits against the
    plain-attention twin printed; the prefill profiled by range
    (HYBRID_RANGES) and by kernel category, and a decode step.  Returns
    K2's launch count over the run."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import attention, model

    argv = ["--arch", HYBRID_ARCH, "--full-config", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN), "--device", "cuda"]
    serve.run(serve.parse_args(argv[:3] + ["--n-layers", "6", "--prompt-len", "256", "--gen", "2",
                                          "--device", "cuda"]))  # warm, at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = serve.run(serve.parse_args(argv + ["--json"]))
    launches = ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, pay, tokens, last = out["cfg"], out["payload"], out["tokens"], out["last_logits"]
    n_groups = attention_applications(cfg)
    if cfg.n_layers != 38 or launches != n_groups:
        raise AssertionError(f"hybrid serve: {cfg.n_layers} layers, {launches} K2 launches, "
                             f"expected {n_groups} (one an application of the prefill, none "
                             f"in decode)")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"hybrid serve: tokens {tuple(tokens.shape)} or outside the "
                             f"vocabulary")
    cache = out["cache"]
    shapes = {f"{stack}/{name}": tuple(t.shape) for stack, d in cache.items()
              for name, t in d.items()}
    finite = all(bool(torch.isfinite(t).all()) for d in cache.values() for t in d.values())
    if shapes["attn/k"] != (n_groups, LM_BATCH, LM_PROMPT + LM_GEN, 32, 64) \
            or shapes["mamba/S"][:3] != (n_groups, cfg.attn_every, LM_BATCH) \
            or "mamba_tail/S" not in shapes or not finite or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"hybrid serve: cache {shapes}, or logits or cache not finite")

    params, batch = out["params"], out["batch"]
    logits_k, layers, planted, _ = prefill_checked(torch, cfg, params, batch)
    last_k = logits_k[:, -1, :].clone()
    del logits_k
    with mock.patch.object(attention.ops, "flash_attention", ref.attention_ref):
        logits_p, _ = model.prefill(cfg, params, batch)
    last_p = logits_p[:, -1, :].clone()
    with mock.patch.object(attention.ops, "flash_attention", ulp_noise_attention(torch)):
        logits_c, _ = model.prefill(cfg, params, batch)
    last_c = logits_c[:, -1, :].clone()
    del logits_p, logits_c
    e2e = {"logits_row_reading": row_reading(last_k, last_p),
           "argmax_agree": float((last_k.argmax(-1) == last_p.argmax(-1)).float().mean()),
           "rerun_bit_identical": bool(torch.equal(last_k, last)),
           "ulp_noise_control_row_reading": row_reading(last_c, last_p)}
    print(f"[hybrid serve] each application's K2 (D 64) vs plain on its inputs, bf16 readings "
          f"(gate {BF16_ROW_ULPS}): {[round(r, 3) for r in layers]}; planted (application 0, "
          f"causal limit one key late) {planted:.3f}; end to end vs the plain-attention twin "
          f"(printed): {e2e}")
    if len(layers) != n_groups or not max(layers) <= BF16_ROW_ULPS:
        raise AssertionError(f"hybrid serve: an application's K2 disagrees with plain: {layers}")
    if planted <= BF16_ROW_ULPS:
        raise AssertionError("hybrid serve: the per-application gate passes a planted wrong "
                             "attention")

    tok = tokens[:, -1:].to(last.device)

    def prefill():
        return model.prefill(cfg, params, batch)

    _, _, ranges, _ = profile_ranges(torch, prefill, HYBRID_RANGES)
    prof = {"prefill": profile_split(torch, prefill, pay["prefill_ms"]),
            "decode_step": profile_split(
                torch, lambda: model.decode_step(cfg, params, cache, tok, LM_PROMPT + LM_GEN - 1),
                pay["decode_ms_per_token"])}
    prof["prefill"]["ranges"] = ranges
    print(f"[hybrid serve] profile prefill by range: {ranges}")
    for what, p in prof.items():
        print(f"[hybrid serve] profile {what}: device kernels {p['device_ms']:.2f} ms (busy share "
              f"{p['busy_share']:.3f}); by category {p['categories']}; top {p['top']}")
    n_params = cfg.param_counts()["total"]
    print(f"[hybrid serve] {card}: {cfg.name} ({n_params:.4e} params, bf16; {cfg.n_layers} "
          f"Mamba2 blocks, {n_groups} shared-block applications) batch {LM_BATCH} prompt "
          f"{LM_PROMPT} gen {LM_GEN}: prefill {pay['prefill_ms']:.1f} ms "
          f"({pay['prefill_tokens_per_s']:.1f} tokens/s)  decode "
          f"{pay['decode_ms_per_token']:.3f} ms/token  K2 launches {launches} (D 64)  peak "
          f"device memory {peak_gb:.2f} GB")
    print("HYBRID_SERVE " + json.dumps({
        **pay, "card": card, "params": n_params, "n_layers": cfg.n_layers, "launches": launches,
        "peak_mem_gb": peak_gb, "cache_shapes": shapes, "application_readings": layers,
        "planted_application0": planted, "end_to_end": e2e, "first_row": tokens[0].tolist(),
        "profile": prof}))
    del out, params, batch, cache, last, last_k, last_p, last_c
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def exact_attention(q, k, v, *, causal=True, scale=None):
    """Attention in the inputs' own dtype throughout (fp64 for the exact
    twin of a train step), the causal limit aligned as K2's."""
    import torch

    s, t = q.shape[2], k.shape[2]
    logits = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5 if scale is None else scale)
    if causal:
        visible = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~visible, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def phase_hybrid_card_vs_cpu(torch):
    """zamba2's SMOKE config cut to 5 layers (2 groups and a 1-block tail;
    fp32) on the card and on the CPU from one CPU init: the prefill's logits
    and every cache leaf, three decode steps (teacher-forced) and the final
    cache, each within 1e-4 of its largest |value|; then three SGD steps:
    losses within 1e-5 relative, and each param leaf within 1e-4 of its
    largest |value| of the same steps run exactly (fp64 on the CPU), or,
    where the CPU's fp32 run itself is further than that from the exact one
    (the zero-initialised conv_b and dt_bias, whose values are only their
    summed, cancelling gradients: some 2e-4), within 4 times the CPU's
    distance.  Planted faults must fail: the prefill check with the Mamba2
    states carried without their decay (A = 0), the parameter check with
    the third step's update of layer 0's conv_b skipped on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import _merge_prefill_cache
    from repro_torch.launch.train import make_batches
    from repro_torch.models import attention, model, ssm
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get_smoke_config(HYBRID_ARCH), n_layers=5)
    batches = make_batches(cfg, 4, 64, 0)
    prompt, fed = (torch.as_tensor(batches(i)["tokens"]).long() for i in (0, 1))
    start = steps.init_train_state(cfg, sgd(0.5), 0, "cpu")
    real = ssm._dt_and_A

    def no_decay(params, dt_raw):
        return real(params, dt_raw)[0], torch.zeros_like(params["A_log"].float())

    def serve_on(dev, fault=False):
        params = tree_map(lambda t: t.clone().to(dev), start["params"])
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(mock.patch.object(ssm, "_dt_and_A", no_decay))
            logits, pre = model.prefill(cfg, params, {"tokens": prompt.to(dev)})
            first = {f"{k}/{n}": t.cpu().clone() for k, d in pre.items() for n, t in d.items()}
            cache = _merge_prefill_cache(cfg, model.init_cache(cfg, 4, 67, device=dev), pre)
            steps_ = [model.decode_step(cfg, params, cache, fed[:, i:i + 1].to(dev), 64 + i)[0]
                      .cpu() for i in range(3)]
        final = {f"{k}/{n}": t.cpu() for k, d in cache.items() for n, t in d.items()}
        return logits.cpu(), first, steps_, final

    (lc, fc, sc, xc), (lp, fp, sp, xp) = serve_on("cuda"), serve_on("cpu")
    readings = {"prefill logits": rel_err(lc, lp)}
    readings.update((f"prefill {n}", rel_err(fc[n], fp[n])) for n in fp)
    readings.update((f"decode {i}", rel_err(a, b)) for i, (a, b) in enumerate(zip(sc, sp)))
    readings.update((f"final {n}", rel_err(xc[n], xp[n])) for n in xp)
    planted = rel_err(serve_on("cuda", fault=True)[0], lp)

    def run(dev, dtype=torch.float32, skip_update=False):
        c = dataclasses.replace(cfg, param_dtype=str(dtype)[6:], compute_dtype=str(dtype)[6:])
        state = tree_map(lambda t: t.clone().to(dev, dtype) if t.is_floating_point()
                         else t.clone().to(dev), start)
        step, losses = steps.make_train_step(c, sgd(0.5)), []
        with contextlib.ExitStack() as stack:
            if dtype == torch.float64:
                stack.enter_context(mock.patch.object(attention.ops, "flash_attention",
                                                      exact_attention))
            for i in range(3):
                before = state["params"]["mamba"]["mixer"]["conv_b"][0].clone()
                state, m = step(state, batches(i))
                if skip_update and i == 2:  # planted: layer 0's conv_b keeps its value
                    with torch.no_grad():
                        state["params"]["mamba"]["mixer"]["conv_b"][0].copy_(before)
                losses.append(m["loss"].item())
        return [t.detach().cpu().double() for t in leaves(state["params"])], losses

    (pc, lsc), (pp, lsp), (px, _) = run("cuda"), run("cpu"), run("cpu", torch.float64)

    def param_rows_of(card_params):
        rows = []
        for a, b, x in zip(card_params, pp, px):
            scale = max(float(x.abs().max()), 1e-30)
            card, cpu = float((a - x).abs().max()) / scale, float((b - x).abs().max()) / scale
            rows.append({"card_vs_exact": card, "cpu_vs_exact": cpu,
                         "bound": max(1e-4, 4 * cpu), "card_vs_cpu": rel_err(a, b)})
        return rows

    param_rows = param_rows_of(pc)
    param_ok = all(r["card_vs_exact"] <= r["bound"] for r in param_rows)
    # the worst leaf's distance from the exact run over its bound: > 1 fails
    planted_update = max(r["card_vs_exact"] / r["bound"]
                         for r in param_rows_of(run("cuda", skip_update=True)[0]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lsc, lsp))
    out = {"readings": readings, "planted_no_decay": planted, "param_rows": param_rows,
           "planted_skipped_update": planted_update, "step_loss_rel": loss_rel,
           "losses_card": lsc, "losses_cpu": lsp}
    print(f"[hybrid card vs cpu] {cfg.name} smoke, 5 layers: max|d|/max|cpu| (tol 1e-4) "
          f"{readings}; planted (no decay) {planted:.3e}; 3 SGD steps: losses rel "
          f"{loss_rel:.2e} (tol 1e-5): card {lsc}, cpu {lsp}; params per leaf, max|d|/max|exact| "
          f"(card vs fp64, CPU fp32 vs fp64, bound): "
          f"{[(round(r['card_vs_exact'], 7), round(r['cpu_vs_exact'], 7)) for r in param_rows]}; "
          f"planted (layer 0's conv_b update skipped at step 3) worst leaf over its bound "
          f"{planted_update:.3f} (fails above 1)")
    if not (max(readings.values()) <= 1e-4 and param_ok and loss_rel <= 1e-5):
        raise AssertionError(f"hybrid: card and CPU disagree: {out}")
    if planted <= 1e-4:
        raise AssertionError("hybrid: the prefill check passes a planted fault (no decay)")
    if not planted_update > 1:
        raise AssertionError("hybrid: the parameter check passes a skipped conv_b update")
    return out


def phase_xlstm_train(torch, card: str):
    """The port's xlstm-1.3b training at full width, depth cut to
    XL_TRAIN_LAYERS, through launch/train (train_cli: XL_STEPS steps, a
    checkpoint every XL_CKPT_EVERY, a fault at XL_FAULT_AT, every replayed
    loss exact, the rescale reload), one K3 launch an sLSTM block a step
    (the block is not rematerialised, as JAX's is not), one step profiled,
    and the first step: every sLSTM block held on its own inputs (K3's h
    and final state against plain within SL_TOL, a planted R transposed
    rejected at the first block; the dx_proj, dR, db the step computed
    within SLSTM_GRAD_RTOL of the exact gradient, autograd through the
    plain recurrence in fp64); the step's loss and gradient leaves against
    its plain-K3 twin printed, not gated (the random-weight stack amplifies
    a rounding-sized change of an sLSTM output, XLSTM's noise control).
    Prints "[xlstm train]" lines and one XLSTM_TRAIN JSON line; returns the
    run's record."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.slstm_step import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import model, xlstm
    from repro_torch.pytree import leaves

    tag = "xlstm train"
    cfg = cut_depth(get_config(XL_ARCH), XL_TRAIN_LAYERS)
    n_slstm = cfg.n_layers // cfg.slstm_every
    check_disk(tag, cfg)
    batch = train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(0)
    params = model.init(cfg, 0, "cuda")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)

    def loss_and_grads():
        loss, _ = model.loss_fn(cfg, params, batch)
        return loss.item(), torch.autograd.grad(loss, flat)

    # (1) Each sLSTM block of the first step on its own inputs: K3's forward
    # against plain (and a planted R transposed at the first block), and the
    # gradient the step's backward computed against the exact one.
    forwards, planted, recorded = [], {}, []
    real_seq, real_backward = ops.slstm_seq, ops.slstm_backward

    def checked(x_proj, R, b):
        out = real_seq(x_proj, R, b)
        with torch.no_grad():
            args = (x_proj.detach(), R.detach(), b.detach())
            want = ref.slstm_seq_ref(*args)
            forwards.append(slstm_readings(out[0], out[1], *want))
            if "forward" not in planted:
                wrong = ref.slstm_seq_ref(args[0], args[1].transpose(-1, -2), args[2])
                planted["forward"] = max(slstm_readings(*wrong, *want).values())
        return out

    def recording(x_proj, R, b, h, dh):
        grads = real_backward(x_proj, R, b, h, dh)
        recorded.append((x_proj, R, b, dh, grads))
        return grads

    launches0 = ops.slstm_seq.launches
    with mock.patch.object(xlstm.ops, "slstm_seq", checked), \
            mock.patch.object(ops, "slstm_backward", recording):
        loss_k, grads_k = loss_and_grads()
    first_launches = ops.slstm_seq.launches - launches0
    grad_rows = []
    for x_proj, R, b, dh, got in recorded:
        exact = slstm_exact_grads(torch, x_proj, R, b, dh)
        grad_rows.append({name: slstm_grad_reading(g, e) for name, g, e in
                          zip(("dx_proj", "dR", "db"), got, exact)})
        del exact
    del recorded

    # (2) The plain-K3 twin: the same step with autograd through the plain
    # recurrence (fp32), its loss and every gradient leaf printed.
    with mock.patch.object(xlstm.ops, "slstm_seq", ref.slstm_seq_ref):
        loss_p, grads_p = loss_and_grads()
    names = [name for name, _ in named_leaves(params)]
    plain = dict(zip(names, grads_p))
    grad_rel = {name: float((g - plain[name]).abs().max())
                / max(float(plain[zero_grad_sibling(name)].abs().max()), 1e-30)
                for name, g in zip(names, grads_k)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    del grads_k, grads_p, plain
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_forward = max(max(r.values()) for r in forwards)
    worst_grad = max(max(r.values()) for r in grad_rows)
    print(f"[{tag}] first step, each sLSTM block on its own inputs: K3 vs plain {forwards} "
          f"(gate {SL_TOL}); the step's gradient vs the exact one {grad_rows} (gate "
          f"{SLSTM_GRAD_RTOL}); planted (R transposed at the first block) {planted}")
    print(f"[{tag}] first step, K3 vs plain-K3 twin (printed, not gated): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}); per-leaf max|dg|/max|g| (b_i at r_i's scale) max "
          f"{max(grad_rel.values()):.3e}: {({k: float(f'{v:.4g}') for k, v in grad_rel.items()})}; K3 "
          f"launches {first_launches}")
    if first_launches != n_slstm or len(forwards) != n_slstm or len(grad_rows) != n_slstm:
        raise AssertionError(f"{tag}: {first_launches} K3 launches, {len(forwards)} forwards and "
                             f"{len(grad_rows)} backwards in one loss and gradient, expected "
                             f"{n_slstm} each (the sLSTM block is not rematerialised)")
    if not (worst_forward <= SL_TOL and worst_grad <= SLSTM_GRAD_RTOL and finite):
        raise AssertionError(f"{tag}: an sLSTM block's K3 or its gradient disagrees on its "
                             f"inputs: {forwards}, {grad_rows}")
    if not planted["forward"] > SL_TOL:
        raise AssertionError(f"{tag}: the per-block gate passes a planted wrong recurrence")

    profile = profile_train_step(torch, tag, cfg, params, batch, XL_STEPS)
    del params, flat
    torch.cuda.empty_cache()
    rec = train_cli(torch, card, tag, XL_ARCH, XL_TRAIN_LAYERS, XL_STEPS, XL_CKPT_EVERY,
                    XL_FAULT_AT, lambda: ops.slstm_seq.launches, n_slstm, "K3",
                    exact_replay=True)
    rec["first_step"] = {"loss": loss_k, "plain_loss": loss_p, "loss_rel": loss_rel,
                         "grad_rel": grad_rel, "block_forwards": forwards,
                         "block_grads": grad_rows, "planted": planted}
    rec["profile"] = {**profile, "busy_share": profile["device_ms"] / rec["step_ms"]}
    print(f"[{tag}] busy share {rec['profile']['busy_share']:.3f}")
    print("XLSTM_TRAIN " + json.dumps(rec))
    return rec


def zero_grad_sibling(name: str) -> str:
    """The leaf whose scale holds `name` when its exact gradient is zero: the
    sLSTM input-gate bias (h is invariant under a constant shift of raw_i,
    which scales c and n alike) against the input gate's recurrent weights."""
    return {"slstm/mixer/b_i": "slstm/mixer/r_i"}.get(name, name)


def named_leaves(tree, prefix=""):
    """(path, tensor) of a nested dict in the port's leaf order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def phase_xlstm_card_vs_cpu(torch):
    """xlstm's SMOKE config (2 groups of an mLSTM and an sLSTM block; fp32)
    on the card and on the CPU from one CPU init: the forward's loss within
    1e-5 relative (its logits against an fp64 forward printed beside a
    one-ulp noise control); then
    three SGD steps: losses within 1e-5 relative, and each param leaf within
    max(1e-4, 4 x the CPU's distance) of its largest |value| of the same
    steps run in fp64 on the CPU (the plain recurrence in fp64 for K3; the
    mLSTM cell keeps its fp32 internals, as the hybrid's anchor keeps the
    SSD's), the sLSTM input-gate bias, whose exact gradient is zero, at
    its sibling's scale (zero_grad_sibling).  A planted fault (the card's
    backward dropping the dc carry) must fail the parameter check."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.slstm_step import backward, ref
    from repro_torch.launch.train import make_batches
    from repro_torch.models import model, xlstm
    from repro_torch.optim import sgd
    from repro_torch.pytree import tree_map
    from repro_torch.runtime import steps

    cfg = get_smoke_config(XL_ARCH)
    batches = make_batches(cfg, 4, 64, 0)
    start = steps.init_train_state(cfg, sgd(0.5), 0, "cpu")

    def config(dtype):
        return dataclasses.replace(cfg, param_dtype=str(dtype)[6:], compute_dtype=str(dtype)[6:])

    def exact_recurrence(dtype):
        if dtype == torch.float64:
            return mock.patch.object(xlstm.ops, "slstm_seq", ref.slstm_seq_ref)
        return contextlib.nullcontext()

    def forward_on(dev, dtype=torch.float32):
        params = tree_map(lambda t: t.clone().to(dev, dtype), start["params"])
        with torch.no_grad(), exact_recurrence(dtype):
            logits, _ = model.forward(config(dtype), params, batches(0))
            loss, _ = model.loss_fn(config(dtype), params, batches(0))
        return logits.cpu().double(), loss.item()

    # The logits of the random-weight stack carry a change of an sLSTM
    # output far (XLSTM's noise control), and K3's fp32 h may differ from
    # plain by more than an ulp (SL_TEST_TOL): the card's and the CPU's
    # logits against the fp64 forward are printed beside a control, the
    # CPU's forward with one fp32 ulp of noise on every sLSTM h; the loss is
    # gated.
    def ulp_noise(x_proj, R, b):
        h, state = ref.slstm_seq_ref(x_proj, R, b)
        noise = torch.randn(h.shape, generator=torch.Generator().manual_seed(3))
        return h * (1 + 2.0 ** -23 * noise), state

    (lc, lsc), (lp, lsp), (lx, _) = (forward_on("cuda"), forward_on("cpu"),
                                     forward_on("cpu", torch.float64))
    with mock.patch.object(xlstm.ops, "slstm_seq", ulp_noise):
        control = rel_err(forward_on("cpu")[0], lx)
    forward = {"logits_card_vs_exact": rel_err(lc, lx), "logits_cpu_vs_exact": rel_err(lp, lx),
               "logits_ulp_noise_control": control, "logits_card_vs_cpu": rel_err(lc, lp),
               "loss_rel": abs(lsc - lsp) / abs(lsp)}

    def no_dc(dcn, f_s):
        out = dcn.mul_(f_s)
        out[:, :, 0] = 0.0
        return out

    def run(dev, dtype=torch.float32, fault=False):
        state = tree_map(lambda t: t.clone().to(dev, dtype) if t.is_floating_point()
                         else t.clone().to(dev), start)
        step, losses = steps.make_train_step(config(dtype), sgd(0.5)), []
        with contextlib.ExitStack() as stack:
            stack.enter_context(exact_recurrence(dtype))
            if fault:
                stack.enter_context(mock.patch.object(backward, "carried", no_dc))
            for i in range(3):
                state, m = step(state, batches(i))
                losses.append(m["loss"].item())
        return {n: t.detach().cpu().double() for n, t in named_leaves(state["params"])}, losses

    (pc, lsc3), (pp, lsp3), (px, _) = run("cuda"), run("cpu"), run("cpu", torch.float64)

    def param_rows_of(card_params):
        rows = {}
        for name, x in px.items():
            scale = max(float(px[zero_grad_sibling(name)].abs().max()), 1e-30)
            card = float((card_params[name] - x).abs().max()) / scale
            cpu = float((pp[name] - x).abs().max()) / scale
            rows[name] = {"card_vs_exact": card, "cpu_vs_exact": cpu,
                          "bound": max(1e-4, 4 * cpu)}
        return rows

    param_rows = param_rows_of(pc)
    param_ok = all(r["card_vs_exact"] <= r["bound"] for r in param_rows.values())
    planted = max(r["card_vs_exact"] / r["bound"]
                  for r in param_rows_of(run("cuda", fault=True)[0]).values())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lsc3, lsp3))
    out = {"forward": forward, "param_rows": param_rows, "step_loss_rel": loss_rel,
           "losses_card": lsc3, "losses_cpu": lsp3, "planted_no_dc_carry": planted}
    print(f"[xlstm card vs cpu] {cfg.name} smoke: forward {forward} (loss tol 1e-5, logits "
          f"printed); "
          f"3 SGD steps: losses rel {loss_rel:.2e} (tol 1e-5): card {lsc3}, cpu {lsp3}; params "
          f"per leaf, max|d|/max|exact| (card vs fp64, CPU fp32 vs fp64): "
          f"{[(n, round(r['card_vs_exact'], 7), round(r['cpu_vs_exact'], 7)) for n, r in param_rows.items()]}; "
          f"planted (the backward's dc carry dropped on the card) worst leaf over its bound "
          f"{planted:.3f} (fails above 1)")
    if not (forward["loss_rel"] <= 1e-5 and param_ok and loss_rel <= 1e-5):
        raise AssertionError(f"xlstm: card and CPU disagree: {out}")
    if not planted > 1:
        raise AssertionError("xlstm: the parameter check passes a backward without its dc carry")
    return out


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
    """The torch twins of examples/ on the card, at the JAX scripts' sizes
    cut in depth as TWIN_CUTS says.  quickstart, denoise_image and
    novel_docs are plain PyTorch (no kernel);
    graph_gossip and multi_pod run the port's coder, whose every iteration
    is a K1 call (iters + 1 a solve); train_lm trains LM_100M (cut) through K2
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
        "train_lm": (0, 2 * TWIN_CUTS["train_lm"]["n_layers"] * TWIN_LM_STEPS),
    }
    out = {}
    for name, mod in (("quickstart", quickstart), ("denoise_image", denoise_image),
                      ("novel_docs", novel_docs), ("graph_gossip", graph_gossip),
                      ("multi_pod", multi_pod), ("train_lm", train_lm)):
        reset_launch_counts()
        t = time.perf_counter()
        result = mod.run(device="cuda", **TWIN_CUTS[name])
        wall = time.perf_counter() - t
        got = (dd_ops.dict_dual_step.launches, fa_ops.flash_attention.launches,
               sl_ops.slstm_seq.launches)
        if name == "train_lm":
            shutil.rmtree(result["ckpt_dir"], ignore_errors=True)
            result = {k: v for k, v in result.items() if k != "losses"}
        out[name] = {"cut": TWIN_CUTS[name], "wall_s": wall,
                     "launches": {"dict_dual_step": got[0], "flash_attention": got[1],
                                  "slstm_seq": got[2]}, "result": result}
        print(f"[twins:{name}] {card}: wall {wall:.1f} s at {TWIN_CUTS[name]}, launches "
              f"(K1, K2, K3) {got}: {result}")
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
    """The table3_auc and fig5_denoise twins on the card at EXPERIMENT_CUTS."""
    from repro_torch.experiments import fig5_denoise, table3_auc

    cuts = EXPERIMENT_CUTS
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


# ---------------------------------------------------------------------------
# Sharded training over a (data, model) mesh (SHARDED line)
# ---------------------------------------------------------------------------

# One card, several ranks: NCCL takes one rank a card, so the ranks of a
# mesh share the card and move their collectives through host memory
# (runtime/mesh.py's gloo_staged); compute and every K2 launch stay on the
# card.  Step times here measure that transport, not a deployment.  Gates:
#   * olmo-1b at full width cut to SHARD_LAYERS layers, mesh 2x2 (tensor-
#     parallel over 2, data-parallel over 2: 8 of 16 heads a rank, 2 of the
#     4 rows), SHARD_STEPS SGD steps at SHARD_LR (constant), launch/train's
#     rank body (`train._train_ranks`, what --mesh runs on each rank) in one
#     spawned world with the granite, a2a and planted runs below (starting
#     a world costs each rank seconds), against the same config, seed and
#     batches at 1x1 here:
#     the first loss within SHARD_LOSS_RTOL, the last step's params within bf16
#     rounding of the 1x1 run's (each leaf's largest |difference| at most
#     2^-8 of its largest |value|) and their updates (pN - p0) within
#     GRAD_BF16_TOL of the 1x1 updates, leaf by leaf; K2 launched on every
#     rank, two a layer a step, only at (2, 8 / 8, 2048, 128) bf16 on
#     wgmma_tma.  SGD, never AdamW: AdamW maps rounding to updates of order
#     lr (ROADMAP section 3);
#   * the same run through launch/train on a 1x1 mesh over nccl (world
#     size 1, the one check of the NCCL path one card allows; its one rank
#     is this process): every loss and every param bit for bit the 1x1
#     run's without a mesh;
#   * granite-moe-1b-a400m at full width cut to SHARD_MOE_LAYERS (4 until
#     the sequence-parallel checks needed the room), mesh 1x2 (16
#     experts a rank through moe_a2a), AdamW, SHARD_MOE_STEPS steps with a
#     checkpoint every SHARD_MOE_CKPT and a fault at SHARD_MOE_FAULT: the
#     replayed loss bit for bit the first pass's; then the reload of step
#     SHARD_MOE_RESCALE on a 2x1 mesh (its capacity dispatch over the data
#     shards), whose loss there is within SHARD_LOSS_RTOL of the saved
#     run's; K2 on every rank at (4, 8 / 4, 2048, 64), then (2, 16 / 8);
#   * the a2a layer at granite's widths (d 1024, 32 experts, top 8, d_ff
#     512) on a 1x2 mesh at capacity SHARD_A2A_CF (nothing dropped) against
#     moe_ref on the card, fp32: the output and the gradients of every
#     weight and of x within SHARD_A2A_RTOL of the largest;
#   * planted faults at the olmo SMOKE config (fp32) on a 2x2 mesh: the
#     clean run's three SGD steps within SHARD_SMOKE_RTOL of the 1x1 run on
#     the card (losses and every param), and each of the attention's
#     row-parallel output without its psum (its psum-scatter under SP)
#     and the data-parallel gradients left unaveraged outside it;
#   * the sequence-parallel residual (SP line): every sharded run above
#     and SERVE_MESH's prefills run it (rules "seq" -> model, S % tp == 0);
#     olmo-1b cut to SHARD_LAYERS at 2x2, one SGD step from seed 0 on one
#     batch under the config's rules and under {"seq": None} (replicated):
#     the loss and every leaf's update (lr x the gradient) within
#     SHARD_SMOKE_RTOL; the bytes remat keeps a layer on rank 0
#     (model.remat_saved) exactly 1/tp of the replicated run's; the
#     device memory the loss's forward leaves allocated on rank 0
#     (torch.cuda.memory_allocated) below the replicated run's by at
#     least SP_HELD_SHARE of the kept bytes' difference over the stack; K2's launches per
#     rank those of the replicated run; a planted block that keeps its
#     residual gathered across the remat (its saved bytes tp times, its
#     forward holding as much more) rejected; granite-8b's SMOKE config (rms norms) 2x2 against
#     1x1 as the olmo SMOKE runs above, clean and with the norms'
#     gradients left without their sum over `model` (planted, rejected);
#     granite-8b's FSDP gradient check keeps 1/tp of the residual a layer.
SHARD_ARCH, SHARD_MOE_ARCH, SHARD_LAYERS, SHARD_MOE_LAYERS = (
    "olmo_1b", "granite_moe_1b_a400m", 4, 2)
# The planted SP norm fault runs at a SMOKE config with rms norms (olmo's
# are nonparametric).
NORM_ARCH = "granite_8b"
NORM_CLEAN, NORM_PLANTED = "clean, rms norms", "norms' gradients unsummed over model"
SHARD_STEPS, SHARD_LR = 2, 0.1
SHARD_MOE_STEPS, SHARD_MOE_CKPT, SHARD_MOE_FAULT, SHARD_MOE_RESCALE = 4, 2, 3, 2
SHARD_LOSS_RTOL = 2.0 ** -7
SHARD_A2A_WIDTHS = (1024, 512, 32, 8)  # granite-moe: d, expert d_ff, experts, top-k
SHARD_A2A_SHAPE, SHARD_A2A_CF, SHARD_A2A_RTOL = (2, 512), 4.0, 1e-4
SHARD_SMOKE_RTOL = 1e-4
SHARD_TRANSPORT = "gloo_staged"


def print_sharded_run(tag: str, out: dict) -> None:
    times = out["step_times"]
    print(f"[sharded {tag}] mesh {out['mesh']}, transport {out['transport']}, world "
          f"{out['world']}: losses {out['losses']}; K2 launches per rank {out['k2_launches']} "
          f"at {out['k2_shapes']}; step ms (rank 0's clock) {[round(t * 1e3, 1) for t in times]};"
          f" rank 0's last step on the wire, per axis [collectives, bytes] "
          f"{out['step_traffic']}; rank 0's seconds {out['rank0_seconds']}")


def sharded_cli(torch, tag: str, argv) -> dict:
    """launch/train with argv on the card (mesh.launch spawns the ranks);
    rank 0's result, the wall seconds beside it."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    out = train.run(train.parse_args(argv + ["--device", "cuda"]))
    out["wall_s"] = time.perf_counter() - t0
    print_sharded_run(tag, out)
    return out


def cli_rank_args(argv, ckpt_dir) -> dict:
    """The arguments launch/train's ranks take for argv (on the card)."""
    from repro_torch.launch import train

    return dict(vars(train.parse_args(argv + ["--device", "cuda"])), ckpt_dir=str(ckpt_dir))


def _sgd_reference(torch, cfg, batches, lr, n_steps):
    """The SGD run on one device without a mesh: (losses, params before,
    params after), the params as CPU tensors in leaf order."""
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant

    return _reference_run(torch, cfg, sgd(constant(lr)), batches, n_steps)


def _reference_run(torch, cfg, opt, batches, n_steps):
    """n_steps of `opt` from seed 0 on one device without a mesh:
    (losses, params before, params after), the params as CPU tensors in
    leaf order."""
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    state = steps.init_train_state(cfg, opt, 0, "cuda")
    before = [t.detach().cpu().clone() for t in leaves(state["params"])]
    step = steps.make_train_step(cfg, opt)
    losses = []
    for i in range(n_steps):
        state, m = step(state, batches(i))
        losses.append(float(m["loss"]))
    after = [t.detach().cpu().clone() for t in leaves(state["params"])]
    del state
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return losses, before, after


def _checkpoint_params(cfg, opt, directory, step):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    tree, got = CheckpointManager(directory).restore(steps.abstract_train_state(cfg, opt), step)
    if got != step:
        raise AssertionError(f"no checkpoint of step {step} in {directory}")
    return leaves(tree["params"])


def _one_device_loss(torch, cfg, directory, step) -> float:
    """The loss of checkpoint `step`'s state on batch `step`, on one
    device in this process (what a reload computes at its first step)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    tree, got = CheckpointManager(directory).restore(
        steps.abstract_train_state(cfg, adamw(1e-3)), step, device="cuda")
    with torch.no_grad():
        loss, _ = model.loss_fn(cfg, tree["params"],
                                train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(step))
    del tree
    return float(loss)


def _k2_ranks(tag, out, per_rank, shape, key="k2_launches", shapes_key="k2_shapes"):
    """Rank r launched K2 per_rank[r] times, only at `shape` (none where 0)."""
    counts, shapes = out[key], out[shapes_key]
    want = [[shape] if n else [] for n in per_rank]
    if list(counts) != list(per_rank) or [list(map(tuple, s)) for s in shapes] != want:
        raise AssertionError(f"{tag}: K2 launches per rank {counts} at {shapes}, expected "
                             f"{per_rank} at {shape}")


class NoModelPsum:
    """The sharding hook (models/sharding_hook) with g, the psum over
    `model`, the identity, and under the sequence-parallel residual its
    psum-scatter the rank's chunk of its own partial sums: a planted
    fault's view of it."""

    def __getattr__(self, name):
        from repro_torch.models import sharding_hook

        return getattr(sharding_hook, name)

    @staticmethod
    def leave_model(x):
        return x

    @staticmethod
    def row_out(x):
        from repro_torch.models import sharding_hook

        return sharding_hook.seq_part(x)  # the identity on a replicated residual


def sharded_world(mesh, job: dict) -> dict:
    """Rank function (mesh.launch, 2x2 over gloo_staged; one world, since
    starting one costs each rank seconds): launch/train's own rank body
    (`train._train_ranks`, what `--mesh` runs on each rank) for olmo-1b on
    this 2x2 mesh and for granite-moe on the 1x2 mesh of ranks 0-1 (the
    others idle) with its 2x1 reload; then the a2a layer at granite's
    widths on that 1x2 mesh against moe_ref; then the olmo SMOKE config's
    granite-8b cut to FSDP_LAYERS on this 2x2 mesh with `embed` over
    `data` (launch/train's rank body, AdamW) and Adafactor on its shards
    (fsdp_adafactor); then the olmo SMOKE config's three SGD steps at 2x2,
    clean and with each planted fault; then the hybrid and xlstm families
    (recurrent_world), SERVE_MESH (serve_mesh_world) and the paper's engine
    one agent a rank (dict_mesh_world).  Rank 0 returns the runs and the
    readings."""
    import torch

    from repro_torch.launch import train
    from repro_torch.models import attention, moe, moe_a2a, sharding_hook
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.runtime import mesh as mesh_mod, sharding, steps

    out = {}
    sub = mesh_mod.make_mesh((1, 2))
    for tag, m in (("olmo", mesh), ("granite", sub)):
        t0 = time.perf_counter()
        run = train._train_ranks(m, job[tag])
        if mesh.rank == 0:
            out[tag] = {**run, "wall_s": time.perf_counter() - t0}
    if sub is not None:
        d, f, e, k = job["a2a_widths"]
        dev = mesh.device
        gen = torch.Generator(device=dev).manual_seed(3)
        full = moe.init_moe(gen, d, f, e, dtype=torch.float32)
        x = torch.randn(*job["a2a_tokens"], d, generator=gen, device=dev)
        c = torch.randn(*job["a2a_tokens"], d, generator=gen, device=dev)
        specs = {"router": (None, None), "wi": ("model", None, None),
                 "wg": ("model", None, None), "wo": ("model", None, None)}
        params = sharding.shard_tree(full, specs, sub)
        flat = leaves(params) + [x]
        for t in flat:
            t.requires_grad_(True)
        t0 = time.perf_counter()
        y, _ = moe_a2a.apply_moe_a2a(sub, params, x, top_k=k, n_experts=e,
                                     capacity_factor=SHARD_A2A_CF)
        grads = torch.autograd.grad(torch.sum(y * c), flat)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gfull = leaves(sharding.unshard_tree(unflatten(params, grads[:-1]), specs, sub))
        gx = grads[-1]
        if sub.rank == 0:
            ref_flat = [t.detach().clone().requires_grad_(True) for t in leaves(full) + [x]]
            ref_params = unflatten(full, ref_flat[:-1])
            want = moe.moe_ref(ref_params, ref_flat[-1], top_k=k)
            rgrads = torch.autograd.grad(torch.sum(want * c), ref_flat)
            out["a2a"] = {
                "out": rel_err(y.detach(), want.detach()),
                "grads": [rel_err(g, w) for g, w in zip(gfull + [gx], rgrads)],
                "wall_s": wall,
            }
    t0 = time.perf_counter()
    run = train._train_ranks(mesh, job["granite8b"])
    if mesh.rank == 0:
        out["granite8b"] = {**run, "wall_s": time.perf_counter() - t0}
    got = fsdp_adafactor(mesh)
    if mesh.rank == 0:
        out["fsdp_adafactor"] = got
    t0 = time.perf_counter()
    got = fsdp_sgd_step(mesh, job["granite8b_cfg"])
    if mesh.rank == 0:
        out["fsdp_gradient"] = {**got, "wall_s": time.perf_counter() - t0}
    faults = {"clean": contextlib.nullcontext(),
              "row-parallel output without its psum": mock.patch.object(
                  attention, "hook", NoModelPsum()),
              "data-parallel gradients unaveraged": mock.patch.object(
                  steps, "_average_over_data", lambda m, grads, specs: list(grads)),
              NORM_CLEAN: contextlib.nullcontext(),
              NORM_PLANTED: mock.patch.object(sharding_hook, "seq_shared", lambda p: p)}
    opt = sgd(job["smoke_lr"])
    for name, patch in faults.items():
        cfg = job["norm_cfg"] if name in (NORM_CLEAN, NORM_PLANTED) else job["smoke_cfg"]
        state = steps.init_train_state(cfg, opt, 0, mesh.device, mesh)
        specs = steps.state_shardings(cfg, opt, mesh)["params"]
        step = steps.make_train_step(cfg, opt, mesh)
        losses = []
        with patch:
            for b in job["smoke_batches"]:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        whole = [t.detach().cpu() for t in
                 leaves(sharding.unshard_tree(state["params"], specs, mesh))]
        if mesh.rank == 0:
            out[name] = {"losses": losses, "params": whole}
    del state
    t0 = time.perf_counter()
    got = sp_check(mesh, job["sp"])
    if mesh.rank == 0:
        out["sp"] = {**got, "wall_s": time.perf_counter() - t0}
    out["recurrent"] = recurrent_world(mesh, job["recurrent"])
    out["serve_mesh"] = serve_mesh_world(mesh, sub, job["serve_mesh"])
    out["dict_mesh"] = dict_mesh_world(mesh, job["dict_mesh"])
    return out


SP_PLANTED = "residual kept gathered across the remat"
# The share of remat's kept bytes' difference over the stack (replicated
# less SP) that the device memory held by the forward must show, for the
# replicated run and the planted one against SP (the allocator's blocks
# and a norm's saved input may move it; the kept bytes are exact).
SP_HELD_SHARE = 0.9


def sp_saved_ok(saved, replicated, tp) -> bool:
    """The SP gate on remat's kept bytes a layer: one entry a layer, each
    exactly 1/tp of the replicated run's."""
    return bool(saved) and len(saved) == len(replicated) and all(
        a * tp == b for a, b in zip(saved, replicated))


def sp_check(mesh, job: dict):
    """The sequence-parallel residual at olmo-1b's width (job["cfg"], cut
    to SHARD_LAYERS) on this 2x2 mesh: one SGD step from seed 0 on
    job["batch"] under the config's rules ("seq" -> model: the residual
    sharded on its sequence) and under {"seq": None} (replicated), each
    from the same params: its loss, the bytes remat keeps a layer
    (model.remat_saved), K2's launches on every rank, the step's wire per
    axis and rank 0's step ms; per leaf, max |SP update - replicated
    update| / max |replicated update| over the world; the device memory
    that the loss's forward alone leaves allocated for its backward
    (torch.cuda.memory_allocated after it less before it, rank 0: the
    allocator's own count of what the graph and the checkpoints hold),
    under each layout; and, as a planted fault, that forward under the
    config's rules with each layer's residual gathered before its
    checkpoint (and cut inside it: the same arithmetic, tp times the kept
    bytes).  Rank 0 returns them."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model, sharding_hook
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding, steps

    cfg, batch = job["cfg"], job["batch"]
    opt = sgd(SHARD_LR)
    state = steps.init_train_state(cfg, opt, 0, mesh.device, mesh)
    start = [t.detach().clone() for t in leaves(state["params"])]
    names = [path for path, _ in named_leaves(state["params"])]
    remat = model._remat

    def gathered(c, fn, lp, h, *rest):  # planted: the whole residual kept by the checkpoint
        def inner(lp, h_whole, *r):
            return fn(lp, sharding_hook.seq_part(h_whole), *r)
        return remat(c, inner, lp, sharding_hook.seq_whole(h), *rest)

    local = steps.batch_to_device(steps.data_shard(batch, mesh), mesh.device)

    def forward_held(rules, patch=contextlib.nullcontext()):
        """The loss's forward alone under `rules`: (bytes it leaves
        allocated, remat's kept bytes a layer)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.enable_grad(), patch, sharding_hook.installed(mesh, rules), \
                model.remat_saved() as saved:
            for p in leaves(state["params"]):
                p.requires_grad_(True)
            loss, _ = model.loss_fn(cfg, state["params"], local)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before
        del loss
        return held, list(saved)

    runs, updates = {}, {}
    for name, rules in (("sp", sharding.rules_for(cfg)),
                        ("replicated", sharding.rules_for(cfg, {"seq": None}))):
        with torch.no_grad():
            for p, s0 in zip(leaves(state["params"]), start):
                p.copy_(s0)
        step = steps.make_train_step(cfg, opt, mesh, rules=rules)
        k2 = ops.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with model.remat_saved() as saved:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[name] = {"layout": "seq" if sharding.residual_seq_axis(
                          mesh, rules, batch["tokens"].shape[1]) else "replicated",
                      "loss": float(m["loss"]), "saved_bytes_per_layer": list(saved),
                      "k2_launches": mesh.all_gather_object(ops.flash_attention.launches - k2),
                      "step_traffic": mesh.step_traffic, "step_ms": ms}
        with torch.no_grad():
            updates[name] = [s0 - p for s0, p in zip(start, leaves(state["params"]))]
        runs[name]["forward_held_bytes"] = forward_held(rules)[0]
    # the planted run: its forward alone (the checkpoints keep what they keep there)
    held, saved = forward_held(sharding.rules_for(cfg), mock.patch.object(model, "_remat",
                                                                           gathered))
    runs[SP_PLANTED] = {"saved_bytes_per_layer": saved, "forward_held_bytes": held}
    with torch.no_grad():
        d = torch.stack([(a - b).abs().max().float()
                         for a, b in zip(updates["sp"], updates["replicated"])])
        w = torch.stack([b.abs().max().float() for b in updates["replicated"]])
        for axis in ("data", "model"):
            d, w = mesh.pmax(d, axis), mesh.pmax(w, axis)
    readings = dict(zip(names, (d / w.clamp_min(1e-30)).tolist()))
    del state, start, updates
    torch.cuda.empty_cache()
    return {"runs": runs, "update_readings": readings} if mesh.rank == 0 else None


def fsdp_sgd_step(mesh, cfg):
    """The FSDP gradient, leaf by leaf: one SGD step at SHARD_LR (its update
    p0 - p1 is lr x the gradient averaged over `data`) of `cfg` (granite-8b
    cut to FSDP_LAYERS, `embed` over `data`) from seed 0 on the first batch
    of the AdamW run, at 2x2 through steps.make_train_step, against the same
    step on one device.  Each rank takes the one-device step itself, one
    rank at a time (a whole tree and its gradient on the card at once), and
    keeps its shard of that update: no weight crosses the wire for the
    check.  Readings per leaf: max |d| / max |one-device update| over the
    world.  Then the same 2x2 step from the same params with the FSDP
    leaves' gradient left unaveraged over `data` (their psum_scatter's sum
    not divided by dp: a planted fault).  Rank 0 returns {"readings",
    "planted"} (leaf path -> reading) and "saved_bytes_per_layer"
    (model.remat_saved: the residual each layer's checkpoint keeps in the
    clean step)."""
    import torch

    from repro_torch.launch import train
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.runtime import sharding, steps

    opt = sgd(SHARD_LR)
    specs = steps.state_shardings(cfg, opt, mesh)["params"]
    flat_specs = leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    batch = train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)(0)
    one_step = steps.make_train_step(cfg, opt)
    ref = None
    for r in range(mesh.world):
        if mesh.rank == r:
            whole = steps.init_train_state(cfg, opt, 0, mesh.device)
            names = [path for path, _ in named_leaves(whole["params"])]
            p0 = [t.detach().clone() for t in leaves(whole["params"])]
            whole, _ = one_step(whole, batch)
            ref = [sharding.shard_tensor(a - b, s, mesh)
                   for a, b, s in zip(p0, leaves(whole["params"]), flat_specs)]
            params = sharding.shard_tree(unflatten(whole["params"], p0), specs, mesh)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros_like(whole["step"])}
            del whole, p0
            torch.cuda.empty_cache()
        mesh.barrier()
    start = [t.detach().clone() for t in leaves(state["params"])]
    step = steps.make_train_step(cfg, opt, mesh)
    averaged = steps._average_over_data

    def unaveraged(m, grads, sp):  # planted: the FSDP leaves keep their sum over `data`
        return [g * m.size("data") if "data" in sharding.spec_axes(s) else g
                for g, s in zip(averaged(m, grads, sp), sp)]

    from repro_torch.models import model

    out = {}
    for name, patch in (("readings", contextlib.nullcontext()),
                        ("planted", mock.patch.object(steps, "_average_over_data", unaveraged))):
        with torch.no_grad():
            for p, s in zip(leaves(state["params"]), start):
                p.copy_(s)
        with patch, model.remat_saved() as saved:
            state, _ = step(state, batch)
        if name == "readings":
            out["saved_bytes_per_layer"] = list(saved)
        with torch.no_grad():
            d = torch.stack([(s - p - u).abs().max().float()
                             for p, s, u in zip(leaves(state["params"]), start, ref)])
            w = torch.stack([u.abs().max().float() for u in ref])
            for axis in ("data", "model"):
                d, w = mesh.pmax(d, axis), mesh.pmax(w, axis)
        out[name] = dict(zip(names, (d / w.clamp_min(1e-30)).tolist()))
    del state, start, ref
    torch.cuda.empty_cache()
    return out if mesh.rank == 0 else None


def fsdp_adafactor(mesh):
    """One Adafactor update (optimizers.adafactor: for_arch's choice for a
    bf16-param config) on granite-8b's embedding table and first layer at
    full width, cut on this 2x2 mesh by the FSDP config's specs (the table
    vocabulary over `model` and `embed` over `data`; every weight of the
    layer its `embed` dim over `data`), against the update of the whole
    leaves on one device (rank 0, no mesh); and once more with the means
    left local (a planted fault: Shards whose psum and sizes are those of
    one rank).  The leaves start at 0 (the update does not read them), the
    gradients are drawn from a seed, the same on every rank.  Rank 0
    returns {"readings", "planted"}: per leaf max |d| / max |whole|."""
    import dataclasses

    import torch

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.models import model
    from repro_torch.optim import adafactor
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding, steps

    cfg = cut_depth(get_config(FSDP_ARCH), 1)
    names = ("embed", "layers")
    specs = {k: model.param_specs(cfg, mesh)[k] for k in names}
    like = model.abstract_params(cfg)
    gen = torch.Generator(device=mesh.device).manual_seed(17)
    grads = {k: model.tree_map(lambda t: torch.randn(t.shape, generator=gen, device=mesh.device),
                               like[k]) for k in names}
    opt = adafactor(1e-3)
    real = steps.shards_for(mesh, leaves(specs, is_leaf=lambda x: isinstance(x, tuple)))
    local = dataclasses.replace(real, psum=lambda x, axis: x, size=lambda axis: 1)

    def sharded(shards):
        params = sharding.shard_tree(model.tree_map(torch.zeros_like, grads), specs, mesh)
        opt.update(sharding.shard_tree(grads, specs, mesh), opt.init(params), params, 0, shards)
        return sharding.unshard_tree(params, specs, mesh)

    got, bad = sharded(real), sharded(local)
    if mesh.rank:
        return None
    want = model.tree_map(torch.zeros_like, grads)
    opt.update(grads, opt.init(want), want, 0)
    return {key: {path: rel_err(a, w) for (path, a), (_, w) in
                  zip(named_leaves(tree), named_leaves(want))}
            for key, tree in (("readings", got), ("planted", bad))}


def serve_mesh_world(mesh, sub, job: dict) -> dict:
    """SERVE_MESH's rank part (in sharded_world): gemma on the world's 2x2
    mesh, then granite-moe on its 1x2 sub-mesh (`sub`, None on ranks 2-3,
    which only join the world's collectives), then granite-8b cut to
    FSDP_LAYERS with `embed` over `data` on the 2x2 mesh, then zamba2 on
    the 2x2 mesh and xlstm on the 1x2 one (serve_mesh_recurrent_case).
    Rank 0 returns each case's run and every rank's readings."""
    import torch

    out = {}
    for tag, (_, shape, _, _) in SERVE_MESH_CASES.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m = mesh if shape == (2, 2) else sub
        case = serve_mesh_recurrent_case if tag in REC_SERVE else serve_mesh_case
        got = case(torch, m, job[tag])
        if mesh.rank == 0:
            out[tag] = {**got, "wall_s": time.perf_counter() - t0}
    return out


def serve_mesh_case(torch, mesh, case: dict):
    """One SERVE_MESH case on this rank of `mesh` (None: idle, only the
    world's collectives): launch/serve's rank body (greedy, the CLI's
    payload), then against the 1x1 run saved at case["ref"]: layer 0's
    prefill K/V and the cache laid from it (bit for bit); each layer's
    decode attention and (MoE) decode FFN on the 1x1 run's inputs at its
    last position, the cache after that step (only the owner's slot of the
    position changed); a teacher-forced decode of the 1x1 tokens (each
    step's logits against the 1x1 step's, each step's greedy pick agreeing
    over `model`); each of the four planted faults, and for an FSDP config
    (its weights' `embed` dim over `data`, gathered before the checks use
    them) a fifth: a layer's weights used without their gather, each rank's
    shard zero-padded to the whole width.  Rank 0 returns the payload and
    every rank's readings."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention, fsdp, model, transformer
    from repro_torch.models import sharding_hook as hook
    from repro_torch.runtime import steps

    args = serve.parse_args(case["argv"])
    run = serve._serve_ranks(mesh, vars(args), keep=True)
    if mesh is None:
        return None
    t0 = time.perf_counter()
    cfg = serve._config(args)
    payload, tokens = run.get("payload"), run["tokens"]
    ref = torch.load(case["ref"], map_location="cpu")
    dev = mesh.device
    d_i, m_i, m_n = mesh.index("data"), mesh.index("model"), mesh.size("model")
    b = LM_BATCH // mesh.size("data")
    rows = slice(d_i * b, (d_i + 1) * b)
    params, max_len, pos = run["params"], run["max_len"], ref["pos"]
    gen = tokens.shape[1]
    seq = model.seq_sharded(cfg, mesh, max_len)
    n_kv = cfg.n_kv_heads
    with hook.installed(mesh):
        specs = model._gather_specs(cfg, "layers")  # None: nothing over `data`

    with torch.no_grad(), hook.installed(mesh):  # each layer's weights as its block uses them
        gathered = {id(lp): fsdp.gather_tree(lp, specs, mesh, skip=("moe",))
                    for lp in params["layers"]}

    def whole(lp):
        return gathered[id(lp)]

    def zero_padded(lp):  # planted: each shard zero-padded to the whole width
        def pad(t, spec):
            for dim in fsdp.data_dims(spec):
                c, i = t.shape[dim], mesh.index("data")
                shape = list(t.shape)
                shape[dim] = c * mesh.size("data")
                full = t.new_zeros(shape)
                full.narrow(dim, i * c, c).copy_(t)
                t = full
            return t

        def walk(tree, sp):
            return {k: walk(v, sp[k]) if isinstance(v, dict) else pad(v, sp[k])
                    for k, v in tree.items()}
        return walk(lp, specs)

    def heads(h):  # this rank's kv heads of a tensor of h of them
        return slice(None) if h == n_kv else slice(m_i * h, (m_i + 1) * h)

    # (1) Layer 0: the prefill's K/V (the rank's kv heads) and the cache laid
    # from it (the rank's positions of the prompt), bit for bit the 1x1's.
    pre = run["prefill_cache"]["layers"]
    laid = run["cache"]["layers"]
    t_loc, h_c = laid["k"].shape[2], laid["k"].shape[3]
    lo = m_i * t_loc if seq else 0
    n_laid = max(0, min(LM_PROMPT - lo, t_loc))
    bits = {"prefill": all(torch.equal(pre[n][0].cpu(),
                                       ref[f"prefill_{n}0"][rows][:, :, heads(pre[n].shape[3])])
                           for n in ("k", "v")),
            "laid": all(torch.equal(laid[n][0][:, :n_laid].cpu(),
                                    ref[f"prefill_{n}0"][rows][:, lo:lo + n_laid][:, :, heads(h_c)])
                        for n in ("k", "v"))}

    # (2) Each layer's decode attention on the 1x1 run's inputs and cache
    # (this rank's slice of it), and the cache after the step's write.
    def cache_slice(full):  # (B, T, Hkv, Dh) -> this rank's part
        x = full[rows]
        return x[:, m_i * t_loc:(m_i + 1) * t_loc] if seq else x[:, :, heads(h_c)]

    slot = attention._slot_of(pos, t_loc, m_i) if seq else pos  # where this rank writes pos

    def attention_readings(weights=whole):
        readings, slot_readings, untouched = [], [], True
        for layer, lp in enumerate(params["layers"]):
            c = {n: cache_slice(ref[f"cache_{n}"][layer]).to(dev) for n in ("k", "v")}
            kept = {n: t.clone() for n, t in c.items()}
            attn = weights(lp)["attn"]
            with torch.no_grad(), hook.installed(mesh):
                y, _ = attention.decode_attention(
                    attn, ref["attn_in"][layer][rows].to(dev), c, pos,
                    qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
                    n_heads=cfg.n_heads, n_kv=n_kv, seq_sharded=seq)
            readings.append(bf16_reading(y, ref["attn_out"][layer][rows].to(dev)))
            for n in ("k", "v"):
                same = c[n] == kept[n]
                if slot is not None:  # the 1x1 step wrote its slot: within rounding of it
                    slot_readings.append(bf16_reading(c[n][:, slot], kept[n][:, slot]))
                    same[:, slot] = True
                untouched = untouched and bool(same.all())
        return readings, slot_readings, untouched

    def moe_readings():
        out = []
        for layer, lp in enumerate(params["layers"]):
            with torch.no_grad(), hook.installed(mesh):
                y, _ = transformer._moe_ffn(lp["moe"], ref["moe_in"][layer][rows].to(dev), cfg, 1,
                                            specs=None if specs is None else specs["moe"])
            out.append(bf16_reading(y, ref["moe_out"][layer][rows].to(dev)))
        return out

    attn, slots, untouched = attention_readings()
    moe = moe_readings() if "moe_in" in ref else []

    # (3) Teacher-forced: each decode step's logits against the 1x1 step's
    # on the same input tokens (this rank's rows and vocabulary range), and
    # each step's greedy pick over `model`.  While every row's greedy token
    # equals the 1x1 run's, the greedy run's own steps are teacher-forced;
    # from the first that differs, up to SERVE_MESH_FORCED steps feed the
    # 1x1 tokens (on the greedy run's cache: each step rewrites its
    # position and masks the later ones).
    v_loc = run["last_logits"].shape[-1]
    cols = slice(None) if v_loc == cfg.vocab else slice(m_i * v_loc, (m_i + 1) * v_loc)

    def own_shard(c, logits, m):  # planted: the argmax of the rank's own shard
        return torch.argmax(logits, dim=-1) + m.index("model") * logits.shape[-1]

    def picks_agree(pick, logits):
        tok = pick(cfg, logits, mesh)
        every = mesh.all_gather_tiled(tok[None], "model", 0)
        return bool((every == tok[None]).all())

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / float(want.abs().max())

    same = (torch.as_tensor(tokens) == ref["tokens"]).all(0).long().cumprod(0)
    first_diff = int(same.sum())  # step i reads token i: greedy steps before it are forced
    stepped = list(enumerate(run["step_logits"][:first_diff]))
    forced = ref["tokens"][rows].to(dev)
    cache = run["cache"]
    with torch.no_grad():
        for i in range(first_diff, min(gen - 1, first_diff + SERVE_MESH_FORCED)):
            lg, cache = model.decode_step(cfg, params, cache, forced[:, i:i + 1], LM_PROMPT + i,
                                          mesh, max_len)
            stepped.append((i, lg[:, -1, :]))
    tf, agree, agree_planted = {}, True, True
    for i, lg in stepped:
        tf[i] = rel(lg, ref["step_logits"][i][rows][:, cols].to(dev))
        agree = agree and picks_agree(steps.greedy_tokens, lg)
        if v_loc != cfg.vocab:
            agree_planted = agree_planted and picks_agree(own_shard, lg)
    prefill_rel = rel(run["last_logits"], ref["last_logits"][rows][:, cols].to(dev))

    # (4) The planted faults, each through the gate it must fail.
    planted = {}
    with mock.patch.object(ops, "combine_decode_parts", lambda o, m, l_sum: o.mean(0)):
        planted["combine without the l e^(m_r - m) weights"] = max(attention_readings()[0])
    with mock.patch.object(attention, "_slot_of", lambda at, t, r: at % t):
        planted["new K/V written on every rank: cache untouched"] = attention_readings()[2]
    if v_loc != cfg.vocab:
        planted["argmax over the rank's own vocab shard: picks agree"] = agree_planted
    if moe:
        with mock.patch.object(transformer, "hook", NoModelPsum()):
            planted["MoE combine without its psum"] = max(moe_readings())
    if specs is not None:
        planted["a layer's weights without their gather (shards zero-padded)"] = max(
            attention_readings(zero_padded)[0])
    mine = {"rank": mesh.rank, "bits": bits, "attn": attn, "slots": slots,
            "untouched": untouched, "moe": moe, "teacher_forced": tf,
            "prefill_logits_rel": prefill_rel, "picks_agree": agree, "planted": planted,
            "tokens_agree_over_model": run["tokens_agree_over_model"],
            "checks_s": time.perf_counter() - t0, "seq_sharded": seq,
            "local_cache": list(laid["k"].shape)}
    every = mesh.all_gather_object(mine)
    del run, cache, params, ref, gathered
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank:
        return None
    return {"payload": payload, "tokens": tokens, "ranks": every}


# -- RECURRENT: the hybrid and xlstm families on a mesh -----------------------


def _rec_layers(cfg, params, seq_len: int):
    """(stack, block function of (layer params, h), layer params) for every
    block of a hybrid or xlstm config in order (model._hybrid_layers,
    model._xlstm_layers): one pre-norm block on the residual of a forward
    over seq_len positions."""
    import torch

    from repro_torch.models import model
    from repro_torch.models import transformer as tfm

    if cfg.family == "hybrid":
        for kind, _, lp in model._hybrid_layers(cfg, params):
            if kind == "attn":
                yield kind, lambda p, h: tfm.apply_block(
                    p, h, torch.arange(seq_len, device=h.device), cfg)[0], lp
            else:
                yield kind, lambda p, h: model._mamba_layer(p, h, cfg), lp
        return
    for kind, _, _, lp in model._xlstm_layers(cfg, params):
        yield kind, functools.partial(
            lambda k, p, h: model._xlstm_layer(p, h, cfg, k), kind), lp


def recurrent_blocks(mesh, cfg, batch, plant: bool) -> dict:
    """Every block of `cfg` (hybrid or xlstm, seed 0's params) on this rank
    of `mesh`, fed the 1x1 block's input: the whole stack walked on one
    device (each rank computes it: no weight crosses the wire for the
    check), each block's output and its input's and parameters' gradients
    under a cotangent drawn from a seed, against the block on the mesh (the
    rank's rows and, under the sequence-parallel residual, its positions;
    its shard of the parameters) on the same input and cotangent.  Per
    block: bf16_reading of the output, and max |d| / max |1x1| over the
    world for the input's gradient and each parameter's (summed over
    `data`).  An sLSTM block's K3 on the rank's rows against the plain
    recurrence (slstm_readings).  With plant, the first Mamba2 block again
    with its gated norm's sum of squares through g alone.  Rank 0 returns
    {"blocks": [(stack, readings)], "k3": per rank, "planted"}."""
    import torch

    from repro_torch.kernels.slstm_step import ops as k3_ops
    from repro_torch.kernels.slstm_step import ref as k3_ref
    from repro_torch.models import model
    from repro_torch.models import sharding_hook as hook
    from repro_torch.models.layers import apply_norm
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.runtime import sharding, steps

    dev = mesh.device
    whole = model.init(cfg, 0, dev)
    specs = model.param_specs(cfg, mesh)
    mine = model.cast_params(cfg, sharding.shard_tree(whole, specs, mesh))
    whole = model.cast_params(cfg, whole)
    rules = sharding.rules_for(cfg)
    s = batch["tokens"].shape[1]
    dp, tp = mesh.size("data"), mesh.size("model")
    b = batch["tokens"].shape[0] // dp
    rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    seq = sharding.residual_seq_axis(mesh, rules, s) is not None
    r = mesh.index("model")
    cols = slice(r * s // tp, (r + 1) * s // tp) if seq else slice(None)
    with torch.no_grad():
        h = model._embed_inputs(cfg, whole, steps.batch_to_device(batch, dev))
    gen = torch.Generator(device=dev).manual_seed(23)

    def layer_specs(stack):
        key = {"attn": "shared_attn"}.get(stack, stack)
        sp = specs[key]
        return leaves(sp if key == "shared_attn" else model.tree_map(lambda t: t[1:], sp),
                      is_leaf=lambda x: isinstance(x, tuple))

    def grads(fn, lp, x, cot, on_mesh):
        flat = [t.detach().requires_grad_(True) for t in leaves(lp)]
        x = x.detach().requires_grad_(True)
        with torch.enable_grad(), (hook.installed(mesh) if on_mesh else
                                   contextlib.nullcontext()):
            with hook.residual(s, rules) if on_mesh else contextlib.nullcontext():
                out = fn(unflatten(lp, flat), x)
            got = torch.autograd.grad(out, [x] + flat, cot)
        return out.detach(), got

    def readings(stack, fn, lp1, lpm, x, planted=contextlib.nullcontext()):
        cot = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        out1, g1 = grads(fn, lp1, x, cot, False)
        with planted:
            outm, gm = grads(fn, lpm, x[rows][:, cols], cot[rows][:, cols].contiguous(), True)
        d = [float((gm[0] - g1[0][rows][:, cols]).abs().max())]
        w = [float(g1[0][rows][:, cols].abs().max())]
        for g, want, sp in zip(gm[1:], g1[1:], layer_specs(stack)):
            want = sharding.shard_tensor(want, sp, mesh)
            d.append(float((mesh.psum(g.float(), "data") - want.float()).abs().max()))
            w.append(float(want.float().abs().max()))
        d, w = torch.tensor(d, device=dev), torch.tensor(w, device=dev)
        for axis in ("data", "model"):
            d, w = mesh.pmax(d, axis), mesh.pmax(w, axis)
        # the sLSTM input-gate bias (an exact gradient of zero) at r_i's scale
        names = ["x"] + [f"{stack}/{path}" for path, _ in named_leaves(lp1)]
        w = torch.stack([w[names.index(zero_grad_sibling(n))] for n in names])
        rel = (d / w.clamp_min(1e-30)).tolist()
        return out1, {"out": bf16_reading(outm, out1[rows][:, cols]), "dx": rel[0],
                      "dparams": max(rel[1:])}

    blocks, k3, planted = [], None, None
    for (stack, fn, lp1), (_, _, lpm) in zip(_rec_layers(cfg, whole, s),
                                             _rec_layers(cfg, mine, s)):
        out1, got = readings(stack, fn, lp1, lpm, h)
        if stack == "slstm":  # K3 on this rank's rows (the whole sequence) against plain
            with torch.no_grad():
                args = k3_ops.stack_gates(lpm["mixer"], apply_norm(cfg.norm, lpm["norm"], h[rows]),
                                          cfg.n_heads)
                hk, sk = k3_ops.slstm_seq(*args)
                hp, sp_ = k3_ref.slstm_seq_ref(*args)
            k3 = slstm_readings(hk, sk, hp, sp_)
            del args, hk, sk, hp, sp_
        if plant and planted is None and stack == "mamba":
            planted = readings(stack, fn, lp1, lpm, h,
                               mock.patch.object(hook, "model_sum", hook.leave_model))[1]
        blocks.append((stack, got))
        h = out1
    every = mesh.all_gather_object({"k3": k3, "blocks": blocks, "planted": planted})
    del whole, mine, h
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank:
        return None
    return {"blocks": [(stack, {k: max(e["blocks"][i][1][k] for e in every) for k in got})
                       for i, (stack, got) in enumerate(blocks)],
            "k3": [e["k3"] for e in every], "planted": planted and {
                k: max(e["planted"][k] for e in every) for k in planted}}


def recurrent_world(mesh, job: dict) -> dict:
    """RECURRENT's rank part (in sharded_world, before SERVE_MESH): for each
    case of job, launch/train's rank body on this 2x2 mesh (the bytes
    remat keeps, rank 0's), then recurrent_blocks.  Rank 0 returns them."""
    import torch

    from repro_torch.launch import train
    from repro_torch.models import model

    out = {}
    for tag, case in job.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with model.remat_saved() as saved:
            run = train._train_ranks(mesh, case["cli"])
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        blocks = recurrent_blocks(mesh, case["cfg"], case["batch"], tag == "zamba2")
        if mesh.rank == 0:
            out[tag] = {"run": {**run, "wall_s": wall}, "saved": list(saved), **blocks,
                        "blocks_s": time.perf_counter() - t0}
    return out


def recurrent_reference(torch) -> dict:
    """RECURRENT's references on one device, in this process: each case's
    first loss (seed 0's params on batch 0, what the mesh run's first step
    reports).  Returns {"first_loss": {tag: loss}}."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.launch import train
    from repro_torch.models import model

    first = {}
    for tag, (arch, n_layers) in REC_CASES.items():
        cfg = cut_depth(get_config(arch), n_layers)
        params = model.init(cfg, 0, "cuda")
        with torch.no_grad():
            loss, _ = model.loss_fn(cfg, params, train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                                                    0)(0))
        first[tag] = float(loss)
        del params
        torch.cuda.empty_cache()
    return {"first_loss": first}


def recurrent_serve_reference(torch, tag: str) -> None:
    """Save what SERVE_MESH holds a recurrent case's serve against: the 1x1
    serve's tokens, prefill and step logits, and one more decode step (the
    last token, at position LM_PROMPT + gen - 1) with every mixer's input,
    its state cache before the step and its output (Mamba2, mLSTM and
    sLSTM decode; the hybrid's shared block: its decode block, with the
    attention cache before the step)."""
    from repro_torch.launch import serve
    from repro_torch.models import model, ssm, xlstm
    from repro_torch.models import transformer as tfm

    arch, _, depth, gen = SERVE_MESH_CASES[tag]
    argv = [a for a in serve_mesh_argv(tag, "1x1", "auto") if a not in ("--mesh", "1x1",
                                                                        "--transport", "auto")]
    out = serve.run(serve.parse_args(argv))
    cfg, cache = out["cfg"], out["cache"]
    pos = LM_PROMPT + gen - 1
    recs = []

    def wrap(stack, real):
        def fn(params, x, layer_cache, *args, **kw):
            before = {n: t.detach().cpu().clone() for n, t in layer_cache.items()}
            y = real(params, x, layer_cache, *args, **kw)
            recs.append({"stack": stack, "in": x.cpu(), "state": before, "out": y[0].cpu()})
            return y
        return fn

    tok = out["tokens"][:, -1:].to(out["prompts"].device)
    with torch.no_grad(), mock.patch.object(ssm, "mamba2_decode",
                                            wrap("mamba", ssm.mamba2_decode)), \
            mock.patch.object(xlstm, "mlstm_decode", wrap("mlstm", xlstm.mlstm_decode)), \
            mock.patch.object(xlstm, "slstm_decode", wrap("slstm", xlstm.slstm_decode)), \
            mock.patch.object(tfm, "decode_block", wrap("attn", tfm.decode_block)):
        model.decode_step(cfg, out["params"], cache, tok, pos)
    stacks = [s for s in model.stack_sizes(cfg)]
    if "mamba_tail" in stacks:  # the tail's records come last, after the groups'
        raise AssertionError("a recurrent SERVE_MESH case keeps whole groups (no tail)")
    ref = {"pos": pos, "tokens": out["tokens"], "last_logits": out["last_logits"].cpu(),
           "step_logits": torch.stack(out["step_logits"]).cpu(), "layers": recs,
           "prefill_ms": out["prefill_ms"], "decode_ms_per_token": out["decode_ms_per_token"]}
    SERVE_MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(ref, SERVE_MESH_DIR / f"{tag}.pt")
    del out, cache, ref, recs
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_prefill_blocks(mesh, cfg, args, mine, specs, pre_cache) -> dict:
    """Every block of a recurrent SERVE_MESH case's prefill on this rank of
    `mesh`, fed the 1x1 block's input: the 1x1 stack walked on one device
    in this rank (the serve's weights from --seed and its whole prompt
    batch: no weight crosses the wire for the check), each block's prefill
    against the block on the mesh (the rank's rows and, under the
    sequence-parallel residual, its positions; its shard `mine` of the
    weights) on the same input: bf16_reading of the residual after the
    block and of every leaf of the cache it returns against the 1x1 leaf
    cut by `specs` (model.cache_specs: a Mamba2 S by heads and conv_buf by
    segment, an mLSTM state by heads, an sLSTM state by rows; the
    attention K/V on the rank's kv heads).  The first block's state as the
    serve's own prefill cache `pre_cache` holds it, against the 1x1's (the
    slot the serve lays into its decode cache).  Planted: the first block
    again with its norm's sum of squares the rank's own
    (REC_SERVE_PLANTED).  Returns {"blocks": [(stack, reading)],
    "handoff": reading, "planted": reading}."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models import sharding_hook as hook
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding

    dev = mesh.device
    whole = model.cast_params(cfg, model.init(cfg, seed=args.seed, device=dev))
    batch, _ = serve._inputs(cfg, args, dev)
    s = batch["tokens"].shape[1]
    rules = sharding.rules_for(cfg)
    b = batch["tokens"].shape[0] // mesh.size("data")
    rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    tp, r = mesh.size("model"), mesh.index("model")
    seq = sharding.residual_seq_axis(mesh, rules, s) is not None
    cols = slice(r * s // tp, (r + 1) * s // tp) if seq else slice(None)
    positions = torch.arange(s, device=dev)
    lead = {"mamba": 2, "mamba_tail": 1, "mlstm": 2, "slstm": 1}

    def walk(params):  # (stack, where in its cache, h -> (h after the block, its cache))
        if cfg.family == "hybrid":
            for kind, at, lp in model._hybrid_layers(cfg, params):
                if kind == "attn":
                    yield kind, at, lambda h, lp=lp: tfm.prefill_block(lp, h, positions, cfg)[:2]
                else:
                    yield kind, at, lambda h, lp=lp: _add(h, model._mamba_mixer(cfg, lp, h, True))
            return
        for kind, gi, li, lp in model._xlstm_layers(cfg, params):
            yield kind, (gi, li) if kind == "mlstm" else (gi,), lambda h, lp=lp, k=kind: _add(
                h, model._xlstm_mixer(cfg, k, lp, h, True))

    def _add(h, got):
        return h + got[0], got[1]

    def want_cache(stack, st1):
        if stack == "attn":  # the rank's kv heads of the whole sequence
            return {n: t[rows] for n, t in st1.items()}
        return {n: sharding.shard_tensor(t, specs[stack][n][lead[stack]:], mesh)
                for n, t in st1.items()}

    def reading(stack, hm, stm, h1, st1):
        want = want_cache(stack, st1)
        got = [bf16_reading(hm, h1[rows][:, cols])]
        for n, t in stm.items():
            w = want[n]
            if stack == "attn" and t.shape[2] != w.shape[2]:
                w = w[:, :, r * t.shape[2]:(r + 1) * t.shape[2]]
            got.append(bf16_reading(t, w) if t.shape == w.shape else math.inf)
        return max(got)

    out, handoff, planted = [], None, None
    with torch.no_grad():
        h = model._embed_inputs(cfg, whole, batch)
        for (stack, at, fn1), (_, _, fnm) in zip(walk(whole), walk(mine)):
            h1, st1 = fn1(h)
            x = h[rows][:, cols].contiguous()
            with hook.installed(mesh), hook.residual(s, rules):
                hm, stm = fnm(x)
                if planted is None:
                    with mock.patch.object(hook, "model_sum", lambda t: t):
                        planted = reading(stack, *fnm(x), h1, st1)
            out.append((stack, reading(stack, hm, stm, h1, st1)))
            if handoff is None:  # the serve's own prefill: the first block's slot
                handoff = max(bf16_reading(pre_cache[stack][n][at], t)
                              for n, t in want_cache(stack, st1).items())
            h = h1
            del hm, stm, st1
    del whole, h
    return {"blocks": out, "handoff": handoff, "planted": planted}


def serve_mesh_recurrent_case(torch, mesh, case: dict):
    """One recurrent SERVE_MESH case on this rank of `mesh` (None: idle):
    launch/serve's rank body (greedy, the CLI's payload), then every block's
    prefill on the 1x1 block's input (recurrent_prefill_blocks), the serve's
    prefill cache laid into a decode cache (init_cache(mesh=),
    merge_prefill_cache) and compared with it bit for bit, and against the
    1x1 run saved at case["ref"]: every mixer's decode step on the 1x1
    run's input and state (the rank's rows and its part of the state: a
    Mamba2 S by heads and conv_buf by segment, an mLSTM state by heads, the
    attention cache as the rank's cache holds it) within BF16_ROW_ULPS of
    the 1x1 output; each greedy step's pick agreeing over `model`; from the
    first step whose greedy input differs from the 1x1 run's, up to
    SERVE_MESH_FORCED more steps fed the 1x1 tokens (from the laid cache: a
    recurrent state cannot take back a token) with their logits against the
    1x1 step's (printed).  Rank 0 returns the payload, the tokens and every
    rank's readings."""
    from repro_torch.launch import serve
    from repro_torch.models import model, ssm, xlstm
    from repro_torch.models import sharding_hook as hook
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding, steps

    args = serve.parse_args(case["argv"])
    run = serve._serve_ranks(mesh, vars(args), keep=True)
    if mesh is None:
        return None
    t0 = time.perf_counter()
    cfg = serve._config(args)
    payload, tokens = run.get("payload"), run["tokens"]
    ref = torch.load(case["ref"], map_location="cpu")
    dev = mesh.device
    b = run["batch"]["tokens"].shape[0]  # this data rank's rows
    rows = slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)
    params, max_len, pos = run["params"], run["max_len"], ref["pos"]
    gen = tokens.shape[1]
    prompt = max_len - gen
    seq = model.seq_sharded(cfg, mesh, max_len)
    specs = model.cache_specs(cfg, mesh, args.batch, max_len)
    lead = {"mamba": 2, "attn": 1, "mlstm": 2, "slstm": 1}
    rules = sharding.rules_for(cfg)
    if cfg.family == "hybrid":
        walk = [(k, lp) for k, _, lp in model._hybrid_layers(cfg, params)]
    else:
        walk = [(k, lp) for k, _, _, lp in model._xlstm_layers(cfg, params)]
    kw = dict(n_heads=cfg.n_heads)
    mixers = {
        "mamba": lambda lp, x, st: ssm.mamba2_decode(lp["mixer"], x, st, **model._mamba_kw(cfg)),
        "attn": lambda lp, x, st: tfm.decode_block(lp, x, st, pos, cfg, seq),
        "mlstm": lambda lp, x, st: xlstm.mlstm_decode(lp["mixer"], x, st,
                                                      proj_factor=cfg.mlstm_proj_factor, **kw),
        "slstm": lambda lp, x, st: xlstm.slstm_decode(lp["mixer"], x, st, **kw),
    }
    decode = []
    if len(walk) != len(ref["layers"]):
        raise AssertionError(f"{len(walk)} blocks, {len(ref['layers'])} records")
    for (stack, lp), r in zip(walk, ref["layers"]):
        if stack != r["stack"]:
            raise AssertionError(f"block {stack} against a record of {r['stack']}")
        st = {n: sharding.shard_tensor(t.to(dev), specs[stack][n][lead[stack]:], mesh)
              for n, t in r["state"].items()}
        with torch.no_grad(), hook.installed(mesh), hook.residual(1, rules):
            y = mixers[stack](lp, r["in"][rows].to(dev), st)[0]
        decode.append((stack, bf16_reading(y, r["out"][rows].to(dev))))
    pre = recurrent_prefill_blocks(mesh, cfg, args, params, specs, run["prefill_cache"])
    with torch.no_grad():  # the serve's prefill cache, laid as the serve lays it
        laid = model.merge_prefill_cache(cfg, model.init_cache(cfg, args.batch, max_len, dev, mesh),
                                         run["prefill_cache"], mesh, max_len)
    laid_same = all(torch.equal(laid[st][n], t) for st, c in run["prefill_cache"].items()
                    if st != "attn" for n, t in c.items())

    def picks_agree(logits):
        tok = steps.greedy_tokens(cfg, logits, mesh)
        every = mesh.all_gather_tiled(tok[None], "model", 0)
        return bool((every == tok[None]).all())

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / float(want.abs().max())

    v_loc = run["last_logits"].shape[-1]
    m_i = mesh.index("model")
    cols = slice(None) if v_loc == cfg.vocab else slice(m_i * v_loc, (m_i + 1) * v_loc)
    same = (torch.as_tensor(tokens) == ref["tokens"][:, :gen]).all(0).long().cumprod(0)
    first_diff = int(same.sum())
    stepped = list(enumerate(run["step_logits"]))
    if first_diff < gen - 1:  # the 1x1 tokens from the laid cache
        with torch.no_grad():
            forced = ref["tokens"][rows].to(dev)
            stepped = []
            for i in range(min(gen - 1, first_diff + SERVE_MESH_FORCED)):
                lg, laid = model.decode_step(cfg, params, laid, forced[:, i:i + 1],
                                             prompt + i, mesh, max_len)
                stepped.append((i, lg[:, -1, :]))
    tf, agree = {}, True
    for i, lg in stepped:
        tf[i] = rel(lg, ref["step_logits"][i][rows][:, cols].to(dev))
        agree = agree and picks_agree(lg)
    # Printed, not gated: the rows whose 1x1 top-2 margin exceeds twice the
    # row's largest logit difference (no such difference can move their
    # argmax) and whether their first token equals the 1x1 run's.  A
    # random-weight recurrent stack carries one bf16 ulp to a tenth of a
    # logit row, so the end-to-end output gates nothing; the blocks do.
    want = ref["last_logits"][rows].to(dev)
    diff = (run["last_logits"].float() - want[:, cols]).abs().amax(-1)
    diff = mesh.pmax(diff, "model")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
    same0 = torch.as_tensor(tokens)[rows, 0].to(dev) == ref["tokens"][rows, 0].to(dev)
    mine = {"rank": mesh.rank, "decode": decode, "prefill": pre["blocks"],
            "handoff": pre["handoff"], "laid_same": laid_same, "planted": pre["planted"],
            "teacher_forced": tf,
            "first_tokens_decided": int(decided.sum()),
            "first_tokens_ok": bool((same0 | ~decided).all()),
            "first_tokens_equal": bool(same0.all()),
            "greedy_agree": float((torch.as_tensor(tokens) == ref["tokens"][:, :gen])
                                  .float().mean()),
            "same_prefix": first_diff, "one_device_prefill_ms": ref["prefill_ms"],
            "one_device_decode_ms_per_token": ref["decode_ms_per_token"],
            "prefill_logits_rel": rel(run["last_logits"],
                                      ref["last_logits"][rows][:, cols].to(dev)),
            "picks_agree": agree, "tokens_agree_over_model": run["tokens_agree_over_model"],
            "checks_s": time.perf_counter() - t0, "seq_sharded": seq,
            "local_cache": {st: {n: list(t.shape) for n, t in c.items()}
                            for st, c in run["cache"].items()}}
    every = mesh.all_gather_object(mine)
    del run, params, ref, laid
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank:
        return None
    return {"payload": payload, "tokens": tokens, "ranks": every}


def _param_readings(got, want) -> list:
    """Per leaf max |got - want| / max |want|."""
    return [rel_err(g, w) for g, w in zip(got, want)]


def phase_sharded(torch, card: str, dm_job: dict) -> dict:
    """The SHARDED gates (see SHARD_ARCH's comment): one gloo_staged world
    of 4 ranks (sharded_world, then recurrent_world, serve_mesh_world and
    dict_mesh_world on `dm_job`; started on a thread while this process
    computes the references on one device) and launch/train on a 1x1 mesh
    over nccl, held against runs on one device without a mesh.  Prints
    "[sharded ...]" lines and one
    SHARDED JSON line; returns the record (K2 launches per rank and path)
    with the world's SERVE_MESH and DICT_MESH results under
    "serve_mesh_world" and "dict_mesh_world" (for phase_serve_mesh and
    phase_dict_mesh)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import cut_depth, get_config, get_smoke_config
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime import mesh as mesh_mod

    rec = {"card": card, "transport": SHARD_TRANSPORT}
    root = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.rmtree(dm_job["dir"], ignore_errors=True)
    pathlib.Path(dm_job["dir"]).mkdir(parents=True)
    cfg = cut_depth(get_config(SHARD_ARCH), SHARD_LAYERS)
    moe_cfg = cut_depth(get_config(SHARD_MOE_ARCH), SHARD_MOE_LAYERS)
    batches = train.make_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    common = ["--full-config", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    sgd_argv = common + ["--n-layers", str(SHARD_LAYERS), "--arch", SHARD_ARCH, "--optimizer",
                         "sgd", "--lr", str(SHARD_LR), "--steps", str(SHARD_STEPS),
                         "--ckpt-every", str(SHARD_STEPS)]
    moe_argv = common + [
        "--n-layers", str(SHARD_MOE_LAYERS), "--arch", SHARD_MOE_ARCH,
        "--steps", str(SHARD_MOE_STEPS),
        "--ckpt-every", str(SHARD_MOE_CKPT), "--inject-fault-at", str(SHARD_MOE_FAULT),
        "--rescale-mesh", "2x1", "--rescale-step", str(SHARD_MOE_RESCALE)]
    fsdp_cfg = cut_depth(get_config(FSDP_ARCH), FSDP_LAYERS)
    fsdp_argv = ["--full-config", "--n-layers", str(FSDP_LAYERS), "--batch", str(TRAIN_BATCH),
                 "--seq", str(TRAIN_SEQ), "--arch", FSDP_ARCH, "--steps", str(FSDP_STEPS),
                 "--ckpt-every", str(FSDP_STEPS)]
    fsdp_args = train.parse_args(fsdp_argv + ["--device", "cuda"])

    # SERVE_MESH's recurrent 1x1 serves first (serve_mesh_job reads them),
    # then the world starts on a thread: its ranks spend some 40 s
    # spawning and importing, while this process computes the references
    # on one device.
    t0 = time.perf_counter()
    for tag in REC_SERVE:
        recurrent_serve_reference(torch, tag)
    rec["recurrent_serve_reference_s"] = time.perf_counter() - t0
    smoke = get_smoke_config(SHARD_ARCH)
    smoke_batches = [train.make_batches(smoke, 4, 32, 0)(i) for i in range(3)]
    norm_smoke = get_smoke_config(NORM_ARCH)
    rec_cfgs = {tag: cut_depth(get_config(arch), n) for tag, (arch, n) in REC_CASES.items()}
    rec_job = {tag: {"cli": cli_rank_args(common + [
        "--n-layers", str(REC_CASES[tag][1]), "--arch", REC_CASES[tag][0], "--optimizer", "sgd",
        "--lr", str(SHARD_LR), "--steps", str(REC_STEPS), "--ckpt-every", str(REC_STEPS),
        "--mesh", "2x2", "--transport", SHARD_TRANSPORT], root / tag),
        "cfg": c, "batch": train.make_batches(c, TRAIN_BATCH, TRAIN_SEQ, 0)(0)}
        for tag, c in rec_cfgs.items()}

    # The world: olmo-1b 2x2 and granite-moe 1x2 (launch/train's rank body
    # with its --mesh 2x2 / 1x2 arguments), the a2a layer, the planted runs.
    t0 = time.perf_counter()
    launcher = ThreadPoolExecutor(1)
    world = launcher.submit(
        mesh_mod.launch, sharded_world, (2, 2), transport=SHARD_TRANSPORT, device="cuda",
        timeout=900, kernels=("flash_attention", "dict_dual_step", "slstm_step"), args=({
            "olmo": cli_rank_args(sgd_argv + ["--mesh", "2x2", "--transport", SHARD_TRANSPORT],
                                  root / "2x2"),
            "granite": cli_rank_args(moe_argv + ["--mesh", "1x2", "--transport",
                                                 SHARD_TRANSPORT], root / "moe"),
            "granite8b": cli_rank_args(fsdp_argv + ["--mesh", "2x2", "--transport",
                                                    SHARD_TRANSPORT], root / "fsdp"),
            "granite8b_cfg": fsdp_cfg,
            "smoke_cfg": smoke, "smoke_batches": smoke_batches, "norm_cfg": norm_smoke,
            "smoke_lr": 0.5, "a2a_widths": SHARD_A2A_WIDTHS,
            "a2a_tokens": SHARD_A2A_SHAPE, "dict_mesh": dm_job,
            "sp": {"cfg": cfg, "batch": batches(0)},
            "recurrent": rec_job, "serve_mesh": serve_mesh_job()},))
    launcher.shutdown(wait=False)

    # The references on one device, in this process: olmo-1b's SGD run and
    # the SMOKE config's.
    reset_launch_counts()
    t1 = time.perf_counter()
    losses1, p0, p1 = _sgd_reference(torch, cfg, batches, SHARD_LR, SHARD_STEPS)
    rec["reference_1x1_s"] = time.perf_counter() - t1
    s_losses, _, s_params = _sgd_reference(torch, smoke, lambda i: smoke_batches[i], 0.5, 3)
    n_losses, _, n_params = _sgd_reference(torch, norm_smoke, lambda i: smoke_batches[i], 0.5, 3)
    # granite-8b cut to FSDP_LAYERS, launch/train's optimizer (for_arch's
    # AdamW on its cosine warmup) on one device.
    t1 = time.perf_counter()
    f_losses1, f_p0, f_p1 = _reference_run(
        torch, fsdp_cfg, train._optimizer(fsdp_cfg, fsdp_args),
        train.make_batches(fsdp_cfg, TRAIN_BATCH, TRAIN_SEQ, 0), FSDP_STEPS)
    rec["fsdp_reference_1x1_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec_ref = recurrent_reference(torch)  # RECURRENT's first losses on one device
    rec["recurrent_reference_s"] = time.perf_counter() - t1
    res = world.result()
    rec["world_s"] = time.perf_counter() - t0
    out22, outm = res["olmo"], res["granite"]
    print_sharded_run("olmo-1b 2x2", out22)
    print_sharded_run("granite-moe 1x2", outm)

    # (1) olmo-1b: 2x2 against 1x1, then 1x1 over nccl.
    t0 = time.perf_counter()
    p22 = _checkpoint_params(cfg, sgd(SHARD_LR), root / "2x2", SHARD_STEPS)
    rec["checkpoint_read_s"] = time.perf_counter() - t0
    loss_rel = abs(out22["losses"][0][1] - losses1[0]) / abs(losses1[0])
    params_rel = _param_readings(p22, p1)
    update_rel = _param_readings([a - b for a, b in zip(p22, p0)],
                                 [a - b for a, b in zip(p1, p0)])
    del p22
    _k2_ranks("olmo-1b 2x2", out22, [2 * SHARD_LAYERS * SHARD_STEPS] * 4,
              (TRAIN_BATCH // 2, 8, 8, TRAIN_SEQ, TRAIN_SEQ, 128, "bfloat16", "wgmma_tma"))
    print(f"[sharded olmo-1b 2x2] {card}: first loss {out22['losses'][0][1]:.6f} vs 1x1 "
          f"{losses1[0]:.6f} (rel {loss_rel:.3e}, gate {SHARD_LOSS_RTOL}); losses "
          f"{[x for _, x in out22['losses']]} vs {losses1}; step-{SHARD_STEPS} params per leaf "
          f"max|d|/max|p| max {max(params_rel):.3e} (gate {BF16_UNIT_ROUNDOFF}); updates "
          f"max {max(update_rel):.3e} (gate {GRAD_BF16_TOL})")
    if not (loss_rel <= SHARD_LOSS_RTOL and max(params_rel) <= BF16_UNIT_ROUNDOFF
            and max(update_rel) <= GRAD_BF16_TOL):
        raise AssertionError("olmo-1b at 2x2 parts from the 1x1 run")
    out11 = sharded_cli(torch, "olmo-1b 1x1 nccl", sgd_argv + [
        "--mesh", "1x1", "--transport", "nccl", "--ckpt-dir", str(root / "nccl")])
    p11 = _checkpoint_params(cfg, sgd(SHARD_LR), root / "nccl", SHARD_STEPS)
    nccl_bits = [x for _, x in out11["losses"]] == losses1 and all(
        torch.equal(a, b) for a, b in zip(p11, p1))
    del p11, p0, p1
    _k2_ranks("olmo-1b 1x1 nccl", out11, [2 * SHARD_LAYERS * SHARD_STEPS],
              (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, "bfloat16", "wgmma_tma"))
    print(f"[sharded olmo-1b 1x1 nccl] every loss and param bit for bit the 1x1 run's "
          f"without a mesh: {nccl_bits}")
    if out11["transport"] != "nccl" or not nccl_bits:
        raise AssertionError("the 1x1 step over nccl differs from the step without a mesh")
    shutil.rmtree(root / "2x2", ignore_errors=True)
    shutil.rmtree(root / "nccl", ignore_errors=True)

    # (2) granite-moe at 1x2 (ranks 0-1; 2-3 idle): fault, replay, the
    # reload at 2x1.
    t0 = time.perf_counter()
    one_loss = _one_device_loss(torch, moe_cfg, root / "moe", SHARD_MOE_RESCALE)
    rec["one_device_loss_s"] = time.perf_counter() - t0
    shutil.rmtree(root / "moe", ignore_errors=True)
    run_steps = [s for s, _ in outm["losses"]]
    replayed = SHARD_MOE_FAULT - SHARD_MOE_CKPT
    first = dict(outm["losses"][:SHARD_MOE_FAULT])
    replay = outm["losses"][SHARD_MOE_FAULT:SHARD_MOE_FAULT + replayed]
    saved_rel = abs(outm["rescaled_loss"] - first[SHARD_MOE_RESCALE]) / \
        abs(first[SHARD_MOE_RESCALE])
    one_rel = abs(outm["rescaled_loss"] - one_loss) / abs(one_loss)
    n_run = SHARD_MOE_STEPS + replayed
    _k2_ranks("granite-moe 1x2", outm, [2 * SHARD_MOE_LAYERS * n_run] * 2 + [0, 0],
              (TRAIN_BATCH, 8, 4, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", "wgmma_tma"))
    rescale_k2 = {"k2_launches": [n for n, _ in outm["k2_rescale"]],
                  "k2_shapes": [s for _, s in outm["k2_rescale"]]}
    _k2_ranks("granite-moe 2x1 reload", rescale_k2, [2 * SHARD_MOE_LAYERS] * 2 + [0, 0],
              (TRAIN_BATCH // 2, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 64, "bfloat16", "wgmma_tma"))
    print(f"[sharded granite-moe 1x2] replay from step {SHARD_MOE_CKPT}: first pass "
          f"{[first[s] for s, _ in replay]}, replayed {[x for _, x in replay]} (bit for bit); "
          f"2x1 reload of step {SHARD_MOE_RESCALE}: loss {outm['rescaled_loss']:.6f}, the same "
          f"checkpoint on one device {one_loss:.6f} (rel {one_rel:.3e}, gate {SHARD_LOSS_RTOL}), "
          f"the saved 1x2 run's {first[SHARD_MOE_RESCALE]:.6f} (rel {saved_rel:.3e}, gate "
          f"{SHARD_LOSS_RTOL}: 1x2 dispatches all-to-all, "
          f"2x1 by capacity, and the two drop different tokens)")
    if outm["faults"] != 1 or run_steps != sorted(run_steps) or len(run_steps) != n_run or \
            any(x != first[s] for s, x in replay) or outm["rescaled_step"] != SHARD_MOE_RESCALE \
            or not one_rel <= SHARD_LOSS_RTOL or not saved_rel <= SHARD_LOSS_RTOL:
        raise AssertionError(f"granite-moe at 1x2: faults {outm['faults']}, steps {run_steps}, "
                             f"replay {replay}, reload {outm['rescaled_step']} rel {one_rel}, "
                             f"{saved_rel}")

    # (3) granite-8b 2x2 with `embed` over `data` against 1x1, and Adafactor
    # on its shards.
    outf = res["granite8b"]
    print_sharded_run("granite-8b 2x2 FSDP", outf)
    t0 = time.perf_counter()
    pf = [t.cuda() for t in _checkpoint_params(fsdp_cfg, train._optimizer(fsdp_cfg, fsdp_args),
                                               root / "fsdp", FSDP_STEPS)]
    f_p0, f_p1 = [t.cuda() for t in f_p0], [t.cuda() for t in f_p1]  # the readings on the card
    rec["fsdp_checkpoint_read_s"] = time.perf_counter() - t0
    shutil.rmtree(root / "fsdp", ignore_errors=True)
    schedule = cosine_warmup(fsdp_args.lr, warmup=20, total=FSDP_STEPS)
    lr_sum = sum(schedule(i) for i in range(FSDP_STEPS))
    f_losses = [x for _, x in outf["losses"]]
    f_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(f_losses, f_losses1))
    f_params_rel = _param_readings(pf, f_p1)
    f_upd = [a - b for a, b in zip(pf, f_p0)]
    f_upd1 = [a - b for a, b in zip(f_p1, f_p0)]
    f_update_rel = _param_readings(f_upd, f_upd1)
    f_flips = [float(((a - b).abs() > ADAMW_FLIP * lr_sum).float().mean())
               for a, b in zip(f_upd, f_upd1)]
    del pf, f_p0, f_p1, f_upd, f_upd1
    torch.cuda.empty_cache()
    _k2_ranks("granite-8b 2x2 FSDP", outf, [2 * FSDP_LAYERS * FSDP_STEPS] * 4,
              (*FA_FSDP_RANK, "bfloat16", "wgmma_tma"))
    ada = res["fsdp_adafactor"]
    print(f"[sharded granite-8b 2x2 FSDP] {card}: losses {f_losses} vs 1x1 {f_losses1} (max rel "
          f"{f_loss_rel:.3e}, gate {SHARD_LOSS_RTOL}); step-{FSDP_STEPS} params per leaf "
          f"max|d|/max|p| max {max(f_params_rel):.3e} (gate {BF16_UNIT_ROUNDOFF}); updates "
          f"(AdamW, summed lr {lr_sum:.3e}) per leaf max|d|/max|update| max "
          f"{max(f_update_rel):.3e} (printed), share of elements parting by more than "
          f"{ADAMW_FLIP} x summed lr max {max(f_flips):.3e} (gate {FSDP_ADAMW_SHARE}); peak GB "
          f"per rank {outf.get('peak_mem_gb_ranks')}")
    print(f"[sharded granite-8b Adafactor on shards] the embedding table and a layer at full "
          f"width, 2x2, vs the whole leaves' update: max {max(ada['readings'].values()):.3e} "
          f"(gate {FSDP_ADAFACTOR_RTOL}), per leaf {ada['readings']}; planted means left local: "
          f"max {max(ada['planted'].values()):.3e}, per leaf {ada['planted']}")
    if not (f_loss_rel <= SHARD_LOSS_RTOL and max(f_params_rel) <= BF16_UNIT_ROUNDOFF
            and max(f_flips) <= FSDP_ADAMW_SHARE):
        raise AssertionError("granite-8b at 2x2 with FSDP parts from the 1x1 run")
    if not (max(ada["readings"].values()) <= FSDP_ADAFACTOR_RTOL
            and max(ada["planted"].values()) > FSDP_ADAFACTOR_RTOL):
        raise AssertionError(f"Adafactor on granite-8b's shards: {ada}")
    fgrad = res["fsdp_gradient"]
    print(f"[sharded granite-8b 2x2 FSDP gradient] {card}: one SGD step at lr {SHARD_LR} from "
          f"seed 0, its update (lr x the gradient averaged over data) vs one device's, per leaf "
          f"max|d|/max|update|: max {max(fgrad['readings'].values()):.3e} (gate "
          f"{GRAD_BF16_TOL}), per leaf {fgrad['readings']}; planted FSDP gradient left "
          f"unaveraged over data: max {max(fgrad['planted'].values()):.3e}; "
          f"{fgrad['wall_s']:.1f} s")
    if not (max(fgrad["readings"].values()) <= GRAD_BF16_TOL
            and max(fgrad["planted"].values()) > GRAD_BF16_TOL):
        raise AssertionError(f"granite-8b's FSDP gradient at 2x2 parts from one device's: {fgrad}")
    # the replicated residual a layer: (B / dp, S, D) bf16; SP keeps 1/tp of it
    f_whole = TRAIN_BATCH // 2 * TRAIN_SEQ * fsdp_cfg.d_model * 2
    print(f"[sharded granite-8b 2x2 FSDP gradient] remat keeps "
          f"{fgrad['saved_bytes_per_layer']} B a layer on rank 0 (SP; the replicated "
          f"layout's (B/dp, S, D) bf16 is {f_whole} B)")
    if not sp_saved_ok(fgrad["saved_bytes_per_layer"], [f_whole] * FSDP_LAYERS, 2):
        raise AssertionError(f"granite-8b 2x2 FSDP: remat keeps {fgrad['saved_bytes_per_layer']} "
                             f"B a layer, not 1/2 of {f_whole}")

    # (3b) the sequence-parallel residual against the replicated layout.
    sp = sp_report(card, res["sp"], cfg, {"olmo-1b": "2x2", "granite-moe": "1x2",
                                          "granite-moe reload": "2x1", "granite-8b FSDP": "2x2"})

    # (4) the a2a layer against moe_ref, and the planted faults at SMOKE.
    a2a = res["a2a"]
    print(f"[sharded a2a layer] granite widths, 1x2, capacity {SHARD_A2A_CF}, fp32, "
          f"{SHARD_A2A_SHAPE} tokens: out vs moe_ref {a2a['out']:.3e}, gradients (router, wg, wi, "
          f"wo, x) {[f'{r:.3e}' for r in a2a['grads']]} (gate {SHARD_A2A_RTOL})")
    if not (a2a["out"] <= SHARD_A2A_RTOL and max(a2a["grads"]) <= SHARD_A2A_RTOL):
        raise AssertionError("the a2a layer parts from moe_ref")
    planted = {}
    for name in ("clean", "row-parallel output without its psum",
                 "data-parallel gradients unaveraged", NORM_CLEAN, NORM_PLANTED):
        run = res[name]
        ref_losses, ref_params = ((n_losses, n_params) if name in (NORM_CLEAN, NORM_PLANTED)
                                  else (s_losses, s_params))
        planted[name] = max([abs(a - b) / abs(b) for a, b in zip(run["losses"], ref_losses)]
                            + _param_readings(run["params"], ref_params))
    print(f"[sharded planted] olmo SMOKE (granite-8b SMOKE for its rms norms) 2x2 vs 1x1 on "
          f"the card, 3 SGD steps, max of loss and per-leaf param readings (gate "
          f"{SHARD_SMOKE_RTOL}): {planted}")
    clean = ("clean", NORM_CLEAN)
    if not all(planted[k] <= SHARD_SMOKE_RTOL for k in clean) or \
            not all(v > SHARD_SMOKE_RTOL for k, v in planted.items() if k not in clean):
        raise AssertionError(f"the 2x2-against-1x1 check: {planted}")

    def run_record(out):
        return {"losses": out["losses"], "step_ms": [t * 1e3 for t in out["step_times"]],
                "step_traffic_rank0": out["step_traffic"], "k2_launches": out["k2_launches"],
                "k2_shapes": out["k2_shapes"], "peak_mem_gb_rank0": out.get("peak_mem_gb"),
                "wall_s": out["wall_s"], "rank0_seconds": out["rank0_seconds"]}

    rec.update({
        "olmo_2x2": {**run_record(out22), "losses_1x1": losses1, "loss_rel": loss_rel,
                     "params_rel": params_rel, "update_rel": update_rel},
        "olmo_1x1_nccl": {**run_record(out11), "bits_equal": nccl_bits},
        "granite_1x2": {**run_record(outm), "rescaled_loss": outm["rescaled_loss"],
                        "reload_vs_one_device": one_rel, "reload_vs_saved_run": saved_rel,
                        "k2_rescale": rescale_k2},
        "a2a_layer": a2a, "planted": planted,
        "granite8b_2x2_fsdp": {**run_record(outf), "losses_1x1": f_losses1,
                               "loss_rel": f_loss_rel, "params_rel": f_params_rel,
                               "update_rel": f_update_rel, "update_flip_share": f_flips,
                               "lr_sum": lr_sum,
                               "peak_mem_gb_ranks": outf.get("peak_mem_gb_ranks")},
        "fsdp_adafactor": ada, "fsdp_gradient": fgrad, "sp": sp,
    })
    rec["recurrent"] = recurrent_report(card, res["recurrent"], rec_ref, rec_cfgs)
    for tag in rec_cfgs:
        shutil.rmtree(root / tag, ignore_errors=True)
    rec["launches"] = {"olmo-1b 2x2 train": sum(out22["k2_launches"]),
                       "granite-8b 2x2 FSDP train": sum(outf["k2_launches"]),
                       "olmo-1b 1x1 nccl train": sum(out11["k2_launches"]),
                       "granite-moe 1x2 train": sum(outm["k2_launches"]),
                       "granite-moe 2x1 reload step": sum(rescale_k2["k2_launches"]),
                       "zamba2-1.2b 2x2 train": sum(rec["recurrent"]["zamba2"]["k2_launches"])}
    rec["k3_launches"] = {"xlstm-1.3b 2x2 train":
                          sum(rec["recurrent"]["xlstm"]["k3_launches"])}
    print("SHARDED " + json.dumps(rec))
    rec["dict_mesh_world"] = res["dict_mesh"]
    rec["serve_mesh_world"] = res["serve_mesh"]
    return rec


def recurrent_report(card: str, got: dict, ref: dict, cfgs: dict) -> dict:
    """RECURRENT's gates on recurrent_world's runs and the RECURRENT line:
    per case the first loss against one device's (SHARD_LOSS_RTOL), K2
    per rank at FA_HYBRID_RANK (zamba2: 2 an application a step, forward
    and remat) and K3 per rank (xlstm: 1 an sLSTM block a step), remat's
    kept bytes, every block's readings, each rank's K3 against plain, the
    planted fault; the step's wire per axis printed beside S.  Returns the
    line."""
    line = {"card": card, "transport": SHARD_TRANSPORT, "mesh": "2x2", "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": REC_STEPS}
    failed = []
    for tag, cfg in cfgs.items():
        g = got[tag]
        run = g["run"]
        print_sharded_run(f"{tag} 2x2", run)
        first, want = run["losses"][0][1], ref["first_loss"][tag]
        loss_rel = abs(first - want) / abs(want)
        hybrid = cfg.family == "hybrid"
        n_attn = cfg.n_layers // cfg.attn_every if hybrid else 0
        n_slstm = 0 if hybrid else cfg.n_layers // cfg.slstm_every
        n_remat = cfg.n_layers + n_attn if hybrid else cfg.n_layers - n_slstm
        _k2_ranks(f"RECURRENT {tag} 2x2", run, [2 * n_attn * REC_STEPS] * 4,
                  (*FA_HYBRID_RANK, "bfloat16", "wgmma_tma"))
        # (B/dp, S, D) in the compute dtype (bf16)
        whole = TRAIN_BATCH // 2 * TRAIN_SEQ * cfg.d_model * cfg.cdtype.itemsize
        blocks = g["blocks"]
        worst = {k: max(r[k] for _, r in blocks) for k in ("out", "dx", "dparams")}
        k3 = [max(r.values()) for r in g["k3"] if r is not None]
        gates = {
            f"first loss within {SHARD_LOSS_RTOL} of one device's": loss_rel <= SHARD_LOSS_RTOL,
            "K3 launches per rank": run["k3_launches"] == [n_slstm * REC_STEPS] * 4,
            "remat keeps 1/tp of the replicated residual a block": sp_saved_ok(
                g["saved"], [whole] * (n_remat * REC_STEPS), 2),
            f"every block's output within {BF16_ROW_ULPS}": worst["out"] <= BF16_ROW_ULPS,
            f"every block's gradients within {GRAD_BF16_TOL}": max(worst["dx"], worst["dparams"])
            <= GRAD_BF16_TOL,
        }
        if n_slstm:
            gates[f"K3 on every rank within {SL_TOL} of plain"] = len(k3) == 4 and max(k3) <= SL_TOL
        if g["planted"] is not None:
            gates["planted rejected: " + REC_PLANTED] = g["planted"]["dparams"] > GRAD_BF16_TOL
        print(f"[recurrent {tag} 2x2] {card}: first loss {first:.6f} vs one device {want:.6f} "
              f"(rel {loss_rel:.3e}); losses {[x for _, x in run['losses']]}; K2 per rank "
              f"{run['k2_launches']}, K3 per rank {run['k3_launches']}; remat keeps "
              f"{sorted(set(g['saved']))} B a block on rank 0 ((B/dp, S, D) is {whole} B); "
              f"a step's wire at S {TRAIN_SEQ}, rank 0, per axis [collectives, bytes] "
              f"{run['step_traffic']}; step ms {[round(t * 1e3, 1) for t in run['step_times']]}")
        print(f"[recurrent {tag} 2x2] blocks on their own inputs (out: bf16 reading; dx, "
              f"dparams: max|d|/max|1x1|) {blocks}; K3 per rank vs plain {g['k3']}; planted "
              f"{g['planted']}; gates {gates}")
        if not all(gates.values()):
            failed.append((tag, [k for k, v in gates.items() if not v]))
        line[tag] = {"losses": run["losses"], "first_loss_1x1": want, "loss_rel": loss_rel,
                     "k2_launches": run["k2_launches"], "k2_shapes": run["k2_shapes"],
                     "k3_launches": run["k3_launches"], "step_traffic_rank0": run["step_traffic"],
                     "step_ms": [t * 1e3 for t in run["step_times"]],
                     "peak_mem_gb_ranks": run.get("peak_mem_gb_ranks"),
                     "saved_bytes_per_block": sorted(set(g["saved"])), "blocks": blocks,
                     "worst": worst, "k3_readings": g["k3"], "planted": g["planted"],
                     "gates": gates, "wall_s": run["wall_s"], "blocks_s": g["blocks_s"]}
    print("RECURRENT " + json.dumps(line))
    if failed:
        raise AssertionError(f"RECURRENT: {failed}")
    return line


def sp_report(card: str, got: dict, cfg, cli_runs: dict) -> dict:
    """The SP gates on sp_check's runs (olmo-1b 2x2) and the SP line: the
    layouts, remat's kept bytes a layer, the memory the forward holds for
    its backward (the replicated run's and the planted run's above SP's by
    at least SP_HELD_SHARE of the kept bytes' difference over the stack),
    the wire a step
    per axis and rank 0's step ms, SP against replicated; the layouts of the CLI runs
    (cli_runs: tag -> mesh) and of SERVE_MESH's prefills beside them."""
    from repro_torch.runtime import sharding

    runs, readings = got["runs"], got["update_readings"]
    sp, rep, bad = runs["sp"], runs["replicated"], runs[SP_PLANTED]
    tp = 2
    loss_rel = abs(sp["loss"] - rep["loss"]) / abs(rep["loss"])
    kept_less = sum(rep["saved_bytes_per_layer"]) - sum(sp["saved_bytes_per_layer"])
    gates = {
        "layouts seq / replicated": (sp["layout"], rep["layout"]) == ("seq", "replicated"),
        f"loss within {SHARD_SMOKE_RTOL}": loss_rel <= SHARD_SMOKE_RTOL,
        f"every leaf's update within {SHARD_SMOKE_RTOL}": max(readings.values())
        <= SHARD_SMOKE_RTOL,
        "kept bytes a layer 1/tp of the replicated run's": sp_saved_ok(
            sp["saved_bytes_per_layer"], rep["saved_bytes_per_layer"], tp),
        "K2 launches per rank the replicated run's": sp["k2_launches"] == rep["k2_launches"]
        == [2 * SHARD_LAYERS] * 4,
        f"forward holds {SP_HELD_SHARE} of the kept bytes' difference less than the "
        "replicated run's": rep["forward_held_bytes"] - sp["forward_held_bytes"]
        >= SP_HELD_SHARE * kept_less > 0,
        "planted gathered residual rejected": not sp_saved_ok(
            bad["saved_bytes_per_layer"], rep["saved_bytes_per_layer"], tp)
        and bad["forward_held_bytes"] - sp["forward_held_bytes"] >= SP_HELD_SHARE * kept_less,
    }
    rules = sharding.rules_for(cfg)
    line = {
        "card": card, "arch": SHARD_ARCH, "n_layers": SHARD_LAYERS, "mesh": "2x2",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "transport": SHARD_TRANSPORT,
        "runs": runs, "loss_rel": loss_rel, "max_update_reading": max(readings.values()),
        "saved_stack_bytes": {k: sum(r["saved_bytes_per_layer"]) for k, r in runs.items()},
        "forward_held_bytes": {k: r["forward_held_bytes"] for k, r in runs.items()},
        "cli_layouts": {tag: "seq" if sharding.residual_seq_axis(
            dict(zip(("data", "model"), map(int, mesh.split("x")))), rules, TRAIN_SEQ)
            else "replicated" for tag, mesh in cli_runs.items()},
        "serve_mesh_prefill_layouts": {tag: "seq" if sharding.residual_seq_axis(
            dict(zip(("data", "model"), shape)), rules, LM_PROMPT) else "replicated"
            for tag, (_, shape, _, _) in SERVE_MESH_CASES.items()},
        "gates": gates, "wall_s": got["wall_s"],
    }
    for name, r in (("sp", sp), ("replicated", rep)):
        print(f"[sp olmo-1b 2x2 {name}] {card}: layout {r['layout']}, loss {r['loss']:.6f}, "
              f"remat keeps {r['saved_bytes_per_layer']} B a layer on rank 0, its forward "
              f"holds {r['forward_held_bytes']} B, wire a step "
              f"{r['step_traffic']}, step {r['step_ms']:.1f} ms (rank 0's clock), K2 per rank "
              f"{r['k2_launches']}")
    print(f"[sp olmo-1b 2x2 planted] {SP_PLANTED}: remat keeps "
          f"{bad['saved_bytes_per_layer']} B a layer on rank 0, its forward holds "
          f"{bad['forward_held_bytes']} B")
    print(f"[sp olmo-1b 2x2] gates {gates}; loss rel {loss_rel:.3e}, updates per leaf max "
          f"{max(readings.values()):.3e}")
    print("SP " + json.dumps(line))
    if not all(gates.values()):
        raise AssertionError(f"the sequence-parallel residual: {gates}")
    return line


def serve_mesh_argv(tag: str, mesh: str, transport: str, n_layers=None) -> list:
    """launch/serve's argv for a SERVE_MESH case: the LM traffic at full
    width, the case's depth and greedy tokens (n_layers: cut to that)."""
    arch, _, depth, gen = SERVE_MESH_CASES[tag]
    n_layers = n_layers or depth
    return (["--arch", arch, "--full-config", "--batch", str(LM_BATCH), "--prompt-len",
             str(LM_PROMPT), "--gen", str(gen), "--device", "cuda", "--mesh", mesh,
             "--transport", transport, "--json"]
            + (["--n-layers", str(n_layers)] if n_layers else []))


def serve_mesh_job() -> dict:
    """The world's SERVE_MESH part: each case's argv and its 1x1 reference
    (saved by phase_lm, phase_moe_serve and phase_fsdp_reference)."""
    job = {}
    for tag, (_, shape, _, _) in SERVE_MESH_CASES.items():
        ref = SERVE_MESH_DIR / f"{tag}.pt"
        if not ref.is_file():
            raise AssertionError(f"SERVE_MESH: no 1x1 reference {ref}; phase_lm, "
                                 f"phase_moe_serve and phase_fsdp_reference save it (run "
                                 f"them first)")
        job[tag] = {"argv": serve_mesh_argv(tag, "x".join(map(str, shape)), SHARD_TRANSPORT),
                    "ref": str(ref)}
    return job


def phase_serve_mesh(torch, card: str, world: dict) -> dict:
    """The SERVE_MESH gates on the world's runs (serve_mesh_world), then
    gemma cut to SERVE_MESH_NCCL_LAYERS on a 1x1 mesh over nccl (its rank
    this process) against the serve without a mesh.  Gated: K2 on every
    rank only at FA_SERVE_MESH on wgmma_tma, one launch a layer; layer 0's
    prefill K/V and laid cache bit for bit the 1x1's on every rank; each
    layer's decode attention and MoE decode FFN on the 1x1 run's inputs
    within BF16_ROW_ULPS of its output, the cache after that step changed
    only in the owner's slot (and there within BF16_ROW_ULPS); the tokens,
    and every teacher-forced step's greedy pick, identical on every model
    rank; each planted fault rejected by its gate; the nccl run bit for
    bit.  Printed, not gated: the teacher-forced logits against the 1x1
    step's, the greedy tokens' agreement with the 1x1 run's, prefill ms,
    decode ms/token, a decode step's wire per axis and each rank's peak
    memory (SERVE_MESH line).  The recurrent cases through
    serve_mesh_recurrent_report.  Returns K2's and K3's launches by path
    ({"k2", "k3"})."""
    from repro_torch.launch import serve
    from repro_torch.runtime import mesh as mesh_mod

    rec, launches, k3 = {"card": card, "transport": SHARD_TRANSPORT}, {}, {}
    for tag, (arch, shape, _, gen) in SERVE_MESH_CASES.items():
        got = world[tag]
        if tag in REC_SERVE:
            rec[tag] = serve_mesh_recurrent_report(card, tag, got, launches, k3)
            continue
        pay, ranks = got["payload"], got["ranks"]
        ref = torch.load(SERVE_MESH_DIR / f"{tag}.pt", map_location="cpu")
        world_n = pay["world"]
        n_mesh = shape[0] * shape[1]
        n_layers = len(ranks[0]["attn"])
        want_shape = (*FA_SERVE_MESH[tag], "bfloat16", "wgmma_tma")
        _k2_ranks(f"SERVE_MESH {tag}", pay, [n_layers] * n_mesh + [0] * (world_n - n_mesh),
                  want_shape)
        worst = {
            "attn": max(max(r["attn"]) for r in ranks),
            "cache_slot": max((max(r["slots"]) for r in ranks if r["slots"]), default=0.0),
            "moe": max((max(r["moe"]) for r in ranks if r["moe"]), default=None),
        }
        gates = {
            "layer-0 prefill K/V bit for bit": all(r["bits"]["prefill"] for r in ranks),
            "layer-0 laid cache bit for bit": all(r["bits"]["laid"] for r in ranks),
            f"decode attention per layer <= {BF16_ROW_ULPS}": worst["attn"] <= BF16_ROW_ULPS,
            f"the step's cache slot <= {BF16_ROW_ULPS}": worst["cache_slot"] <= BF16_ROW_ULPS,
            "only the owner's slot written": all(r["untouched"] for r in ranks),
            "tokens identical on every model rank": pay["tokens_agree_over_model"] and all(
                r["tokens_agree_over_model"] and r["picks_agree"] for r in ranks),
            "cache sharded on its sequence": all(r["seq_sharded"] for r in ranks),
        }
        if worst["moe"] is not None:
            gates[f"MoE decode FFN per layer <= {BF16_ROW_ULPS}"] = worst["moe"] <= BF16_ROW_ULPS
        planted = {}
        for name in ranks[0]["planted"]:
            vals = [r["planted"][name] for r in ranks]
            if isinstance(vals[0], bool):  # a gate's flag: rejected if any rank fails it
                planted[name] = {"rejected": not all(vals), "per_rank": vals}
            else:
                planted[name] = {"rejected": max(vals) > BF16_ROW_ULPS, "reading": max(vals)}
        tokens = torch.as_tensor(got["tokens"])
        greedy_agree = float((tokens == ref["tokens"]).float().mean())
        same_prefix = int((tokens == ref["tokens"]).all(0).long().cumprod(0).sum())
        tf = {i: max(r["teacher_forced"][i] for r in ranks) for i in ranks[0]["teacher_forced"]}
        case = {"mesh": pay["mesh"], "transport": pay["transport"], "world": world_n,
                "prefill_ms": pay["prefill_ms"], "decode_ms_per_token": pay["decode_ms_per_token"],
                "decode_step_traffic_rank0": pay["decode_step_traffic"],
                "peak_mem_gb": pay["peak_mem_gb"], "k2_launches": pay["k2_launches"],
                "k2_shapes": pay["k2_shapes"], "cache_layout": pay["cache_layout"],
                "local_cache": ranks[0]["local_cache"], "gates": gates, "worst": worst,
                "planted": planted, "teacher_forced_logits_rel": tf,
                "prefill_logits_rel": max(r["prefill_logits_rel"] for r in ranks),
                "greedy_tokens_agree_with_1x1": greedy_agree,
                "greedy_steps_equal_1x1": same_prefix, "wall_s": got["wall_s"],
                "checks_s": max(r["checks_s"] for r in ranks)}
        print(f"[serve_mesh {tag} {pay['mesh']}] {card}, transport {pay['transport']}, world "
              f"{world_n}: prefill {pay['prefill_ms']:.1f} ms, decode "
              f"{pay['decode_ms_per_token']:.2f} ms/token (rank 0's clock: the transport's "
              f"time); cache {pay['cache_layout']} {ranks[0]['local_cache']} a rank; K2 "
              f"{pay['k2_launches']} at {pay['k2_shapes']}; a decode step's wire, rank 0 "
              f"{pay['decode_step_traffic']}; peak GB per rank {pay['peak_mem_gb']}")
        print(f"[serve_mesh {tag}] gates {gates}; worst readings {worst}; planted {planted}")
        print(f"[serve_mesh {tag}] printed, not gated: teacher-forced step logits max|d|/max|1x1| "
              f"(step: reading) {[f'{i}: {x:.3e}' for i, x in tf.items()]}; prefill logits "
              f"{case['prefill_logits_rel']:.3e}; "
              f"greedy tokens equal to the 1x1 run's {greedy_agree:.3f} (all rows equal for the "
              f"first {same_prefix} of {gen})")
        if not all(gates.values()):
            raise AssertionError(f"SERVE_MESH {tag}: {[k for k, v in gates.items() if not v]}")
        if not all(p["rejected"] for p in planted.values()):
            raise AssertionError(f"SERVE_MESH {tag}: a planted fault passes: {planted}")
        rec[tag] = case
        launches[f"{arch} {pay['mesh']} serve"] = sum(pay["k2_launches"])

    # gemma cut in depth, on a 1x1 mesh over nccl, against the serve without one.
    argv = serve_mesh_argv("gemma", "1x1", "nccl", SERVE_MESH_NCCL_LAYERS)
    plain_argv = [a for a in argv if a not in ("--mesh", "1x1", "--transport", "nccl")]
    one = serve.run(serve.parse_args(plain_argv))
    reset_launch_counts()
    nccl = mesh_mod.launch(serve._serve_ranks, (1, 1), transport="nccl", device="cuda",
                           args=(vars(serve.parse_args(argv)), True))
    bits = torch.equal(nccl["tokens"], one["tokens"]) and \
        torch.equal(nccl["last_logits"], one["last_logits"]) and \
        all(torch.equal(a, b) for a, b in zip(nccl["step_logits"], one["step_logits"])) and \
        all(torch.equal(nccl["cache"]["layers"][n], one["cache"]["layers"][n]) for n in ("k", "v"))
    pay = nccl["payload"]
    _k2_ranks("SERVE_MESH gemma 1x1 nccl", pay, [SERVE_MESH_NCCL_LAYERS],
              (LM_BATCH, 8, 1, LM_PROMPT, LM_PROMPT, 256, "bfloat16", "wgmma_tma"))
    print(f"[serve_mesh gemma 1x1 nccl, {SERVE_MESH_NCCL_LAYERS} layers] transport "
          f"{pay['transport']}: tokens, prefill and step logits and the cache bit for bit the "
          f"serve without a mesh: {bits}; prefill {pay['prefill_ms']:.1f} ms, decode "
          f"{pay['decode_ms_per_token']:.2f} ms/token (without a mesh "
          f"{one['prefill_ms']:.1f}, {one['decode_ms_per_token']:.2f})")
    if pay["transport"] != "nccl" or not bits:
        raise AssertionError("the 1x1 serve over nccl differs from the serve without a mesh")
    rec["gemma_1x1_nccl"] = {"bits_equal": bits, "layers": SERVE_MESH_NCCL_LAYERS,
                             "prefill_ms": pay["prefill_ms"],
                             "decode_ms_per_token": pay["decode_ms_per_token"],
                             "no_mesh_prefill_ms": one["prefill_ms"],
                             "no_mesh_decode_ms_per_token": one["decode_ms_per_token"],
                             "k2_launches": pay["k2_launches"]}
    launches["gemma-2b 1x1 nccl serve (2 layers)"] = sum(pay["k2_launches"])
    del one, nccl
    torch.cuda.empty_cache()
    shutil.rmtree(SERVE_MESH_DIR, ignore_errors=True)
    print("SERVE_MESH " + json.dumps(rec))
    return {"k2": launches, "k3": k3}


def serve_mesh_recurrent_report(card: str, tag: str, got: dict, launches: dict,
                                k3: dict) -> dict:
    """The gates of a recurrent SERVE_MESH case (serve_mesh_recurrent_case):
    K2 per rank only at FA_HYBRID_RANK, one a prefill per application of
    zamba2's shared block; K3 per rank one a prefill per sLSTM block; every
    block's prefill on the 1x1 input (the residual after it and every leaf
    of its cache) within BF16_ROW_ULPS; the first block's state in the
    serve's prefill cache within BF16_ROW_ULPS of the 1x1's, and that cache
    laid into the decode cache bit for bit; every mixer's decode step on
    the 1x1 inputs within BF16_ROW_ULPS; the tokens and every step's pick
    identical on every model rank; zamba2's attention cache sharded on its
    sequence; the planted REC_SERVE_PLANTED past BF16_ROW_ULPS.  Printed:
    the teacher-forced and prefill logits, the first tokens (and those of
    the rows a top-2 margin decides), the greedy tokens' agreement, prefill
    ms, decode ms/token, a decode step's wire and the cache a rank.  Adds
    the case's launches to `launches` (K2) and `k3`."""
    from repro_torch.configs import cut_depth, get_config

    arch, shape, depth, gen = SERVE_MESH_CASES[tag]
    cfg = cut_depth(get_config(arch), depth)
    pay, ranks = got["payload"], got["ranks"]
    world_n, n_mesh = pay["world"], shape[0] * shape[1]
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    n_slstm = cfg.n_layers // cfg.slstm_every if cfg.family == "xlstm" else 0
    _k2_ranks(f"SERVE_MESH {tag}", pay, [n_attn] * n_mesh + [0] * (world_n - n_mesh),
              (*FA_HYBRID_RANK, "bfloat16", "wgmma_tma"))
    worst = max(r for rank in ranks for _, r in rank["decode"])
    prefill = [max(r["prefill"][i][1] for r in ranks) for i in range(len(ranks[0]["prefill"]))]
    handoff = max(r["handoff"] for r in ranks)
    planted = min(r["planted"] for r in ranks)
    gates = {
        "K3 launches per rank": pay["k3_launches"] == [n_slstm] * n_mesh
        + [0] * (world_n - n_mesh),
        f"every block's prefill on the 1x1 input, output and cache <= {BF16_ROW_ULPS}":
            max(prefill) <= BF16_ROW_ULPS,
        f"the first block's state in the serve's prefill cache <= {BF16_ROW_ULPS}, laid bit "
        "for bit": handoff <= BF16_ROW_ULPS and all(r["laid_same"] for r in ranks),
        f"every mixer's decode step on the 1x1 inputs <= {BF16_ROW_ULPS}": worst <= BF16_ROW_ULPS,
        "tokens identical on every model rank": pay["tokens_agree_over_model"] and all(
            r["tokens_agree_over_model"] and r["picks_agree"] for r in ranks),
        "planted rejected: " + REC_SERVE_PLANTED: planted > BF16_ROW_ULPS,
    }
    if n_attn:
        gates["attention cache sharded on its sequence"] = all(r["seq_sharded"] for r in ranks)
    tf = {i: max(r["teacher_forced"][i] for r in ranks) for i in ranks[0]["teacher_forced"]}
    case = {"mesh": pay["mesh"], "transport": pay["transport"], "world": world_n,
            "n_layers": depth, "prefill_ms": pay["prefill_ms"],
            "decode_ms_per_token": pay["decode_ms_per_token"],
            "decode_step_traffic_rank0": pay["decode_step_traffic"],
            "peak_mem_gb": pay["peak_mem_gb"], "k2_launches": pay["k2_launches"],
            "k2_shapes": pay["k2_shapes"], "k3_launches": pay["k3_launches"],
            "cache_layout": pay["cache_layout"], "local_cache": ranks[0]["local_cache"],
            "decode_readings": [max(r["decode"][i][1] for r in ranks)
                                for i in range(len(ranks[0]["decode"]))],
            "prefill_readings": prefill, "prefill_handoff_reading": handoff,
            "planted": {REC_SERVE_PLANTED: planted},
            "gates": gates, "teacher_forced_logits_rel": tf,
            "prefill_logits_rel": max(r["prefill_logits_rel"] for r in ranks),
            "greedy_tokens_agree_with_1x1": ranks[0]["greedy_agree"],
            "first_tokens_equal": all(r["first_tokens_equal"] for r in ranks),
            "first_tokens_decided_rows": [r["first_tokens_decided"] for r in ranks],
            "first_tokens_decided_equal": all(r["first_tokens_ok"] for r in ranks),
            "greedy_steps_equal_1x1": ranks[0]["same_prefix"],
            "one_device_prefill_ms": ranks[0]["one_device_prefill_ms"],
            "one_device_decode_ms_per_token": ranks[0]["one_device_decode_ms_per_token"],
            "wall_s": got["wall_s"], "checks_s": max(r["checks_s"] for r in ranks)}
    print(f"[serve_mesh {tag} {pay['mesh']}, {depth} layers] {card}, transport "
          f"{pay['transport']}, world {world_n}: prefill {pay['prefill_ms']:.1f} ms, decode "
          f"{pay['decode_ms_per_token']:.2f} ms/token (rank 0's clock: the transport's time; "
          f"1x1 {case['one_device_prefill_ms']:.1f}, {case['one_device_decode_ms_per_token']:.2f});"
          f" cache {pay['cache_layout']} {ranks[0]['local_cache']} a rank; K2 "
          f"{pay['k2_launches']} at {pay['k2_shapes']}, K3 {pay['k3_launches']}; a decode step's "
          f"wire, rank 0 {pay['decode_step_traffic']}; peak GB per rank {pay['peak_mem_gb']}")
    print(f"[serve_mesh {tag}] gates {gates}; each block's prefill reading {prefill}, the "
          f"first block's state in the serve's cache {handoff}, planted ({REC_SERVE_PLANTED}) "
          f"{planted}; each mixer's decode reading "
          f"{case['decode_readings']}; printed, not gated: teacher-forced step logits "
          f"max|d|/max|1x1| {[f'{i}: {x:.3e}' for i, x in tf.items()]}; prefill logits "
          f"{case['prefill_logits_rel']:.3e}; first tokens all equal "
          f"{case['first_tokens_equal']} (rows decided by the margin, per rank "
          f"{case['first_tokens_decided_rows']}, theirs equal "
          f"{case['first_tokens_decided_equal']}); greedy tokens equal to the 1x1 run's "
          f"{case['greedy_tokens_agree_with_1x1']:.3f} (all rows for the first "
          f"{case['greedy_steps_equal_1x1']} of {gen})")
    if not all(gates.values()):
        raise AssertionError(f"SERVE_MESH {tag}: {[k for k, v in gates.items() if not v]}")
    for counts, by_path in ((pay["k2_launches"], launches), (pay["k3_launches"], k3)):
        if sum(counts):
            by_path[f"{arch} {pay['mesh']} serve"] = sum(counts)
    return case


# DICT_MESH: the paper's engine one agent a rank (runtime/mesh.py,
# runtime/comm.py's mesh wire), in the SHARDED phase's world (4 ranks
# sharing the card over gloo_staged): each case (tag, mesh, agents, config,
# with a fit, planted fault) against the one-process coder in this process.
DM_AGENTS, DM_MU_W, DM_SAMPLES = 4, 0.1, 32
DM_RTOL = 1e-5  # nu, y, W: max |mesh - one process| / max |one process|
# 2x2: W's update (W2 - W) within DM_UPDATE_RTOL of the one process's
# beyond 4 fp32 half-ulps of W (W2 is stored in fp32: an update of a few
# 1e-6 against |W| ~ 0.05 is not known finer than that)
DM_UPDATE_RTOL = 1e-4
DM_CASES = (
    ("graph 1x4", "1x4", DM_AGENTS, {"mode": "graph", "topology": "ring_metropolis"}, True,
     "a dropped graph round"),
    ("exact_fista 2x2", "2x2", 2, {"mode": "exact_fista"}, True,
     "fit_batch without its data sum"),
    ("hier 2x1x2", "2x1x2", (2, 2), {"mode": "hier", "topology": "ring_metropolis",
                                     "pod_topology": "ring_metropolis",
                                     "pod_gossip_every": 2}, False, None),
)
DM_DIR = ROOT / "build" / "chip_smoke_dict_mesh"


def dict_mesh_streams(submit) -> dict:
    """DICT_MESH's serve_dict streams (serve_dict's draws at K = 4 x and 1 x
    the agent width, seed 1), each a future of `submit(fn, *args, **kw)`."""
    from repro_torch.data.synthetic import sparse_stream

    return {key: submit(sparse_stream, DM_SAMPLES, m=M, k_true=n * ATOMS_PER_AGENT,
                        nonneg=False, seed=1) for key, n in (("X14", DM_AGENTS), ("X11", 1))}


def dict_mesh_job(streams: dict) -> dict:
    """What the DICT_MESH phase takes: its directory, the coder cases' rows
    (the gossip phase's planted stream), the drawn serve streams."""
    from repro_torch.data.synthetic import sparse_stream

    return {"dir": str(DM_DIR), "x": sparse_stream(MICRO_BATCH, m=M, k_true=LEARN_K_TRUE, seed=1),
            **{key: f.result() for key, f in streams.items()}}


def dm_serve_argv(mesh: str, transport=None, learn: bool = True):
    """serve_dict's flags of the DICT_MESH runs (exact_fista: it codes at
    this width, graph does not)."""
    return ["--mode", "exact_fista", "--m", str(M), "--atoms-per-agent", str(ATOMS_PER_AGENT),
            "--mesh", mesh, "--samples", str(DM_SAMPLES), "--micro-batch", str(MICRO_BATCH),
            "--iters", str(ITERS), "--gamma", str(GAMMA), "--delta", str(DELTA),
            "--device", "cuda", "--json"] + (["--transport", transport] if transport else []) \
        + ([] if learn else ["--no-learn"])


def given_stream(X):
    """A stand-in for serve_dict's `sparse_stream` that returns the rows X
    drawn ahead (the same call's)."""
    def stream(n, **kw):
        return X[:n]
    return stream


def drop_last_round(real):
    """comm.graph_shift with the schedule's last round lost (the planted
    fault: a destination gets zeros for it)."""
    def shift(*a, **kw):
        got = real(*a, **kw)
        return got[:-1] + tuple(r * 0 for r in got[-1:])
    return shift


def update_reading(W2, W2_ref, W) -> float:
    """max |(W2 - W) - (W2_ref - W)| over its allowance: DM_UPDATE_RTOL of
    max |W2_ref - W| plus 4 x 2^-24 x max |W2_ref| (<= 1 passes)."""
    allowed = DM_UPDATE_RTOL * float((W2_ref - W).abs().max()) + 4 * 2.0 ** -24 * float(
        W2_ref.abs().max())
    return max_err(W2 - W, W2_ref - W) / allowed


def dict_mesh_world(mesh, job: dict) -> dict:
    """The DICT_MESH part of the SHARDED world (every rank; the 2x2 mesh
    and the 1x4 and 2x1x2 meshes over the same 4 ranks): each DM_CASES
    coder on its mesh (one agent a rank) on the rows job["x"] and the
    first columns of serve_dict's W0 draw: solve_per_agent gathered, one
    timed solve (and its wire bytes), a fit_batch whose
    blocks go to files under job["dir"], the planted fault; then
    serve_dict's rank body at 1x4 over gloo_staged (learning on) on the
    stream job["X14"], its final dictionary to a file.  Rank 0 returns
    what each rank counted (K1 launches, engine calls, peak memory, wire
    bytes, seconds) and the gathered results."""
    import numpy as np
    import torch

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.dictionary import init_dictionary
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict
    from repro_torch.runtime import comm, mesh as mesh_mod

    dev = mesh.device
    root = pathlib.Path(job["dir"])
    torch.cuda.empty_cache()
    meshes = {"2x2": mesh, "1x4": mesh_mod.make_mesh((1, 4)),
              "2x1x2": mesh_mod.make_mesh((2, 1, 2), ("pod", "data", "model"))}
    res, reg = make_task("sparse_svd", gamma=GAMMA, delta=DELTA)
    gen = torch.Generator(device=dev).manual_seed(0)
    W_full = init_dictionary(gen, M, DM_AGENTS * ATOMS_PER_AGENT, device=dev)
    x = torch.as_tensor(job["x"], device=dev)
    out = {"world_s": {}}
    for tag, key, agents, cfg, fit, fault in DM_CASES:
        t_case = time.perf_counter()
        m = meshes[key]
        coder = DistributedSparseCoder(agents, res, reg, DistConfig(iters=ITERS, **cfg),
                                       device=dev, mesh=m)
        W, xl = coder.shard(W_full[:, :coder.n_agents * ATOMS_PER_AGENT], x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches0 = ops.dict_dual_step.launches
        nu, y = coder.solve_per_agent(W, xl)  # gathered; also the timed solve's warmup
        torch.cuda.synchronize()
        before = {a: list(c) for a, c in m.traffic.items()}
        t = time.perf_counter()
        coder.solve(W, xl)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        traffic = {a: [c[0] - before.get(a, [0, 0])[0], c[1] - before.get(a, [0, 0])[1]]
                   for a, c in m.traffic.items() if c != before.get(a)}
        solves = 2
        if fit:
            W2 = coder.fit_batch(W, xl, DM_MU_W)
            solves += 1
            if m.index("data") == 0:
                torch.save(W2.cpu(), root / f"{tag} {coder.agent_index}.pt")
            del W2
        torch.cuda.synchronize()
        launches = ops.dict_dual_step.launches - launches0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        nu_fault = None
        if fault == "a dropped graph round":
            with mock.patch.object(comm, "graph_shift", drop_last_round(comm.graph_shift)):
                nu_fault, _ = coder.solve_per_agent(W, xl)
        elif fault == "fit_batch without its data sum":
            with mock.patch.object(coder, "_data_sum", lambda t: t):
                W2 = coder.fit_batch(W, xl, DM_MU_W)
            if m.index("data") == 0:
                torch.save(W2.cpu(), root / f"{tag} fault {coder.agent_index}.pt")
            del W2
        ranks = m.all_gather_object({
            "agent": coder.agent_index, "coords": m.coords, "solve_s": secs,
            "k1_launches": launches, "solves": solves, "peak_gb": peak_gb,
            "traffic": traffic})
        if m.rank == 0:
            out[tag] = {"ranks": ranks, "nu": nu.cpu().numpy(), "y": y.cpu().numpy(),
                        "nu_fault": None if nu_fault is None else nu_fault.cpu().numpy(),
                        "wire": coder.wire_bytes_per_iter(xl.shape[0], M)}
        del coder, W, xl, nu, y, nu_fault
        out["world_s"][tag] = time.perf_counter() - t_case
    del W_full
    torch.cuda.empty_cache()

    m14 = meshes["1x4"]
    args = serve_dict.parse_args(dm_serve_argv("1x4", "gloo_staged"))
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with mock.patch.object(serve_dict, "sparse_stream", given_stream(job["X14"])):
        got = serve_dict._serve_ranks(m14, args)
    wall = time.perf_counter() - t
    peaks = m14.all_gather_object(torch.cuda.max_memory_allocated() / 1e9)
    if m14.rank == 0:
        np.save(root / "serve 1x4.npy", got.pop("dictionary"))
        got["rank_peak_gb"], got["world_wall_s"] = peaks, wall
        out["serve 1x4"] = got
        out["world_s"]["serve 1x4"] = time.perf_counter() - t
    return out if mesh.rank == 0 else None


def phase_dict_mesh(torch, card: str, raw: dict, job: dict) -> dict:
    """The DICT_MESH gates, on what `dict_mesh_world` returned: each case
    against the one-process coder on the card in this process (nu, y and W
    after fit_batch at DM_RTOL; at 2x2 W's update at DM_UPDATE_RTOL), each
    planted fault rejected by the same check, K1 launches per rank = (iters
    + 1) x solves, each rank's wire bytes over a solve = iters x
    wire_bytes_per_iter (the exact modes' psum counted once there, twice in
    the accounting, plus the adaptive step's 4-byte reduction per agent
    axis); the serve_dict run at 1x4 (every sample coded and finite, some
    nonzero, its final dictionary a one-process replay of the micro-batches
    rank 0 fitted); then serve_dict on a 1x1 mesh over nccl (its rank this
    process) bit for bit the run without a mesh (codes without learning;
    the learned dictionary against its replay).  Prints one DICT_MESH line;
    returns {path: K1 launches} (summed over the ranks)."""
    import numpy as np

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.dictionary import full_from_blocks, init_dictionary
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.launch import serve_dict

    root = pathlib.Path(job["dir"])
    res, reg = make_task("sparse_svd", gamma=GAMMA, delta=DELTA)
    gen = torch.Generator(device="cuda").manual_seed(0)
    W_full = init_dictionary(gen, M, DM_AGENTS * ATOMS_PER_AGENT, device="cuda")
    x = torch.as_tensor(job["x"], device="cuda")
    rec = {"card": card, "transport": SHARD_TRANSPORT, "M": M, "atoms_per_agent": ATOMS_PER_AGENT,
           "B": MICRO_BATCH, "iters": ITERS, "cases": {}}
    launches = {}
    for tag, key, agents, cfg, fit, fault in DM_CASES:
        got = raw[tag]
        coder = DistributedSparseCoder(agents, res, reg, DistConfig(iters=ITERS, **cfg),
                                       device="cuda")
        W, xt = coder.shard(W_full[:, :coder.n_agents * ATOMS_PER_AGENT], x)
        coder.solve(W, xt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        coder.solve(W, xt)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
        nu, y = coder.solve_per_agent(W, xt)
        row = {"mesh": key, "agents": coder.n_agents, "config": cfg,
               "nu": rel_err(torch.as_tensor(got["nu"], device="cuda"), nu),
               "y": rel_err(torch.as_tensor(got["y"], device="cuda"), y),
               "one_process_solve_s": one_s}
        ok = row["nu"] <= DM_RTOL and row["y"] <= DM_RTOL
        if fault == "a dropped graph round":
            row["fault"] = {fault: rel_err(torch.as_tensor(got["nu_fault"], device="cuda"), nu)}
        if fit:
            W2 = coder.fit_batch(W, xt, DM_MU_W)

            def blocks(name):
                return torch.cat([torch.load(root / f"{name} {k}.pt") for k in
                                  range(coder.n_agents)]).to("cuda")

            W2m = blocks(tag)
            row["W"] = rel_err(W2m, W2)
            ok = ok and row["W"] <= DM_RTOL
            if fault == "fit_batch without its data sum":
                row["max_update"] = float((W2 - W).abs().max())
                row["update"] = update_reading(W2m, W2, W)
                row["fault"] = {fault: update_reading(blocks(f"{tag} fault"), W2, W)}
                ok = ok and row["update"] <= 1.0
            del W2, W2m
        ranks = got["ranks"]
        want_launches = [(ITERS + 1) * r["solves"] for r in ranks]
        row["k1_launches_per_rank"] = [r["k1_launches"] for r in ranks]
        row["solve_s_per_rank"] = [r["solve_s"] for r in ranks]
        row["solve_s"] = ranks[0]["solve_s"]
        row["peak_gb_per_rank"] = [r["peak_gb"] for r in ranks]
        exact = cfg["mode"].startswith("exact")
        row["wire_bytes_per_iter"] = {a: b for a, b in got["wire"]}
        row["traffic_per_rank"] = [r["traffic"] for r in ranks]
        wire_ok = all(r["traffic"].get(a, [0, 0])[1] == ITERS * b / (2 if exact else 1) + 4
                      for r in ranks for a, b in got["wire"])
        print(f"[dict mesh {tag}] {card}: nu {row['nu']:.3e}, y {row['y']:.3e}"
              + (f", W {row['W']:.3e}" if fit else "")
              + f" of the one process's (gate {DM_RTOL})"
              + (f"; update {row['update']:.3e} of its allowance (max |dW| "
                 f"{row['max_update']:.3e})" if "update" in row else "")
              + f"; planted {row.get('fault')}; solve "
              f"{row['solve_s']:.3f} s on rank 0 (one process {one_s:.3f} s); K1 launches per "
              f"rank {row['k1_launches_per_rank']} (expected {want_launches}); wire per rank "
              f"{row['traffic_per_rank']} for {row['wire_bytes_per_iter']} an iteration; peak "
              f"GB per rank {[round(v, 3) for v in row['peak_gb_per_rank']]}")
        if not ok:
            raise AssertionError(f"dict mesh {tag}: the mesh parts from the one process")
        for name, reading in row.get("fault", {}).items():
            gate = 1.0 if "update" in row else DM_RTOL
            if not reading > gate:
                raise AssertionError(f"dict mesh {tag}: the gate passes a planted fault: {name}")
        if row["k1_launches_per_rank"] != want_launches:
            raise AssertionError(f"dict mesh {tag}: K1 launches per rank "
                                 f"{row['k1_launches_per_rank']}, expected {want_launches}")
        if not wire_ok:
            raise AssertionError(f"dict mesh {tag}: wire bytes per rank {row['traffic_per_rank']}"
                                 f" against {row['wire_bytes_per_iter']} an iteration")
        launches[f"dict mesh {tag}"] = sum(row["k1_launches_per_rank"])
        rec["cases"][tag] = row
        del coder, W, xt, nu, y
    del W_full
    torch.cuda.empty_cache()

    # serve_dict at 1x4 over gloo_staged, learning on: the codes, and the
    # final dictionary against a one-process replay of rank 0's fits.
    got = raw["serve 1x4"]
    pay, results, log = got["payload"], got["results"], got["fit_log"]
    codes = np.stack([y for _, y in results])
    finite = all(np.isfinite(nu).all() and np.isfinite(y).all() for nu, y in results)
    coder = DistributedSparseCoder(DM_AGENTS, res, reg,
                                   DistConfig(mode="exact_fista", iters=ITERS), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Wb = coder.snapshot(init_dictionary(gen, M, DM_AGENTS * ATOMS_PER_AGENT, device="cuda"))
    for xb, mu_w, t0 in log:
        Wb = coder.fit_batch(Wb, xb, mu_w, t0)
    W_mesh = torch.as_tensor(np.load(root / "serve 1x4.npy", mmap_mode="r"), device="cuda")
    replay = rel_err(W_mesh, full_from_blocks(Wb))
    del W_mesh, Wb, coder
    torch.cuda.empty_cache()
    calls = got["engine_calls"]
    want = [(ITERS + 1) * c for c in calls]
    lat = pay["latency_ms"]
    serve = {"samples_per_s": pay["samples_per_s"], "latency_ms": lat, "wall_s": pay["wall_s"],
             "world_wall_s": got["world_wall_s"], "fit_steps": len(log),
             "k1_launches_per_rank": got["k1_launches"], "engine_calls_per_rank": calls,
             "rank_peak_gb": got["rank_peak_gb"], "replay_rel": replay,
             "nonzero_code_share": float(np.count_nonzero(codes)) / codes.size,
             "mesh": got["mesh"], "transport": got["transport"]}
    print(f"[dict mesh serve 1x4] {card}: {pay['samples_per_s']:.4f} samples/s, p50 "
          f"{lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms, wall {pay['wall_s']:.2f} s; "
          f"{len(log)} fits, final dictionary vs the one-process replay {replay:.3e} (gate "
          f"{DM_RTOL}); K1 launches per rank {got['k1_launches']} ({calls} engine calls); "
          f"nonzero code share {serve['nonzero_code_share']:.3e}; peak GB per rank "
          f"{[round(v, 3) for v in got['rank_peak_gb']]}")
    if len(results) != DM_SAMPLES or not finite or serve["nonzero_code_share"] == 0.0:
        raise AssertionError("dict mesh serve 1x4: codes missing, not finite or all zero")
    if not replay <= DM_RTOL or not log:
        raise AssertionError(f"dict mesh serve 1x4: the dictionary parts from its replay "
                             f"({replay}, {len(log)} fits)")
    if len(set(calls)) != 1 or got["k1_launches"] != want:
        raise AssertionError(f"dict mesh serve 1x4: K1 launches {got['k1_launches']}, "
                             f"engine calls {calls}")
    launches["dict mesh serve 1x4"] = sum(got["k1_launches"])
    rec["serve_1x4"] = serve

    # serve_dict on a 1x1 mesh over nccl against the run without a mesh.
    def cli(argv):
        reset_launch_counts()
        with mock.patch.object(serve_dict, "sparse_stream", given_stream(job["X11"])):
            return serve_dict.run(serve_dict.parse_args(argv))

    plain = cli(dm_serve_argv("1x1", learn=False))
    nccl = cli(dm_serve_argv("1x1", "nccl", learn=False))
    codes_bits = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                     for a, b in zip(plain["results"], nccl["results"]))
    learned = cli(dm_serve_argv("1x1", "nccl", learn=True))
    launches["dict mesh serve 1x1 nccl"] = sum(nccl["k1_launches"]) + sum(learned["k1_launches"])
    coder = DistributedSparseCoder(1, res, reg, DistConfig(mode="exact_fista", iters=ITERS),
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Wb = coder.snapshot(init_dictionary(gen, M, ATOMS_PER_AGENT, device="cuda"))
    for xb, mu_w, t0 in learned["fit_log"]:
        Wb = coder.fit_batch(Wb, xb, mu_w, t0)
    dict_bits = bool(np.array_equal(full_from_blocks(Wb).cpu().numpy(), learned["dictionary"]))
    del Wb, coder
    rec["nccl_1x1"] = {"codes_bit_for_bit": codes_bits, "dictionary_bit_for_bit": dict_bits,
                       "fits": len(learned["fit_log"]), "transport": nccl["transport"],
                       "samples_per_s": nccl["payload"]["samples_per_s"],
                       "plain_samples_per_s": plain["payload"]["samples_per_s"]}
    print(f"[dict mesh serve 1x1 nccl] every code bit for bit the run without a mesh: "
          f"{codes_bits}; the learned dictionary bit for bit its one-process replay "
          f"({len(learned['fit_log'])} fits): {dict_bits}")
    if nccl["transport"] != "nccl" or not codes_bits or not dict_bits or \
            not learned["fit_log"]:
        raise AssertionError("serve_dict on a 1x1 mesh over nccl differs from the run "
                             "without a mesh")
    rec["launches"] = launches
    rec["world_s"] = raw["world_s"]
    print("DICT_MESH " + json.dumps(rec))
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

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f}s")
        return res

    # Every serve_dict run codes the same planted stream (serve_dict's
    # sparse_stream call at M, K and seed 1), whose 262144 planted atoms take
    # the host 40-70 s to draw: drawn once, memoized, on a host thread beside
    # the build (which waits on nvcc).  A second thread draws the fleet's
    # publish dictionary (fleet_w0) meanwhile.  Both are awaited before the
    # first timed kernel phase, so no draw shares the host with a timing.
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data.synthetic import sparse_stream
    from repro_torch.launch import serve_dict

    stream = functools.lru_cache(maxsize=1)(sparse_stream)
    W0_fleet = timed("fleet's W0 to the host", fleet_w0, torch)
    drawer = ThreadPoolExecutor(3)
    drawn = drawer.submit(stream, SAMPLES, m=M, k_true=ATOMS_PER_AGENT * N_AGENTS,
                          nonneg=False, seed=1)
    publish = (W0_fleet, drawer.submit(serve_dict.perturbed, W0_fleet, FLEET_SEED + 3, False))
    dm_streams = dict_mesh_streams(drawer.submit)
    drawer.shutdown(wait=False)
    build_lines = []

    def build():
        t = time.perf_counter()
        return phase_build(build_lines.append), time.perf_counter() - t

    builder = ThreadPoolExecutor(1)
    built = builder.submit(build)
    builder.shutdown(wait=False)
    # The learner and the experiments are plain PyTorch (no kernel of the
    # port is on their path, as in the JAX package): none may launch one.
    # They run on the card while nvcc builds the kernels on the host.
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
    t = time.perf_counter()
    (wgmma_build, slstm_build), build_s = built.result()
    print("\n".join(build_lines))
    print(f"[phase] build: {build_s:.1f}s (beside the learner and the experiments), "
          f"{time.perf_counter() - t:.1f}s more after them")
    t = time.perf_counter()
    drawn.result()
    publish[1].result()
    print(f"[phase] planted stream and the fleet's publish dictionary (drawn beside the "
          f"build): {time.perf_counter() - t:.1f}s more; {stream.cache_info()}")
    rec = timed("dict_dual_step", phase_kernels, torch)
    fa_rec = timed("flash_attention", phase_flash_attention, torch)
    fa_rec["wgmma_build"] = wgmma_build  # HGMMA in the SASS, ptxas registers and spills
    fa_rec["backward"] = timed("flash_attention gradient", phase_flash_attention_grad, torch)
    fa_rec["moe_shapes"] = timed("flash_attention MoE shapes", phase_flash_attention_moe, torch)
    fa_rec["vlm_audio_shapes"] = timed("flash_attention VLM and audio shapes",
                                       phase_flash_attention_vlm_audio, torch)
    fa_rec["hybrid_shape"] = timed("flash_attention hybrid shape", phase_flash_attention_hybrid,
                                   torch)
    fa_rec["serve_mesh_shapes"] = timed("flash_attention per-rank serve shapes",
                                        phase_flash_attention_serve_mesh, torch)
    fa_rec["fsdp_shapes"] = timed("flash_attention granite-8b, qwen3-32b and FSDP shapes",
                                  phase_flash_attention_fsdp, torch)
    moe_layer = timed("MoE layer", phase_moe_layer, torch)
    sl_rec = timed("slstm_seq", phase_slstm, torch, slstm_build)
    sl_rec["backward"] = timed("slstm_seq gradient", phase_slstm_grad, torch)
    timed("small coder", phase_small_coder, torch)
    timed("elastic small", phase_elastic_small, torch)
    rec["grown_shapes"] = timed("dict_dual_step at N 18, 20", phase_k1_grown_shapes, torch)
    gossip = timed("gossip modes", phase_gossip_modes, torch, card)
    fa_rec["launches"] = timed("gemma-2b serve", phase_lm, torch, card)
    sl_rec["launches"] = timed("xlstm-1.3b serve", phase_xlstm, torch, card)
    train = timed("olmo-1b train", phase_train, torch, card, "train", TRAIN_ARCH, TRAIN_LAYERS,
                  TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT)
    timed("train card vs cpu", phase_train_card_vs_cpu, torch)
    moe_serve = timed("granite-moe serve", phase_moe_serve, torch, card)
    moe_train = timed("granite-moe train", phase_moe_train, torch, card)
    kimi = timed("kimi-k2 cut serve", phase_kimi, torch, card)
    moe_cpu = timed("MoE card vs cpu", phase_moe_card_vs_cpu, torch)
    granite8b = timed("granite-8b serve", phase_granite8b, torch, card)
    qwen = timed("qwen3-32b cut serve", phase_qwen32b, torch, card)
    fsdp_ref = timed("granite-8b cut serve (SERVE_MESH's 1x1)", phase_fsdp_reference, torch)
    dm_job = dict_mesh_job(dm_streams)
    sharded = timed("sharded training", phase_sharded, torch, card, dm_job)
    serve_mesh = timed("serving on a mesh", phase_serve_mesh, torch, card,
                       sharded.pop("serve_mesh_world"))
    sl_rec["per_rank_shape"]["launches_by_path"] = {**sharded["k3_launches"],
                                                   **serve_mesh["k3"]}
    dict_mesh = timed("dictionary engine on a mesh", phase_dict_mesh, torch, card,
                      sharded.pop("dict_mesh_world"), dm_job)
    shutil.rmtree(DM_DIR, ignore_errors=True)
    vlm_serve = timed("phi-3-vision serve", phase_vlm_serve, torch, card)
    vlm_train = timed("phi-3-vision train", phase_train, torch, card, "vlm train", VLM_ARCH,
                      VLM_TRAIN_LAYERS, VLM_STEPS, VLM_CKPT_EVERY, VLM_FAULT_AT,
                      TWIN_GRAD_FLOOR)
    audio = timed("hubert-xlarge encode", phase_audio_encode, torch, card)
    audio_train = timed("hubert-xlarge train", phase_train, torch, card, "audio train",
                        AUDIO_ARCH, AUDIO_TRAIN_LAYERS, AUDIO_STEPS, AUDIO_CKPT_EVERY,
                        AUDIO_FAULT_AT, TWIN_GRAD_FLOOR)
    va_cpu = timed("VLM and audio card vs cpu", phase_vlm_audio_card_vs_cpu, torch)
    hybrid_serve = timed("zamba2-1.2b serve", phase_hybrid_serve, torch, card)
    hybrid_train = timed("zamba2-1.2b train", phase_train, torch, card, "hybrid train",
                         HYBRID_ARCH, HYBRID_TRAIN_LAYERS, HYBRID_STEPS, HYBRID_CKPT_EVERY,
                         HYBRID_FAULT_AT, None)
    hybrid_cpu = timed("hybrid card vs cpu", phase_hybrid_card_vs_cpu, torch)
    xlstm_train = timed("xlstm-1.3b train", phase_xlstm_train, torch, card)
    xlstm_cpu = timed("xlstm card vs cpu", phase_xlstm_card_vs_cpu, torch)
    sl_rec["launches_by_path"] = {"xlstm-1.3b serve": sl_rec["launches"],
                                  "xlstm-1.3b train": xlstm_train["launches"],
                                  **sl_rec["per_rank_shape"]["launches_by_path"]}
    sl_rec["launches"] = sum(sl_rec["launches_by_path"].values())
    sl_rec["train_launches_per_step"] = xlstm_train["launches_per_step"]
    sl_rec["backward"]["launches_per_step"] = xlstm_train["launches_per_step"]
    fa_rec["launches_by_path"] = {"gemma-2b serve": fa_rec["launches"],
                                  "olmo-1b train": train["launches"],
                                  "granite-moe serve": moe_serve,
                                  "granite-moe train": moe_train["launches"],
                                  "kimi-k2 cut serve": kimi,
                                  "granite-8b serve": granite8b,
                                  "qwen3-32b cut serve": qwen,
                                  "granite-8b cut serve": fsdp_ref,
                                  "phi-3-vision serve": vlm_serve,
                                  "phi-3-vision train": vlm_train["launches"],
                                  "hubert-xlarge encode": audio,
                                  "hubert-xlarge train": audio_train["launches"],
                                  "zamba2 serve": hybrid_serve,
                                  "zamba2 train": hybrid_train["launches"],
                                  **sharded["launches"], **serve_mesh["k2"]}
    fa_rec["launches"] = sum(fa_rec["launches_by_path"].values())
    fa_rec["train_launches_per_step"] = train["launches_per_step"]
    fa_rec["moe_train_launches_per_step"] = moe_train["launches_per_step"]
    fa_rec["vlm_train_launches_per_step"] = vlm_train["launches_per_step"]
    fa_rec["audio_train_launches_per_step"] = audio_train["launches_per_step"]
    fa_rec["hybrid_train_launches_per_step"] = hybrid_train["launches_per_step"]
    fa_rec["sharded"] = {"launches_per_rank": {
        "olmo-1b 2x2 train": sharded["olmo_2x2"]["k2_launches"],
        "olmo-1b 1x1 nccl train": sharded["olmo_1x1_nccl"]["k2_launches"],
        "granite-moe 1x2 train": sharded["granite_1x2"]["k2_launches"],
        "granite-moe 2x1 reload step": sharded["granite_1x2"]["k2_rescale"]["k2_launches"],
        "granite-8b 2x2 FSDP train": sharded["granite8b_2x2_fsdp"]["k2_launches"],
        "zamba2-1.2b 2x2 train": sharded["recurrent"]["zamba2"]["k2_launches"]},
        "shapes_per_rank": {"olmo-1b 2x2 train": sharded["olmo_2x2"]["k2_shapes"],
                            "zamba2-1.2b 2x2 train": sharded["recurrent"]["zamba2"]["k2_shapes"],
                            "granite-moe 1x2 train": sharded["granite_1x2"]["k2_shapes"],
                            "granite-8b 2x2 FSDP train":
                                sharded["granite8b_2x2_fsdp"]["k2_shapes"]},
        "transport": SHARD_TRANSPORT}
    print("MOE_CHECKS " + json.dumps({"layer": moe_layer, "card_vs_cpu": moe_cpu}))
    print("VLM_AUDIO_CHECKS " + json.dumps({"card_vs_cpu": va_cpu}))
    print("HYBRID_CHECKS " + json.dumps({"card_vs_cpu": hybrid_cpu}))
    print("XLSTM_CHECKS " + json.dumps({"card_vs_cpu": xlstm_cpu}))
    # The diffusion's step is bounded by the worst block's curvature
    # (sigma_max(W_k)^2 / delta, about 58 here) while its consensus term
    # contracts by only mu / N per iteration, so after 150 iterations at this
    # width an agent's nu is still a small fraction of x (1 - (1 - mu/N)^150,
    # about 0.13) and no atom passes the threshold: graph codes may all be
    # zero.  exact_fista converges in 150 iterations and must code.
    # The two schedule-driven paths run the service too: graph_tv_q8 with
    # link failures and the three-level chain of the gossip phase.
    # Every run codes the same planted stream, `stream` (drawn beside the
    # build).
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
    launches["fleet"] = timed("fleet", phase_fleet, torch, card, stream, publish)
    publish = W0_fleet = None  # the 17 GB of the host they held
    launches["kill drill"] = timed("kill drill", phase_kill_drill, torch, card, stream)
    launches.update(gossip)
    launches.update(dict_mesh)
    rec["launches"] = sum(launches.values())
    rec["launches_by_mode"] = launches
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
