"""Serving launcher: batched prefill + greedy decode loop with a KV cache,
on one card or over a (data, model) mesh of ranks.

Port of src/repro/launch/serve.py for the dense, moe, vlm, xlstm and
hybrid LM families.  Prefills the prompt batch once, then steps the decode function
greedily.  Dense, moe and vlm: every layer's attention runs through the
flash-attention kernel (K2), and the prompt's KV is copied into a cache of
prompt + gen positions (moe with leading dense layers: the "dense" and
"layers" caches, as JAX merges them); each MoE layer dispatches by
capacity (models/moe.py).  vlm: each prompt has n_img_tokens image
embeddings before its text, drawn from the same generator after the
prompts (as JAX's), so the prefill covers n_img_tokens + prompt positions
and the cache n_img_tokens + prompt + gen.  xlstm: every sLSTM block's
recurrence is one launch of the sLSTM kernel (K3), and the prefill's state
caches are carried over as they are.  hybrid: each application of the
shared block attends through K2 (n_layers // attn_every a prefill), its
K/V is copied into a cache of prompt + gen positions, and the Mamba2
state caches are carried over as they are.  The audio family is encoder-only
and is refused, as by JAX's CLI.  At full width, on one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \\
      --full-config --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \\
      --full-config --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi_k2_1t_a32b \\
      --full-config --n-layers 2 --batch 4 --prompt-len 2048 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b \\
      --full-config --batch 4 --prompt-len 2048 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --full-config --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
      --full-config --batch 4 --prompt-len 2048 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_32b \\
      --full-config --n-layers 16 --batch 4 --prompt-len 2048 --gen 4

`--n-layers` cuts the depth of the chosen config (kimi-k2's 61 layers do
not fit one card; 2 keep its dense first layer and one MoE layer;
qwen3-32b's 64 layers are 128 GB of fp32 weights, 16 of them 34.3 GB; a hybrid
config keeps at least one group of attn_every Mamba2 layers) and keeps
every width.  Weights are random, made from --seed on the device.  `--device cpu` runs
on the CPU (the default is the card, and no card is an error).

`--mesh DxM` serves the dense, MoE, hybrid and xlstm families over D x M
ranks, spawned
by runtime/mesh.launch as `launch/train --mesh` spawns them, and computes
what JAX's sharded serve computes (src/repro/launch/serve.py:36-78): the
prompts, drawn from --seed as at 1x1, split over `data`; the weights made
as at 1x1 and cut by the sharding rules (runtime/sharding), so a mesh
serves the model 1x1 serves; a tensor-parallel prefill (K2 on each rank's
query heads, the MoE FFN all-to-all where S divides M); a decode cache
sharded on its sequence over `model` where max_len divides M (each rank
attends over its positions and the parts combine by their log-sum-exp),
else on its kv heads where they divide M, else replicated; an MoE decode
step through the expert-sharded capacity dispatch over the step's whole
batch (gathered over `data`); the greedy argmax vocab-parallel.  The
hybrid (zamba2) and xlstm families run their Mamba2 and mLSTM mixers
tensor-parallel by heads and their sLSTM on every model rank
(models/ssm.py, models/xlstm.py): the shared block's cache as the dense
one, the Mamba2 and mLSTM states by heads, the sLSTM's the rank's rows.
`--transport auto` runs gloo on the CPU, nccl with a card a rank and
gloo_staged for several ranks on one card; any other value runs even a
1x1 mesh through this path (its one rank this process).  An FSDP config
(fsdp_embed: granite-8b, qwen3-32b, kimi-k2) holds D / dp of every
weight's `embed` dim a rank and gathers it over `data` before use
(models/fsdp.py): each layer's weights in every prefill and decode step.
A rank that raises fails the run.  The vlm and audio families and a
`pod` axis are refused on a mesh, naming the ROADMAP item that lifts each:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh 2x2 --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \
      --device cpu --mesh 1x2 --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b --device cpu \
      --mesh 2x2 --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1p3b --device cpu \
      --mesh 1x2 --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b --full-config \
      --n-layers 2 --batch 4 --prompt-len 2048 --gen 4 --mesh 2x2

Prints the JAX CLI's lines (config, prefill ms and decode ms/token, the
first row's token ids); `--json` adds one `BENCH` line (on a mesh also the
mesh, transport and world, the tokens gathered over `data`, each rank's
K2 launches and shapes and K3 launches, a decode step's collectives and bytes per axis,
each rank's peak device memory; times on rank 0's clock).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ALIASES, ARCH_IDS, cut_depth, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS
from repro_torch.runtime.runner import check_mesh


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="gemma_2b", choices=ARCH_IDS + list(ALIASES))
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to this many layers (widths kept)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", type=str, default="1x1",
                    help="DATAxMODEL ranks (dense, moe, hybrid and xlstm families); 1x1 "
                         "serves in process")
    ap.add_argument("--transport", type=str, default="auto",
                    choices=("auto",) + mesh_mod.TRANSPORTS,
                    help="the mesh's collectives: auto = gloo on the CPU, nccl with a card "
                         "a rank, gloo_staged for several ranks on one card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true",
                    help="emit a single BENCH json line at the end")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(args: argparse.Namespace):
    """The config of --arch (smoke or full, cut to --n-layers), checked
    against --mesh; SystemExit naming what is refused."""
    try:
        cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
        if args.n_layers is not None:
            cfg = cut_depth(cfg, args.n_layers)
        check_mesh(args.mesh, cfg)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    if not cfg.decode_supported:
        raise SystemExit(f"{args.arch} is encoder-only; no decode loop")
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")
    return cfg


def _sharded(args: argparse.Namespace) -> bool:
    return args.transport != "auto" or any(n != 1 for n in mesh_mod.parse_mesh(args.mesh))


def _inputs(cfg, args: argparse.Namespace, device) -> Tuple[dict, int]:
    """The whole prompt batch, drawn from --seed ({"tokens"}, and vlm's
    "img_embeds" drawn after them, as JAX's), and the cache's max_len.

    The prefill fills the image positions and the prompt, and decode
    writes gen - 1 more: the cache holds n_img + prompt + gen positions.
    JAX's CLI (src/repro/launch/serve.py:48) sizes it prompt + gen, so a
    VLM's last n_img decode writes are clamped into its last slot."""
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), device=device)}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.as_tensor(
            rng.standard_normal((args.batch, n_img, cfg.vision_dim)), device=device
        ).to(cfg.cdtype)
    return batch, n_img + args.prompt_len + args.gen


def _payload(cfg, args, device, prefill_s: float, decode_s: float) -> dict:
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    steps = max(args.gen - 1, 1)
    return {
        "arch": cfg.name,
        "device": str(device),
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "n_img_tokens": n_img,
        "gen": args.gen,
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_token": decode_s * 1e3 / steps,
        "decode_tokens_per_s": args.batch * (args.gen - 1) / decode_s if decode_s > 0 else None,
        "prefill_tokens_per_s": args.batch * (n_img + args.prompt_len) / prefill_s,
    }


def _print(cfg, args, payload: dict, first_row) -> None:
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill {payload['prefill_ms']:.1f} ms; decode "
          f"{payload['decode_ms_per_token']:.2f} ms/token")
    print("generated token ids (first row):", first_row)
    if args.json:
        print("BENCH " + json.dumps(payload))


def run(args: argparse.Namespace) -> Dict:
    """Serve one prompt batch.  Returns {"tokens": (B, gen) int64 on the
    CPU, "prefill_ms", "decode_ms_per_token", "payload": the BENCH dict,
    and for checks: "cfg", "params" (as `cast_params` leaves them), "prompts",
    "batch" (the prefill's input: the prompts, and vlm's image embeddings),
    "last_logits" (B, V) fp32 of the prefill's last position, "step_logits"
    (each decode step's (B, V) fp32),
    "prefill_cache" and "cache" (for xlstm one tree: the state caches are
    carried over and the decode loop advances them in place; hybrid's
    Mamba2 states are shared by the two the same way)}.  On a mesh (see
    the module's docstring) rank 0's {"tokens", "prefill_ms",
    "decode_ms_per_token", "payload"} and "cfg"."""
    cfg = _config(args)
    if _sharded(args):
        return _run_sharded(args, cfg)
    device = resolve_device(args.device)

    # Serving needs only the compute copy: cast once, keep no fp32 master.
    params = M.cast_params(cfg, M.init(cfg, seed=args.seed, device=device))
    batch, max_len = _inputs(cfg, args, device)
    prompts = batch["tokens"]
    pos0 = max_len - args.gen

    # Prefill: run the prompt through the model, then copy the per-layer KV
    # into a max_len cache (the xlstm state caches need no copy).
    _sync(device)
    t0 = time.perf_counter()
    logits, pre_cache = M.prefill(cfg, params, batch)
    last_logits = logits[:, -1, :].clone()
    del logits  # (B, S, V) fp32: 8.4 GB at gemma-2b, B 4, S 2048
    cache = None if cfg.family == "xlstm" else M.init_cache(cfg, args.batch, max_len, device=device)
    cache = _merge_prefill_cache(cfg, cache, pre_cache)
    tok = torch.argmax(last_logits, dim=-1)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out_tokens, step_logits = [tok], []
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok, pos0 + i)
        step_logits.append(logits[:, -1, :])
        tok = torch.argmax(step_logits[-1], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu()
    payload = _payload(cfg, args, device, prefill_s, decode_s)
    _print(cfg, args, payload, gen[0].tolist())
    return {
        "tokens": gen, "prefill_ms": payload["prefill_ms"],
        "decode_ms_per_token": payload["decode_ms_per_token"], "payload": payload,
        "cfg": cfg, "params": params, "prompts": prompts, "batch": batch,
        "last_logits": last_logits, "step_logits": step_logits,
        "prefill_cache": pre_cache, "cache": cache,
    }


def _merge_prefill_cache(cfg, cache: Optional[dict], pre_cache: dict) -> dict:
    """Copy the prefill cache (length = prompt, with vlm's image positions)
    into the max_len cache, in place: "layers", and "dense" where an MoE
    config has leading dense layers; hybrid's "attn", one K/V per
    application of the shared block (model.merge_prefill_cache).  The
    xlstm caches and hybrid's "mamba" and "mamba_tail" are pure state: the
    prefill's are carried over as they are (and for xlstm `cache` is not
    read)."""
    if cfg.family == "xlstm":
        return pre_cache
    if cfg.family not in ("dense", "moe", "vlm", "hybrid"):
        raise KeyError(cfg.family)
    if cfg.family == "hybrid":
        cache.update({key: pre_cache[key] for key in pre_cache if key != "attn"})
        M.merge_prefill_cache(cfg, {"attn": cache["attn"]}, pre_cache)
        return cache
    return M.merge_prefill_cache(cfg, cache, pre_cache)


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------


def _run_sharded(args: argparse.Namespace, cfg) -> Dict:
    shape = mesh_mod.parse_mesh(args.mesh)
    if args.device == "cuda":
        resolve_device("cuda")  # no card: the error, before any rank is spawned
    out = mesh_mod.launch(_serve_ranks, shape, transport=args.transport, device=args.device,
                          args=(vars(args),))
    out["cfg"] = cfg
    return out


def _serve_ranks(mesh, a: dict, keep: bool = False) -> Optional[Dict]:
    """One rank of a sharded serve on `mesh` (None beyond it: the rank only
    joins the world's collectives).  Rank 0 prints the CLI's lines and
    returns {"tokens", "prefill_ms", "decode_ms_per_token", "payload"};
    with keep, every rank of the mesh returns its run (`_serve_on`'s
    dict, the payload on rank 0)."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.slstm_step import ops as k3_ops
    from repro_torch.launch.train import _k2_counts

    args = argparse.Namespace(**a)
    cfg = _config(args)
    ops.flash_attention.launches = 0
    ops.launch_shapes.clear()
    k3_ops.slstm_seq.launches = 0
    cuda = mesh is not None and mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    run = _serve_on(mesh, cfg, args) if mesh is not None else None
    k2 = _k2_counts(ops)
    k3 = [None] * dist.get_world_size()  # every rank's K3 launches in the serve
    dist.all_gather_object(k3, k3_ops.slstm_seq.launches)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(
        peaks, torch.cuda.max_memory_allocated(mesh.device) / 1e9 if cuda else None)
    if dist.get_rank() == 0:
        payload = {**_payload(cfg, args, mesh.device, run["prefill_s"], run["decode_s"]),
                   "mesh": args.mesh, "transport": mesh.transport,
                   "world": dist.get_world_size(), "cache_layout": run["cache_layout"],
                   "tokens": run["tokens"].tolist(),
                   "tokens_agree_over_model": run["tokens_agree_over_model"],
                   "k2_launches": [n for n, _ in k2], "k2_shapes": [s for _, s in k2],
                   "k3_launches": k3,
                   "decode_step_traffic": run["decode_step_traffic"], "peak_mem_gb": peaks}
        _print(cfg, args, payload, run["tokens"][0].tolist())
        run["payload"] = payload
    if keep:
        return run
    if dist.get_rank() != 0:
        return None
    return {"tokens": run["tokens"], "prefill_ms": run["payload"]["prefill_ms"],
            "decode_ms_per_token": run["payload"]["decode_ms_per_token"],
            "payload": run["payload"]}


def _serve_on(mesh, cfg, args: argparse.Namespace) -> dict:
    """Serve on this rank of `mesh`: the global weights made from --seed as
    at 1x1 and cut to the rank's shards, the rank's rows of the prompts,
    the prefill, its K/V laid into the rank's cache shard, the greedy
    decode.  Returns {"tokens" (B, gen) gathered over `data`, on the CPU;
    "prefill_s", "decode_s" (this rank's clock); "cache_layout";
    "decode_step_traffic" (the last decode step's [collectives, bytes] per
    axis); "tokens_agree_over_model"; and for checks "params", "batch"
    (the rank's rows), "max_len", "last_logits" and "step_logits" (the
    rank's vocabulary range), "prefill_cache", "cache"}."""
    from repro_torch.runtime.sharding import shard_tree
    from repro_torch.runtime.steps import data_shard, greedy_tokens

    device = mesh.device
    full = M.init(cfg, seed=args.seed, device=device)
    params = M.cast_params(cfg, shard_tree(full, M.param_specs(cfg, mesh), mesh))
    del full
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the whole fp32 tree's blocks, for the other ranks
    whole, max_len = _inputs(cfg, args, device)
    batch = data_shard(whole, mesh)
    pos0 = max_len - args.gen
    seq = M.seq_sharded(cfg, mesh, max_len)

    _sync(device)
    t0 = time.perf_counter()
    logits, pre_cache = M.prefill(cfg, params, batch, mesh)
    last_logits = logits[:, -1, :].clone()
    del logits
    cache = M.init_cache(cfg, args.batch, max_len, device, mesh)
    cache = M.merge_prefill_cache(cfg, cache, pre_cache, mesh, max_len)
    tok = greedy_tokens(cfg, last_logits, mesh)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out_tokens, step_logits, traffic = [tok], [], {}
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        before = {ax: list(c) for ax, c in mesh.traffic.items()}
        logits, cache = M.decode_step(cfg, params, cache, tok, pos0 + i, mesh, max_len)
        step_logits.append(logits[:, -1, :])
        tok = greedy_tokens(cfg, step_logits[-1], mesh)[:, None]
        out_tokens.append(tok)
        traffic = {ax: [n - before.get(ax, [0, 0])[0], b - before.get(ax, [0, 0])[1]]
                   for ax, (n, b) in mesh.traffic.items()}
    _sync(device)
    decode_s = time.perf_counter() - t0

    mine = torch.cat(out_tokens, dim=1)
    every = mesh.all_gather_tiled(mine[None], MODEL_AXIS, 0)
    agree = bool((every == mine[None]).all())
    layout = _cache_layout(cfg, mesh, cache, seq)
    return {"tokens": mesh.all_gather_tiled(mine, DATA_AXIS, 0).cpu(),
            "prefill_s": prefill_s, "decode_s": decode_s, "cache_layout": layout,
            "decode_step_traffic": traffic, "tokens_agree_over_model": agree,
            "params": params, "batch": batch, "max_len": max_len,
            "last_logits": last_logits, "step_logits": step_logits,
            "prefill_cache": pre_cache, "cache": cache}


def _cache_layout(cfg, mesh, cache: dict, seq: bool) -> str:
    """How the rank's decode cache is cut over `model`: the attention K/V's
    "seq", "heads" or "replicated" (the hybrid's shared block's), and for
    xlstm, whose mLSTM state goes by heads, "heads" (or "replicated" at
    tp 1)."""
    if cfg.family == "xlstm":
        return "heads" if mesh.size(MODEL_AXIS) > 1 else "replicated"
    layers = (cache["attn"] if cfg.family == "hybrid" else next(iter(cache.values())))["k"]
    return "seq" if seq else "heads" if layers.shape[3] != cfg.n_kv_heads else "replicated"


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))["payload"]


if __name__ == "__main__":
    main()
