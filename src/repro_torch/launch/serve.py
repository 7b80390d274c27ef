"""Serving launcher: batched prefill + greedy decode loop with a KV cache,
on one card.

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
and is refused, as by JAX's CLI.  At full width:

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

`--n-layers` cuts the depth of the chosen config (kimi-k2's 61 layers do
not fit one card; 2 keep its dense first layer and one MoE layer; a hybrid
config keeps at least one group of attn_every Mamba2 layers) and keeps
every width.  Weights are random, made from --seed on the device.  `--device cpu` runs
on the CPU (the default is the card, and no card is an error).  One card
holds the whole model, so `--mesh` takes only 1x1: sharded serving (a
decode over a KV cache sharded on its sequence) is ROADMAP section 1,
item 1; launch/train --mesh trains sharded.

Prints the JAX CLI's lines (config, prefill ms and decode ms/token, the
first row's token ids); `--json` adds one `BENCH` line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ALIASES, ARCH_IDS, cut_depth, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M


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
                    help="device mesh; one card serves the whole model: only 1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true",
                    help="emit a single BENCH json line at the end")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> Dict:
    """Serve one prompt batch.  Returns {"tokens": (B, gen) int64 on the
    CPU, "prefill_ms", "decode_ms_per_token", "payload": the BENCH dict,
    and for checks: "cfg", "params" (as `cast_params` leaves them), "prompts",
    "batch" (the prefill's input: the prompts, and vlm's image embeddings),
    "last_logits" (B, V) fp32 of the prefill's last position,
    "prefill_cache" and "cache" (for xlstm one tree: the state caches are
    carried over and the decode loop advances them in place; hybrid's
    Mamba2 states are shared by the two the same way)}."""
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh!r}: sharded serving is not ported yet "
                         f"(ROADMAP section 1, item 1: sharded serving); one card serves "
                         f"the whole model with --mesh 1x1 (launch/train --mesh trains "
                         f"sharded)")
    try:
        cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
        if args.n_layers is not None:
            cfg = cut_depth(cfg, args.n_layers)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    if not cfg.decode_supported:
        raise SystemExit(f"{args.arch} is encoder-only; no decode loop")
    if args.gen < 1:
        raise SystemExit("--gen must be at least 1")
    device = resolve_device(args.device)

    # The prefill fills the image positions and the prompt, and decode
    # writes gen - 1 more: the cache holds n_img + prompt + gen positions.
    # JAX's CLI (src/repro/launch/serve.py:48) sizes it prompt + gen, so a
    # VLM's last n_img decode writes are clamped into its last slot.
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    max_len = n_img + args.prompt_len + args.gen
    # Serving needs only the compute copy: cast once, keep no fp32 master.
    params = M.cast_params(cfg, M.init(cfg, seed=args.seed, device=device))
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), device=device
    )
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.as_tensor(
            rng.standard_normal((args.batch, n_img, cfg.vision_dim)), device=device
        ).to(cfg.cdtype)

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

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        step_logits, cache = M.decode_step(cfg, params, cache, tok, n_img + args.prompt_len + i)
        tok = torch.argmax(step_logits[:, -1, :], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu()
    steps = max(args.gen - 1, 1)
    payload = {
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
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill {payload['prefill_ms']:.1f} ms; decode "
          f"{payload['decode_ms_per_token']:.2f} ms/token")
    print("generated token ids (first row):", gen[0].tolist())
    if args.json:
        print("BENCH " + json.dumps(payload))
    return {
        "tokens": gen, "prefill_ms": payload["prefill_ms"],
        "decode_ms_per_token": payload["decode_ms_per_token"], "payload": payload,
        "cfg": cfg, "params": params, "prompts": prompts, "batch": batch,
        "last_logits": last_logits,
        "prefill_cache": pre_cache, "cache": cache,
    }


def _merge_prefill_cache(cfg, cache: Optional[dict], pre_cache: dict) -> dict:
    """Copy the prefill cache (length = prompt, with vlm's image positions)
    into the max_len cache, in place: "layers", and "dense" where an MoE
    config has leading dense layers; hybrid's "attn", one K/V per
    application of the shared block.  The xlstm caches and hybrid's
    "mamba" and "mamba_tail" are pure state: the prefill's are carried over
    as they are (and for xlstm `cache` is not read)."""
    if cfg.family == "xlstm":
        return pre_cache
    if cfg.family not in ("dense", "moe", "vlm", "hybrid"):
        raise KeyError(cfg.family)
    if cfg.family == "hybrid":
        cache.update({key: pre_cache[key] for key in pre_cache if key != "attn"})
        stacks = {"attn": cache["attn"]}
    else:
        stacks = cache
    for stack, layers in stacks.items():
        for name, full in layers.items():
            part = pre_cache[stack][name]
            full[:, :, : part.shape[2]] = part
    return cache


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))["payload"]


if __name__ == "__main__":
    main()
