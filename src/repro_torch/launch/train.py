"""Training launcher, on one card.

Port of src/repro/launch/train.py for every family (dense, moe, vlm,
audio, hybrid and xlstm): the smoke config of --arch (or with
--full-config the full one) trains on its synthetic stream (the Markov
tokens, for dense, moe, hybrid and xlstm; with image embeddings
before the text for vlm, whose loss is over the text; hubert's
masked-prediction frames for audio) through the fault-tolerant runner,
with AdamW on a cosine warmup (Adafactor for a bf16-param config,
kimi-k2's), checkpoints, an injected fault (--inject-fault-at) and an
elastic reload (--rescale-mesh).  The loss of an MoE config carries 0.01 x
its load-balance aux (the step's `moe_aux`):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --steps 12 \\
      --batch 8 --seq 64 --ckpt-every 5 --inject-fault-at 7 --rescale-mesh 1x1
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --full-config \\
      --batch 4 --seq 2048 --steps 12 --ckpt-every 6 --ckpt-dir build/ckpt_olmo
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_1b_a400m \\
      --full-config --batch 4 --seq 2048 --steps 8 --ckpt-every 4 --inject-fault-at 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi-3-vision-4.2b \\
      --full-config --n-layers 4 --batch 4 --seq 2048 --steps 6 --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
      --full-config --batch 4 --seq 2048 --steps 6 --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --full-config --n-layers 14 --batch 4 --seq 2048 --steps 6 --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_1p3b \\
      --full-config --n-layers 16 --batch 4 --seq 2048 --steps 6 --ckpt-every 3

`--n-layers` cuts the depth of the chosen config and keeps every width
(a hybrid config keeps at least one group of attn_every Mamba2 layers:
n_layers // attn_every groups, each followed by the shared block, and a
tail of the remainder; an xlstm config whole groups of slstm_every
blocks, the last of each the sLSTM block).
Weights are random, made from --seed on the device.  `--device cpu` runs on
the CPU (the default is the card, and no card is an error).  One card
holds the whole run, so --mesh and --rescale-mesh take only 1x1: a sharded
run is ROADMAP section 1's sharded-training item.
Checkpoints go to --ckpt-dir, by default a fresh directory under
build/checkpoints/.

Prints the JAX CLI's lines: the loss every 10 steps, the final loss with
the faults recovered, the checkpoint list, and "elastic rescale ...:
resumed at step ..."; then, from the command line, the step time (the
median after the first step) and, on the card, the process's peak device
memory.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.configs import ALIASES, ARCH_IDS, cut_depth, get_config, get_smoke_config
from repro_torch.data import synthetic as data
from repro_torch.device import resolve_device
from repro_torch.models.model import require_ported
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.runner import RunnerConfig, TrainRunner, check_mesh

CKPT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "checkpoints"


def make_batches(cfg, batch: int, seq: int, seed: int = 0):
    """Step-indexed batch factory (replay-safe), numpy batches as JAX's:
    step -> {"tokens": (B, S) int32} (dense, moe, hybrid, xlstm); audio
    {"features", "targets", "mask"} of S frames; vlm {"tokens": (B, max(S -
    n_img_tokens, 8)), "img_embeds"}, S positions in all for S >=
    n_img_tokens + 8."""
    if cfg.family == "audio":
        def fn(step):
            gen = data.audio_batches(cfg.frame_dim, cfg.vocab, batch, seq, 1, seed=seed + step)
            return next(iter(gen))
        return fn
    if cfg.family == "vlm":
        def fn(step):
            gen = data.vlm_batches(cfg.vocab, cfg.n_img_tokens, cfg.vision_dim, batch,
                                   max(seq - cfg.n_img_tokens, 8), 1, seed=seed + step)
            return next(iter(gen))
        return fn
    stream = data.TokenStream(cfg.vocab, seed)

    def fn(step):
        return {"tokens": next(stream.batches(batch, seq, 1, host_index=step))}

    return fn


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="olmo_1b", choices=ARCH_IDS + list(ALIASES))
    ap.add_argument("--full-config", action="store_true",
                    help="use the full assigned config (real hardware only)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the config's depth to this many layers (widths kept)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", type=str, default="1x1",
                    help="DATAxMODEL; one card trains the whole model: only 1x1")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--rescale-mesh", type=str, default=None,
                    help="after training, reload the checkpoint on this mesh (only 1x1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict:
    """Train.  Returns {"cfg", "runner", "state", "history" (the runner's,
    one metrics dict per step run, replays included), "losses" ([step,
    loss] per step run, in order), "faults", "ckpt_dir", "ckpt_steps",
    "rescaled_step" (None without --rescale-mesh)}."""
    try:
        check_mesh(args.mesh)
        if args.rescale_mesh:
            check_mesh(args.rescale_mesh)
        cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
        if args.n_layers is not None:
            cfg = cut_depth(cfg, args.n_layers)
        require_ported(cfg)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    device = resolve_device(args.device)
    opt = opt_mod.for_arch(cfg, lr=cosine_warmup(args.lr, warmup=20, total=args.steps))
    if args.ckpt_dir:
        ckpt_dir = args.ckpt_dir
    else:
        CKPT_ROOT.mkdir(parents=True, exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix=f"ckpt_{args.arch}_", dir=CKPT_ROOT)
    # Every step reports (log_every 1) so the run records each loss; the
    # lines print every 10 steps, as the JAX CLI's.
    run_cfg = RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every, log_every=1)

    injected = {"done": False}

    def fault_hook(step):
        if step == args.inject_fault_at and not injected["done"]:
            injected["done"] = True
            raise RuntimeError(f"injected node failure at step {step}")

    runner = TrainRunner(cfg, args.mesh, opt, run_cfg, device=device,
                         fault_hook=fault_hook if args.inject_fault_at >= 0 else None)
    batches = make_batches(cfg, args.batch, args.seq, args.seed)
    losses = []

    def log(step, metrics):
        losses.append([step - 1, metrics["loss"]])
        if step % 10 == 0:
            print(f"step {step:5d}  loss {metrics['loss']:.4f}  ce {metrics['ce']:.4f}")

    state, history = runner.run(batches, args.steps, seed=args.seed, metrics_cb=log)
    faults = len([e for e in runner.events if e["kind"] == "fault"])
    print(f"final loss {history[-1]['loss']:.4f} after {args.steps} steps "
          f"({faults} faults recovered)")
    print(f"checkpoints in {ckpt_dir}: steps {runner.ckpt.steps()}")

    rescaled_step = None
    if args.rescale_mesh:
        del state  # one train state on the device at a time
        runner2 = TrainRunner.rescale(cfg, args.rescale_mesh, opt, run_cfg, device=device)
        state = runner2.restore_or_init(args.seed)
        rescaled_step = int(state["step"])
        print(f"elastic rescale {args.mesh} -> {args.rescale_mesh}: resumed at step "
              f"{rescaled_step}")
    return {"cfg": cfg, "runner": runner, "state": state, "history": history,
            "losses": losses, "faults": faults, "ckpt_dir": ckpt_dir,
            "ckpt_steps": runner.ckpt.steps(), "rescaled_step": rescaled_step}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    out = run(args)
    times = out["runner"].step_times
    line = (f"{out['cfg'].name}, {out['cfg'].n_layers} layers, {args.batch} x {args.seq} "
            f"positions: step {statistics.median(times[1:] or times) * 1e3:.1f} ms (median "
            f"of the {len(times) - 1} steps run after the first; first {times[0] * 1e3:.1f} ms)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        line += f"; peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"
    print(line)
    return {k: out[k] for k in ("losses", "faults", "ckpt_dir", "ckpt_steps", "rescaled_step")}


if __name__ == "__main__":
    main()
