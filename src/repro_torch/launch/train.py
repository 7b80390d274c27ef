"""Training launcher, on one card.

Port of src/repro/launch/train.py for the dense and moe LM families: the
smoke config of --arch (or with --full-config the full one) trains on the
Markov token stream through the fault-tolerant runner, with AdamW on a
cosine warmup (Adafactor for a bf16-param config, kimi-k2's), checkpoints,
an injected fault (--inject-fault-at) and an elastic reload
(--rescale-mesh).  The loss of an MoE config carries 0.01 x its
load-balance aux (the step's `moe_aux`):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --steps 12 \\
      --batch 8 --seq 64 --ckpt-every 5 --inject-fault-at 7 --rescale-mesh 1x1
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --full-config \\
      --batch 4 --seq 2048 --steps 12 --ckpt-every 6 --ckpt-dir build/ckpt_olmo
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_1b_a400m \\
      --full-config --batch 4 --seq 2048 --steps 8 --ckpt-every 4 --inject-fault-at 6

`--n-layers` cuts the depth of the chosen config and keeps every width.
Weights are random, made from --seed on the device.  `--device cpu` runs on
the CPU (the default is the card, and no card is an error).  One card
holds the whole run, so --mesh and --rescale-mesh take only 1x1: a sharded
run is ROADMAP section 1's sharded-training item.  xlstm waits for the
xLSTM-training item (K3's gradient); the other families for their slices.
Checkpoints go to --ckpt-dir, by default a fresh directory under
build/checkpoints/.

Prints the JAX CLI's lines: the loss every 10 steps, the final loss with
the faults recovered, the checkpoint list, and "elastic rescale ...:
resumed at step ...".
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.configs import (ALIASES, ARCH_IDS, FAMILY_SLICES, cut_depth, get_config,
                                 get_smoke_config)
from repro_torch.data import synthetic as data
from repro_torch.device import resolve_device
from repro_torch.models.model import require_trainable
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.runner import RunnerConfig, TrainRunner, check_mesh

CKPT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "checkpoints"


def make_batches(cfg, batch: int, seq: int, seed: int = 0):
    """Step-indexed batch factory (replay-safe): step -> {"tokens": (B, S)
    int32 numpy}."""
    if cfg.family in FAMILY_SLICES:  # audio and vlm batches wait for their slices
        raise NotImplementedError(f"{cfg.name}: {cfg.family} batches wait for ROADMAP "
                                  f"section 1, {FAMILY_SLICES[cfg.family]}")
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
        require_trainable(cfg)
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
    out = run(parse_args(argv))
    return {k: out[k] for k in ("losses", "faults", "ckpt_dir", "ckpt_steps", "rescaled_step")}


if __name__ == "__main__":
    main()
