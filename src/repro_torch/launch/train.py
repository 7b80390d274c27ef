"""Training launcher, on one card or over a (data, model) mesh of ranks.

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
the CPU (the default is the card, and no card is an error).
Checkpoints go to --ckpt-dir, by default a fresh directory under
build/checkpoints/.

`--mesh DxM` (and `--rescale-mesh D2xM2`) trains the dense, MoE, hybrid
and xlstm families sharded over D x M ranks, spawned by runtime/mesh.launch (max(D
M, D2 M2) of them; each mesh takes the first ranks): the parameters cut
by the JAX package's sharding rules, tensor-parallel over `model`,
data-parallel over `data` (an FSDP config, fsdp_embed: granite-8b,
qwen3-32b, kimi-k2, also every weight's `embed` dim over `data`, gathered
before use, models/fsdp.py; Adafactor's means then span the shards), the
MoE FFN expert-parallel (models/moe_a2a), the Mamba2 and mLSTM mixers
tensor-parallel by heads and the sLSTM on every model rank (its K3 on
each),
checkpoints of whole tensors written by rank 0, the injected fault raised
on every rank at the same step, and after the run the reload of the
latest checkpoint (or --rescale-step's) on the rescale mesh with one step
there.  `--transport auto` runs gloo on the CPU (`--device cpu`), nccl
with a card a rank, and gloo_staged for several ranks on fewer cards (the
ranks share the card; the collectives stage through host memory); the
choice is printed and never switched on a failure.  `--transport` other
than auto runs even a 1x1 mesh through the distributed path (its one rank
is this process).  A rank that raises fails the run.  `--optimizer sgd` trains with plain SGD at the
constant --lr (the default: AdamW on a cosine warmup, Adafactor for a
bf16-param config).  The vlm and audio families and a `pod` axis are
refused on a mesh, naming the ROADMAP item that lifts each:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --mesh 2x2 --steps 8 \
      --batch 4 --seq 32 --ckpt-every 4 --inject-fault-at 5 --rescale-mesh 1x2 --json
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_1b_a400m \
      --full-config --n-layers 4 --mesh 1x2 --batch 4 --seq 2048 --steps 4 --ckpt-every 2 \
      --inject-fault-at 3 --rescale-mesh 2x1 --rescale-step 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b --full-config \
      --n-layers 2 --mesh 2x2 --batch 4 --seq 2048 --steps 3 --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b --device cpu \
      --mesh 2x2 --steps 8 --batch 4 --seq 32 --ckpt-every 4 --inject-fault-at 5 \
      --rescale-mesh 1x2 --json

Prints the JAX CLI's lines: the loss every 10 steps, the final loss with
the faults recovered, the checkpoint list, and "elastic rescale ...:
resumed at step ..."; then, from the command line, the step time (the
median after the first step) and, on the card, the process's peak device
memory (rank 0's on a mesh, beside the transport).  `--json` adds one JSON
line: rank 0's result (mesh, transport, world, losses, faults,
rescaled_step, rescaled_loss, each rank's K2 launches and, on the card,
peak device memory).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.configs import ALIASES, ARCH_IDS, cut_depth, get_config, get_smoke_config
from repro_torch.data import synthetic as data
from repro_torch.device import resolve_device
from repro_torch.models.model import require_ported
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedules import constant, cosine_warmup
from repro_torch.runtime import mesh as mesh_mod
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
                    help="DATAxMODEL ranks (dense, moe, hybrid and xlstm families); 1x1 "
                         "trains in process")
    ap.add_argument("--transport", type=str, default="auto",
                    choices=("auto",) + mesh_mod.TRANSPORTS,
                    help="the mesh's collectives: auto = gloo on the CPU, nccl with a card "
                         "a rank, gloo_staged for several ranks on one card")
    ap.add_argument("--optimizer", type=str, default="auto", choices=("auto", "adamw", "sgd"),
                    help="auto: AdamW on a cosine warmup (Adafactor for bf16 params); "
                         "sgd: plain SGD at the constant --lr")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--rescale-mesh", type=str, default=None,
                    help="after training, reload the checkpoint on this mesh")
    ap.add_argument("--rescale-step", type=int, default=None,
                    help="the checkpoint step the rescale reloads (default: the latest)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true", help="emit one JSON result line at the end")
    return ap.parse_args(argv)


def _config(args):
    """The config of --arch (smoke or full, cut to --n-layers), checked
    against both meshes; SystemExit naming what is refused."""
    try:
        cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
        if args.n_layers is not None:
            cfg = cut_depth(cfg, args.n_layers)
        require_ported(cfg)
        check_mesh(args.mesh, cfg)
        if args.rescale_mesh:
            check_mesh(args.rescale_mesh, cfg)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    return cfg


def _optimizer(cfg, args):
    if args.optimizer == "sgd":
        return opt_mod.sgd(constant(args.lr))
    schedule = cosine_warmup(args.lr, warmup=20, total=args.steps)
    return opt_mod.adamw(schedule) if args.optimizer == "adamw" else \
        opt_mod.for_arch(cfg, lr=schedule)


def _fault_hook(args):
    injected = {"done": False}

    def fault_hook(step):
        if step == args.inject_fault_at and not injected["done"]:
            injected["done"] = True
            raise RuntimeError(f"injected node failure at step {step}")

    return fault_hook if args.inject_fault_at >= 0 else None


def _ckpt_dir(args) -> str:
    if args.ckpt_dir:
        return args.ckpt_dir
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"ckpt_{args.arch}_", dir=CKPT_ROOT)


def _sharded(args) -> bool:
    meshes = [args.mesh] + ([args.rescale_mesh] if args.rescale_mesh else [])
    return args.transport != "auto" or any(
        any(n != 1 for n in mesh_mod.parse_mesh(m)) for m in meshes)


def run(args: argparse.Namespace) -> Dict:
    """Train.  Returns {"cfg", "runner", "state", "history" (the runner's,
    one metrics dict per step run, replays included), "losses" ([step,
    loss] per step run, in order), "faults", "ckpt_dir", "ckpt_steps",
    "rescaled_step" (None without --rescale-mesh)}.  On a mesh (see the
    module's docstring) rank 0's result instead: no "runner" and "state",
    but "mesh", "transport", "world", "step_times", "rescaled_loss" and
    "k2_launches" (each rank's)."""
    cfg = _config(args)
    if _sharded(args):
        return _run_sharded(args, cfg)
    device = resolve_device(args.device)
    opt = _optimizer(cfg, args)
    ckpt_dir = _ckpt_dir(args)
    # Every step reports (log_every 1) so the run records each loss; the
    # lines print every 10 steps, as the JAX CLI's.
    run_cfg = RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every, log_every=1)
    runner = TrainRunner(cfg, args.mesh, opt, run_cfg, device=device,
                         fault_hook=_fault_hook(args))
    batches = make_batches(cfg, args.batch, args.seq, args.seed)
    losses = []
    state, history = runner.run(batches, args.steps, seed=args.seed,
                                metrics_cb=_logger(losses, True))
    faults = _report(runner, history, args, ckpt_dir)

    rescaled_step = None
    if args.rescale_mesh:
        del state  # one train state on the device at a time
        runner2 = TrainRunner.rescale(cfg, args.rescale_mesh, opt, run_cfg, device=device)
        state = runner2.restore_or_init(args.seed, step=args.rescale_step)
        rescaled_step = int(state["step"])
        print(f"elastic rescale {args.mesh} -> {args.rescale_mesh}: resumed at step "
              f"{rescaled_step}")
    return {"cfg": cfg, "runner": runner, "state": state, "history": history,
            "losses": losses, "faults": faults, "ckpt_dir": ckpt_dir,
            "ckpt_steps": runner.ckpt.steps(), "rescaled_step": rescaled_step}


def _logger(losses: list, lead: bool):
    def log(step, metrics):
        losses.append([step - 1, metrics["loss"]])
        if lead and step % 10 == 0:
            print(f"step {step:5d}  loss {metrics['loss']:.4f}  ce {metrics['ce']:.4f}")
    return log


def _report(runner, history, args, ckpt_dir) -> int:
    faults = len([e for e in runner.events if e["kind"] == "fault"])
    if runner.lead:
        print(f"final loss {history[-1]['loss']:.4f} after {args.steps} steps "
              f"({faults} faults recovered)")
        print(f"checkpoints in {ckpt_dir}: steps {runner.ckpt.steps()}")
    return faults


def _run_sharded(args, cfg) -> Dict:
    shape = mesh_mod.parse_mesh(args.mesh)
    world = max(math.prod(mesh_mod.parse_mesh(m)) for m in (args.mesh, args.rescale_mesh) if m)
    if args.device == "cuda":
        resolve_device("cuda")  # no card: the error, before any rank is spawned
    a = dict(vars(args), ckpt_dir=_ckpt_dir(args))
    out = mesh_mod.launch(_train_ranks, shape, transport=args.transport, device=args.device,
                          args=(a,), world=world)
    out["cfg"] = cfg
    return out


def _train_ranks(mesh, a: dict) -> Optional[Dict]:
    """One rank of a sharded run: train on `mesh` (None beyond it), then
    the rescale on its mesh.  Rank 0 returns the result."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.slstm_step import ops as k3_ops

    t0 = time.perf_counter()
    seconds = {"startup": mesh_mod.startup_seconds()}  # then from this rank's start
    args = argparse.Namespace(**a)
    cfg = _config(args)
    opt = _optimizer(cfg, args)
    run_cfg = RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=1)
    batches = make_batches(cfg, args.batch, args.seq, args.seed)
    rank = dist.get_rank()
    ops.flash_attention.launches = 0
    ops.launch_shapes.clear()
    k3_ops.slstm_seq.launches = 0
    if mesh is not None and mesh.device.type == "cuda":
        # this run's peak (a world of one rank runs in its caller's process)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    out = None
    if mesh is not None:
        runner = TrainRunner(cfg, mesh, opt, run_cfg, fault_hook=_fault_hook(args))
        seconds["runner_ready"] = time.perf_counter() - t0
        losses = []
        state, history = runner.run(batches, args.steps, seed=args.seed,
                                    metrics_cb=_logger(losses, runner.lead))
        seconds["run_done"] = time.perf_counter() - t0
        del state
        faults = _report(runner, history, args, args.ckpt_dir)
        if runner.lead:
            out = {"mesh": args.mesh, "transport": mesh.transport, "world": dist.get_world_size(),
                   "step_traffic": mesh.step_traffic,
                   "history": history, "losses": losses, "faults": faults,
                   "ckpt_dir": args.ckpt_dir, "ckpt_steps": runner.ckpt.steps(),
                   "step_times": runner.step_times, "events": runner.events}
        del runner
    k2 = _k2_counts(ops)
    k3 = [None] * dist.get_world_size()  # every rank's K3 launches in the run
    dist.all_gather_object(k3, k3_ops.slstm_seq.launches)
    rescaled = {"rescaled_step": None, "rescaled_loss": None}
    if args.rescale_mesh:
        new = mesh_mod.make_mesh(mesh_mod.parse_mesh(args.rescale_mesh))
        if new is not None:
            runner2 = TrainRunner.rescale(cfg, new, opt, run_cfg)
            state = runner2.restore_or_init(args.seed, step=args.rescale_step)
            step = int(state["step"])
            state, metrics = runner2.step_fn(state, batches(step))
            rescaled = {"rescaled_step": step, "rescaled_loss": float(metrics["loss"])}
            if new.rank == 0:
                print(f"elastic rescale {args.mesh} -> {args.rescale_mesh}: resumed at step "
                      f"{step}, loss there {rescaled['rescaled_loss']:.6f}")
            del state, runner2
        rescaled["k2_rescale"] = _k2_counts(ops)
    peaks = [None] * dist.get_world_size()  # each rank's peak device memory (GB)
    cuda = mesh is not None and mesh.device.type == "cuda"
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(mesh.device) / 1e9
                           if cuda else None)
    if rank == 0:
        seconds["rescale_done"] = time.perf_counter() - t0
        out.update(rescaled, k2_launches=[n for n, _ in k2], k2_shapes=[s for _, s in k2],
                   k3_launches=k3, rank0_seconds=seconds)
        if cuda:
            out.update(peak_mem_gb=peaks[0], peak_mem_gb_ranks=peaks)
    return out


def _k2_counts(ops) -> list:
    """Every rank's K2 launches and their distinct shapes since the last
    call (a collective over the world), the counts then set to 0."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (ops.flash_attention.launches, sorted(ops.launch_shapes)))
    ops.flash_attention.launches = 0
    ops.launch_shapes.clear()
    return got


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    out = run(args)
    sharded = "step_times" in out
    times = out["step_times"] if sharded else out["runner"].step_times
    line = (f"{out['cfg'].name}, {out['cfg'].n_layers} layers, {args.batch} x {args.seq} "
            f"positions: step {statistics.median(times[1:] or times) * 1e3:.1f} ms (median "
            f"of the {len(times) - 1} steps run after the first; first {times[0] * 1e3:.1f} ms)")
    device = resolve_device(args.device)
    if sharded:
        line += f" on mesh {out['mesh']}, transport {out['transport']} (rank 0's clock)"
        if "peak_mem_gb" in out:
            line += f"; rank 0's peak device memory {out['peak_mem_gb']:.2f} GB"
    elif device.type == "cuda":
        import torch

        line += f"; peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"
    print(line)
    keys = ("losses", "faults", "ckpt_dir", "ckpt_steps", "rescaled_step")
    if sharded:
        keys += ("mesh", "transport", "world", "rescaled_loss", "k2_launches", "k2_shapes",
                 "k3_launches")
    result = {k: out[k] for k in keys}
    if args.json:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
