"""Online streaming dictionary service launcher.

Port of src/repro/launch/serve_dict.py: streams synthetic samples through
the continuously-learning dictionary service (repro_torch.runtime.service)
with micro-batched coding against a double-buffered snapshot, online
`fit_batch` on the live copy, one optional mid-stream elastic growth of the
model level (`--grow-at`, `--grow-model`; at sample 300 by default) and one
optional mid-stream agent drain (`--drain-at`, `--drain`: the ranks leave,
survivors keep their atoms).  `--mesh` names the agents: '1xN' is N agents
of a flat mode, '2x1x8' the 2 pods of 8 agents of a hier mode, and a chain
takes one leading dim per outer level, outermost first ('2x2x1x4' for
three levels).  Without `--transport` one process on one device holds
every agent, so the data extent D of `--mesh` must be 1.  With
`--transport` (gloo on the CPU; nccl, a card a rank; gloo_staged, ranks
sharing a card; auto) `runtime/mesh.launch` spawns one rank per mesh
coordinate: one agent per (outer levels, model) coordinate, as the JAX
engine's devices, the samples split over D.  Mesh rank 0 runs the service
and prints; every other rank follows its engine calls
(`runtime.service.follow`).  On a mesh the growth drill is off by default
and growth, drain and the fleet are refused (ROADMAP section 1, items 8
and 9).  The dictionary has `--atoms-per-agent` atoms per agent.  At the
repository's production dictionary (M = 8192, K = 262144, 16 agents, the
paper's diffusion):

  PYTHONPATH=src python -m repro_torch.launch.serve_dict \\
      --mode graph --m 8192 --atoms-per-agent 16384 --mesh 1x16 --samples 64 \\
      --grow-at 0

A three-level chain (q8 pod ring every 2nd iteration, a stale q8 ring
every 4th) that grows by one model rank per group at sample 32 and drains
rank 0 at sample 48:

  PYTHONPATH=src python -m repro_torch.launch.serve_dict \\
      --mode chain --mesh 2x2x1x4 --levels torus,ring_metropolis:2:q8,ring:4:q8:stale \\
      --samples 64 --grow-at 32 --grow-model 1 --drain-at 48 --drain 0

`--replicas N` (or `--router`) switches to the serving plane
(repro_torch.runtime.serving): N services on the one card, each on its own
CUDA stream, behind the freshness-aware Router; `--publish-at` fans one
perturbed dictionary out to them, one replica at a time, mid-stream.
Replicas serve a published snapshot, so fleet mode implies --no-learn and
disables the grow/drain drills, as in the JAX CLI.

Four ranks, one agent each, on the card(s) (gloo_staged where they share
one):

  PYTHONPATH=src python -m repro_torch.launch.serve_dict \\
      --mode graph --m 8192 --atoms-per-agent 16384 --mesh 1x4 --samples 64 \\
      --transport auto

`--device cpu` runs on the CPU (the default is the card, and no card is an
error).  Prints throughput (samples/s), per-sample latency percentiles,
learner progress and the grow and drain events; `--json` adds one `BENCH`
line with the JAX CLI's keys (single service or fleet).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.conjugates import make_task
from repro_torch.core.dictionary import blocks_from_full, init_dictionary
from repro_torch.core.distributed import (
    HIER_MODES, MESH_GROWTH_ITEM, MODES, DistConfig, DistributedSparseCoder,
)
from repro_torch.core.topology import DIRECTED_KINDS, GRAPH_KINDS
from repro_torch.data.synthetic import sparse_stream
from repro_torch.device import resolve_device
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.service import MESH_FLEET_ITEM, DictionaryService, ServiceConfig, follow
from repro_torch.runtime.serving import (
    ReplicaSet, Router, RouterConfig, device_pools, replica_bytes,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", type=str, default="sparse_svd")
    ap.add_argument("--gamma", type=float, default=0.25)
    ap.add_argument("--delta", type=float, default=0.05)
    ap.add_argument("--mode", type=str, default="exact_fista", choices=list(MODES))
    ap.add_argument("--topology", type=str, default="ring_metropolis",
                    choices=list(GRAPH_KINDS + DIRECTED_KINDS),
                    help="graph-mode combiner kind (core/topology.make_topology); the "
                         "intra-pod kind for the hier modes; the directed kinds "
                         "(dicycle, distar) are for the push modes")
    ap.add_argument("--pod-topology", type=str, default="", choices=[""] + list(GRAPH_KINDS),
                    help="hier modes: inter-pod combiner kind (required for hier/hier_q8)")
    ap.add_argument("--pod-gossip-every", type=int, default=1,
                    help="hier modes: fire the inter-pod hop every k-th iteration")
    ap.add_argument("--levels", type=str, default="",
                    help="chain mode: comma-separated level specs "
                         "'kind[:stride][:wire][:stale]', innermost (model) level first "
                         "(core/topology.parse_level_specs)")
    ap.add_argument("--topology-p", type=float, default=0.5, help="erdos edge probability")
    ap.add_argument("--topology-seed", type=int, default=0,
                    help="erdos graph / time-varying sequence seed")
    ap.add_argument("--topology-schedule", type=str,
                    default="alternating:ring_metropolis,torus",
                    help="graph_tv modes: core/topology.make_topology_schedule spec "
                         "('fixed:<kind>' | 'alternating:<k1>,<k2>,...' | 'erdos_resampled')")
    ap.add_argument("--schedule-period", type=int, default=2,
                    help="period of the erdos_resampled schedule")
    ap.add_argument("--fail-p", type=float, default=0.0,
                    help="graph_tv modes: per-step per-edge link-failure probability "
                         "(core/topology.link_failure_schedule)")
    ap.add_argument("--fail-seed", type=int, default=0, help="seed of the failure draws")
    ap.add_argument("--fail-steps", type=int, default=0,
                    help="distinct failure realizations before the trace repeats "
                         "(0 = the base schedule's period)")
    ap.add_argument("--iters", type=int, default=150, help="dual iterations per solve")
    ap.add_argument("--m", type=int, default=32, help="data dimension")
    ap.add_argument("--atoms-per-agent", type=int, default=8)
    ap.add_argument("--mesh", type=str, default="1x2",
                    help="'DxM' (flat modes), 'PxDxM' (hier modes) or one leading dim "
                         "per outer chain level, outermost first; D must be 1 "
                         "without --transport")
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--micro-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--mu-w", type=float, default=0.1)
    ap.add_argument("--grow-at", type=int, default=300,
                    help="sample index of the elastic growth event (0 = never; off "
                         "on a mesh unless given, and then refused)")
    ap.add_argument("--grow-model", type=int, default=2,
                    help="extra model-axis agents added at --grow-at")
    ap.add_argument("--drain-at", type=int, default=0,
                    help="sample index of the agent-drain event (0 = never)")
    ap.add_argument("--drain", type=str, default="",
                    help="comma-separated model ranks decommissioned at "
                         "--drain-at (survivors keep their atom shards)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="submit rate in samples/s (0 = as fast as possible)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica count for the multi-replica serving plane "
                         "(each replica a service on its own CUDA stream of the "
                         "one card; >1 implies --router)")
    ap.add_argument("--router", action="store_true",
                    help="front the fleet with the freshness-aware Router "
                         "even for --replicas 1 (measures the router's own "
                         "overhead against the single-service baseline)")
    ap.add_argument("--publish-at", type=int, default=0,
                    help="fleet mode: sample index of one rolling snapshot "
                         "publish (a perturbed dictionary fans out to the "
                         "replicas one at a time; 0 = never)")
    ap.add_argument("--no-learn", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--transport", type=str, default=None,
                    choices=list(mesh_mod.TRANSPORTS) + ["auto"],
                    help="run on a mesh of ranks, one agent each, samples over D "
                         "(runtime/mesh.launch); without it one process holds every agent")
    ap.add_argument("--json", action="store_true",
                    help="emit a single BENCH json line at the end")
    args = ap.parse_args(argv)
    given = sys.argv[1:] if argv is None else list(argv)
    if args.transport is not None and not any(a.split("=")[0] == "--grow-at" for a in given):
        args.grow_at = 0  # the default drill is off on a mesh (growth there: refused)
    return args


_PERTURB_CHUNK = 1 << 26  # values per draw of `perturbed`


def perturbed(W0: np.ndarray, seed: int, nonneg: bool) -> np.ndarray:
    """The JAX CLI's rolling-publish dictionary: W0 + 0.01 N(0, 1) from
    numpy's `default_rng(seed)` (float64 draws cast to float32), clipped at
    0 for a nonneg task, each column projected onto the unit ball.  Drawn
    a few rows at a time (the same values as one draw) to bound host
    memory at the production width."""
    rng = np.random.default_rng(seed)
    W1 = np.empty_like(W0)
    rows = max(1, _PERTURB_CHUNK // W0.shape[1])
    for r in range(0, W0.shape[0], rows):
        part = W0[r:r + rows]
        W1[r:r + rows] = part + 0.01 * rng.standard_normal(part.shape).astype(np.float32)
    if nonneg:
        np.maximum(W1, 0.0, out=W1)
    W1 /= np.maximum(1.0, np.linalg.norm(W1, axis=0, keepdims=True))
    return W1


def host_full(W_blocks: torch.Tensor) -> np.ndarray:
    """Host (M, N * Kb) copy of (N, M, Kb) blocks, one block at a time (no
    full-size temporary on the device)."""
    n, m, kb = W_blocks.shape
    out = np.empty((m, n * kb), np.float32)
    for i in range(n):
        out[:, i * kb:(i + 1) * kb] = W_blocks[i].cpu().numpy()
    return out


def _setup(args: argparse.Namespace) -> Dict:
    """Check the arguments and build what every process (every rank of a
    mesh) needs: the mesh dims, the agents per level, the configs and the
    task."""
    dims = [int(v) for v in args.mesh.split("x")]
    # Agent levels the mesh carries: the --levels spec's for chain, 2 for
    # the hier modes, 1 for the flat ones (as the JAX CLI).
    if args.mode == "chain":
        if not args.levels:
            raise SystemExit("--mode chain needs a --levels spec "
                             "(e.g. 'ring_metropolis,ring_metropolis:2:q8,full:4:q8')")
        n_agent_levels = len([v for v in args.levels.split(",") if v.strip()])
    else:
        n_agent_levels = 2 if args.mode in HIER_MODES else 1
    if len(dims) != n_agent_levels + 1:
        want = ("'DxM'" if n_agent_levels == 1 else "'PxDxM'" if n_agent_levels == 2
                else f"{n_agent_levels + 1} dims (one per outer level, outermost first, "
                     f"then data x model)")
        raise SystemExit(f"--mode {args.mode} needs a --mesh of {want}, got {args.mesh!r}")
    *outer_dims, d, m_axis = dims
    on_mesh = args.transport is not None
    if d != 1 and not on_mesh:
        raise SystemExit(f"--mesh {args.mesh!r}: one process holds every agent, so the "
                         f"data extent D must be 1; D > 1 needs --transport (a mesh of "
                         f"ranks, the samples split over D)")
    if args.grow_at >= args.samples:
        args.grow_at = 0  # growth point past the stream: never fires
    drain_ranks = [int(v) for v in args.drain.split(",") if v.strip()]
    if args.drain_at >= args.samples:
        args.drain_at = 0  # drain point past the stream: never fires
    if bool(args.drain_at) != bool(drain_ranks):
        raise SystemExit("--drain-at and --drain must be given together")
    if args.drain_at and args.grow_at and args.drain_at <= args.grow_at:
        raise SystemExit("--drain-at must come after --grow-at (the drain "
                         "ranks refer to the then-current model axis)")
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    fleet_mode = args.replicas > 1 or args.router
    if on_mesh and fleet_mode:
        raise SystemExit(f"--replicas / --router on a mesh: {MESH_FLEET_ITEM}")
    if on_mesh and (args.grow_at or args.drain_at):
        raise SystemExit(f"--grow-at / --drain-at on a mesh: {MESH_GROWTH_ITEM}")
    if fleet_mode:
        # Replicas serve a published snapshot (new dictionaries arrive by
        # the rolling publish, not per-replica learning), and the grow/drain
        # drills are single-service lifecycle drills.
        if args.grow_at or args.drain_at:
            print("fleet mode: disabling the grow/drain drills "
                  "(single-service lifecycle drills; see tests/test_torch_serving.py "
                  "for the fleet lifecycle)")
            args.grow_at, args.drain_at, drain_ranks = 0, 0, []
        if not args.no_learn:
            print("fleet mode: replicas serve the published snapshot "
                  "(learning off; snapshots arrive via publish fan-out)")
            args.no_learn = True
        if args.publish_at >= args.samples:
            args.publish_at = 0  # publish point past the stream: never fires
    level_sizes = (m_axis, *reversed(outer_dims))  # innermost first
    n_agents = math.prod(level_sizes)
    try:
        dist_cfg = DistConfig(
            mode=args.mode, iters=args.iters, topology=args.topology,
            topology_p=args.topology_p, topology_seed=args.topology_seed,
            topology_schedule=args.topology_schedule,
            schedule_period=args.schedule_period,
            failure_p=args.fail_p, failure_seed=args.fail_seed,
            failure_steps=args.fail_steps,
            pod_topology=args.pod_topology, pod_gossip_every=args.pod_gossip_every,
            levels=args.levels,
        )
    except (KeyError, ValueError) as e:
        raise SystemExit(f"serve_dict: {e}")
    res, reg = make_task(args.task, gamma=args.gamma, delta=args.delta)
    svc_cfg = ServiceConfig(
        micro_batch=args.micro_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        learn=not args.no_learn,
        mu_w=args.mu_w,
    )
    # the mesh's axes, outermost first: one per outer level, data, model
    axes = tuple(dist_cfg.level_axis(i) for i in reversed(range(1, n_agent_levels))) + (
        "data", dist_cfg.level_axis(0))
    return {"dims": dims, "axes": axes, "n_agents": n_agents, "drain_ranks": drain_ranks,
            "agents": level_sizes if dist_cfg.chain_levels() else n_agents,
            "dist_cfg": dist_cfg, "res": res, "reg": reg, "svc_cfg": svc_cfg,
            "k0": args.atoms_per_agent * n_agents, "fleet_mode": fleet_mode}


def _print_coder(args, coder, device, k0) -> None:
    comb = coder.combiner_info()
    print(f"serve_dict: task={args.task} mode={args.mode} mesh={args.mesh} "
          f"device={device} M={args.m} K={k0} micro_batch={args.micro_batch} "
          f"samples={args.samples} grow_at={args.grow_at or 'never'} "
          f"topology={comb['topology']} mixing_rate={comb['mixing_rate']:.3f} "
          f"schedule_period={comb['schedule_period']} "
          f"pod_gossip_every={comb['pod_gossip_every']}")
    for lv in comb["levels"]:
        print(f"  level axis={lv['axis']} kind={lv['kind']} n={lv['n']} "
              f"stride={lv['gossip_every']} wire={lv['wire']} stale={lv['stale']}")


def run(args: argparse.Namespace) -> Dict:
    """Serve args.samples samples.  Returns {"payload": the BENCH dict,
    "results": [(nu, y), ...], "X": the stream, and "service" (the stopped
    service; its final snapshot and coder stay readable) with "swap_s"
    ({"grow": s, "drain": s}, None where no swap ran), or in fleet mode
    "fleet" (the stopped ReplicaSet) with "router" (its final stats) and
    "publish_s" ({"draw_wait": s, "install": s}: the wait at --publish-at
    for the host's draw of the new dictionary, then the rolling install;
    None without a publish)}.  On a mesh (`--transport`) rank 0's result
    of `_serve_ranks` instead."""
    st = _setup(args)
    if args.transport is not None:
        return mesh_mod.launch(_serve_ranks, st["dims"], axes=st["axes"],
                               transport=args.transport, device=args.device, args=(args,),
                               kernels=("dict_dual_step",))
    device = resolve_device(args.device)
    res, reg, k0, n_agents = st["res"], st["reg"], st["k0"], st["n_agents"]
    pools = None
    if st["fleet_mode"]:  # before W0 exists, so the check sees the card's free memory
        pools = device_pools(args.replicas, replica_bytes(
            n_agents, args.m, args.atoms_per_agent, learn=False), device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    W0 = blocks_from_full(
        init_dictionary(gen, args.m, k0, nonneg=reg.nonneg, device=device), n_agents
    )
    X = sparse_stream(args.samples, m=args.m, k_true=k0, nonneg=reg.nonneg,
                      seed=args.seed + 1)
    if st["fleet_mode"]:
        return _run_fleet(args, res, reg, st["dist_cfg"], st["svc_cfg"], st["agents"], device,
                          pools, W0, X)
    coder = DistributedSparseCoder(st["agents"], res, reg, st["dist_cfg"], device=device)
    _print_coder(args, coder, device, k0)
    return _serve(args, coder, W0, X, st["svc_cfg"], st["drain_ranks"])


def _serve_ranks(mesh, args: argparse.Namespace) -> Optional[Dict]:
    """Every rank of a `--transport` run: the coder on `mesh` (one agent a
    rank), W0 drawn as one process draws it (every rank the same draw, on
    its device) and cut to this rank's block.  Mesh rank 0 runs the service
    over the stream and returns `run`'s dict with the fit steps it made
    ("fit_log": (padded batch, mu_w, t0) each), the final live dictionary
    gathered whole ("dictionary", host (M, K)), and per rank the K1
    launches and engine calls; the other ranks follow and return None."""
    from repro_torch.kernels.dict_dual_step import ops
    from repro_torch.runtime import service

    st = _setup(args)
    res, reg, k0 = st["res"], st["reg"], st["k0"]
    coder = DistributedSparseCoder(st["agents"], res, reg, st["dist_cfg"], device=mesh.device,
                                   mesh=mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    W0 = coder.snapshot(init_dictionary(gen, args.m, k0, nonneg=reg.nonneg, device=mesh.device))
    launches0, calls0 = ops.dict_dual_step.launches, service._engine.calls
    if mesh.rank == 0:
        X = sparse_stream(args.samples, m=args.m, k_true=k0, nonneg=reg.nonneg,
                          seed=args.seed + 1)
        _print_coder(args, coder, f"{mesh.device} x {mesh.world} ranks ({mesh.transport})", k0)
        out = _serve(args, coder, W0, X, st["svc_cfg"], [], record_fits=True)
        live = out["service"].live()
        out["fit_log"] = out["service"].fit_log
        del out["service"]
    else:
        live = follow(coder, W0)
    del W0
    counts = mesh.all_gather_object((ops.dict_dual_step.launches - launches0,
                                     service._engine.calls - calls0))
    full = coder.gather(live)
    if mesh.rank != 0:
        return None
    out["dictionary"] = full.cpu().numpy()
    out["k1_launches"] = [c[0] for c in counts]
    out["engine_calls"] = [c[1] for c in counts]
    out["mesh"], out["transport"] = mesh.describe(), mesh.transport
    return out


def _serve(args, coder, W0, X, svc_cfg, drain_ranks, record_fits: bool = False) -> Dict:
    """The single service over the stream X (rank 0's part on a mesh)."""
    svc = DictionaryService(coder, W0, svc_cfg, record_fits=record_fits)
    del W0  # the service holds the only reference: no second copy
    futures: List[Future] = []
    grow_fut = drain_fut = None
    # seconds from each swap's request to its resolved Future
    swap_s: Dict[str, Optional[float]] = {"grow": None, "drain": None}

    def timed(name: str, fut: Future) -> Future:
        t = time.perf_counter()
        fut.add_done_callback(lambda f: swap_s.__setitem__(name, time.perf_counter() - t))
        return fut

    t0 = time.perf_counter()
    with svc:
        for i in range(args.samples):
            if args.grow_at and i == args.grow_at:
                # let the pre-growth stream drain so the event lands truly
                # mid-stream (coding goes on against the old snapshot until
                # the new coder and snapshot are published)
                futures[-1].result(timeout=3600)
                grow_fut = timed("grow", svc.grow(args.grow_model,
                                                  torch.Generator().manual_seed(args.seed + 2)))
            if args.drain_at and i == args.drain_at:
                # the same for the decommission: a learner-thread swap
                futures[-1].result(timeout=3600)
                drain_fut = timed("drain", svc.drain(drain_ranks))
            if grow_fut is not None and i == args.samples - args.micro_batch:
                # overlap growth with the stream, but make sure the final
                # micro-batch is coded by the grown network
                grow_fut.result(timeout=3600)
            futures.append(svc.submit(X[i]))
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
        results: List = [f.result(timeout=3600) for f in futures]
        if grow_fut is not None:
            print(f"growth applied: {grow_fut.result(timeout=3600)}")
        if drain_fut is not None:
            print(f"drain applied: {drain_fut.result(timeout=3600)}")
    wall_s = time.perf_counter() - t0
    # Read once the service has stopped: the learner has then fitted every
    # batch the stream gave it.  Read before the stop, fit_steps and
    # published count only the fits that had finished when the last code
    # came back, which depends on how busy the host is.
    stats = svc.stats()

    # For the l2-residual tasks nu* IS the fit residual (paper Eq. 53).
    pre = np.mean([np.linalg.norm(nu) for nu, _ in results[: args.micro_batch]])
    post = np.mean([np.linalg.norm(nu) for nu, _ in results[-args.micro_batch:]])
    k_dims = sorted({r[1].shape[0] for r in results})
    if len(results) != args.samples:
        raise RuntimeError(f"dropped samples: {len(results)} of {args.samples}")

    lat = stats.get("latency_ms", {})
    print(f"coded {stats['coded']}/{args.samples} samples in {wall_s:.2f}s "
          f"({stats['coded'] / wall_s:.1f} samples/s)")
    print(f"latency ms: p50 {lat.get('p50', float('nan')):.1f}  "
          f"p95 {lat.get('p95', float('nan')):.1f}  "
          f"p99 {lat.get('p99', float('nan')):.1f}")
    print(f"fit_steps {stats['fit_steps']}  published {stats['published']}  "
          f"grow_events {len(stats['grow_events'])}  "
          f"drain_events {len(stats['drain_events'])}  y dims seen {k_dims}")
    print(f"mean ||nu||: first batch {pre:.4f} -> last batch {post:.4f}")

    payload = {
        "samples": args.samples,
        "replicas": 1,
        "topology": stats["topology"],
        "mixing_rate": stats["mixing_rate"],
        "schedule": stats.get("schedule"),
        "schedule_period": stats.get("schedule_period", 1),
        "active_schedule": stats.get("active_schedule", 0),
        "pod_topology": stats.get("pod_topology"),
        "pod_gossip_every": stats.get("pod_gossip_every", 1),
        "levels": stats.get("levels"),
        "wall_s": wall_s,
        "samples_per_s": stats["coded"] / wall_s,
        "agg_samples_per_s": stats["coded"] / wall_s,
        "p99_ms": lat.get("p99"),
        "latency_ms": lat,
        "fit_steps": stats["fit_steps"],
        "published": stats["published"],
        "grow_events": stats["grow_events"],
        "drain_events": stats["drain_events"],
        "y_dims": k_dims,
        "residual_first": float(pre),
        "residual_last": float(post),
    }
    if args.json:
        print("BENCH " + json.dumps(payload))
    return {"payload": payload, "results": results, "X": X, "service": svc, "swap_s": swap_s}


def _run_fleet(args, res, reg, dist_cfg, svc_cfg, agents, device, pools, W0, X) -> Dict:
    """Fleet mode: args.replicas services on the card, each on its own
    stream (`pools`), behind the Router, with one optional rolling publish.
    The replicas share W0 (never written: no learning in fleet mode)."""
    coders = [DistributedSparseCoder(agents, res, reg, dist_cfg, device=device)
              for _ in pools]
    comb = coders[0].combiner_info()
    n, m, kb = W0.shape
    print(f"serve_dict[fleet]: task={args.task} mode={args.mode} "
          f"replicas={args.replicas} mesh={args.mesh}/replica device={device} "
          f"M={m} K={n * kb} micro_batch={args.micro_batch} "
          f"samples={args.samples} publish_at={args.publish_at or 'never'} "
          f"topology={comb['topology']} mixing_rate={comb['mixing_rate']:.3f}")

    services = [DictionaryService(c, W0, svc_cfg, stream=p.stream)
                for c, p in zip(coders, pools)]
    # The publish's dictionary depends only on W0 and the seed: drawn on a
    # host thread while the first samples are coded (at the production
    # width the draw takes the host tens of seconds).
    drawer = ThreadPoolExecutor(1)
    W1 = drawer.submit(perturbed, host_full(W0), args.seed + 3, reg.nonneg) \
        if args.publish_at else None
    drawer.shutdown(wait=False)
    del W0
    router_cfg = RouterConfig(
        micro_batch=args.micro_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        seed=args.seed,
    )
    futures = []
    published: Dict[str, int] = {}
    publish_s = None
    t0 = time.perf_counter()
    with ReplicaSet(services) as fleet:
        with Router(fleet, router_cfg) as router:
            for i in range(args.samples):
                if args.publish_at and i == args.publish_at:
                    # rolling publish truly mid-stream: let the pre-publish
                    # tail land, then fan a perturbed dictionary out replica
                    # by replica while the stream keeps flowing
                    futures[-1].result(timeout=3600)
                    t_pub = time.perf_counter()
                    W1 = W1.result()
                    t_drawn = time.perf_counter()
                    published = fleet.publish(W1)
                    W1 = None
                    publish_s = {"draw_wait": t_drawn - t_pub,
                                 "install": time.perf_counter() - t_drawn}
                futures.append(router.submit(X[i]))
                if args.rate > 0:
                    time.sleep(1.0 / args.rate)
            results = [f.result(timeout=3600) for f in futures]
            rstats = router.stats()
        fstats = fleet.stats()
    wall_s = time.perf_counter() - t0

    if len(results) != args.samples:
        raise RuntimeError(f"dropped samples: {len(results)} of {args.samples}")
    lat = rstats.get("latency_ms", {})
    agg = args.samples / wall_s
    per_rep = {
        name: {
            "coded": st["coded"],
            "snapshot_version": st["snapshot_version"],
            "serving_version": st["serving_version"],
            "samples_per_s": st["samples_per_s"],
        }
        for name, st in fstats["replicas"].items()
    }
    print(f"coded {args.samples} samples in {wall_s:.2f}s "
          f"({agg:.1f} samples/s aggregate over {args.replicas} replica(s))")
    print(f"latency ms: p50 {lat.get('p50', float('nan')):.1f}  "
          f"p95 {lat.get('p95', float('nan')):.1f}  "
          f"p99 {lat.get('p99', float('nan')):.1f}")
    print(f"routed {rstats['routed']}  rerouted {rstats['rerouted']}  "
          f"failed {rstats['failed']}  publishes {fstats['publishes']} "
          f"{published}")

    payload = {
        "samples": args.samples,
        "replicas": args.replicas,
        "topology": comb["topology"],
        "mixing_rate": comb["mixing_rate"],
        "wall_s": wall_s,
        "agg_samples_per_s": agg,
        "samples_per_s": agg,
        "p99_ms": lat.get("p99"),
        "latency_ms": lat,
        "routed": rstats["routed"],
        "rerouted": rstats["rerouted"],
        "failed": rstats["failed"],
        "publishes": fstats["publishes"],
        "publish_versions": published,
        "per_replica": per_rep,
    }
    if args.json:
        print("BENCH " + json.dumps(payload))
    return {"payload": payload, "results": results, "X": X, "fleet": fleet,
            "router": rstats, "publish_s": publish_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))["payload"]


if __name__ == "__main__":
    main()
