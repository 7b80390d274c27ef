"""Online streaming dictionary service launcher, on one card.

Port of the single-service path of src/repro/launch/serve_dict.py: streams
synthetic samples through the continuously-learning dictionary service
(repro_torch.runtime.service) with micro-batched coding against a
double-buffered snapshot and online `fit_batch` on the live copy.  `--mesh
1xN` means N agents on the one device; the dictionary has
`--atoms-per-agent * N` atoms.  At the repository's production dictionary
(M = 8192, K = 262144, 16 agents, the paper's diffusion):

  PYTHONPATH=src python -m repro_torch.launch.serve_dict \\
      --mode graph --m 8192 --atoms-per-agent 16384 --mesh 1x16 --samples 64

`--device cpu` runs on the CPU (the default is the card, and no card is an
error).  The grow/drain drills and fleet mode (`--replicas`, `--router`) are
not ported yet and are refused with the ROADMAP slice that ports them.

Prints throughput (samples/s), per-sample latency percentiles and learner
progress; `--json` adds one `BENCH` line with the JAX CLI's single-service
keys.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.conjugates import make_task
from repro_torch.core.dictionary import blocks_from_full, init_dictionary
from repro_torch.core.distributed import MODES, DistConfig, DistributedSparseCoder
from repro_torch.core.topology import GRAPH_KINDS
from repro_torch.data.synthetic import sparse_stream
from repro_torch.device import resolve_device
from repro_torch.runtime.service import DictionaryService, ServiceConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", type=str, default="sparse_svd")
    ap.add_argument("--gamma", type=float, default=0.25)
    ap.add_argument("--delta", type=float, default=0.05)
    ap.add_argument("--mode", type=str, default="exact_fista", choices=list(MODES))
    ap.add_argument("--topology", type=str, default="ring_metropolis", choices=list(GRAPH_KINDS),
                    help="graph-mode combiner kind (core/topology.make_topology)")
    ap.add_argument("--topology-p", type=float, default=0.5, help="erdos edge probability")
    ap.add_argument("--topology-seed", type=int, default=0, help="erdos graph seed")
    ap.add_argument("--iters", type=int, default=150, help="dual iterations per solve")
    ap.add_argument("--m", type=int, default=32, help="data dimension")
    ap.add_argument("--atoms-per-agent", type=int, default=8)
    ap.add_argument("--mesh", type=str, default="1x2",
                    help="'1xN': N agents on the one device")
    ap.add_argument("--samples", type=int, default=600)
    ap.add_argument("--micro-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--mu-w", type=float, default=0.1)
    ap.add_argument("--grow-at", type=int, default=0,
                    help="elastic growth point (not ported yet: only 0 = never)")
    ap.add_argument("--drain-at", type=int, default=0,
                    help="agent-drain point (not ported yet: only 0 = never)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="multi-replica serving plane (not ported yet: only 1)")
    ap.add_argument("--router", action="store_true",
                    help="front the service with the router (not ported yet)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="submit rate in samples/s (0 = as fast as possible)")
    ap.add_argument("--no-learn", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", action="store_true",
                    help="emit a single BENCH json line at the end")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict:
    """Serve args.samples samples; returns {"payload": the BENCH dict,
    "results": [(nu, y), ...], "X": the stream, "service": the stopped
    service (its final snapshot and coder stay readable)}."""
    if args.grow_at or args.drain_at:
        raise SystemExit("the grow/drain drills are not ported yet (ROADMAP "
                         "slice 6d, growth and drain); run with --grow-at 0 --drain-at 0")
    if args.replicas != 1 or args.router:
        raise SystemExit("fleet mode (--replicas, --router) is not ported yet "
                         "(ROADMAP section 1, the serving plane)")
    dims = [int(v) for v in args.mesh.split("x")]
    if len(dims) != 2:
        raise SystemExit(f"--mesh must be '1xN' for the flat modes, got {args.mesh!r}")
    d, n_agents = dims
    if d != 1:
        raise SystemExit(f"--mesh {args.mesh!r}: one device holds every agent, so the "
                         f"data extent D must be 1 (use '1x{n_agents}')")
    device = resolve_device(args.device)
    try:
        dist_cfg = DistConfig(
            mode=args.mode, iters=args.iters, topology=args.topology,
            topology_p=args.topology_p, topology_seed=args.topology_seed,
        )
    except NotImplementedError as e:
        raise SystemExit(str(e))

    res, reg = make_task(args.task, gamma=args.gamma, delta=args.delta)
    k0 = args.atoms_per_agent * n_agents
    gen = torch.Generator(device=device).manual_seed(args.seed)
    W0 = blocks_from_full(
        init_dictionary(gen, args.m, k0, nonneg=reg.nonneg, device=device), n_agents
    )
    svc_cfg = ServiceConfig(
        micro_batch=args.micro_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        learn=not args.no_learn,
        mu_w=args.mu_w,
    )
    X = sparse_stream(args.samples, m=args.m, k_true=k0, nonneg=reg.nonneg,
                      seed=args.seed + 1)
    coder = DistributedSparseCoder(n_agents, res, reg, dist_cfg, device=device)
    comb = coder.combiner_info()
    print(f"serve_dict: task={args.task} mode={args.mode} mesh={args.mesh} "
          f"device={device} M={args.m} K={k0} micro_batch={args.micro_batch} "
          f"samples={args.samples} topology={comb['topology']} "
          f"mixing_rate={comb['mixing_rate']:.3f}")

    svc = DictionaryService(coder, W0, svc_cfg)
    del W0  # the service holds the only reference: no second copy
    t0 = time.perf_counter()
    with svc:
        futures = []
        for i in range(args.samples):
            futures.append(svc.submit(X[i]))
            if args.rate > 0:
                time.sleep(1.0 / args.rate)
        results: List = [f.result(timeout=3600) for f in futures]
    stats = svc.stats()
    wall_s = time.perf_counter() - t0

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
          f"y dims seen {k_dims}")
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
    return {"payload": payload, "results": results, "X": X, "service": svc}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))["payload"]


if __name__ == "__main__":
    main()
