"""Graph-topology gossip: the paper's Sec.-IV-B regime on the production
engine, plus the time-varying regime of Daneshmand et al.  Torch twin of
examples/graph_gossip.py, at its sizes.

`DistConfig(mode="graph", topology=...)` runs diffusion under the
doubly-stochastic combiner of `core/topology.make_topology`, compiled once
into a gossip schedule (one shift per distinct edge offset along the agent
axis; the torus its 4-link schedule), every agent stepping with the
globally safe mu.  Denser graphs have a smaller mixing rate (the
second-largest singular value of A) and need fewer iterations for the same
SNR.  The second table runs `mode="graph_tv"`: the combiner changes every
iteration (an alternating ring/torus cycle, or a freshly resampled erdos
graph per step), and convergence tracks the windowed mixing rate
sigma_2(A_0...A_{P-1})^(1/P).

The 8 agents live on one device, as the leading axis of the coder's
tensors (the JAX script puts them on 8 mesh devices).  W and x are drawn
from numpy generators (seeds 1 and 2) where the JAX script uses jax.random
keys 1 and 2, so the SNRs match statistically, not bit for bit; the mixing
rates and message counts are the JAX engine's exactly.

  PYTHONPATH=src python -m repro_torch.experiments.graph_gossip
  PYTHONPATH=src python -m repro_torch.experiments.graph_gossip --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.conjugates import make_task
from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
from repro_torch.core.inference import fista_infer, snr_db
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json

TOPOLOGIES = ("full", "erdos", "torus", "ring_metropolis")
SCHEDULES = [
    ("static ring_metropolis", "fixed:ring_metropolis", 1),
    ("static torus", "fixed:torus", 1),
    ("alternating ring/torus", "alternating:ring_metropolis,torus", 2),
    ("erdos resampled (P=4)", "erdos_resampled", 4),
]


def problem(m: int, k: int, b: int, device):
    """The task, a unit-column W (m, k) and a batch x (b, m), from numpy
    generators 1 and 2, and the centralized reference nu (FISTA, 1500
    iterations)."""
    res, reg = make_task("sparse_svd", gamma=0.1, delta=0.1)
    W = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32)
    W = torch.as_tensor(W / np.linalg.norm(W, axis=0), device=device)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((b, m)).astype(np.float32),
                        device=device)
    return res, reg, W, x, fista_infer(res, reg, W, x, iters=1500)


def solve_snr(coder, W, x, nu_ref) -> float:
    Ws, xs = coder.shard(W, x)
    nu, _ = coder.solve(Ws, xs)
    return float(snr_db(nu_ref, nu))


@torch.no_grad()
def run(m: int = 32, k: int = 64, b: int = 8, iters_short: int = 400, iters_long: int = 1600,
        device: str = "cuda"):
    dev = resolve_device(device)
    res, reg, W, x, nu_ref = problem(m, k, b, dev)
    n = 8
    out = {"static": [], "time_varying": []}
    print(f"{'topology':<16} {'mixing_rate':>11} {'msgs/iter':>9} "
          f"{'snr@' + str(iters_short):>8} {'snr@' + str(iters_long):>9}")
    for topology in TOPOLOGIES:
        row, coder = [], None
        for iters in (iters_short, iters_long):
            coder = DistributedSparseCoder(
                n, res, reg, DistConfig(mode="graph", iters=iters, topology=topology), device=dev)
            row.append(solve_snr(coder, W, x, nu_ref))
        info = coder.combiner_info()
        msgs = coder.gossip_schedule.messages_per_iter
        out["static"].append({"topology": topology, "mixing_rate": info["mixing_rate"],
                              "messages_per_iter": msgs, "snr_db": row})
        print(f"{topology:<16} {info['mixing_rate']:>11.4f} {msgs:>9d} "
              f"{row[0]:>8.1f} {row[1]:>9.1f}")

    # -- time-varying schedules: the network changes every iteration --------
    print()
    print(f"{'schedule':<34} {'windowed_mix':>12} {'period':>6} "
          f"{'snr@' + str(iters_short):>8} {'snr@' + str(iters_long):>9}")
    for label, spec, period in SCHEDULES:
        row, coder = [], None
        for iters in (iters_short, iters_long):
            coder = DistributedSparseCoder(
                n, res, reg, DistConfig(mode="graph_tv", iters=iters, topology_schedule=spec,
                                        schedule_period=period), device=dev)
            row.append(solve_snr(coder, W, x, nu_ref))
        info = coder.combiner_info()
        out["time_varying"].append({"schedule": spec, "mixing_rate": info["mixing_rate"],
                                    "period": info["schedule_period"], "snr_db": row})
        print(f"{label:<34} {info['mixing_rate']:>12.4f} "
              f"{info['schedule_period']:>6d} {row[0]:>8.1f} {row[1]:>9.1f}")
    save_json("graph_gossip", out)
    return out


if __name__ == "__main__":
    main(run)
