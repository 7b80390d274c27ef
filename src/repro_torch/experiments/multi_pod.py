"""Hierarchical (multi-pod) gossip: graph-of-graphs diffusion over two
pods.  Torch twin of examples/multi_pod.py, at its sizes.

`DistConfig(mode="hier", topology=..., pod_topology=...)` composes one
combiner per level into the Kronecker two-level combiner A_pod (x) A_model:
the intra-pod schedule over the model level and the inter-pod schedule
over the pod level, back to back, every agent stepping with the globally
safe mu.  Two knobs relieve the slow inter-pod link (second table):
`pod_gossip_every = k` fires the pod hop every k-th iteration, and
`mode="hier_q8"` ships the inter-pod messages on the int8 wire.  The third
table generalizes both to an N-level Kronecker chain (`mode="chain"`): a
3-level chip (x) pod (x) rack network, each level with its own combiner,
stride and wire.

The agents live on one device, as the leading axis of the coder's tensors;
the hierarchical coders take their agents per level INNERMOST first, so
the JAX script's `debug_mesh(model=4, data=1, pods=2)` is (4, 2) here and
its chain mesh `debug_mesh(model=2, data=1, pods=2, outer=(2,))` is
(2, 2, 2).  W and x are drawn from numpy generators (seeds 1 and 2) where
the JAX script uses jax.random keys 1 and 2, so the SNRs match
statistically, not bit for bit; the mixing rates, pod bytes and level
tables are the JAX engine's exactly.

  PYTHONPATH=src python -m repro_torch.experiments.multi_pod
  PYTHONPATH=src python -m repro_torch.experiments.multi_pod --device cpu
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json
from repro_torch.experiments.graph_gossip import problem, solve_snr

FLAT_AND_HIER = [
    ("flat graph:torus (1 pod of 8)", 8, DistConfig(mode="graph", iters=1, topology="torus")),
    ("hier torus+ring_metropolis", (4, 2),
     DistConfig(mode="hier", iters=1, topology="torus", pod_topology="ring_metropolis")),
]
POD_KNOBS = [
    ("hier, pod hop every iter", "hier", 1),
    ("hier, pod_gossip_every=2", "hier", 2),
    ("hier, pod_gossip_every=4", "hier", 4),
    ("hier_q8, pod_gossip_every=2", "hier_q8", 2),
]
CHAINS = [
    ("ring_metropolis,ring_metropolis,full", "all hops every iter, fp32"),
    ("ring_metropolis,ring_metropolis:2:q8,full:4:q8", "q8 outer hops, strides 1/2/4"),
]


@torch.no_grad()
def run(m: int = 32, k: int = 64, b: int = 8, iters_short: int = 400, iters_long: int = 1600,
        device: str = "cuda"):
    dev = resolve_device(device)
    res, reg, W, x, nu_ref = problem(m, k, b, dev)
    out = {"flat_vs_hier": [], "pod_link": [], "chains": []}

    # -- flat vs hierarchical on the same 8-agent network -------------------
    print(f"{'network':<30} {'mixing_rate':>11} {'snr@' + str(iters_short):>8} "
          f"{'snr@' + str(iters_long):>9}")
    for label, agents, cfg in FLAT_AND_HIER:
        snrs, coder = [], None
        for iters in (iters_short, iters_long):
            coder = DistributedSparseCoder(agents, res, reg, dataclasses.replace(cfg, iters=iters),
                                           device=dev)
            snrs.append(solve_snr(coder, W, x, nu_ref))
        rate = coder.combiner_info()["mixing_rate"]
        out["flat_vs_hier"].append({"network": label, "mixing_rate": rate, "snr_db": snrs})
        print(f"{label:<30} {rate:>11.4f} {snrs[0]:>8.1f} {snrs[1]:>9.1f}")

    # -- relieving the slow inter-pod link ----------------------------------
    print()
    print(f"{'configuration':<30} {'eff_mix':>8} {'pod B/iter':>10} "
          f"{'snr@' + str(iters_short):>8} {'snr@' + str(iters_long):>9}")
    for label, mode, every in POD_KNOBS:
        snrs, coder = [], None
        for iters in (iters_short, iters_long):
            coder = DistributedSparseCoder(
                (4, 2), res, reg,
                DistConfig(mode=mode, iters=iters, topology="torus",
                           pod_topology="ring_metropolis", pod_gossip_every=every), device=dev)
            snrs.append(solve_snr(coder, W, x, nu_ref))
        rate = coder.combiner_info()["mixing_rate"]
        payload = b * (m * 1 + 4) if mode == "hier_q8" else b * m * 4
        pod_bytes = coder.hier_gossip_schedule.pod_messages_per_iter * payload
        out["pod_link"].append({"configuration": label, "mixing_rate": rate,
                                "pod_bytes_per_iter": pod_bytes, "snr_db": snrs})
        print(f"{label:<30} {rate:>8.4f} {pod_bytes:>10.0f} {snrs[0]:>8.1f} {snrs[1]:>9.1f}")

    # -- N-level chains: levels as data -------------------------------------
    # Same 8 agents, three levels deep: 2 chips/pod x 2 pods/rack x 2 racks;
    # each level of the spec carries kind[:stride][:wire], innermost first.
    print()
    print(f"{'3-level chain':<42} {'eff_mix':>8} {'snr@' + str(iters_long):>9}")
    for spec, label in CHAINS:
        coder = DistributedSparseCoder((2, 2, 2), res, reg,
                                       DistConfig(mode="chain", iters=iters_long, levels=spec),
                                       device=dev)
        snr = solve_snr(coder, W, x, nu_ref)
        info = coder.combiner_info()
        out["chains"].append({"levels": spec, "mixing_rate": info["mixing_rate"],
                              "snr_db": snr, "level_table": info["levels"]})
        print(f"{label:<42} {info['mixing_rate']:>8.4f} {snr:>9.1f}")
        for lv in info["levels"]:
            print(f"  level {lv['axis']:<6} kind={lv['kind']:<16} "
                  f"n={lv['n']} stride={lv['gossip_every']} wire={lv['wire']}")
    save_json("multi_pod", out)
    return out


if __name__ == "__main__":
    main(run)
