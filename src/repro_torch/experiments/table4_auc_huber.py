"""Paper Table IV: novel-document detection with the HUBER residual (the
projected dual iteration onto ||nu||_inf <= 1).  Torch twin of
benchmarks/table4_auc_huber.py: the Table III protocol run with the Huber
task (paper Alg. 4) and with the l2 task, side by side; the same caveat
(statistical, not bit-for-bit, agreement with the JAX script) holds.
The paper's claim: Huber >= l2 under heavy-tailed/corrupted data, and
distributed ~= fully connected."""

from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, main, save_json
from repro_torch.experiments.table3_auc import run as run_l2


def run(device: str = "cuda"):
    dev = resolve_device(device)
    huber = run_l2(task="nmf_huber", bench_name="table4_huber", device=dev)
    l2 = run_l2(task="nmf", bench_name="table4_l2ref", device=dev)
    summary = {}
    for variant in ("diffusion_fc", "diffusion_dist"):
        h_mean = float(np.mean(list(huber[variant].values())))
        l_mean = float(np.mean(list(l2[variant].values())))
        summary[variant] = {"huber": h_mean, "l2": l_mean}
        emit(f"table4/{variant}/huber_mean_auc", f"{h_mean:.3f}",
             "paper: Huber competitive-or-better")
        emit(f"table4/{variant}/l2_mean_auc", f"{l_mean:.3f}")
    # distributed ~ fully-connected (paper: within ~0.01)
    gap = abs(summary["diffusion_fc"]["huber"] - summary["diffusion_dist"]["huber"])
    emit("table4/fc_vs_dist_gap", f"{gap:.3f}", "paper: ~0.01")
    save_json("table4_auc_huber", summary)
    return summary


if __name__ == "__main__":
    main(run)
