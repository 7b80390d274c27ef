"""Paper Fig. 4: SNR of the dual variable nu and primal coefficients y vs
diffusion iteration, against the centralized optimum (the step-size tuning
methodology of Sec. IV-A).  Torch twin of benchmarks/fig4_convergence.py.

The dictionary and the sample come from torch generators, so the curve
matches the JAX script's statistically, not bit for bit.

Emits `fig4/<...>` CSV rows and build/experiments/fig4_convergence.json.
"""

from __future__ import annotations

import torch

from repro_torch.core import topology as topo
from repro_torch.core.conjugates import make_task
from repro_torch.core.dictionary import blocks_from_full, init_dictionary
from repro_torch.core.inference import (
    DiffusionConfig,
    diffusion_infer,
    fista_infer,
    recover_y,
    safe_diffusion_mu,
    snr_db,
)
from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, main, save_json


@torch.no_grad()
def run(n_agents: int = 16, m: int = 64, record_every: int = 10000, iters: int = 200000,
        device: str = "cuda"):
    """Runs the convergence curve for BOTH residuals (see the JAX script for
    the Huber plateau of nu)."""
    dev = resolve_device(device)
    out = {}
    for task in ("nmf", "nmf_huber"):
        res, reg = make_task(task, gamma=0.05, delta=0.1, eta=0.2)
        gen = torch.Generator(device=dev).manual_seed(0)
        W = init_dictionary(gen, m, n_agents, nonneg=True, device=dev)  # 1 atom/agent (paper)
        Wb = blocks_from_full(W, n_agents)
        x = torch.randn((m,), generator=gen, device=dev).abs()
        x = x / torch.linalg.vector_norm(x)

        A = torch.as_tensor(topo.make_topology("erdos", n_agents, p=0.5, seed=0),
                            dtype=torch.float32, device=dev)
        mu = 0.01 * safe_diffusion_mu(res, reg, Wb)

        # centralized reference (CVX stand-in): accelerated dual ascent
        nu_ref = fista_infer(res, reg, W, x, iters=5000)
        y_ref = recover_y(reg, W, nu_ref)

        _, _, traj = diffusion_infer(
            res, reg, Wb, x, A, torch.ones((n_agents,), device=dev),
            DiffusionConfig(iters=iters), record_every=record_every, mu=mu,
        )
        rows = []
        for i in range(traj.shape[0]):
            nu_i = traj[i][0]  # agent 0's estimate
            y_i = recover_y(reg, W, nu_i)
            rows.append({
                "iteration": (i + 1) * record_every,
                "snr_nu_db": float(snr_db(nu_ref, nu_i)),
                "snr_y_db": float(snr_db(y_ref, y_i)),
            })
        out[task] = rows
        label = "l2" if task == "nmf" else "huber"
        for r in rows[:: max(len(rows) // 5, 1)]:
            emit(f"fig4/{label}/iter{r['iteration']}/snr_nu_db", f"{r['snr_nu_db']:.2f}")
            emit(f"fig4/{label}/iter{r['iteration']}/snr_y_db", f"{r['snr_y_db']:.2f}")
        emit(f"fig4/{label}/final_snr_nu_db", f"{rows[-1]['snr_nu_db']:.2f}",
             "paper band 40-50 (l2 reaches it; huber boundary plateau)")
        emit(f"fig4/{label}/final_snr_y_db", f"{rows[-1]['snr_y_db']:.2f}",
             "paper: y leads nu")
    save_json("fig4_convergence", out)
    return out


if __name__ == "__main__":
    main(run)
