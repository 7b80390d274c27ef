"""Quickstart: learn a distributed dictionary on synthetic sparse data with
the paper's Algorithm 1 and check the dual inference against the
centralized solver.  Torch twin of examples/quickstart.py, at its sizes.

The planted stream is the JAX script's (the same numpy generator); the
initial dictionary comes from a torch generator (the learner's seed), so
the numbers match the JAX script's statistically, not bit for bit.

  PYTHONPATH=src python -m repro_torch.experiments.quickstart
  PYTHONPATH=src python -m repro_torch.experiments.quickstart --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inference import fista_infer, recover_y, snr_db
from repro_torch.core.learner import DictionaryLearner, LearnerConfig
from repro_torch.data.synthetic import sparse_stream
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json


@torch.no_grad()
def run(m: int = 24, k_true: int = 32, n: int = 2048, k: int = 48, n_agents: int = 16,
        epochs: int = 10, device: str = "cuda"):
    dev = resolve_device(device)
    # -- planted sparse data (the shared x = W0 y + noise model) -------------
    X_np, W0 = sparse_stream(n, m=m, k_true=k_true, seed=0, return_dictionary=True)
    X = torch.as_tensor(X_np, device=dev)

    # -- the paper's Algorithm 1: 16 agents, 3 atoms each -------------------
    cfg = LearnerConfig(
        m=m, k=k, n_agents=n_agents, task="sparse_svd", gamma=0.25, delta=0.05,
        mu=-1.0,              # curvature-adaptive safe step
        inference_iters=200,
        engine="fista",       # accelerated dual engine
        topology="erdos", mu_w=0.5, seed=0,
    )
    learner = DictionaryLearner(cfg, device=dev)
    state = learner.init_state()

    print(f"dictionary {m}x{cfg.k} over {cfg.n_agents} agents "
          f"({cfg.atoms_per_agent} atoms each)")
    epochs_out = []
    for epoch in range(epochs):
        state, metrics = learner.fit(state, X, batch_size=32)
        row = {"primal": float(metrics.primal_obj), "residual": float(metrics.residual_norm),
               "sparsity": float(metrics.sparsity)}
        epochs_out.append(row)
        print(f"epoch {epoch}: primal {row['primal']:.4f} residual {row['residual']:.4f} "
              f"sparsity {row['sparsity']:.2f}")

    # -- recovery quality -----------------------------------------------------
    W = learner.dictionary(state).cpu().numpy()
    cos = np.abs(W0.T @ W)
    recovered = float((cos.max(axis=1) > 0.9).mean())
    print(f"planted atoms recovered (|cos|>0.9): {recovered:.0%}")

    # -- dual inference == centralized primal solve (strong duality) ---------
    x = X[:4]
    Wd = learner.dictionary(state)
    nu = fista_infer(learner.res, learner.reg, Wd, x, iters=400)
    y = recover_y(learner.reg, Wd, nu)
    resid = x - y @ Wd.T
    snr = float(snr_db(resid, nu))
    print(f"Eq. 53 check  nu == residual:  SNR {snr:.1f} dB")
    out = {"epochs": epochs_out, "recovered": recovered, "eq53_snr_db": snr}
    save_json("quickstart", out)
    return out


if __name__ == "__main__":
    main(run)
