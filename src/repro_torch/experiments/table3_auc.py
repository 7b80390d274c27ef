"""Paper Table III: novel-document detection AUC per time step with the
square-Euclidean residual: centralized [6] vs diffusion (fully connected)
vs diffusion (distributed, Erdos-Renyi p=0.5).  Torch twin of
benchmarks/table3_auc.py.  The synthetic topic stream stands in for TDT2.

The dictionary grows by `atoms_per_step` after every step, matching the
paper's +10-atoms/step protocol.  The documents are the JAX script's (the
same numpy generator); the initial and added atoms come from torch
generators, so the AUCs match the JAX script's statistically, not bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import MairalConfig, MairalLearner
from repro_torch.core.detection import auc, exact_score
from repro_torch.core.inference import fista_infer
from repro_torch.core.learner import DictionaryLearner, LearnerConfig
from repro_torch.data import synthetic as ds
from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, main, save_json


@torch.no_grad()
def _score_dict(res, reg, W, h):
    nu = fista_infer(res, reg, W, h, iters=400)
    return exact_score(res, reg, W, nu, h).cpu().numpy()


def run(task: str = "nmf", n_steps: int = 5, m_vocab: int = 200, k0: int = 10,
        atoms_per_step: int = 10, eta: float = 0.2, gamma: float = 0.05,
        bench_name: str = "table3", device: str = "cuda"):
    dev = resolve_device(device)
    ts = ds.topic_documents(m_vocab=m_vocab, n_topics=24, docs_per_step=200,
                            n_steps=n_steps, topics_per_step=3, seed=0)
    docs = torch.as_tensor(ts.docs, device=dev)

    def fresh_learner(topology: str) -> DictionaryLearner:
        return DictionaryLearner(LearnerConfig(
            m=m_vocab, k=k0, n_agents=k0, task=task, gamma=gamma, delta=0.1,
            eta=eta, mu=-1.0, inference_iters=300,
            engine="diffusion" if topology != "centralized" else "fista",
            topology="full" if topology == "fc" else "erdos",
            mu_w=0.3, seed=0,
        ), device=dev)

    variants = {}
    # -- diffusion variants (fully connected + sparse random graph) --------
    for name, topology in (("diffusion_fc", "fc"), ("diffusion_dist", "dist")):
        learner = fresh_learner(topology)
        state = learner.init_state()
        state, _ = learner.fit(state, docs[0], batch_size=8)
        aucs = {}
        for s in range(1, n_steps + 1):
            labels = np.isin(ts.labels[s], list(ts.novel_steps[s]))
            if labels.sum():
                scores = _score_dict(learner.res, learner.reg, learner.dictionary(state), docs[s])
                aucs[s] = auc(scores, labels)
            learner, state = learner.expanded(
                state, extra_agents=atoms_per_step,
                generator=torch.Generator(device=dev).manual_seed(100 + s),
            )
            state, _ = learner.fit(state, docs[s], batch_size=8)
        variants[name] = aucs

    # -- centralized baseline [6] ------------------------------------------
    ref = fresh_learner("centralized")
    central = MairalLearner(
        MairalConfig(m=m_vocab, k=k0, gamma=gamma, delta=0.1, nonneg=True, seed=0), ref.reg,
        device=dev,
    )
    mst = central.init_state()
    mst, _ = central.fit(mst, docs[0], batch_size=8)
    aucs = {}
    for s in range(1, n_steps + 1):
        labels = np.isin(ts.labels[s], list(ts.novel_steps[s]))
        if labels.sum():
            scores = _score_dict(ref.res, ref.reg, mst.W, docs[s])
            aucs[s] = auc(scores, labels)
        # grow the centralized dictionary identically
        k_new = mst.W.shape[1] + atoms_per_step
        central = MairalLearner(
            MairalConfig(m=m_vocab, k=k_new, gamma=gamma, delta=0.1, nonneg=True,
                         seed=s), ref.reg, device=dev,
        )
        fresh = central.init_state()
        fresh.W[:, : mst.W.shape[1]] = mst.W
        mst, _ = central.fit(fresh, docs[s], batch_size=8)
    variants["centralized"] = aucs

    for name, aucs in variants.items():
        for s, a in aucs.items():
            emit(f"{bench_name}/step{s}/{name}_auc", f"{a:.3f}")
        emit(f"{bench_name}/mean/{name}_auc", f"{np.mean(list(aucs.values())):.3f}",
             "paper: diffusion >= centralized after warm-up")
    save_json(f"{bench_name}_auc", {k: {str(s): v for s, v in a.items()} for k, a in variants.items()})
    return variants


if __name__ == "__main__":
    main(run)
