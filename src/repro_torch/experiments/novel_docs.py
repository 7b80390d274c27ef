"""Novel-document detection (paper Sec. IV-C, Algs. 3-4): stream document
blocks, grow the dictionary and the network each step, flag documents whose
dual objective is large; the l2 and Huber residuals.  Torch twin of
examples/novel_docs.py, at its sizes.

The documents are the JAX script's (the same numpy generator); the initial
atoms and those each step adds come from torch generators (the learner's
seed, then seed 100 + step, as the JAX script's keys), so the AUCs match
the JAX script's statistically, not bit for bit.

  PYTHONPATH=src python -m repro_torch.experiments.novel_docs
  PYTHONPATH=src python -m repro_torch.experiments.novel_docs --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.detection import auc, exact_score
from repro_torch.core.inference import exact_infer, fista_infer
from repro_torch.core.learner import DictionaryLearner, LearnerConfig
from repro_torch.data import synthetic as ds
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json


@torch.no_grad()
def run(m_vocab: int = 200, n_steps: int = 4, docs_per_step: int = 200, device: str = "cuda"):
    dev = resolve_device(device)
    ts = ds.topic_documents(m_vocab=m_vocab, n_topics=24, docs_per_step=docs_per_step,
                            n_steps=n_steps, topics_per_step=3, seed=0)
    out = {}
    for task in ("nmf", "nmf_huber"):
        print(f"\n== residual = {'squared-l2' if task == 'nmf' else 'Huber'} ==")
        cfg = LearnerConfig(
            m=m_vocab, k=10, n_agents=10, task=task, gamma=0.05, delta=0.1, eta=0.2,
            mu=-1.0, inference_iters=300, engine="fista", mu_w=0.3, seed=0,
        )
        learner = DictionaryLearner(cfg, device=dev)
        state = learner.init_state()
        state, _ = learner.fit(state, torch.as_tensor(ts.docs[0], device=dev), batch_size=8)
        rows = []
        for s in range(1, n_steps + 1):
            h = torch.as_tensor(ts.docs[s], device=dev)
            labels = np.isin(ts.labels[s], list(ts.novel_steps[s]))
            infer = exact_infer if task == "nmf_huber" else fista_infer
            W = learner.dictionary(state)
            nu = infer(learner.res, learner.reg, W, h, iters=400)
            scores = exact_score(learner.res, learner.reg, W, nu, h).cpu().numpy()
            a = auc(scores, labels) if labels.sum() else float("nan")
            rows.append({"step": s, "novel": int(labels.sum()), "auc": a, "k": learner.cfg.k})
            print(f"time-step {s}: {int(labels.sum()):3d} novel docs, AUC {a:.3f}; "
                  f"dictionary {learner.cfg.k} atoms -> +10")
            # the paper's protocol: absorb the block, grow by 10 atoms/agents
            gen = torch.Generator(device=dev).manual_seed(100 + s)
            learner, state = learner.expanded(state, 10, gen)
            state, _ = learner.fit(state, h, batch_size=8)
        out[task] = rows
    save_json("novel_docs", out)
    return out


if __name__ == "__main__":
    main(run)
