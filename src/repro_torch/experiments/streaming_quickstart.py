"""Streaming quickstart: the online dictionary service end to end.  Torch
twin of examples/streaming_quickstart.py, at its sizes.

Each sample is presented to the network once (the paper's single-pass
streaming regime): submitted to the service, micro-batched, coded against
the published dictionary snapshot, and used for one online learning step on
the live copy.  Mid-stream the network grows: two agents join the model
level with fresh atoms (paper Sec. IV-C), and coding goes on against the
snapshot throughout.  The stream is the JAX script's (the same numpy
generator); the initial and the fresh atoms come from torch generators.

  PYTHONPATH=src python -m repro_torch.experiments.streaming_quickstart
  PYTHONPATH=src python -m repro_torch.experiments.streaming_quickstart --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.conjugates import make_task
from repro_torch.core.dictionary import init_dictionary
from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
from repro_torch.data.synthetic import sparse_stream
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json
from repro_torch.runtime.service import DictionaryService, ServiceConfig


def run(m: int = 32, atoms_per_agent: int = 8, n_samples: int = 256, grow_at: int = 128,
        device: str = "cuda"):
    dev = resolve_device(device)
    res, reg = make_task("sparse_svd", gamma=0.25, delta=0.05)
    k0 = atoms_per_agent * 2
    W0 = init_dictionary(torch.Generator(device=dev).manual_seed(0), m, k0, device=dev)
    coder = DistributedSparseCoder(2, res, reg, DistConfig(mode="exact_fista", iters=100),
                                   device=dev)
    X = sparse_stream(n_samples, m=m, k_true=k0, seed=1)

    print(f"streaming {n_samples} samples through a {m}x{k0} dictionary "
          f"on 2 agents; growing to 4 agents at sample {grow_at}")
    futures, grow_fut = [], None
    with DictionaryService(coder, W0, ServiceConfig(micro_batch=16, mu_w=0.1)) as svc:
        for i in range(n_samples):
            if i == grow_at:
                grow_fut = svc.grow(2, torch.Generator().manual_seed(2))
            futures.append(svc.submit(X[i]))
        results = [f.result(timeout=300) for f in futures]
        growth = grow_fut.result(timeout=300)
        print("growth:", growth)
        stats = svc.stats()

    # nu* is the fit residual for l2 tasks (Eq. 53): watch it shrink online.
    res_norms = np.asarray([np.linalg.norm(nu) for nu, _ in results])
    k_dims = sorted({y.shape[0] for _, y in results})
    print(f"coded {stats['coded']} samples at {stats['samples_per_s']:.1f}/s; "
          f"fit_steps {stats['fit_steps']}, published {stats['published']}")
    print(f"y dims seen (pre/post growth): {k_dims}")
    print(f"mean residual ||nu||: first 32 {res_norms[:32].mean():.4f} "
          f"-> last 32 {res_norms[-32:].mean():.4f}")
    out = {"coded": stats["coded"], "fit_steps": stats["fit_steps"],
           "published": stats["published"], "growth": growth, "y_dims": k_dims,
           "residual_first32": float(res_norms[:32].mean()),
           "residual_last32": float(res_norms[-32:].mean())}
    save_json("streaming_quickstart", out)
    return out


if __name__ == "__main__":
    main(run)
