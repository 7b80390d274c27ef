"""The torch twins of examples/ (repro_torch/experiments: quickstart,
denoise_image, novel_docs, graph_gossip, multi_pod, train_lm) on the CPU at
cut sizes, each through its command line, writing its JSON under
build/experiments/.  graph_gossip's and multi_pod's network columns (mixing
rates, messages per iteration, pod bytes, the chain's level tables) equal
the JAX engine's, computed by the JAX package's own topology and schedule
functions as its coder builds them (no multi-device mesh here); the SNR
columns depend on W and x, which the twins draw from numpy generators, so
only their ordering is checked.
"""

import json
import math

import numpy as np
import pytest

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _run(name, argv):
    import importlib

    from repro_torch.experiments import common

    mod = importlib.import_module(f"repro_torch.experiments.{name}")
    out = common.OUT / f"{name}.json"
    out.unlink(missing_ok=True)
    result = common.main(mod.run, argv + ["--device", "cpu"])
    assert json.loads(out.read_text()) is not None
    return result


def test_quickstart_twin():
    r = _run("quickstart", ["--n", "256", "--epochs", "2"])
    assert len(r["epochs"]) == 2 and 0.0 <= r["recovered"] <= 1.0
    assert r["epochs"][1]["primal"] < r["epochs"][0]["primal"]
    assert r["eq53_snr_db"] > 60  # nu is the residual (strong duality), as JAX's 111 dB


def test_denoise_image_twin():
    r = _run("denoise_image", ["--n-patches", "300", "--img-size", "24"])
    assert set(r) == {"noisy_psnr_db", "denoised_all_psnr_db", "denoised_one_psnr_db"}
    assert all(math.isfinite(v) for v in r.values())
    assert r["denoised_all_psnr_db"] > r["noisy_psnr_db"]


def test_novel_docs_twin():
    r = _run("novel_docs", ["--m-vocab", "40", "--n-steps", "2", "--docs-per-step", "40"])
    assert set(r) == {"nmf", "nmf_huber"}
    for rows in r.values():
        assert [row["k"] for row in rows] == [10, 20]  # +10 atoms a step
        assert all(np.isnan(row["auc"]) or 0.0 <= row["auc"] <= 1.0 for row in rows)


def test_train_lm_twin_learns():
    r = _run("train_lm", ["--steps", "150", "--batch", "8", "--seq", "64", "--n-layers", "1",
                          "--d-model", "128"])
    assert r["last10_loss"] < r["first_loss"] - 1.0
    assert r["ckpt_steps"] == [100, 150]


def _jax_static(topology, n=8):
    from repro.core import topology as T
    from repro.core.distributed import DistConfig
    from repro.runtime import dist as D

    beta, p, seed = DistConfig().beta, 0.5, 0
    if topology == "erdos":
        A = T.metropolis_weights(T.erdos_renyi_adjacency(n, p=p, seed=seed))
    else:
        A = T.make_topology(topology, n, p=p, seed=seed, beta=beta)
    sched = D.torus_schedule(*T.torus_dims(n), A) if topology == "torus" else D.graph_schedule(A)
    return T.mixing_rate(A), sched.messages_per_iter


def _jax_chain(cfg, ns):
    from repro.core import topology as T
    from repro.runtime import dist as D

    chain = T.make_kronecker_chain(cfg.chain_levels(), ns, p=cfg.topology_p,
                                   seed=cfg.topology_seed, beta=cfg.beta)
    axes = tuple(cfg.level_axis(i) for i in range(len(ns)))
    return chain, D.chain_schedule(chain, axes)


def test_graph_gossip_twin_tables_are_the_jax_engines():
    from repro.core import topology as T
    from repro.core.distributed import DistConfig

    r = _run("graph_gossip", ["--iters-short", "60", "--iters-long", "240"])
    for row in r["static"]:
        rate, msgs = _jax_static(row["topology"])
        assert row["mixing_rate"] == pytest.approx(rate, abs=1e-12)
        assert row["messages_per_iter"] == msgs
    from repro_torch.experiments.graph_gossip import SCHEDULES

    for row, (_, spec, period) in zip(r["time_varying"], SCHEDULES):
        ts = T.make_topology_schedule(spec, 8, p=0.5, seed=0, beta=DistConfig().beta,
                                      period=period)
        assert row["mixing_rate"] == pytest.approx(ts.windowed_mixing_rate(), abs=1e-12)
        assert row["period"] == ts.period
    snr = {row["topology"]: row["snr_db"] for row in r["static"]}
    assert snr["full"][1] > snr["ring_metropolis"][1]  # denser mixes faster


def test_multi_pod_twin_tables_are_the_jax_engines():
    from repro.core.distributed import DistConfig

    r = _run("multi_pod", ["--iters-short", "60", "--iters-long", "240"])
    flat, hier = r["flat_vs_hier"]
    assert flat["mixing_rate"] == pytest.approx(_jax_static("torus")[0], abs=1e-12)
    chain, _ = _jax_chain(DistConfig(mode="hier", topology="torus",
                                     pod_topology="ring_metropolis"), (4, 2))
    assert hier["mixing_rate"] == pytest.approx(chain.effective_mixing_rate(), abs=1e-12)
    from repro_torch.experiments.multi_pod import CHAINS, POD_KNOBS

    b, m = 8, 32
    for row, (_, mode, every) in zip(r["pod_link"], POD_KNOBS):
        cfg = DistConfig(mode=mode, topology="torus", pod_topology="ring_metropolis",
                         pod_gossip_every=every)
        chain, cs = _jax_chain(cfg, (4, 2))
        payload = b * (m + 4) if mode == "hier_q8" else b * m * 4
        assert row["mixing_rate"] == pytest.approx(chain.effective_mixing_rate(), abs=1e-12)
        assert row["pod_bytes_per_iter"] == cs.levels[1].sched.messages_per_iter / every * payload
    for row, (spec, _) in zip(r["chains"], CHAINS):
        cfg = DistConfig(mode="chain", levels=spec)
        chain, cs = _jax_chain(cfg, (2, 2, 2))
        assert row["mixing_rate"] == pytest.approx(chain.effective_mixing_rate(), abs=1e-12)
        want = [{"kind": s.kind, "axis": lvl.axis, "n": int(n), "gossip_every": s.gossip_every,
                 "wire": s.wire, "stale": s.stale}
                for s, n, lvl in zip(chain.specs, chain.ns, cs.levels)]
        assert row["level_table"] == want
