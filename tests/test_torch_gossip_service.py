"""Port checks: the service's schedule clock and the gossip configuration.

The streaming service threads a schedule offset t0 through every solve and
fit of a time-varying coder (src/repro/runtime/service.py:341-373): each
execution claims the next `iters` iterations, the offset passed is taken
modulo the coder's schedule period, and a fit that raises gives its window
back.  Static coders always get 0.  Also: every cross-field refusal of the
JAX `DistConfig` (src/repro/core/distributed.py:293-370) is a refusal of
the port's too, and `convert` carries a chain configuration across.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_common import rand, unit_cols

M, KB = 16, 4


def _service(agents, cfg, learn, **svc):
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.service import DictionaryService, ServiceConfig

    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    coder = DistributedSparseCoder(agents, res, reg, DistConfig(**cfg), device="cpu")
    W0 = unit_cols(rand(np.random.default_rng(0), M, coder.n_agents * KB))
    return coder, DictionaryService(coder, W0, ServiceConfig(
        micro_batch=4, max_wait_s=0.002, learn=learn, mu_w=0.1, **svc))


def _record_solves(coder, calls):
    """Wrap coder.solve to append each call's t0."""
    real = coder.solve

    def solve(W, x, t0=0):
        calls.append(t0)
        return real(W, x, t0)

    coder.solve = solve


@pytest.mark.parametrize("agents,cfg,period", [
    (4, dict(mode="graph_tv", iters=5, topology_schedule="erdos_resampled",
             schedule_period=3), 3),
    (4, dict(mode="graph_tv_q8", iters=4, failure_p=0.25, failure_steps=6), 6),
    ((2, 2), dict(mode="hier", iters=3, pod_topology="ring_metropolis", pod_gossip_every=2), 2),
    (4, dict(mode="graph", iters=5), 1),
])
def test_successive_solves_advance_the_schedule_clock(agents, cfg, period):
    coder, svc = _service(agents, cfg, learn=False)
    assert coder.schedule_period == period and coder.is_time_varying == (period > 1)
    calls = []
    _record_solves(coder, calls)
    X = rand(np.random.default_rng(1), 5, M)
    with svc:
        stats0 = svc.stats()
        for x in X:  # one micro-batch per sample: wait for each
            svc.submit(x).result(timeout=60)
        stats = svc.stats()
    iters = cfg["iters"]
    assert calls[0] == 0  # the warmup claims nothing
    if period > 1:
        assert calls[1:] == [i * iters % period for i in range(len(X))]
        assert svc._sched_t == len(X) * iters
    else:
        assert calls[1:] == [0] * len(X) and svc._sched_t == 0
    assert stats0["active_schedule"] == 0 and stats0["schedule_period"] == period
    assert stats["active_schedule"] == len(X) * iters % period
    assert stats["schedule_period"] == period


def test_a_fit_that_raises_gives_its_window_back():
    coder, svc = _service(4, dict(mode="graph_tv", iters=5), learn=True)
    solves, fits = [], []
    _record_solves(coder, solves)
    real_fit = coder.fit_batch

    def failing_fit(W, x, mu_w, t0=0):
        fits.append(t0)
        if mu_w > 0:  # the warmup's fit (mu_w = 0) runs
            raise RuntimeError("planted fit failure")
        return real_fit(W, x, mu_w, t0)

    coder.fit_batch = failing_fit
    with svc:  # stop() lets the learner try every batch it was given
        for x in rand(np.random.default_rng(2), 3, M):
            svc.submit(x).result(timeout=60)
    stats = svc.stats()
    assert stats["fit_failures"] == 3 and stats["fit_steps"] == 0
    assert "planted fit failure" in stats["fit_first_error"]
    # the warmup's solve and fit (t0 = 0) claim nothing; each coding solve
    # claimed its window and each failed fit gave its own back
    assert len(solves) == len(fits) == 4 and solves[0] == fits[0] == 0
    assert svc._sched_t == 3 * 5 and stats["active_schedule"] == 3 * 5 % 2


def test_the_clock_counts_every_execution_under_contention():
    """Batcher and learner claim windows concurrently: with a tiny switch
    interval and a stream of small batches, the clock still ends at iters
    per execution (a lost update would leave it short)."""
    import sys

    coder, svc = _service(4, dict(mode="graph_tv", iters=2, topology_schedule="erdos_resampled",
                                  schedule_period=3), learn=True, learn_queue_cap=0)
    solves, fits = [], []
    _record_solves(coder, solves)
    real_fit = coder.fit_batch

    def fit(W, x, mu_w, t0=0):
        fits.append(t0)
        return real_fit(W, x, mu_w, t0)

    coder.fit_batch = fit
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with svc:
            futs = svc.submit_many(rand(np.random.default_rng(3), 60, M))
            for f in futs:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    stats = svc.stats()
    assert stats["coded"] == 60 and stats["fit_failures"] == 0
    executions = len(solves) + len(fits) - 2  # less the warmup's solve and fit
    assert stats["fit_steps"] == len(fits) - 1 >= 1
    assert svc._sched_t == 2 * executions
    assert all(0 <= t < 3 for t in solves + fits)


@pytest.mark.parametrize("bad", [
    dict(mode="graph_tv", topology_schedule=None),
    dict(mode="graph_tv_q8", topology_schedule=None),
    dict(mode="hier"),
    dict(mode="hier_q8", pod_topology=""),
    dict(mode="chain"),
    dict(mode="chain", levels=""),
    dict(mode="graph", levels="ring,ring"),
    dict(mode="hier", pod_topology="ring", levels="ring,ring"),
    dict(mode="hier", pod_topology="ring", pod_gossip_every=0),
    dict(mode="graph_tv", failure_p=1.0),
    dict(mode="graph_tv", failure_p=-0.1),
    dict(mode="graph", failure_p=0.25),
    dict(mode="push", failure_p=0.25),
    dict(mode="graph_tv", failure_steps=-1),
    dict(mode="chain", levels="ring:q9"),
    dict(mode="chain", levels="ring:0"),
])
def test_every_jax_config_refusal_is_a_port_refusal(bad):
    from repro.core.distributed import DistConfig as JaxDistConfig
    from repro_torch.core.distributed import DistConfig

    with pytest.raises(ValueError):
        JaxDistConfig(**bad)
    with pytest.raises(ValueError):
        DistConfig(**bad)


def test_config_levels_and_convert_match_jax():
    from repro.core.distributed import DistConfig as JaxDistConfig
    from repro_torch import convert
    from repro_torch.core.distributed import DistConfig

    spec = "torus,ring_metropolis:2:q8,ring:4:q8:stale"
    for fields in (dict(mode="chain", levels=spec, topology_seed=3),
                   dict(mode="hier_q8", topology="torus", pod_topology="erdos",
                        pod_gossip_every=3, informed="one"),
                   dict(mode="graph_tv_q8", topology_schedule="erdos_resampled",
                        schedule_period=4, failure_p=0.1, failure_seed=2, failure_steps=8),
                   dict(mode="push_q8", topology="distar")):
        jcfg = JaxDistConfig(**fields)
        got = convert.dist_config_from_jax_fields(**dataclasses.asdict(jcfg))
        assert got == DistConfig(**fields)
        assert [vars(s) for s in got.chain_levels()] == [vars(s) for s in jcfg.chain_levels()]
        assert [got.level_axis(i) for i in range(len(got.chain_levels()))] == \
            [jcfg.level_axis(i) for i in range(len(jcfg.chain_levels()))]
        assert convert.dist_config_from_jax_fields(
            **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}) == got
    with pytest.raises(ValueError):  # a directed combiner outside the push modes
        DistConfig(mode="graph_tv", topology="dicycle")
