"""Port checks: the streaming service's swaps (runtime/service.py).

The port's twin of tests/test_service.py's lifecycle drill, in process on
the CPU: for every MODE_REGISTRY family, stream -> grow -> stream -> drain
-> stream, every sample finite with its era's K, the grow and drain events'
bookkeeping, and the schedule clock of a time-varying coder carried across
both swaps (iters per execution, never reset).  Also the serving plane's
hooks against the JAX service: `install_snapshot` (the version bump, the
shape refusal, the "coder changed during install" refusal), `load()`'s
keys (read off the JAX source by AST), `kill` (every pending Future fails,
stop() after kill() is a no-op), and a grow that lands while a batch is in
flight (the batch codes with the coder of its own snapshot).
"""

import ast
import pathlib
import threading
import time

import numpy as np
import pytest

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = pathlib.Path(__file__).resolve().parents[1]
M, K0 = 16, 16

# family -> (agents per level, DistConfig fields, grow count, drain ranks):
# each family's most constrained representative, as the JAX drill's.
_FAMILY_LIFECYCLE = {
    "exact": (2, dict(mode="exact", iters=60), 2, [1, 2]),
    "ring": (2, dict(mode="ring", iters=120), 2, [1, 2]),
    "graph": (2, dict(mode="graph", topology="ring_metropolis", iters=120), 2, [1, 2]),
    "tv": (2, dict(mode="graph_tv", iters=30, topology_seed=5,
                   topology_schedule="alternating:ring_metropolis,full",
                   failure_p=0.25, failure_seed=11, failure_steps=6), 2, [1, 2]),
    "push": (2, dict(mode="push", topology="distar", iters=120), 2, [1, 2]),
    "chain": ((2, 2), dict(mode="hier", iters=25, topology="ring_metropolis",
                           pod_topology="ring_metropolis", pod_gossip_every=2,
                           topology_seed=5), 1, [1]),
}


def _task():
    from repro_torch.core.conjugates import make_task

    return make_task("sparse_svd", gamma=0.25, delta=0.05)


def _w0(n_atoms=K0, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((M, n_atoms)).astype(np.float32)
    return W / np.linalg.norm(W, axis=0)


def _service(agents, cfg, **svc):
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.service import DictionaryService, ServiceConfig

    coder = DistributedSparseCoder(agents, *_task(), DistConfig(**cfg), device="cpu")
    kw = dict(micro_batch=8, mu_w=0.1)
    kw.update(svc)
    return coder, DictionaryService(coder, _w0(), ServiceConfig(**kw))


def test_lifecycle_params_cover_every_registry_family():
    from repro.core.distributed import MODE_REGISTRY as JAX_REGISTRY
    from repro_torch.core.distributed import MODE_REGISTRY

    families = {caps.family for caps in MODE_REGISTRY.values()}
    assert families == {caps.family for caps in JAX_REGISTRY.values()}
    assert set(_FAMILY_LIFECYCLE) == families


@pytest.mark.parametrize("family", sorted(_FAMILY_LIFECYCLE))
def test_service_lifecycle_grow_then_drain(family, monkeypatch):
    import torch

    from repro_torch.core.distributed import DistributedSparseCoder
    from repro_torch.data.synthetic import sparse_stream

    agents, cfg, grow_n, drain_ranks = _FAMILY_LIFECYCLE[family]
    # every execution's claimed offset, with the coder's period at the time
    claims = []
    for name in ("solve", "fit_batch"):
        real = getattr(DistributedSparseCoder, name)

        def wrapped(self, W, x, *rest, _real=real, _fit=name == "fit_batch"):
            t0 = rest[1 if _fit else 0] if len(rest) > (1 if _fit else 0) else None
            if t0 is not None:
                claims.append((t0, self.schedule_period, self.is_time_varying))
            return _real(self, W, x, *rest)

        monkeypatch.setattr(DistributedSparseCoder, name, wrapped)
    coder, svc = _service(agents, cfg)
    X = sparse_stream(72, m=M, k_true=K0, seed=3)
    with svc:
        pre = [f.result(timeout=120) for f in svc.submit_many(X[:24])]
        info_g = svc.grow(grow_n, torch.Generator().manual_seed(4)).result(timeout=120)
        mid = [f.result(timeout=120) for f in svc.submit_many(X[24:48])]
        info_d = svc.drain(drain_ranks).result(timeout=120)
        post = [f.result(timeout=120) for f in svc.submit_many(X[48:])]
    stats = svc.stats()

    # every sample of every era resolved, finite, with that era's K
    assert len(pre) == len(mid) == len(post) == 24
    assert all(np.isfinite(nu).all() and np.isfinite(y).all() for nu, y in pre + mid + post)
    assert all(y.shape == (K0,) for _, y in pre)
    assert all(y.shape == (info_g["k_new"],) for _, y in mid)
    assert all(y.shape == (info_d["k_new"],) for _, y in post)

    # grow/drain bookkeeping is consistent and K tracks the model level
    assert info_g["model_new"] == info_g["model_old"] + grow_n
    assert info_d["model_old"] == info_g["model_new"]
    assert info_d["model_new"] == info_g["model_new"] - len(drain_ranks)
    assert info_d["departed"] == sorted(drain_ranks)
    assert info_g["k_new"] == K0 * info_g["model_new"] // info_g["model_old"]
    assert info_d["k_new"] < info_g["k_new"]
    assert list(info_g) == ["at_coded", "k_old", "k_new", "model_old", "model_new", "topology",
                            "mixing_rate", "schedule", "schedule_period", "pod_topology",
                            "pod_gossip_every", "levels"]
    assert list(info_d)[:3] == ["at_coded", "departed", "k_old"] and "sched_t" in info_d
    assert stats["grow_events"] == [info_g] and stats["drain_events"] == [info_d]
    assert stats["coded"] == stats["submitted"] == 72
    assert stats["fit_failures"] == 0, stats["fit_first_error"]
    assert stats["published"] == stats["snapshot_version"] == stats["fit_steps"] + 2
    W_pub = svc.dictionary()
    assert W_pub.shape == (M, info_d["k_new"]) and np.isfinite(W_pub).all()

    # the schedule clock of a time-varying coder threads both swaps: each
    # execution claims iters from where the last one ended (reduced mod the
    # period of the coder that runs it); static families sit at 0
    if coder.is_time_varying:
        assert info_d["sched_t"] > 0 and svc._sched_t >= info_d["sched_t"]
        clock = 0
        for t0, period, tv in claims:
            assert tv and t0 == clock % period
            clock += cfg["iters"]
        assert svc._sched_t == clock == cfg["iters"] * len(claims)
    else:
        assert info_d["sched_t"] == 0 and svc._sched_t == 0
        assert all(t0 == 0 for t0, _, _ in claims)


def test_install_snapshot_bumps_the_version_and_refuses_what_it_must():
    coder, svc = _service(4, dict(mode="graph", iters=20), learn=False)
    W1 = _w0(seed=5)
    with pytest.raises(RuntimeError):
        svc.install_snapshot(W1)  # not running
    with svc:
        assert svc.install_snapshot(W1) == 1
        np.testing.assert_array_equal(svc.dictionary(), W1)
        assert svc.load()["snapshot_version"] == 1 and svc.stats()["published"] == 1
        x = _w0(seed=6)[:, 0]
        nu, y = svc.submit(x).result(timeout=60)
        nu_ref, y_ref = coder.solve(coder.snapshot(W1), x[None])
        np.testing.assert_allclose(nu, nu_ref[0].numpy(), rtol=1e-6, atol=1e-6)
        assert svc.load()["serving_version"] == 1
        with pytest.raises(ValueError, match="does not match"):
            svc.install_snapshot(_w0(n_atoms=K0 + 4))
        # a grow or drain that swaps the coder while W is being placed
        other, real = object(), coder.snapshot

        def swapping_snapshot(W):
            with svc._lock:
                svc._coder = other
            return real(W)

        coder.snapshot = swapping_snapshot
        with pytest.raises(RuntimeError, match="coder changed"):
            svc.install_snapshot(W1)
        with svc._lock:
            svc._coder = coder
        del coder.snapshot
        assert svc.load()["snapshot_version"] == 1  # the refused install published nothing


def test_load_keys_match_the_jax_service():
    tree = ast.parse((REPO / "src/repro/runtime/service.py").read_text())
    load = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "load")
    jax_keys = [k.value for n in ast.walk(load) if isinstance(n, ast.Dict) for k in n.keys]
    _, svc = _service(4, dict(mode="graph", iters=5), learn=False, warmup=False)
    assert list(svc.load()) == jax_keys
    assert svc.sample_dim == M


def _hold_first_batch(svc):
    """Hold the exec lock and wrap the batcher's solve so the test knows
    when a batch is in flight (read its pair, waiting for the lock).
    Returns (in-flight event, the pairs the batcher coded with)."""
    in_flight, pairs = threading.Event(), []
    real = svc._solve_padded

    def solve(coder, snap, xb):
        pairs.append((coder, snap, xb.shape[0]))
        in_flight.set()
        return real(coder, snap, xb)

    svc._solve_padded = solve
    svc._exec_lock.acquire()
    return in_flight, pairs


def test_kill_fails_every_pending_future_and_stop_is_then_a_noop():
    import torch

    _, svc = _service(4, dict(mode="graph", iters=10), learn=True)
    X = np.stack([_w0(seed=s)[:, 0] for s in range(40)])
    svc.start()
    in_flight, pairs = _hold_first_batch(svc)
    futs = svc.submit_many(X)
    assert in_flight.wait(30)
    killer = threading.Thread(target=svc.kill)
    killer.start()
    for _ in range(500):  # kill() sweeps the queue before it joins the workers
        if svc._queue.empty():
            break
        time.sleep(0.01)
    svc._exec_lock.release()
    killer.join(60)
    assert not killer.is_alive() and not svc.running()
    coded = [f for f in futs if f.exception(timeout=10) is None]
    failed = [f for f in futs if f.exception(timeout=10) is not None]
    batch = pairs[0][2]  # the batch in flight completes; the queue fails
    assert 1 <= batch <= 8 and len(coded) == batch and len(failed) == 40 - batch
    assert all("killed" in str(f.exception()) for f in failed)
    assert all(f.done() for f in futs)
    stats = svc.stats()
    svc.stop()  # a no-op sweep
    svc.kill()  # idempotent
    assert svc.stats()["coded"] == stats["coded"] == batch
    for call in (lambda: svc.submit(X[0]), lambda: svc.grow(1, torch.Generator()),
                 lambda: svc.drain([0]), lambda: svc.install_snapshot(_w0())):
        with pytest.raises(RuntimeError):
            call()


def test_a_grow_landing_while_a_batch_is_in_flight_keeps_the_batch_in_its_era():
    import torch

    coder, svc = _service(4, dict(mode="graph", iters=10), learn=False, warmup=False)
    x = _w0(seed=7)[:, 0]
    with svc:
        in_flight, pairs = _hold_first_batch(svc)
        fut = svc.submit(x)
        assert in_flight.wait(30)  # the batcher holds the old (coder, snapshot)
        info = svc.grow(2, torch.Generator().manual_seed(1)).result(timeout=60)
        assert svc._coder is not coder and svc.snapshot().shape[0] == 6
        svc._exec_lock.release()
        nu, y = fut.result(timeout=60)  # coded by the old pair, not the new coder
        nu2, y2 = svc.submit(x).result(timeout=60)
    assert pairs[0][0] is coder and pairs[0][1].shape[0] == 4
    assert y.shape == (info["k_old"],) == (K0,) and y2.shape == (info["k_new"],)
    nu_ref, _ = coder.solve(pairs[0][1], x[None])
    np.testing.assert_allclose(nu, nu_ref[0].numpy(), rtol=1e-6, atol=1e-6)
    assert svc.stats()["serving_version"] == 1
