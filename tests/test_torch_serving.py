"""Port checks: the serving plane (runtime/serving.py).

JAX's fake-replica tests (tests/test_serving.py) against the port's
`pick_replica`, `Router` and `ReplicaSet`: admission by size or deadline,
seeded placement, version-aware shedding, re-routing a killed replica's
in-flight work, a clean failure with no live replica.  The port's and
JAX's `pick_replica` give the same placements on one seeded load history.
`device_pools` on the CPU (no stream) and its memory refusal.  Then real
fleets of the port's services on CPU pools: the lifecycle (publish, grow,
drain, publish) for every MODE_REGISTRY family, the rolling publish with
codes matching a single service at 1e-5, and a kill soak that loses no
request.
"""

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class FakeReplica:
    """Replica-protocol fake: codes x -> (2x, sum(x)) inline.  `hold=True`
    parks inner futures until release()/kill(), a real in-flight window."""

    def __init__(self, version=0, dim=4, hold=False):
        self.version = version
        self.sample_dim = dim
        self.hold = hold
        self.depth = 0  # reported queue depth (tests set it directly)
        self.calls = 0
        self.load_calls = 0
        self._held = []
        self._running = False
        self._lk = threading.Lock()

    def start(self):
        self._running = True
        return self

    def stop(self):
        self.release()
        self._running = False

    def kill(self):
        with self._lk:
            self._running = False
            held, self._held = self._held, []
        for fut, _ in held:
            fut.set_exception(RuntimeError("replica killed"))

    def release(self):
        with self._lk:
            held, self._held = self._held, []
        for fut, x in held:
            fut.set_result((2 * x, float(np.sum(x))))

    def running(self):
        return self._running

    def load(self):
        with self._lk:
            self.load_calls += 1
            return {"queue_depth": self.depth, "snapshot_version": self.version,
                    "serving_version": self.version, "coded": self.calls}

    def install_snapshot(self, W):
        with self._lk:
            if not self._running:
                raise RuntimeError("service is not running")
            self.version += 1
            return self.version

    def submit(self, x):
        with self._lk:
            if not self._running:
                raise RuntimeError("service is not running")
            self.calls += 1
            fut = Future()
            if self.hold:
                self._held.append((fut, x))
                return fut
        fut.set_result((2 * x, float(np.sum(x))))
        return fut

    def stats(self):
        return {"coded": self.calls, "snapshot_version": self.version,
                "serving_version": self.version}


def _serving():
    from repro_torch.runtime import serving

    return serving


# -- the placement policy -------------------------------------------------------


def test_pick_replica_prefers_shallow_and_fresh():
    sv = _serving()
    cfg = sv.RouterConfig(depth_weight=1.0, stale_penalty=8.0)
    rng = np.random.default_rng(0)

    def mk(d, v):
        return {"queue_depth": d, "snapshot_version": v}

    assert sv.pick_replica([mk(5, 1), mk(2, 1)], 1, cfg, rng) == 1
    assert sv.pick_replica([mk(0, 0), mk(7, 1)], 1, cfg, rng) == 1
    assert sv.pick_replica([mk(0, 0), mk(9, 1)], 1, cfg, rng) == 0
    assert sv.pick_replica([None, mk(99, 0)], 1, cfg, rng) == 1
    with pytest.raises(ValueError):
        sv.pick_replica([None, None], 1, cfg, rng)


def test_pick_replica_tie_break_is_seeded_and_deterministic():
    sv = _serving()
    cfg = sv.RouterConfig(seed=0)

    def run(seed):
        rng = np.random.default_rng(seed)
        picks = []
        for i in range(20):
            loads = [{"queue_depth": 3, "snapshot_version": 2} for _ in range(3)]
            if i % 5 == 0:  # a non-tie round draws nothing
                loads[1] = {"queue_depth": 0, "snapshot_version": 2}
            picks.append(sv.pick_replica(loads, 2, cfg, rng))
        return picks

    assert run(7) == run(7)
    assert all(run(7)[i] == 1 for i in range(0, 20, 5))
    assert len(set(run(7))) > 1


def test_pick_replica_places_as_jax_does():
    from repro.runtime import serving as js

    sv = _serving()
    history = np.random.default_rng(3)
    loads_seq = []
    for _ in range(400):
        loads = []
        for _ in range(4):
            if history.random() < 0.15:
                loads.append(None)
            else:
                loads.append({"queue_depth": int(history.integers(0, 3)),
                              "snapshot_version": int(history.integers(4, 6))})
        if all(ld is None for ld in loads):
            loads[0] = {"queue_depth": 0, "snapshot_version": 5}
        loads_seq.append(loads)
    for kw in (dict(seed=11), dict(seed=2, stale_penalty=1.0, depth_weight=0.5)):
        rt, rj = np.random.default_rng(kw["seed"]), np.random.default_rng(kw["seed"])
        ct, cj = sv.RouterConfig(**kw), js.RouterConfig(**kw)
        ours = [sv.pick_replica(ld, 5, ct, rt) for ld in loads_seq]
        theirs = [js.pick_replica(ld, 5, cj, rj) for ld in loads_seq]
        assert ours == theirs and len(set(ours)) == 4
    assert [f.name for f in dataclasses.fields(sv.RouterConfig)] == \
        [f.name for f in dataclasses.fields(js.RouterConfig)]
    assert sv.RouterConfig() == sv.RouterConfig(**vars(js.RouterConfig()))


# -- the router over fakes ------------------------------------------------------


def test_router_admission_full_batch_vs_deadline():
    sv = _serving()
    reps = [FakeReplica(), FakeReplica()]
    fleet = sv.ReplicaSet(reps).start()
    with sv.Router(fleet, sv.RouterConfig(micro_batch=8, max_wait_s=0.05)) as router:
        t0 = time.perf_counter()
        nu, y = router.submit(np.ones(4, np.float32)).result(timeout=5)
        assert time.perf_counter() - t0 < 1.0
        assert np.allclose(nu, 2.0) and y == pytest.approx(4.0)
        base = sum(r.load_calls for r in reps)
        futs = [router.submit(np.ones(4, np.float32)) for _ in range(8)]
        for f in futs:
            f.result(timeout=5)
        assert sum(r.load_calls for r in reps) == base + 2
        with pytest.raises(ValueError):
            router.submit(np.ones(5, np.float32))
    fleet.stop()


def test_router_routing_is_deterministic_under_seed():
    sv = _serving()

    def run(seed):
        reps = [FakeReplica(), FakeReplica()]
        fleet = sv.ReplicaSet(reps).start()
        with sv.Router(fleet, sv.RouterConfig(micro_batch=1, max_wait_s=0.001,
                                              seed=seed)) as router:
            for _ in range(24):
                router.submit(np.zeros(4, np.float32)).result(timeout=5)
            routed = router.stats()["routed"]
        fleet.stop()
        return routed, [r.calls for r in reps]

    assert run(3) == run(3)


def test_router_version_aware_shedding_until_publish_catches_up():
    sv = _serving()
    reps = [FakeReplica(version=1), FakeReplica(version=0)]  # r1 is stale
    fleet = sv.ReplicaSet(reps).start()
    with sv.Router(fleet, sv.RouterConfig(micro_batch=1, max_wait_s=0.001,
                                          stale_penalty=8.0)) as router:
        for _ in range(30):
            router.submit(np.zeros(4, np.float32)).result(timeout=5)
        stale_phase = dict(router.stats()["routed"])
        assert stale_phase["r0"] == 30 and stale_phase["r1"] == 0
        assert fleet.publish(np.zeros((2, 2))) == {"r0": 2, "r1": 1}
        reps[0].version = reps[1].version = max(r.version for r in reps)
        for _ in range(30):
            router.submit(np.zeros(4, np.float32)).result(timeout=5)
        assert router.stats()["routed"]["r1"] > 0
    assert fleet.stats()["publishes"] == 1 and fleet.fleet_version() == 2
    fleet.stop()


def test_router_reroutes_killed_replicas_in_flight_work():
    sv = _serving()
    reps = [FakeReplica(hold=True), FakeReplica()]
    reps[1].depth = 5
    fleet = sv.ReplicaSet(reps).start()
    with sv.Router(fleet, sv.RouterConfig(micro_batch=4, max_wait_s=0.005)) as router:
        futs = [router.submit(np.full(4, i, np.float32)) for i in range(8)]
        for _ in range(200):
            if reps[0].calls >= 8:
                break
            time.sleep(0.01)
        assert reps[0].calls >= 8
        reps[1].depth = 0
        fleet.kill("r0")
        res = [f.result(timeout=10) for f in futs]
        assert len(res) == 8
        assert all(np.allclose(nu, 2 * i) for i, (nu, _) in enumerate(res))
        st = router.stats()
        assert st["failed"] == 0 and st["rerouted"] >= 8 and st["routed"]["r1"] >= 8
        assert fleet.alive() == ["r1"] and st["replicas"]["r0"] is None
    fleet.stop()


def test_router_fails_cleanly_with_no_live_replicas():
    sv = _serving()
    rep = FakeReplica(hold=True)
    fleet = sv.ReplicaSet([rep]).start()
    router = sv.Router(fleet, sv.RouterConfig(micro_batch=2, max_wait_s=0.005,
                                              max_retries=1)).start()
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(4)]
    fleet.kill("r0")
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=10)
    st = router.stats()
    assert st["failed"] == 4 and st["inflight"] == 0
    router.stop()
    with pytest.raises(RuntimeError):
        router.submit(np.zeros(4, np.float32))


def test_router_counters_hold_under_contention():
    """Many client threads against two fakes, a tiny switch interval and a
    kill mid-stream: every request resolves, and the counters agree (a lost
    update would leave inflight off zero or the placements short)."""
    import sys

    sv = _serving()
    reps = [FakeReplica(), FakeReplica()]
    fleet = sv.ReplicaSet(reps).start()
    router = sv.Router(fleet, sv.RouterConfig(micro_batch=4, max_wait_s=0.001)).start()
    futs, lock = [], threading.Lock()

    def client(k):
        for i in range(50):
            f = router.submit(np.full(4, k * 100 + i, np.float32))
            with lock:
                futs.append(f)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        fleet.kill("r0")
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        results = [f.result(timeout=60) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    st = router.stats()
    router.stop()
    fleet.stop()
    assert len(results) == 16 * 50 == st["admitted"]
    assert st["failed"] == 0 and st["inflight"] == 0
    assert sum(st["routed"].values()) == st["admitted"] + st["rerouted"]


def test_replica_set_rejects_dupes_and_unknown_names():
    sv = _serving()
    with pytest.raises(ValueError):
        sv.ReplicaSet([FakeReplica(), FakeReplica()], names=["a", "a"])
    with pytest.raises(ValueError):
        sv.ReplicaSet([])
    fleet = sv.ReplicaSet([FakeReplica()], names=["a"])
    with pytest.raises(KeyError):
        fleet["b"]
    assert isinstance(fleet["a"], sv.Replica) and len(fleet) == 1


def test_device_pools_on_the_cpu_and_the_memory_refusal():
    import torch

    sv = _serving()
    pools = sv.device_pools(3, device="cpu")
    assert [(p.device, p.stream) for p in pools] == [(torch.device("cpu"), None)] * 3
    per = sv.replica_bytes(16, 8192, 16384, learn=False)
    assert per == 2 * 16 * 8192 * 16384 * 4  # the snapshot and one install
    assert sv.replica_bytes(16, 8192, 16384, learn=True) == 3 * per // 2
    assert len(sv.device_pools(2, per, device="cpu", free_bytes=2 * per)) == 2
    with pytest.raises(ValueError, match="GB free"):
        sv.device_pools(3, per, device="cpu", free_bytes=2 * per)
    with pytest.raises(ValueError):
        sv.device_pools(0, device="cpu")


# -- real fleets on CPU pools ---------------------------------------------------

M, K0 = 16, 16
# family -> (agents per level, DistConfig fields, grow count, drain ranks)
_FAMILY_FLEET_LIFECYCLE = {
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


def _w0(k=K0, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((M, k)).astype(np.float32)
    return W / np.linalg.norm(W, axis=0)


def _fleet(agents, cfg, n=2, **svc):
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.service import DictionaryService, ServiceConfig

    res, reg = make_task("sparse_svd", gamma=0.25, delta=0.05)
    W0 = _w0(8 * int(np.prod(agents)))
    kw = dict(micro_batch=8, learn=False)
    kw.update(svc)
    services = [DictionaryService(DistributedSparseCoder(agents, res, reg, DistConfig(**cfg),
                                                         device=p.device),
                                  W0, ServiceConfig(**kw), stream=p.stream)
                for p in _serving().device_pools(n, device="cpu")]
    return W0, _serving().ReplicaSet(services)


def test_fleet_lifecycle_params_cover_every_registry_family():
    from repro_torch.core.distributed import MODE_REGISTRY

    assert set(_FAMILY_FLEET_LIFECYCLE) == {caps.family for caps in MODE_REGISTRY.values()}


@pytest.mark.parametrize("family", sorted(_FAMILY_FLEET_LIFECYCLE))
def test_fleet_lifecycle_publish_grow_drain_publish(family):
    import torch

    from repro_torch.data.synthetic import sparse_stream

    sv = _serving()
    agents, cfg, grow_n, drain_ranks = _FAMILY_FLEET_LIFECYCLE[family]
    W0, fleet = _fleet(agents, cfg)
    X = sparse_stream(64, m=M, k_true=W0.shape[1], seed=3)

    def versions():
        return {r.name: r.service.load()["snapshot_version"] for r in fleet.replicas}

    with fleet:
        with sv.Router(fleet, sv.RouterConfig(micro_batch=8)) as router:
            a = [f.result(timeout=120) for f in router.submit_many(X[:16])]
            rng = np.random.default_rng(1)
            W1 = W0 + 0.01 * rng.standard_normal(W0.shape).astype(np.float32)
            W1 /= np.maximum(1.0, np.linalg.norm(W1, axis=0, keepdims=True))
            assert fleet.publish(W1) == {"r0": 1, "r1": 1}
            b = [f.result(timeout=120) for f in router.submit_many(X[16:32])]
            infos = [r.service.grow(grow_n, torch.Generator().manual_seed(4)).result(timeout=120)
                     for r in fleet.replicas]
            assert all(i["k_new"] == infos[0]["k_new"] for i in infos)
            assert versions() == {"r0": 2, "r1": 2}
            c = [f.result(timeout=120) for f in router.submit_many(X[32:48])]
            dinfos = [r.service.drain(drain_ranks).result(timeout=120) for r in fleet.replicas]
            assert all(d["k_new"] == dinfos[0]["k_new"] for d in dinfos)
            d = [f.result(timeout=120) for f in router.submit_many(X[48:])]
            W2 = fleet.replicas[0].service.dictionary()
            with pytest.raises(ValueError):
                fleet.publish(W2[:, :-1])  # another geometry is refused
            assert fleet.publish(W2 * 0.5) == {"r0": 4, "r1": 4}
            stats = router.stats()
    assert stats["failed"] == 0
    assert len(a) == len(b) == len(c) == len(d) == 16
    assert all(np.isfinite(nu).all() and np.isfinite(y).all() for nu, y in a + b + c + d)
    assert all(y.shape == (W0.shape[1],) for _, y in a + b)
    assert all(y.shape == (infos[0]["k_new"],) for _, y in c)
    assert all(y.shape == (dinfos[0]["k_new"],) for _, y in d)
    assert fleet.alive() == []


def test_fleet_rolling_publish_and_code_match():
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.data.synthetic import sparse_stream

    sv = _serving()
    cfg = dict(mode="graph", topology="ring_metropolis", iters=40)
    W0, fleet = _fleet(2, cfg)
    X = sparse_stream(64, m=M, k_true=K0, seed=3)
    rng = np.random.default_rng(0)
    W1 = W0 + 0.01 * rng.standard_normal(W0.shape).astype(np.float32)
    W1 /= np.maximum(1.0, np.linalg.norm(W1, axis=0, keepdims=True))
    ref = DistributedSparseCoder(2, *make_task("sparse_svd", gamma=0.25, delta=0.05),
                                 DistConfig(**cfg), device="cpu")
    ref0 = ref.solve(ref.snapshot(W0), X[:32])[0].numpy()
    ref1 = ref.solve(ref.snapshot(W1), X[32:])[0].numpy()
    with fleet:
        with sv.Router(fleet, sv.RouterConfig(micro_batch=8)) as router:
            pre = [f.result(timeout=120) for f in router.submit_many(X[:32])]
            assert fleet.publish(W1) == {"r0": 1, "r1": 1}
            post = [f.result(timeout=120) for f in router.submit_many(X[32:])]
            rstats = router.stats()
    fstats = fleet.stats()
    assert rstats["failed"] == 0 and rstats["rerouted"] == 0
    assert sum(rstats["routed"].values()) == 64
    err0 = max(float(np.abs(nu - ref0[i]).max()) for i, (nu, _) in enumerate(pre))
    err1 = max(float(np.abs(nu - ref1[i]).max()) for i, (nu, _) in enumerate(post))
    assert err0 < 1e-5 and err1 < 1e-5, (err0, err1)
    for name, st in fstats["replicas"].items():
        assert st["snapshot_version"] == 1, name
    assert fstats["publish_events"] == [{"r0": 1, "r1": 1}]


def test_replica_kill_soak():
    from repro_torch.data.synthetic import sparse_stream

    sv = _serving()
    W0, fleet = _fleet(2, dict(mode="graph", topology="ring_metropolis", iters=40))
    N = 160
    X = sparse_stream(N, m=M, k_true=K0, seed=3)
    trace = {"r0": [], "r1": []}
    stop_poll = threading.Event()

    def poll():
        while not stop_poll.is_set():
            for rep in fleet.replicas:
                st = rep.service.stats()
                trace[rep.name].append((st["snapshot_version"], st["serving_version"]))
            time.sleep(0.002)

    with fleet:
        with sv.Router(fleet, sv.RouterConfig(micro_batch=8, max_wait_s=0.005)) as router:
            t = threading.Thread(target=poll, daemon=True)
            t.start()
            futs = []
            for i in range(N):
                if i == N // 2:
                    fleet.kill("r0")  # the stream still flowing, work in flight
                futs.append(router.submit(X[i]))
            assert list(fleet.publish(W0 * 0.9)) == ["r1"]
            res_all = [f.result(timeout=120) for f in futs]
            rstats = router.stats()
        stop_poll.set()
        t.join()
    fstats = fleet.stats()
    assert len(res_all) == N and all(np.isfinite(nu).all() for nu, _ in res_all)
    assert rstats["failed"] == 0 and rstats["inflight"] == 0
    assert rstats["routed"]["r1"] > N // 2
    assert rstats["latency_ms"]["p99"] > 0.0
    for name, tr in trace.items():
        for col in (0, 1):
            seq = [v[col] for v in tr]
            assert seq == sorted(seq), name
    assert fstats["replicas"]["r1"]["snapshot_version"] == 1
    assert fstats["alive"] == []
