"""Port parity: every gossip mode of the production coder (core/distributed).

Two references, both from the JAX package as it is:

* in process, the single-host engines of src/repro/core/inference.py at
  1e-4: `graph_tv` (also with link failures, at t0 0 and 3) against
  `diffusion_infer` under the schedule's callable A_t, `push` against
  `push_sum_infer` (directed and undirected combiners), `hier` and an fp32
  `chain` against `diffusion_infer` under the chain's callable;
* the JAX shard_map engine itself for all 15 modes, run once per module in
  a subprocess with 8 CPU devices (flat modes on a 1x4 mesh, hier on 2 pods
  of 2, a chain of 2 x 2 x 2 with a q8 and a stale level), at a fixed
  mu > 0 (the safe mu of the shard_map engine sits one fp32 ulp from the
  single-host one): per-agent nu and y and the novelty score within 1e-4
  (1e-2 on the q8 wire), and the combiner, its sequence, the schedule
  period, `is_time_varying`, `combiner_info()` and `wire_bytes_per_iter`
  exactly.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO, subprocess_env
from test_torch_common import assert_close, one_torch_thread, rand, to_jax, unit_cols  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, M, K, B = 4, 16, 32, 4
ITERS = 300
Q8_TOL = 1e-2


def _task():
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    return jc.make_task("sparse_svd", gamma=0.05, delta=0.1), \
        tc.make_task("sparse_svd", gamma=0.05, delta=0.1)


def _data(seed, n_atoms=K):
    rng = np.random.default_rng(seed)
    return unit_cols(rand(rng, M, n_atoms)), rand(rng, B, M)


def _coder(agents, task_t, **cfg):
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    cfg.setdefault("iters", ITERS)
    return DistributedSparseCoder(agents, *task_t, DistConfig(**cfg), device="cpu")


def _jax_reference(engine, task_j, W, x, n, A, mu, informed="all", t0=0):
    """JAX's `diffusion_infer` or `push_sum_infer` at the port's mu, with a
    callable A_t started at iteration t0."""
    import jax.numpy as jnp

    from repro.core import inference as ji
    from repro.core.dictionary import blocks_from_full

    if callable(A) and t0:
        A = (lambda f: lambda t: f(t + t0))(A)
    elif not callable(A):
        A = jnp.asarray(A, jnp.float32)
    theta = np.ones(n, np.float32) if informed == "all" else np.eye(n, dtype=np.float32)[0]
    return getattr(ji, engine)(*task_j, blocks_from_full(to_jax(W), n), to_jax(x), A,
                               to_jax(theta), ji.DiffusionConfig(iters=ITERS),
                               mu=jnp.asarray(mu, jnp.float32))


def _check_safe_mu(task_j, coder, Wb, W, n):
    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import safe_diffusion_mu

    mus = coder.adaptive_mu(Wb).numpy()
    mu_j = float(safe_diffusion_mu(*task_j, blocks_from_full(to_jax(W), n)))
    assert float(np.ptp(mus)) == 0.0 and abs(float(mus[0]) - mu_j) <= 1e-5 * mu_j
    return float(mus[0])


@pytest.mark.parametrize("t0", [0, 3])
@pytest.mark.parametrize("spec,period,failure_p", [
    ("alternating:ring_metropolis,torus", 2, 0.0),
    ("erdos_resampled", 3, 0.0),
    ("fixed:erdos", 2, 0.25),
    ("alternating:ring_metropolis,torus", 2, 0.25),
])
def test_graph_tv_matches_diffusion_infer_under_the_schedule(spec, period, failure_p, t0):
    from repro.core import topology as jt

    task_j, task_t = _task()
    W, x = _data(1)
    coder = _coder(N, task_t, mode="graph_tv", topology_schedule=spec, schedule_period=period,
                   topology_seed=7, failure_p=failure_p, failure_seed=4, failure_steps=6)
    sched = jt.make_topology_schedule(spec, N, seed=7, period=period)
    if failure_p:
        sched = jt.link_failure_schedule(sched, failure_p, failure_seed=4, steps=6)
    for a, b in zip(coder.combiner_sequence(), sched.combiners, strict=True):
        np.testing.assert_array_equal(a, b)
    Wb, xt = coder.shard(W, x)
    mu = _check_safe_mu(task_j, coder, Wb, W, N)
    nu_j, y_j, _ = _jax_reference("diffusion_infer", task_j, W, x, N, sched.as_callable(), mu,
                                  t0=t0)
    nu_t, y_t = coder.solve_per_agent(Wb, xt, t0=t0)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")
    # only t0 mod the period matters
    nu_0, _ = coder.solve_per_agent(Wb, xt, t0=0)
    assert (float((nu_0 - nu_t).abs().max()) > 1e-3) == bool(t0 % coder.schedule_period)


@pytest.mark.parametrize("kind", ["dicycle", "distar", "ring_metropolis"])
def test_push_matches_push_sum_infer(kind):
    from repro.core import topology as jt

    task_j, task_t = _task()
    W, x = _data(2)
    coder = _coder(N, task_t, mode="push", topology=kind)
    A = jt.make_topology(kind, N)
    np.testing.assert_array_equal(coder.combiner(), A)
    Wb, xt = coder.shard(W, x)
    mu = _check_safe_mu(task_j, coder, Wb, W, N)
    nu_j, y_j, w_j = _jax_reference("push_sum_infer", task_j, W, x, N, A, mu)
    nu_t, y_t = coder.solve_per_agent(Wb, xt)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")
    if kind == "ring_metropolis":  # doubly stochastic: w stays 1, push is graph
        np.testing.assert_array_equal(np.asarray(w_j), np.ones(N, np.float32))
        graph = _coder(N, task_t, mode="graph", topology=kind)
        assert torch.equal(graph.solve_per_agent(Wb, xt)[0], nu_t)
    # only the star's columns do not sum to 1, so only there w moves
    assert (float(np.ptp(np.asarray(w_j))) > 1e-3) == (kind == "distar")


@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("mode,sizes,cfg", [
    ("hier", (2, 2), dict(pod_topology="ring_metropolis", pod_gossip_every=2)),
    ("hier", (4, 2), dict(topology="torus", pod_topology="full", informed="one")),
    ("chain", (2, 2, 2), dict(levels="ring_metropolis,ring_metropolis,full")),
    ("chain", (2, 2, 2), dict(levels="torus,ring_metropolis:2,ring:2")),
])
def test_hierarchical_modes_match_diffusion_infer_under_the_chain(mode, sizes, cfg, t0):
    from repro.core import topology as jt

    task_j, task_t = _task()
    n = int(np.prod(sizes))
    W, x = _data(3, n_atoms=8 * n)
    coder = _coder(sizes, task_t, mode=mode, topology_seed=5, **cfg)
    chain = coder.chain
    jchain = jt.make_kronecker_chain(
        [jt.LevelSpec(kind=s.kind, gossip_every=s.gossip_every) for s in chain.specs],
        sizes, seed=5)
    for a, b in zip(coder.combiner_sequence(), jchain.sequence(), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(coder.chain_gossip_schedule.reconstruct(), jchain.kron(),
                               atol=1e-12)
    if mode == "hier":  # the two-level views of the same chain
        np.testing.assert_array_equal(coder.hier_topology.kron(), jchain.kron())
        np.testing.assert_allclose(coder.hier_gossip_schedule.reconstruct(), jchain.kron(),
                                   atol=1e-12)
    assert coder.gossip_schedule is None and coder.topology_schedule is None
    Wb, xt = coder.shard(W, x)
    mu = _check_safe_mu(task_j, coder, Wb, W, n)
    nu_j, y_j, _ = _jax_reference("diffusion_infer", task_j, W, x, n, jchain.as_callable(), mu,
                                  informed=cfg.get("informed", "all"), t0=t0)
    nu_t, y_t = coder.solve_per_agent(Wb, xt, t0=t0)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")


def test_every_mode_solves_through_the_kernel_wrapper(monkeypatch):
    """iters + 1 calls of ops.dict_dual_step per solve in every mode."""
    from repro_torch.core import distributed

    _, task_t = _task()
    W, x = _data(4)
    calls = []
    real = distributed.ops.dict_dual_step
    monkeypatch.setattr(distributed.ops, "dict_dual_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for name, case in ENGINE_CASES.items():
        coder = _coder(case["agents"], task_t, **dict(case["cfg"], iters=7))
        Wb, xt = coder.shard(W, x)
        calls.clear()
        coder.solve(Wb, xt, t0=case["t0"])
        assert len(calls) == 8, name


# -- against the JAX shard_map engine -----------------------------------------

_G = dict(iters=60, mu=0.02)
_FLAT, _HIER, _CHAIN = {"model": 4}, {"model": 2, "pods": 2}, {"model": 2, "pods": 2,
                                                               "outer": [2]}
# mode -> JAX debug_mesh axes, the port's agents per level (innermost
# first), the config, the schedule offset of the solve.
ENGINE_CASES = {
    "exact": dict(mesh=_FLAT, agents=4, cfg=dict(mode="exact", iters=60, mu=0.005)),
    "exact_fista": dict(mesh=_FLAT, agents=4, cfg=dict(mode="exact_fista", iters=60, mu=0.005)),
    "ring": dict(mesh=_FLAT, agents=4, cfg=dict(mode="ring", **_G)),
    "ring_q8": dict(mesh=_FLAT, agents=4, cfg=dict(mode="ring_q8", **_G)),
    "ring_async": dict(mesh=_FLAT, agents=4, cfg=dict(mode="ring_async", beta=0.25, **_G)),
    "graph": dict(mesh=_FLAT, agents=4, cfg=dict(mode="graph", topology="erdos",
                                                 topology_seed=7, **_G)),
    "graph_q8": dict(mesh=_FLAT, agents=4, cfg=dict(mode="graph_q8", **_G)),
    "graph_async": dict(mesh=_FLAT, agents=4, cfg=dict(mode="graph_async", topology="torus",
                                                       **_G)),
    "graph_tv": dict(mesh=_FLAT, agents=4, cfg=dict(mode="graph_tv", **_G)),
    "graph_tv_q8": dict(mesh=_FLAT, agents=4, cfg=dict(mode="graph_tv_q8", failure_p=0.25,
                                                       failure_steps=3, **_G)),
    "push": dict(mesh=_FLAT, agents=4, cfg=dict(mode="push", topology="distar", **_G)),
    "push_q8": dict(mesh=_FLAT, agents=4, cfg=dict(mode="push_q8", topology="dicycle", **_G)),
    "hier": dict(mesh=_HIER, agents=(2, 2), cfg=dict(
        mode="hier", pod_topology="ring_metropolis", pod_gossip_every=2, informed="one", **_G)),
    "hier_q8": dict(mesh=_HIER, agents=(2, 2), cfg=dict(
        mode="hier_q8", topology="torus", pod_topology="full", **_G)),
    "chain": dict(mesh=_CHAIN, agents=(2, 2, 2), cfg=dict(
        mode="chain", levels="torus,ring_metropolis:2:q8,ring:3:stale", **_G)),
}
for _case in ENGINE_CASES.values():
    _case["t0"] = 1  # off every stride and period of the cases

_ENGINE_SCRIPT = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.core.conjugates import make_task
from repro.core.distributed import DistConfig, DistributedSparseCoder
from repro.runtime import dist

cases, out = json.loads(sys.argv[1]), sys.argv[2]
res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
data = np.load(sys.argv[3])
W, x = jnp.asarray(data["W"]), jnp.asarray(data["x"])
arrays, meta = {}, {}
for name, case in cases.items():
    coder = DistributedSparseCoder(dist.debug_mesh(**case["mesh"]), res, reg,
                                   DistConfig(**case["cfg"]))
    Ws, xs = coder.shard(W, x)
    nu, y = coder.solve_per_agent(Ws, xs, case["t0"])
    arrays[name + "/nu"], arrays[name + "/y"] = np.asarray(nu), np.asarray(y)
    arrays[name + "/score"] = np.asarray(coder.score(Ws, xs, case["t0"]))
    arrays[name + "/combiner"] = np.asarray(coder.combiner())
    arrays[name + "/sequence"] = np.stack(coder.combiner_sequence())
    meta[name] = {"schedule_period": coder.schedule_period,
                  "is_time_varying": coder.is_time_varying,
                  "combiner_info": coder.combiner_info(),
                  "wire_bytes": [list(e) for e in coder.wire_bytes_per_iter(4, 16)]}
arrays["meta"] = np.array(json.dumps(meta))
np.savez(out, **arrays)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """Every ENGINE_CASES mode solved by the JAX shard_map engine on 8 CPU
    devices, one subprocess for the module: (W, x, arrays, meta)."""
    tmp = tmp_path_factory.mktemp("jax_engine")
    W, x = _data(11)
    np.savez(tmp / "data.npz", W=W, x=x)
    cases = {k: {f: v for f, v in c.items() if f != "agents"} for k, c in ENGINE_CASES.items()}
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_ENGINE_SCRIPT), json.dumps(cases),
         str(tmp / "out.npz"), str(tmp / "data.npz")],
        env=subprocess_env(8), cwd=str(REPO), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return W, x, out, json.loads(str(out["meta"]))


@pytest.mark.parametrize("mode", list(ENGINE_CASES))
def test_matches_the_jax_shard_map_engine(mode, jax_engine):
    from repro_torch.core.distributed import MODE_REGISTRY

    W, x, out, meta = jax_engine
    case = ENGINE_CASES[mode]
    _, task_t = _task()
    coder = _coder(case["agents"], task_t, **case["cfg"])
    Wb, xt = coder.shard(W, x)
    tol = Q8_TOL if MODE_REGISTRY[mode].quantized or "q8" in case["cfg"].get("levels", "") \
        else 1e-4
    nu, y = coder.solve_per_agent(Wb, xt, t0=case["t0"])
    assert_close(nu, out[mode + "/nu"], rtol=tol, atol=tol, what="nu")
    assert_close(y, out[mode + "/y"], rtol=tol, atol=tol, what="y")
    assert_close(coder.score(Wb, xt, t0=case["t0"]), out[mode + "/score"], rtol=tol, atol=tol,
                 what="score")
    np.testing.assert_array_equal(coder.combiner(), out[mode + "/combiner"])
    np.testing.assert_array_equal(np.stack(coder.combiner_sequence()), out[mode + "/sequence"])
    jm = meta[mode]
    assert coder.schedule_period == jm["schedule_period"]
    assert coder.is_time_varying == jm["is_time_varying"]
    assert json.loads(json.dumps(coder.combiner_info())) == jm["combiner_info"]
    assert [list(e) for e in coder.wire_bytes_per_iter(4, 16)] == jm["wire_bytes"]
