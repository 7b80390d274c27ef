"""Port parity: elastic growth and agent drain (topology and coder).

Three layers, each against the JAX package as it is:

* the topology copies (core/topology.py), in process and bit for bit:
  `erdos_renyi_grow` (also from n to n), `shrink_adjacency` (also a cut
  vertex that forces the ring repair), the `grown` / `shrunk` of the
  alternating, erdos_resampled and fixed schedules, of link failures, of a
  3-level chain and of `HierarchicalTopology`, and the refusals;
* the coder's `grown` / `shrunk` for every MODE_REGISTRY family against the
  JAX shard_map engine's, which one module-scoped subprocess runs on 12 CPU
  devices: `combiner()`, the combiner sequence, `schedule_period`,
  `combiner_info()` and `wire_bytes_per_iter` exactly; old blocks bit for
  bit after a grow at JAX's atom positions, survivor blocks bit for bit
  after a drain (the port's drain of JAX's grown W equals JAX's drained W);
  fresh blocks unit-norm, nonnegative for a nonneg task;
* the grown coder's solve on JAX's grown W (crossed as numpy) at a fixed
  mu > 0, within 1e-4 of JAX's single-host `diffusion_infer` /
  `push_sum_infer` / `exact_infer` under the grown combiner.
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
from test_torch_topology import _same_schedule

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, KB, B = 16, 4, 4


def _topo():
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    return jt, tt


def _same_chain(ct, cj):
    assert (ct.ns, ct.period, ct.p, ct.seed, ct.beta) == (cj.ns, cj.period, cj.p, cj.seed,
                                                          cj.beta)
    assert [vars(s) for s in ct.specs] == [vars(s) for s in cj.specs]
    for a, b in zip(ct.combiners + ct.adjacencies, cj.combiners + cj.adjacencies, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ct.sequence(), cj.sequence(), strict=True):
        np.testing.assert_array_equal(a, b)


# -- module 1: the topology copies ---------------------------------------------


@pytest.mark.parametrize("n_old,n_new,p,seed", [(4, 6, 0.5, 3), (5, 5, 0.5, 1), (3, 9, 0.3, 7),
                                                 (1, 4, 0.5, 2)])
def test_erdos_renyi_grow_matches_jax(n_old, n_new, p, seed):
    jt, tt = _topo()
    adj = jt.erdos_renyi_adjacency(n_old, p=p, seed=seed)
    got = tt.erdos_renyi_grow(adj, n_new, p=p, seed=jt.derive_seed(seed, 0, n_new))
    want = jt.erdos_renyi_grow(adj, n_new, p=p, seed=jt.derive_seed(seed, 0, n_new))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n_old, :n_old], adj)  # no old edge rewired
    assert tt.is_connected(got) and got is not adj
    for mod in (jt, tt):
        with pytest.raises(ValueError):
            mod.erdos_renyi_grow(adj, n_old - 1)


def test_shrink_adjacency_matches_jax_and_repairs_a_cut_vertex():
    jt, tt = _topo()
    star = np.zeros((5, 5), bool)
    star[0, 1:] = star[1:, 0] = True  # agent 0 is a cut vertex
    repaired = tt.shrink_adjacency(star, (4, 2, 1, 3))
    np.testing.assert_array_equal(repaired, jt.shrink_adjacency(star, (4, 2, 1, 3)))
    np.testing.assert_array_equal(repaired, tt.ring_adjacency(4))  # the ring repair
    er = jt.erdos_renyi_adjacency(7, p=0.5, seed=4)
    for survivors in ((0, 2, 3, 6), (1,), tuple(range(7))):
        got = tt.shrink_adjacency(er, survivors)
        np.testing.assert_array_equal(got, jt.shrink_adjacency(er, survivors))
        if tt.is_connected(er[np.ix_(survivors, survivors)]):  # survivors keep every edge
            np.testing.assert_array_equal(got, er[np.ix_(survivors, survivors)])
    for bad in ((), (1, 1), (0, 7), (-1, 2)):
        for mod in (jt, tt):
            with pytest.raises(ValueError):
                mod.shrink_adjacency(er, bad)


@pytest.mark.parametrize("spec,period", [
    ("alternating:erdos,ring_metropolis,torus", 2),
    ("erdos_resampled", 3),
    ("fixed:erdos", 2),
    ("fixed:full", 2),
    ("alternating:ring,ring_metropolis", 2),
])
def test_schedule_grown_and_shrunk_match_jax(spec, period):
    jt, tt = _topo()
    kw = dict(p=0.5, seed=5, beta=0.25, period=period)
    st, sj = tt.make_topology_schedule(spec, 4, **kw), jt.make_topology_schedule(spec, 4, **kw)
    gt, gj = st.grown(7), sj.grown(7)
    _same_schedule(gt, gj)
    for k, adj in enumerate(gt.adjacencies):  # erdos steps keep the old edges
        if gt.kinds[k] == "erdos":
            np.testing.assert_array_equal(adj[:4, :4], st.adjacencies[k])
    _same_schedule(gt.shrunk((5, 0, 2)), gj.shrunk((5, 0, 2)))
    _same_schedule(st.shrunk((1, 3)), sj.shrunk((1, 3)))
    explicit_t = tt.fixed_schedule(st.combiners[0])
    explicit_j = jt.fixed_schedule(sj.combiners[0])
    for sched in (explicit_t, explicit_j):
        with pytest.raises(ValueError):
            sched.grown(6)
        with pytest.raises(ValueError):
            sched.shrunk((0, 1))
    for sched in (st, sj):
        for bad in ((), (0, 0), (4,)):
            with pytest.raises(ValueError):
                sched.shrunk(bad)


def test_link_failures_grown_and_shrunk_match_jax():
    jt, tt = _topo()
    base = "alternating:erdos,ring_metropolis"
    ft = tt.link_failure_schedule(tt.make_topology_schedule(base, 4, seed=2), 0.3,
                                  failure_seed=9, steps=5)
    fj = jt.link_failure_schedule(jt.make_topology_schedule(base, 4, seed=2), 0.3,
                                  failure_seed=9, steps=5)
    for got, want in ((ft.grown(6), fj.grown(6)), (ft.shrunk((0, 1, 3)), fj.shrunk((0, 1, 3))),
                      (ft.grown(6).shrunk((1, 2, 5)), fj.grown(6).shrunk((1, 2, 5)))):
        _same_schedule(got, want)
        _same_schedule(got.base, want.base)
        assert (got.fail_p, got.failure_seed, got.period) == (0.3, 9, 5)
    # a chain-backed realization has no generator to re-derive
    chain = tt.make_kronecker_chain(tt.parse_level_specs("ring_metropolis,ring:2"), (3, 2))
    with pytest.raises(ValueError):
        tt.link_failure_schedule(chain, 0.2).grown(5)


@pytest.mark.parametrize("specs", ["erdos,ring_metropolis:2:q8,full:3:stale",
                                   "torus,ring_metropolis:2,ring:4:q8:stale"])
def test_kronecker_chain_grown_and_shrunk_match_jax(specs):
    jt, tt = _topo()
    ct = tt.make_kronecker_chain(tt.parse_level_specs(specs), (3, 2, 2), p=0.5, seed=6)
    cj = jt.make_kronecker_chain(jt.parse_level_specs(specs), (3, 2, 2), p=0.5, seed=6)
    gt, gj = ct.grown(5), cj.grown(5)
    _same_chain(gt, gj)
    for a, b in zip(gt.combiners[1:], ct.combiners[1:]):  # outer levels verbatim
        np.testing.assert_array_equal(a, b)
    _same_chain(gt.shrunk((0, 2, 4)), gj.shrunk((0, 2, 4)))
    _same_chain(ct.shrunk((1,)), cj.shrunk((1,)))
    _same_chain(ct.grown(3), cj.grown(3))
    for chain in (ct, cj):
        with pytest.raises(ValueError):
            chain.grown(2)
        with pytest.raises(ValueError):
            chain.shrunk((3,))


@pytest.mark.parametrize("model_kind", ["erdos", "torus"])
def test_hierarchical_topology_grown_matches_jax(model_kind):
    jt, tt = _topo()
    ht = tt.make_hierarchical_topology("ring_metropolis", model_kind, 2, 3, seed=4,
                                       gossip_every=2)
    hj = jt.make_hierarchical_topology("ring_metropolis", model_kind, 2, 3, seed=4,
                                       gossip_every=2)
    gt, gj = ht.grown(5), hj.grown(5)
    assert (gt.n_pods, gt.n_model, gt.gossip_every) == (gj.n_pods, gj.n_model, gj.gossip_every)
    for f in ("A_pod", "A_model"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
    assert (gt.model_adjacency is None) == (gj.model_adjacency is None)
    if gt.model_adjacency is not None:
        np.testing.assert_array_equal(gt.model_adjacency, gj.model_adjacency)
    for a, b in zip(gt.sequence(), gj.sequence(), strict=True):
        np.testing.assert_array_equal(a, b)


# -- module 2: the coder's grown and shrunk, against the JAX engine ---------------

_FLAT, _HIER = {"model": 2}, {"model": 2, "pods": 2}
_MU = 0.02
# family -> the JAX debug_mesh axes, the port's agents per level (innermost
# first), the task, the config, the agents a grow adds, the ranks a drain
# takes and whether the single-host reference models the mode (q8 and stale
# levels it does not).
CASES = {
    "exact": dict(mesh=_FLAT, agents=2, task="sparse_svd",
                  cfg=dict(mode="exact", iters=120, mu=0.005), grow=2, drain=[1, 2]),
    "ring": dict(mesh=_FLAT, agents=2, task="nmf", cfg=dict(mode="ring", iters=120, mu=_MU),
                 grow=2, drain=[1, 2]),
    "graph": dict(mesh=_FLAT, agents=2, task="sparse_svd",
                  cfg=dict(mode="graph", topology="erdos", topology_seed=7, iters=120, mu=_MU),
                  grow=3, drain=[0, 3]),
    "tv": dict(mesh=_FLAT, agents=2, task="sparse_svd",
               cfg=dict(mode="graph_tv", topology_schedule="alternating:erdos,ring_metropolis",
                        topology_seed=5, failure_p=0.25, failure_seed=11, failure_steps=6,
                        iters=120, mu=_MU), grow=2, drain=[1, 2]),
    "tv_q8": dict(mesh=_FLAT, agents=2, task="sparse_svd",
                  cfg=dict(mode="graph_tv_q8", topology_schedule="erdos_resampled",
                           schedule_period=3, iters=60, mu=_MU), grow=2, drain=[0], ref=False),
    "push": dict(mesh=_FLAT, agents=2, task="sparse_svd",
                 cfg=dict(mode="push", topology="distar", iters=120, mu=_MU), grow=2,
                 drain=[1, 2]),
    "hier": dict(mesh=_HIER, agents=(2, 2), task="sparse_svd",
                 cfg=dict(mode="hier", topology="erdos", pod_topology="ring_metropolis",
                          pod_gossip_every=2, topology_seed=5, iters=120, mu=_MU),
                 grow=1, drain=[1]),
    "chain": dict(mesh={"model": 2, "pods": 2, "outer": [2]}, agents=(2, 2, 2), task="nmf",
                  cfg=dict(mode="chain", levels="erdos,ring_metropolis:2,ring",
                           topology_seed=3, iters=120, mu=_MU), grow=1, drain=[0]),
    "chain_q8_stale": dict(mesh={"model": 2, "pods": 2, "outer": [2]}, agents=(2, 2, 2),
                           task="sparse_svd",
                           cfg=dict(mode="chain", levels="torus,ring_metropolis:2:q8,ring:3:stale",
                                    iters=60, mu=_MU), grow=1, drain=[2], ref=False),
}
T0 = 1  # off every stride and period of the cases

_ENGINE_SCRIPT = """
import json, sys
import numpy as np, jax
from repro.core.conjugates import make_task
from repro.core.distributed import DistConfig, DistributedSparseCoder
from repro.runtime import dist

cases, out = json.loads(sys.argv[1]), sys.argv[2]
data = np.load(sys.argv[3])
arrays, meta = {}, {}

def views(name, coder):
    arrays[name + "/combiner"] = np.asarray(coder.combiner())
    arrays[name + "/sequence"] = np.stack(coder.combiner_sequence())
    meta[name] = {"schedule_period": coder.schedule_period,
                  "is_time_varying": coder.is_time_varying,
                  "combiner_info": coder.combiner_info(),
                  "wire_bytes": [list(e) for e in coder.wire_bytes_per_iter(4, 16)]}

for name, case in cases.items():
    res, reg = make_task(case["task"], gamma=0.05, delta=0.1)
    coder = DistributedSparseCoder(dist.debug_mesh(**case["mesh"]), res, reg,
                                   DistConfig(**case["cfg"]))
    W, x = data[name + "/W"], data["x"]
    Ws, _ = coder.shard(jax.numpy.asarray(W), jax.numpy.asarray(x))
    grown, W2 = coder.grown(Ws, case["grow"], jax.random.PRNGKey(4))
    shrunk, W3 = grown.shrunk(W2, case["drain"])
    views(name + "/grown", grown)
    views(name + "/shrunk", shrunk)
    arrays[name + "/W2"], arrays[name + "/W3"] = np.asarray(W2), np.asarray(W3)
arrays["meta"] = np.array(json.dumps(meta))
np.savez(out, **arrays)
print("OK")
"""


def _n_agents(case):
    return int(np.prod(case["agents"]))


def _inputs():
    rng = np.random.default_rng(21)
    W = {name: unit_cols(rand(rng, M, KB * _n_agents(c))) for name, c in CASES.items()}
    for name, c in CASES.items():
        if c["task"] == "nmf":
            W[name] = np.abs(W[name])
    return W, rand(rng, B, M)


@pytest.fixture(scope="module")
def jax_elastic(tmp_path_factory):
    """Every CASES coder grown then drained by the JAX engine on 12 CPU
    devices, one subprocess for the module: (W by case, x, arrays, meta)."""
    tmp = tmp_path_factory.mktemp("jax_elastic")
    W, x = _inputs()
    np.savez(tmp / "data.npz", x=x, **{f"{k}/W": v for k, v in W.items()})
    cases = {k: {f: c[f] for f in ("mesh", "task", "cfg", "grow", "drain")}
             for k, c in CASES.items()}
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_ENGINE_SCRIPT), json.dumps(cases),
         str(tmp / "out.npz"), str(tmp / "data.npz")],
        env=subprocess_env(12), cwd=str(REPO), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]
    out = np.load(tmp / "out.npz")
    return W, x, out, json.loads(str(out["meta"]))


def _coder(case, agents=None):
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    res, reg = make_task(case["task"], gamma=0.05, delta=0.1)
    return DistributedSparseCoder(agents or case["agents"], res, reg, DistConfig(**case["cfg"]),
                                  device="cpu")


def _same_views(coder, out, meta, key):
    np.testing.assert_array_equal(coder.combiner(), out[key + "/combiner"])
    np.testing.assert_array_equal(np.stack(coder.combiner_sequence()), out[key + "/sequence"])
    jm = meta[key]
    assert coder.schedule_period == jm["schedule_period"]
    assert coder.is_time_varying == jm["is_time_varying"]
    assert json.loads(json.dumps(coder.combiner_info())) == jm["combiner_info"]
    assert [list(e) for e in coder.wire_bytes_per_iter(4, 16)] == jm["wire_bytes"]


def test_cases_cover_every_registry_family():
    from repro.core.distributed import MODE_REGISTRY as JAX_REGISTRY
    from repro_torch.core.distributed import MODE_REGISTRY

    families = {caps.family for caps in MODE_REGISTRY.values()}
    assert families == {caps.family for caps in JAX_REGISTRY.values()}
    assert {MODE_REGISTRY[c["cfg"]["mode"]].family for c in CASES.values()} == families


@pytest.mark.parametrize("name", list(CASES))
def test_grown_and_shrunk_coders_match_jax(name, jax_elastic):
    W, x, out, meta = jax_elastic
    case = CASES[name]
    coder = _coder(case)
    Wb = coder.snapshot(W[name])
    grown, W2 = coder.grown(Wb, case["grow"], torch.Generator().manual_seed(4))
    _same_views(grown, out, meta, name + "/grown")
    n_old, n_new = coder.level_sizes[0], grown.level_sizes[0]
    outer = coder.n_agents // n_old
    assert grown.level_sizes == (n_new,) + coder.level_sizes[1:] and n_new == n_old + case["grow"]
    assert W2.shape == (outer * n_new, M, KB) and W2.is_contiguous()
    # old blocks bit for bit, where JAX's grown W keeps them too
    W2_jax = grown.snapshot(out[name + "/W2"])
    old_t = W2.view(outer, n_new, M, KB)[:, :n_old]
    assert torch.equal(old_t, Wb.view(outer, n_old, M, KB))
    assert torch.equal(W2_jax.view(outer, n_new, M, KB)[:, :n_old], old_t)
    fresh = W2.view(outer, n_new, M, KB)[:, n_old:]
    np.testing.assert_allclose(torch.linalg.vector_norm(fresh, dim=2).numpy(), 1.0, atol=1e-6)
    if grown.reg.nonneg:
        assert bool((fresh >= 0).all())
    else:
        assert bool((fresh < 0).any())
    # the drain: survivors bit for bit, on the port's grown W and on JAX's
    shrunk, W3 = grown.shrunk(W2, case["drain"])
    _same_views(shrunk, out, meta, name + "/shrunk")
    keep = [r for r in range(n_new) if r not in case["drain"]]
    assert torch.equal(W3.view(outer, len(keep), M, KB), W2.view(outer, n_new, M, KB)[:, keep])
    _, W3_jax = grown.shrunk(W2_jax, case["drain"])
    assert torch.equal(W3_jax, shrunk.snapshot(out[name + "/W3"]))


def test_grow_and_drain_refusals():
    case = CASES["graph"]
    coder = _coder(case)
    Wb = coder.snapshot(unit_cols(rand(np.random.default_rng(0), M, KB * 2)))
    gen = torch.Generator().manual_seed(0)
    for extra in (0, -1):
        with pytest.raises(ValueError):
            coder.grown(Wb, extra, gen)
    for bad in ([], [2], [-1], [0, 1]):
        with pytest.raises(ValueError):
            coder.shrunk(Wb, bad)
    with pytest.raises(ValueError):
        coder.grown(Wb[:1], 1, gen)  # not this coder's blocks
    with pytest.raises(ValueError):
        type(coder)(2, coder.res, coder.reg, coder.cfg, "cpu", grown_from=coder,
                    shrunk_from=(coder, (0,)))


def _reference(name, grown, W2_blocks, x):
    """JAX's single-host engine under the grown coder's combiner(s), at the
    case's fixed mu, from iteration T0: (nu (N, B, M), y (N, B, Kb))."""
    import jax.numpy as jnp

    from repro.core import conjugates as jc
    from repro.core import inference as ji

    case = CASES[name]
    res, reg = jc.make_task(case["task"], gamma=0.05, delta=0.1)
    cfg = case["cfg"]
    mu = jnp.asarray(cfg["mu"], jnp.float32)
    Wj, xj = to_jax(W2_blocks), to_jax(x)
    n = grown.n_agents
    if cfg["mode"] == "exact":
        W_full = jnp.concatenate(list(Wj), axis=1)
        nu = ji.exact_infer(res, reg, W_full, xj, mu=mu, iters=cfg["iters"])
        return jnp.broadcast_to(nu, (n,) + nu.shape), reg.ystar(jnp.einsum("bm,nmk->nbk", nu, Wj))
    seq = np.stack(grown.combiner_sequence()).astype(np.float32)
    stack = jnp.asarray(seq)
    A = (lambda t: stack[jnp.mod(t + T0, len(seq))]) if len(seq) > 1 else stack[0]
    dcfg = ji.DiffusionConfig(iters=cfg["iters"])
    engine = ji.push_sum_infer if cfg["mode"] == "push" else ji.diffusion_infer
    nu, y, _ = engine(res, reg, Wj, xj, A, jnp.ones(n, jnp.float32), dcfg, mu=mu)
    return nu, y


@pytest.mark.parametrize("name", [k for k, c in CASES.items() if c.get("ref", True)])
def test_grown_coder_solves_jax_grown_w_like_the_single_host_engine(name, jax_elastic):
    W, x, out, _ = jax_elastic
    case = CASES[name]
    grown, _ = _coder(case).grown(_coder(case).snapshot(W[name]), case["grow"],
                                  torch.Generator().manual_seed(4))
    W2 = grown.snapshot(out[name + "/W2"])
    nu, y = grown.solve_per_agent(W2, x, t0=T0)
    nu_j, y_j = _reference(name, grown, W2.numpy(), x)
    assert_close(nu, nu_j, what="nu")
    assert_close(y, y_j, what="y")
    assert float(np.abs(np.asarray(y_j)).max()) > 0  # codes are nonzero at this size
