"""The paper's engine across ranks: `DistributedSparseCoder(..., mesh=)`,
one agent per rank of the `model` axis (the hierarchical modes: of
`pod` x `model`, one `pod<i>` more per outer chain level), the samples
split over `data`, gossip through `Mesh.ppermute` and `psum`
(runtime/comm.py's mesh wire).

One world of eight gloo ranks on the CPU (module-scoped, spawned by
runtime/mesh.launch, `torch_mesh_workers.mesh_coder`) runs every mode at
1x4 (`hier`, `hier_q8` and a two-level `chain` at 2x1x2, a three-level
chain at 2x2x1x2), `graph`, `graph_q8` and `exact_fista` at 2x2, and the
ppermute cases; each case is held here against the one-process engine
(`solve_per_agent`, `solve`, `fit_batch`, `score`, `adaptive_mu`) on the
same numpy inputs (1e-5 relative, 1e-2 for the q8 wire), ring, graph and
the exact modes against JAX's single-host solve (1e-4, as
tests/test_torch_distributed.py), the 2x2 step against the whole batch's,
and each rank's bytes on the wire against `wire_bytes_per_iter`.
"""

import functools

import numpy as np
import pytest

import torch_mesh_workers as W
from test_torch_common import REPO  # noqa: F401  (puts src on the path)

WORLD_TIMEOUT = 240  # seconds the spawned world may run (launch raises past it)
M, KB, B, ITERS = 16, 8, 8, 40
TASK = ("sparse_svd", 0.05, 0.1)  # task, gamma, delta
MU_W = 0.3
FP32_RTOL, Q8_RTOL, JAX_TOL = 1e-5, 1e-2, 1e-4
FLAT = ("exact", "exact_fista", "ring", "ring_q8", "ring_async", "graph", "graph_q8",
        "graph_async", "graph_tv", "graph_tv_q8", "push", "push_q8")
FLAT14, HIER212, CHAIN3 = ((1, 4), ("data", "model")), \
    ((2, 1, 2), ("pod", "data", "model")), ((2, 2, 1, 2), ("pod2", "pod", "data", "model"))


def _case(mesh, agents, **cfg):
    shape, axes = mesh
    return {"shape": shape, "axes": axes, "agents": agents, "cfg": {"iters": ITERS, **cfg}}


CASES = {
    **{mode: _case(FLAT14, 4, mode=mode) for mode in FLAT},
    "graph informed one": _case(FLAT14, 4, mode="graph", informed="one"),
    "graph_tv t0 3": {**_case(FLAT14, 4, mode="graph_tv"), "t0": 3},
    "hier": _case(HIER212, (2, 2), mode="hier", pod_topology="ring_metropolis",
                  pod_gossip_every=2),
    "hier_q8": _case(HIER212, (2, 2), mode="hier_q8", pod_topology="ring_metropolis"),
    "chain": _case(HIER212, (2, 2), mode="chain",
                   levels="ring_metropolis,ring_metropolis:2:q8:stale"),
    "chain 3 levels": _case(CHAIN3, (2, 2, 2), mode="chain",
                            levels="ring_metropolis,ring_metropolis:2:q8,full:4:q8:stale"),
    "graph 2x2": _case(((2, 2), ("data", "model")), 2, mode="graph"),
    "graph_q8 2x2": _case(((2, 2), ("data", "model")), 2, mode="graph_q8"),
    "exact_fista 2x2": _case(((2, 2), ("data", "model")), 2, mode="exact_fista"),
}
DATA_CASES = ("graph 2x2", "graph_q8 2x2", "exact_fista 2x2")


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(11)
    n = 4
    Wf = rng.standard_normal((M, n * KB)).astype(np.float32)
    Wf /= np.linalg.norm(Wf, axis=0, keepdims=True)
    x = rng.standard_normal((B, M)).astype(np.float32)
    h = rng.standard_normal((B, M)).astype(np.float32)
    return Wf, x, h


def _W_for(agents) -> np.ndarray:
    """The case's dictionary: KB atoms per agent, the first columns of the
    shared draw (re-normalised columns are already unit)."""
    n = int(np.prod(agents))
    Wf, _, _ = _inputs()
    if n * KB <= Wf.shape[1]:
        return Wf[:, :n * KB]
    rng = np.random.default_rng(12)
    Wn = rng.standard_normal((M, n * KB)).astype(np.float32)
    return Wn / np.linalg.norm(Wn, axis=0, keepdims=True)


@functools.lru_cache(maxsize=None)
def _world():
    from repro_torch.runtime import mesh

    _, x, h = _inputs()
    job = {"task": TASK[0], "gamma": TASK[1], "delta": TASK[2], "x": x, "h": h, "mu_w": MU_W,
           "cases": {name: {**c, "W": _W_for(c["agents"])} for name, c in CASES.items()}}
    return mesh.launch(W.mesh_coder, (2, 2, 1, 2), axes=("pod2", "pod", "data", "model"),
                       device="cpu", threads=1, quiet=True, args=(job,),
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world():
    return _world()


def _one_process(name):
    """The one-process engine's results for a case, on the same inputs."""
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    c = CASES[name]
    res, reg = make_task(TASK[0], gamma=TASK[1], delta=TASK[2])
    coder = DistributedSparseCoder(c["agents"], res, reg, DistConfig(**c["cfg"]), device="cpu")
    _, x, h = _inputs()
    Wb, xt = coder.shard(_W_for(c["agents"]), x)
    t0 = c.get("t0", 0)
    nu, y = coder.solve_per_agent(Wb, xt, t0)
    nu0, y_flat = coder.solve(Wb, xt, t0)
    return coder, {"nu": nu, "y": y, "nu0": nu0, "y_flat": y_flat,
                   "W": coder.gather(coder.fit_batch(Wb, xt, MU_W, t0)),
                   "score": coder.score(Wb, h, t0), "mu": coder.adaptive_mu(Wb)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _tol(name) -> float:
    return Q8_RTOL if "q8" in CASES[name]["cfg"]["mode"] or "q8" in CASES[name]["cfg"].get(
        "levels", "") else FP32_RTOL


def test_ppermute_sends_each_pair_and_zeros_elsewhere(world):
    got = world["ppermute"]
    xs = [W.inputs(7, r, (3, 5)) for r in range(4)]
    zero = np.zeros((3, 5))
    want = {"shift": [xs[3], xs[0], xs[1], xs[2]],
            "partial": [xs[2], zero, xs[0], xs[3]],  # (0, 2), (2, 0), (3, 3)
            "none": [zero] * 4,
            "self on a size-1 axis": xs, "none on a size-1 axis": [zero] * 4}
    sent = {"shift": [1, 1, 1, 1], "partial": [1, 0, 1, 0], "none": [0] * 4,
            "self on a size-1 axis": [0] * 4, "none on a size-1 axis": [0] * 4}
    for name in want:
        for r in range(4):
            out, traffic = got[r][name]
            np.testing.assert_array_equal(out, want[name][r], err_msg=f"{name} rank {r}")
            assert traffic == ({"model": [1, 3 * 5 * 8]} if sent[name][r] else {}), \
                (name, r, traffic)


@pytest.mark.parametrize("name", list(CASES))
def test_each_mode_on_the_mesh_is_the_one_process_engine(world, name):
    got = world[name]
    coder, want = _one_process(name)
    tol = _tol(name)
    n = coder.n_agents
    assert [r["agent"] for r in got["ranks"]] == \
        [W.flat_agent(r["coords"], CASES[name]["axes"], CASES[name]["shape"])
         for r in got["ranks"]]
    assert sorted({r["agent"] for r in got["ranks"]}) == list(range(n))
    for key in ("nu", "y", "nu0", "y_flat", "W", "score"):
        assert _rel(got[key], want[key]) <= tol, (name, key, _rel(got[key], want[key]))
    # the step size: every rank's the one process's (pmax'd / psum'd)
    assert got["mu"].shape == (n,) and float(np.ptp(got["mu"])) == 0.0
    assert _rel(got["mu"], want["mu"]) <= FP32_RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_wire_bytes_per_iteration_are_the_accounting(world, name):
    """Every rank's bytes on each agent axis over one solve: iters x
    `wire_bytes_per_iter` (an all-reduce there counts twice its operand,
    the mesh its operand once), plus the adaptive step's one fp32 pmax
    (psum for the exact modes) per agent axis."""
    got = world[name]
    exact = CASES[name]["cfg"]["mode"].startswith("exact")
    for r in got["ranks"]:
        for axis, per_iter in got["wire"]:
            calls, nbytes = r["traffic"][axis]
            assert nbytes == ITERS * per_iter / (2 if exact else 1) + 4, \
                (name, r["coords"], axis, r["traffic"], per_iter)
        assert set(r["traffic"]) == {a for a, _ in got["wire"]}


def _jax_solve(mode, W_full, x, A, mu):
    import jax.numpy as jnp

    from repro.core import conjugates as jc
    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import DiffusionConfig, diffusion_infer, full_dual_grad

    res, reg = jc.make_task(TASK[0], gamma=TASK[1], delta=TASK[2])
    n = A.shape[0]
    if not mode.startswith("exact"):
        nu, y, _ = diffusion_infer(res, reg, blocks_from_full(jnp.asarray(W_full), n),
                                   jnp.asarray(x), jnp.asarray(A, jnp.float32),
                                   jnp.ones((n,), jnp.float32), DiffusionConfig(iters=ITERS),
                                   mu=jnp.asarray(mu, jnp.float32))
        return np.asarray(nu), np.asarray(y)
    Wj, xj = jnp.asarray(W_full), jnp.asarray(x)
    nu = nu_prev = jnp.zeros_like(xj)
    c_f = float(res.grad_fstar(jnp.ones((1,)))[0])
    L = 1.0 / mu
    beta = (np.sqrt(L) - np.sqrt(c_f)) / (np.sqrt(L) + np.sqrt(c_f))
    for _ in range(ITERS):
        if mode == "exact_fista":
            z = nu + beta * (nu - nu_prev)
            z = res.project_dual(z - mu * full_dual_grad(res, reg, Wj, z, xj))
            nu, nu_prev = z, nu
        else:
            nu = res.project_dual(nu - mu * full_dual_grad(res, reg, Wj, nu, xj))
    y = reg.ystar(nu @ Wj)
    return (np.broadcast_to(np.asarray(nu), (n,) + nu.shape),
            np.moveaxis(np.asarray(y).reshape(B, n, KB), 1, 0))


@pytest.mark.parametrize("name", ["ring", "graph", "exact", "exact_fista"])
def test_ring_graph_and_exact_on_the_mesh_match_jax_single_host(world, name):
    got = world[name]
    coder, _ = _one_process(name)
    _, x, _ = _inputs()
    nu, y = _jax_solve(CASES[name]["cfg"]["mode"], _W_for(4), x, coder.combiner(),
                       float(got["mu"][0]))
    np.testing.assert_allclose(got["nu"], nu, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got["y"], y, rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("name", DATA_CASES)
def test_the_data_sum_makes_the_2x2_step_the_whole_batch_step(world, name):
    """At 2x2 each data rank solves half the rows; `fit_batch` sums nu^T y
    and the row count over `data`, so the step is the one process's on all
    B rows (and without the sum it is not)."""
    got = world[name]
    coder, want = _one_process(name)
    assert got["ranks"][0]["traffic"].keys() == {"model"}  # a solve moves nothing over data
    assert _rel(got["W"], want["W"]) <= _tol(name)
    halves = got["W_no_data_sum"]  # each data rank's own half-batch step, gathered
    assert _rel(halves, want["W"]) > _tol(name)  # the check above rejects it


def test_a_mesh_refuses_growth_drain_and_a_wrong_shape():
    import torch

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.mesh import Mesh

    res, reg = make_task(*TASK[:1], gamma=TASK[1], delta=TASK[2])
    mesh = Mesh(("data", "model"), (1, 4), 1, "gloo", torch.device("cpu"), {})
    coder = DistributedSparseCoder(4, res, reg, DistConfig(mode="graph"), device="cpu",
                                   mesh=mesh)
    assert coder.agent_index == 1
    Wb = torch.zeros((1, M, KB))
    with pytest.raises(NotImplementedError, match="item 8"):
        coder.grown(Wb, 1, torch.Generator())
    with pytest.raises(NotImplementedError, match="item 8"):
        coder.shrunk(Wb, [0])
    with pytest.raises(ValueError, match="needs the mesh axes"):
        DistributedSparseCoder(2, res, reg, DistConfig(mode="graph"), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="needs the mesh axes"):
        DistributedSparseCoder((2, 2), res, reg, DistConfig(mode="hier", pod_topology="ring"),
                               device="cpu", mesh=mesh)
