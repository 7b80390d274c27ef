"""Port parity: the production coder (core/distributed) for the flat modes.

The port's coder (N = 4 agents on the CPU) against the single-host JAX
reference (core/inference.py) under the identical combiner A and step mu,
at 1e-4: the diffusion modes against `diffusion_infer`, the exact modes
against JAX projected-gradient and FISTA iterations run with the port's mu.
Also the step size, the dictionary step (Eq. 51), one in-process check
against the JAX DistributedSparseCoder on a 1x1 mesh, and `convert`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, rand, to_jax, to_torch, unit_cols

N, M, K, B = 4, 16, 32, 4
ITERS = 300


def _setup(task="sparse_svd", seed=0):
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    rng = np.random.default_rng(seed)
    W = unit_cols(rand(rng, M, K))
    if task.startswith("nmf"):
        W = unit_cols(np.abs(W))
    x = rand(rng, B, M)
    if task.startswith("nmf"):
        x = np.abs(x)
    return (jc.make_task(task, gamma=0.05, delta=0.1),
            tc.make_task(task, gamma=0.05, delta=0.1), W, x)


def _coder(task_t, **cfg):
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    res, reg = task_t
    return DistributedSparseCoder(N, res, reg, DistConfig(iters=ITERS, **cfg), device="cpu")


def _jax_diffusion(task_j, W, x, A, informed, mu):
    import jax.numpy as jnp

    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import DiffusionConfig, diffusion_infer

    res, reg = task_j
    theta = np.ones(N, np.float32) if informed == "all" else np.eye(N, dtype=np.float32)[0]
    return diffusion_infer(res, reg, blocks_from_full(to_jax(W), N), to_jax(x),
                           jnp.asarray(A, jnp.float32), to_jax(theta),
                           DiffusionConfig(iters=ITERS), mu=jnp.asarray(mu, jnp.float32))


DIFFUSION_CASES = [
    ("ring", "ring_metropolis", "all"),
    ("ring", "ring_metropolis", "one"),
    ("graph", "ring_metropolis", "all"),
    ("graph", "torus", "all"),
    ("graph", "erdos", "all"),
    ("graph", "erdos", "one"),
]


@pytest.mark.parametrize("mode,kind,informed", DIFFUSION_CASES)
def test_diffusion_modes_match_reference_engine(mode, kind, informed):
    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import safe_diffusion_mu

    task_j, task_t, W, x = _setup(seed=1)
    coder = _coder(task_t, mode=mode, topology=kind, topology_seed=7, informed=informed)
    Wb, xt = coder.shard(W, x)
    A = coder.combiner()
    mus = coder.adaptive_mu(Wb).numpy()
    assert mus.shape == (N,) and float(np.ptp(mus)) == 0.0
    mu_j = float(safe_diffusion_mu(*task_j, blocks_from_full(to_jax(W), N)))
    assert abs(float(mus[0]) - mu_j) <= 1e-5 * mu_j
    nu_j, y_j, _ = _jax_diffusion(task_j, W, x, A, informed, mus[0])
    nu_t, y_t = coder.solve_per_agent(Wb, xt)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")
    # solve(): agent 0's nu, and the per-agent y blocks side by side
    nu0, y_flat = coder.solve(Wb, xt)
    assert_close(nu0, np.asarray(nu_j)[0])
    assert_close(y_flat, np.moveaxis(np.asarray(y_j), 0, 1).reshape(B, K))


def test_graph_schedule_realizes_the_combiner():
    from repro.runtime.dist import graph_schedule as jax_schedule
    from repro_torch.core.topology import make_topology
    from repro_torch.runtime import comm

    for kind in ("ring_metropolis", "torus", "erdos", "full"):
        A = make_topology(kind, 6, seed=3)
        sched = comm.graph_schedule(A)
        np.testing.assert_allclose(sched.reconstruct(), A, atol=1e-12)
        js = jax_schedule(A)
        assert sched.diag == js.diag
        assert [w for _, w in sched.steps] == [w for _, w in js.steps]
        assert [d for d, _ in sched.steps] == [perm[0][1] for perm, _ in js.steps]
        psi = torch.randn(6, 3, 5)
        dense = torch.tensordot(torch.as_tensor(A.T, dtype=torch.float32), psi, dims=1)
        weights = comm.schedule_weights(sched, torch.float32, psi.device)
        assert_close(comm.graph_combine(psi, sched, weights), dense, rtol=1e-6, atol=1e-6)
    left, right = comm.ring_shift(torch.arange(4.0))
    assert left.tolist() == [3.0, 0.0, 1.0, 2.0] and right.tolist() == [1.0, 2.0, 3.0, 0.0]
    with pytest.raises(ValueError):
        comm.graph_schedule(np.array([[0.9, 0.2], [0.1, 0.8]]))


def _jax_exact(task_j, W, x, mu, fista):
    """The JAX engine's exact iterations on the full dictionary (the sum
    over agents of the back-projections is the full W's), at the port's mu."""
    import jax.numpy as jnp

    from repro.core.inference import full_dual_grad

    res, reg = task_j
    Wj, xj = to_jax(W), to_jax(x)
    nu = jnp.zeros_like(xj)
    nu_prev = nu
    c_f = float(res.grad_fstar(jnp.ones((1,)))[0])
    L = 1.0 / mu
    beta = (np.sqrt(L) - np.sqrt(c_f)) / (np.sqrt(L) + np.sqrt(c_f))
    for _ in range(ITERS):
        if fista:
            z = nu + beta * (nu - nu_prev)
            z = res.project_dual(z - mu * full_dual_grad(res, reg, Wj, z, xj))
            nu, nu_prev = z, nu
        else:
            nu = res.project_dual(nu - mu * full_dual_grad(res, reg, Wj, nu, xj))
    return nu, reg.ystar(nu @ Wj)


@pytest.mark.parametrize("mode", ["exact", "exact_fista"])
@pytest.mark.parametrize("task", ["sparse_svd", "nmf_huber"])
def test_exact_modes_match_jax_iterations(mode, task):
    import jax

    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import power_sigma2

    task_j, task_t, W, x = _setup(task, seed=2)
    coder = _coder(task_t, mode=mode)
    Wb, xt = coder.shard(W, x)
    mus = coder.adaptive_mu(Wb).numpy()
    res, reg = task_j
    c_f = float(res.grad_fstar(np.ones((1,), np.float32))[0])
    sig2 = np.asarray(jax.vmap(power_sigma2)(blocks_from_full(to_jax(W), N)))
    mu_j = 1.0 / (c_f + float(sig2.sum()) / reg.delta)  # the loose summed bound
    assert float(np.ptp(mus)) == 0.0 and abs(float(mus[0]) - mu_j) <= 1e-5 * mu_j
    nu_j, y_j = _jax_exact(task_j, W, x, float(mus[0]), fista=(mode == "exact_fista"))
    nu_t, y_t = coder.solve(Wb, xt)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")
    nu_a, _ = coder.solve_per_agent(Wb, xt)
    assert tuple(nu_a.shape) == (N, B, M) and torch.equal(nu_a[0], nu_a[3])


@pytest.mark.parametrize("mode,task", [("graph", "sparse_svd"), ("ring", "nmf"),
                                       ("exact_fista", "nmf")])
def test_fit_batch_matches_eq51_from_jax_reference(mode, task):
    import jax.numpy as jnp

    from repro.core.dictionary import blocks_from_full, dict_update
    from repro_torch.core.dictionary import blocks_from_full as tblocks

    task_j, task_t, W, x = _setup(task, seed=3)
    coder = _coder(task_t, mode=mode)
    Wb, xt = coder.shard(W, x)
    mu = float(coder.adaptive_mu(Wb)[0])
    if mode == "exact_fista":
        nu, y = _jax_exact(task_j, W, x, mu, fista=True)
        nu_k = jnp.broadcast_to(nu, (N,) + nu.shape)
        y_k = jnp.moveaxis(y.reshape(B, N, K // N), 1, 0)
    else:
        nu_k, y_k, _ = _jax_diffusion(task_j, W, x, coder.combiner(), "all", mu)
    W_k = blocks_from_full(to_jax(W), N)
    want = jnp.stack([dict_update(W_k[a], nu_k[a], y_k[a], 0.3, nonneg=task_t[1].nonneg)
                      for a in range(N)])
    before = Wb.clone()
    got = coder.fit_batch(Wb, xt, 0.3)
    assert torch.equal(Wb, before), "fit_batch wrote its input"
    assert got.data_ptr() != Wb.data_ptr()
    assert_close(got, want, what="W after one step")
    assert torch.equal(tblocks(to_torch(W), N), Wb)


def test_matches_jax_coder_on_a_1x1_mesh():
    from repro.core.distributed import DistConfig as JaxDistConfig
    from repro.core.distributed import DistributedSparseCoder as JaxCoder
    from repro.core.distributed import make_debug_mesh
    from repro_torch.convert import dist_config_from_jax_fields
    from repro_torch.core.distributed import DistributedSparseCoder

    task_j, task_t, W, x = _setup(seed=4)
    jcfg = JaxDistConfig(mode="exact_fista", iters=120)
    jcoder = JaxCoder(make_debug_mesh(model=1, data=1), *task_j, jcfg)
    nu_j, y_j = jcoder.solve(*jcoder.shard(to_jax(W), to_jax(x)))
    tcfg = dist_config_from_jax_fields(**dataclasses.asdict(jcfg))
    coder = DistributedSparseCoder(1, *task_t, tcfg, device="cpu")
    nu_t, y_t = coder.solve(*coder.shard(W, x))
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")
    mu_j = float(np.asarray(jcoder.adaptive_mu(jcoder.shard(to_jax(W), to_jax(x))[0]))[0])
    assert abs(float(coder.adaptive_mu(coder.shard(W, x)[0])[0]) - mu_j) <= 1e-5 * mu_j


def test_convert_round_trips_and_configs():
    from repro.core.dictionary import blocks_from_full
    from repro.core.distributed import DistConfig as JaxDistConfig
    from repro_torch import convert
    from repro_torch.core.distributed import DistConfig

    rng = np.random.default_rng(5)
    W = rand(rng, M, K)
    blocks = convert.dictionary_from_numpy(W, N, device="cpu")
    assert tuple(blocks.shape) == (N, M, K // N) and blocks.is_contiguous()
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(blocks_from_full(to_jax(W), N)))
    np.testing.assert_array_equal(convert.dictionary_to_numpy(blocks), W)
    for fields in (dict(mode="graph", iters=7, topology="erdos", topology_seed=3,
                        informed="one", mu=0.2),
                   dict(mode="ring", beta=0.25, use_kernel=True)):
        want = {k: v for k, v in fields.items() if k != "use_kernel"}
        got = convert.dist_config_from_jax_fields(**dataclasses.asdict(JaxDistConfig(**fields)))
        assert got == DistConfig(**want)
    with pytest.raises(TypeError):
        convert.dist_config_from_jax_fields(mode="graph", not_a_field=1)


def test_config_rejects_unported_and_bad_settings():
    from repro.core.distributed import MODE_REGISTRY as JAX_REGISTRY
    from repro_torch.core.distributed import MODE_REGISTRY, MODES, PORTED_MODES, DistConfig

    assert PORTED_MODES == MODES == tuple(JAX_REGISTRY)
    for mode, caps in MODE_REGISTRY.items():
        assert dataclasses.asdict(caps) == dataclasses.asdict(JAX_REGISTRY[mode]), mode
    with pytest.raises(KeyError):
        DistConfig(mode="nope")
    with pytest.raises(ValueError):
        DistConfig(mode="ring", beta=0.6)
    with pytest.raises(ValueError):
        DistConfig(informed="some")
    with pytest.raises(ValueError):
        DistConfig(mode="graph", topology="distar")
