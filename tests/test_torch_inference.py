"""Port parity: core/inference (the reference engine) against JAX.

Solves at 1e-4 (tests/test_parity_ref_dist.py).  The power-iteration
curvature estimates at 1e-5 relative: two frameworks' fp32 reductions
cannot promise the 1e-7 the JAX suite asserts against itself.
"""

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, rand, to_jax, to_torch, unit_cols

N, M, K, B = 4, 16, 32, 4


def _problem(seed=0, task="sparse_svd", gamma=0.05, delta=0.1):
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    rng = np.random.default_rng(seed)
    W = unit_cols(rand(rng, M, K))
    if task.startswith("nmf"):
        W = unit_cols(np.abs(W))
    x = rand(rng, B, M)
    return (jc.make_task(task, gamma=gamma, delta=delta),
            tc.make_task(task, gamma=gamma, delta=delta), W, x)


def _blocks(W):
    from repro_torch.core.dictionary import blocks_from_full

    return blocks_from_full(to_torch(W), N)


@pytest.mark.parametrize("kind", ["ring_metropolis", "erdos"])
@pytest.mark.parametrize("informed", ["all", "one"])
def test_diffusion_infer_matches_jax(kind, informed):
    import jax.numpy as jnp

    from repro.core import inference as ji
    from repro.core.dictionary import blocks_from_full as jblocks
    from repro_torch.core import inference as ti
    from repro_torch.core.topology import make_topology

    (jres, jreg), (tres, treg), W, x = _problem(1)
    A = make_topology(kind, N, p=0.5, seed=7)
    inf = np.ones(N, np.float32) if informed == "all" else np.eye(N, dtype=np.float32)[0]
    mu = float(ji.safe_diffusion_mu(jres, jreg, jblocks(to_jax(W), N)))
    cfg_j, cfg_t = ji.DiffusionConfig(iters=200), ti.DiffusionConfig(iters=200)
    nu_j, y_j, _ = ji.diffusion_infer(jres, jreg, jblocks(to_jax(W), N), to_jax(x),
                                      jnp.asarray(A, jnp.float32), to_jax(inf), cfg_j,
                                      mu=jnp.asarray(mu, jnp.float32))
    nu_t, y_t, _ = ti.diffusion_infer(tres, treg, _blocks(W), to_torch(x),
                                      torch.as_tensor(A, dtype=torch.float32),
                                      to_torch(inf), cfg_t, mu=mu)
    assert tuple(nu_t.shape) == (N, B, M) and tuple(y_t.shape) == (N, B, K // N)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")


def test_diffusion_record_every_not_dividing_iters():
    """The remainder iterations still run: nu reflects the whole budget."""
    import jax.numpy as jnp

    from repro.core import inference as ji
    from repro.core.dictionary import blocks_from_full as jblocks
    from repro_torch.core import inference as ti
    from repro_torch.core.topology import make_topology

    (jres, jreg), (tres, treg), W, x = _problem(2, task="nmf_huber")
    A = make_topology("ring_metropolis", N)
    ones = np.ones(N, np.float32)
    nu_j, _, traj_j = ji.diffusion_infer(
        jres, jreg, jblocks(to_jax(W), N), to_jax(x), jnp.asarray(A, jnp.float32),
        to_jax(ones), ji.DiffusionConfig(mu=0.2, iters=50), record_every=15)
    nu_t, _, traj_t = ti.diffusion_infer(
        tres, treg, _blocks(W), to_torch(x), torch.as_tensor(A, dtype=torch.float32),
        to_torch(ones), ti.DiffusionConfig(mu=0.2, iters=50), record_every=15)
    assert tuple(traj_t.shape) == tuple(traj_j.shape) == (3, N, B, M)
    assert_close(traj_t, traj_j, what="trajectory")
    assert_close(nu_t, nu_j, what="final nu (after the 5 remainder iterations)")
    full, _, _ = ti.diffusion_infer(
        tres, treg, _blocks(W), to_torch(x), torch.as_tensor(A, dtype=torch.float32),
        to_torch(ones), ti.DiffusionConfig(mu=0.2, iters=50))
    assert torch.equal(full, nu_t)


def test_diffusion_penalty_form_matches_jax():
    import jax.numpy as jnp

    from repro.core import inference as ji
    from repro.core.dictionary import blocks_from_full as jblocks
    from repro_torch.core import inference as ti
    from repro_torch.core.topology import make_topology

    (jres, jreg), (tres, treg), W, x = _problem(3, task="nmf_huber")
    A = make_topology("torus", N)
    ones = np.ones(N, np.float32)
    nu_j, _, _ = ji.diffusion_infer(
        jres, jreg, jblocks(to_jax(W), N), to_jax(x), jnp.asarray(A, jnp.float32),
        to_jax(ones), ji.DiffusionConfig(mu=0.1, iters=60, mode="penalty"))
    nu_t, _, _ = ti.diffusion_infer(
        tres, treg, _blocks(W), to_torch(x), torch.as_tensor(A, dtype=torch.float32),
        to_torch(ones), ti.DiffusionConfig(mu=0.1, iters=60, mode="penalty"))
    assert_close(nu_t, nu_j)


@pytest.mark.parametrize("task", ["sparse_svd", "nmf_huber"])
def test_exact_and_fista_infer_match_jax(task):
    from repro.core import inference as ji
    from repro_torch.core import inference as ti

    (jres, jreg), (tres, treg), W, x = _problem(4, task=task)
    nu_j = ji.exact_infer(jres, jreg, to_jax(W), to_jax(x), iters=300)
    nu_t = ti.exact_infer(tres, treg, to_torch(W), to_torch(x), iters=300)
    assert_close(nu_t, nu_j, what="exact")
    nu_j = ji.fista_infer(jres, jreg, to_jax(W), to_jax(x), iters=150)
    nu_t = ti.fista_infer(tres, treg, to_torch(W), to_torch(x), iters=150)
    assert_close(nu_t, nu_j, what="fista")
    assert_close(ti.recover_y(treg, to_torch(W), nu_t), ji.recover_y(jreg, to_jax(W), nu_j))
    assert_close(ti.full_dual_grad(tres, treg, to_torch(W), nu_t, to_torch(x)),
                 ji.full_dual_grad(jres, jreg, to_jax(W), nu_j, to_jax(x)))
    snr_t = float(ti.snr_db(nu_t, nu_t + 1e-3))
    snr_j = float(ji.snr_db(nu_j, nu_j + 1e-3))
    assert abs(snr_t - snr_j) < 1e-2


def test_power_sigma2_and_safe_mu_match_jax():
    import jax

    from repro.core import inference as ji
    from repro.core.dictionary import blocks_from_full as jblocks
    from repro_torch.core import inference as ti

    (jres, jreg), (tres, treg), W, _ = _problem(5)
    rel = 1e-5
    s_j = float(ji.power_sigma2(to_jax(W)))
    s_t = float(ti.power_sigma2(to_torch(W)))
    assert abs(s_t - s_j) <= rel * s_j
    per_j = np.asarray(jax.vmap(ji.power_sigma2)(jblocks(to_jax(W), N)))
    per_t = ti.power_sigma2(_blocks(W)).numpy()
    np.testing.assert_allclose(per_t, per_j, rtol=rel)
    mu_j = float(ji.safe_diffusion_mu(jres, jreg, jblocks(to_jax(W), N)))
    mu_t = float(ti.safe_diffusion_mu(tres, treg, _blocks(W)))
    assert abs(mu_t - mu_j) <= rel * mu_j
    L_j, m_j = ji.estimate_dual_curvature(jres, jreg, to_jax(W))
    L_t, m_t = ti.estimate_dual_curvature(tres, treg, to_torch(W))
    assert abs(float(L_t) - float(L_j)) <= rel * float(L_j) and float(m_t) == float(m_j)
