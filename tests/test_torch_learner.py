"""Port parity: core/learner (the paper's Alg. 1) against the JAX learner.

Both sides start from one state (the JAX learner's, carried across with
`convert.learner_state_from_numpy`) and take the same numpy minibatches; W
and all four StepMetrics after 3 fit_batch steps at 1e-4 relative (fp32
solves, tests/test_parity_ref_dist.py).  Also code(), fit with a streaming
tail, growth with injected blocks, a config swapped between epochs, and the
check that `graph` coding to (almost) zero at the production Kb/M is the
reference's arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import SOLVE_TOL, assert_close, one_torch_thread, to_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, K, N, B = 16, 32, 8, 16


def _learners(**kw):
    from repro.core.learner import DictionaryLearner as JL, LearnerConfig as JC
    from repro_torch.core.learner import DictionaryLearner as TL, LearnerConfig as TC

    kw = dict(dict(m=M, k=K, n_agents=N, gamma=0.05, delta=0.1, mu=-1.0,
                   inference_iters=100, mu_w=0.1, beta=0.05, seed=0), **kw)
    return JL(JC(**kw)), TL(TC(**kw), device="cpu")


def _shared_state(jl, js):
    from repro_torch.convert import learner_state_from_numpy

    return learner_state_from_numpy(np.array(jl.dictionary(js)), np.array(js.A),
                                    np.array(js.informed), int(js.step), jl.cfg.n_agents,
                                    device="cpu")


def _stream(n, nonneg, seed=1):
    from repro_torch.data.synthetic import sparse_stream

    return sparse_stream(n, m=M, k_true=24, nonneg=nonneg, seed=seed)


def _assert_metrics(tm, jm):
    for name, t, j in zip(tm._fields, tm, jm):
        np.testing.assert_allclose(float(t), float(j), rtol=SOLVE_TOL, atol=1e-6, err_msg=name)


LEARNER_CASES = (
    [(e, h, t, "projection", "all") for e in ("diffusion", "exact", "fista")
     for h in ("none", "l1") for t in ("sparse_svd", "nmf")]
    + [("diffusion", "none", "nmf_huber", "penalty", "all"),
       ("diffusion", "none", "sparse_svd", "projection", "one")]
)


@pytest.mark.parametrize("engine,h_w,task,mode,informed", LEARNER_CASES)
def test_fit_batch_matches_jax(engine, h_w, task, mode, informed):
    jl, tl = _learners(engine=engine, h_w=h_w, task=task, inference_mode=mode,
                       informed=informed)
    js = jl.init_state()
    ts = _shared_state(jl, js)
    X = _stream(3 * B, nonneg=task.startswith("nmf"))
    for i in range(3):
        xb = X[i * B:(i + 1) * B]
        js, jm = jl.fit_batch(js, to_jax(xb))
        ts, tm = tl.fit_batch(ts, xb)
    assert ts.step == int(js.step) == 3
    assert_close(tl.dictionary(ts), jl.dictionary(js), what="W")
    _assert_metrics(tm, jm)
    nu_t, y_t = tl.infer(ts, X[:4])
    nu_j, y_j = jl.infer(js, to_jax(X[:4]))
    assert tuple(nu_t.shape) == (N, 4, M) and tuple(y_t.shape) == (N, 4, K // N)
    assert_close(nu_t, nu_j, what="nu")
    assert_close(y_t, y_j, what="y")


@pytest.mark.parametrize("engine", ["exact", "fista"])
def test_code_matches_jax(engine):
    jl, tl = _learners(engine=engine)
    js = jl.init_state()
    ts = _shared_state(jl, js)
    x = _stream(6, nonneg=False)
    y_t = tl.code(ts, x)
    assert tuple(y_t.shape) == (6, K)
    assert_close(y_t, jl.code(js, to_jax(x)))


def test_fit_processes_the_tail_as_jax_does():
    jl, tl = _learners(engine="exact", inference_iters=20)
    js = jl.init_state()
    ts = _shared_state(jl, js)
    X = _stream(10, nonneg=False)
    js, jm = jl.fit(js, to_jax(X), batch_size=4)
    ts, tm = tl.fit(ts, X, batch_size=4)
    assert ts.step == int(js.step) == 3  # two full batches and a tail of 2
    assert_close(tl.dictionary(ts), jl.dictionary(js), what="W")
    _assert_metrics(tm, jm)
    # fewer samples than one batch: the whole input is the tail
    ts2, tm2 = tl.fit(_shared_state(jl, jl.init_state()), X[:3], batch_size=8)
    assert ts2.step == 1 and np.isfinite(float(tm2.primal_obj))


def test_expanded_keeps_old_blocks_and_steps_like_jax():
    import jax

    jl, tl = _learners(engine="exact", inference_iters=50)
    js = jl.init_state()
    ts = _shared_state(jl, js)
    W_before = tl.dictionary(ts).clone()
    jl2, js2 = jl.expanded(js, extra_agents=4, key=jax.random.PRNGKey(9))
    tl2, ts2 = tl.expanded(ts, extra_agents=4, generator=torch.Generator().manual_seed(9))
    assert tl2.cfg == dataclasses.replace(tl.cfg, n_agents=N + 4, k=K + 4 * (K // N))
    assert tl2.cfg.n_agents == jl2.cfg.n_agents and tl2.cfg.k == jl2.cfg.k
    assert torch.equal(tl2.dictionary(ts2)[:, :K], W_before)
    assert ts2.step == 0 and tuple(ts2.W_blocks.shape) == (N + 4, M, K // N)
    assert_close(ts2.A, js2.A, rtol=0, atol=0)
    # inject the JAX draw of the new blocks, then one step on both sides
    new_blocks = torch.from_numpy(np.array(js2.W_blocks)[N:])
    ts2 = ts2._replace(W_blocks=torch.cat([ts2.W_blocks[:N], new_blocks]))
    assert torch.equal(tl2.dictionary(ts2)[:, :K], W_before)
    x = _stream(B, nonneg=False)
    js3, jm = jl2.fit_batch(js2, to_jax(x))
    ts3, tm = tl2.fit_batch(ts2, x)
    assert_close(tl2.dictionary(ts3), jl2.dictionary(js3), what="W")
    _assert_metrics(tm, jm)


def test_config_swapped_between_epochs_takes_effect():
    """The denoising experiment decays mu_w by replacing learner.cfg: the
    port reads the config at call time, so the swap steps with the new mu_w."""
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig

    cfg = LearnerConfig(m=M, k=K, n_agents=N, engine="fista", inference_iters=50, mu_w=0.1)
    swapped = DictionaryLearner(cfg, device="cpu")
    swapped.cfg = dataclasses.replace(cfg, mu_w=0.4)
    direct = DictionaryLearner(dataclasses.replace(cfg, mu_w=0.4), device="cpu")
    plain = DictionaryLearner(cfg, device="cpu")
    x = _stream(B, nonneg=False)
    W = {name: lrn.fit_batch(lrn.init_state(), x)[0].W_blocks
         for name, lrn in (("swapped", swapped), ("direct", direct), ("plain", plain))}
    assert torch.equal(W["swapped"], W["direct"])
    assert not torch.equal(W["swapped"], W["plain"])


def test_graph_zero_codes_are_the_reference_arithmetic():
    """At the production Kb/M = 2 (M = 512, Kb = 1024, N = 16), 150 iterations
    of `graph` diffusion (ring_metropolis, gamma 0.05, delta 0.1) leave nu a
    small fraction of x, so almost no atom passes the threshold.  The port's
    plain graph solve agrees with JAX's single-host diffusion_infer on nu
    (1e-4) and on which codes are nonzero; exact_fista at the same shape
    codes."""
    import jax.numpy as jnp

    from repro.core import conjugates as jc
    from repro.core.dictionary import blocks_from_full
    from repro.core.inference import DiffusionConfig, diffusion_infer
    from repro_torch.core import conjugates as tc
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.data.synthetic import sparse_stream

    n, m, kb, b, iters = 16, 512, 1024, 16, 150
    rng = np.random.default_rng(0)
    W = rng.standard_normal((m, n * kb)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0)
    x = sparse_stream(b, m=m, k_true=n * kb, seed=1)
    res, reg = tc.make_task("sparse_svd", gamma=0.05, delta=0.1)
    graph = DistributedSparseCoder(
        n, res, reg, DistConfig(mode="graph", iters=iters, topology="ring_metropolis"),
        device="cpu")
    Wb, xt = graph.shard(W, x)
    mu = float(graph.adaptive_mu(Wb)[0])
    nu_t, y_t = graph.solve_per_agent(Wb, xt)
    nu_j, y_j, _ = diffusion_infer(
        *jc.make_task("sparse_svd", gamma=0.05, delta=0.1), blocks_from_full(to_jax(W), n),
        to_jax(x), jnp.asarray(graph.combiner(), jnp.float32), jnp.ones(n),
        DiffusionConfig(iters=iters), mu=jnp.asarray(mu, jnp.float32))
    assert_close(nu_t, nu_j, what="nu")
    nonzero_t, nonzero_j = int((y_t != 0).sum()), int(np.count_nonzero(np.asarray(y_j)))
    assert nonzero_t == nonzero_j
    assert nonzero_t / y_t.numel() < 1e-4
    # nu has closed only about 1 - (1 - mu/N)^150 of the way to x
    ratio = float(torch.linalg.vector_norm(nu_t[0]) / torch.linalg.vector_norm(xt))
    assert 0.05 < ratio < 0.3, ratio
    fista = DistributedSparseCoder(n, res, reg, DistConfig(mode="exact_fista", iters=iters),
                                   device="cpu")
    _, y_f = fista.solve(Wb, xt)
    assert float((y_f != 0).float().mean()) > 1e-3
