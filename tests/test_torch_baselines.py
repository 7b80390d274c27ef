"""Port parity: core/baselines (primal FISTA coder, Mairal's online learner)
against the JAX module, at 1e-4 relative (fp32 solves and learner steps).

The Mairal step's block-coordinate update is Gauss-Seidel over the columns;
holding W against JAX after three steps pins that order (a Jacobi update is
another algorithm and misses the tolerance).
"""

import numpy as np
import pytest
import torch

from test_torch_common import (
    SOLVE_TOL, assert_close, one_torch_thread, rand, to_jax, to_torch, unit_cols,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, K, B = 16, 32, 16


def _regs(nonneg):
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    task = "nmf" if nonneg else "sparse_svd"
    return jc.make_task(task, gamma=0.05, delta=0.1)[1], tc.make_task(task, gamma=0.05, delta=0.1)[1]


def _data(nonneg, n=3 * B):
    from repro_torch.data.synthetic import sparse_stream

    return sparse_stream(n, m=M, k_true=24, nonneg=nonneg, seed=2)


@pytest.mark.parametrize("nonneg", [False, True])
def test_fista_coder_matches_jax(nonneg):
    from repro.core.baselines import fista_coder as jfista
    from repro_torch.core.baselines import fista_coder

    jreg, treg = _regs(nonneg)
    W = unit_cols(rand(np.random.default_rng(3), M, K))
    if nonneg:
        W = unit_cols(np.abs(W))
    x = _data(nonneg, n=6)
    y = fista_coder(treg, to_torch(W), to_torch(x), iters=200)
    assert tuple(y.shape) == (6, K) and (not nonneg or bool((y >= 0).all()))
    assert_close(y, jfista(jreg, to_jax(W), to_jax(x), iters=200))


@pytest.mark.parametrize("nonneg", [False, True])
def test_mairal_steps_match_jax(nonneg):
    from repro.core.baselines import MairalConfig as JC, MairalLearner as JL
    from repro_torch.convert import mairal_state_from_numpy
    from repro_torch.core.baselines import MairalConfig, MairalLearner

    jreg, treg = _regs(nonneg)
    cfg = dict(m=M, k=K, gamma=0.05, delta=0.1, nonneg=nonneg, code_iters=100)
    jl, tl = JL(JC(**cfg), jreg), MairalLearner(MairalConfig(**cfg), treg, device="cpu")
    js = jl.init_state()
    ts = mairal_state_from_numpy(*(np.array(a) for a in js[:3]), int(js.t), device="cpu")
    X = _data(nonneg)
    for i in range(3):
        js, jobj = jl.fit_batch(js, to_jax(X[i * B:(i + 1) * B]))
        ts, tobj = tl.fit_batch(ts, X[i * B:(i + 1) * B])
    assert ts.t == int(js.t) == 3
    for name in ("W", "A", "B"):
        assert_close(getattr(ts, name), getattr(js, name), what=name)
    np.testing.assert_allclose(float(tobj), float(jobj), rtol=SOLVE_TOL)
    assert float(torch.linalg.vector_norm(ts.W, dim=0).max()) <= 1.0 + 1e-6
    # fit drops a final partial minibatch, as the reference does
    ts2, _ = tl.fit(ts, X[:B + 5], batch_size=B)
    js2, _ = jl.fit(js, to_jax(X[:B + 5]), batch_size=B)
    assert ts2.t == int(js2.t) == 4
    assert_close(ts2.W, js2.W, what="W after fit")


def test_mairal_baseline_learns():
    from repro_torch.core.baselines import MairalConfig, MairalLearner

    _, treg = _regs(False)
    learner = MairalLearner(MairalConfig(m=M, k=K, gamma=0.05, delta=0.1), treg, device="cpu")
    state = learner.init_state()
    X = _data(False, n=16 * B)
    objs = []
    for i in range(16):
        state, obj = learner.fit_batch(state, X[i * B:(i + 1) * B])
        objs.append(float(obj))
    assert objs[-1] < objs[0] and all(np.isfinite(objs))
