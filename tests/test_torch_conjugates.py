"""Port parity: core/conjugates, every Table-I task, elementwise at 1e-6."""

import numpy as np
import pytest

from test_torch_common import as_np, rand, to_jax, to_torch, unit_cols

TOL = 1e-6


TASKS = ["sparse_svd", "bi_clustering", "nmf", "nmf_huber"]


@pytest.mark.parametrize("task", TASKS)
def test_task_functions_match_jax(task):
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    jres, jreg = jc.make_task(task, gamma=0.07, delta=0.3, eta=0.25)
    tres, treg = tc.make_task(task, gamma=0.07, delta=0.3, eta=0.25)
    assert (tres.name, tres.bounded_dual, tres.strongly_convex) == (
        jres.name, jres.bounded_dual, jres.strongly_convex)
    assert (treg.name, treg.gamma, treg.delta, treg.nonneg) == (
        jreg.name, jreg.gamma, jreg.delta, jreg.nonneg)

    rng = np.random.default_rng(TASKS.index(task))
    u = 1.5 * rand(rng, 5, 12)
    v = rand(rng, 5, 20)
    y = rand(rng, 5, 20)
    y_pos = np.abs(y)
    W = unit_cols(rand(rng, 12, 20))
    x = rand(rng, 5, 12)

    def same(j, t, what):
        np.testing.assert_allclose(as_np(t), as_np(j), rtol=TOL, atol=TOL, err_msg=what)

    for name in ("f", "fstar", "grad_fstar", "project_dual"):
        same(getattr(jres, name)(to_jax(u)), getattr(tres, name)(to_torch(u)), name)
    for name in ("hstar", "ystar"):
        same(getattr(jreg, name)(to_jax(v)), getattr(treg, name)(to_torch(v)), name)
    same(jreg.h(to_jax(y)), treg.h(to_torch(y)), "h")
    same(jreg.h(to_jax(y_pos)), treg.h(to_torch(y_pos)), "h (nonneg y)")
    if jres.recover_z is not None:
        same(jres.recover_z(to_jax(x), to_jax(u)), tres.recover_z(to_torch(x), to_torch(u)), "z")
    else:
        assert tres.recover_z is None
    same(jc.primal_objective(jres, jreg, to_jax(W), to_jax(y_pos), to_jax(x)),
         tc.primal_objective(tres, treg, to_torch(W), to_torch(y_pos), to_torch(x)), "Q")
    nu = 0.5 * rand(rng, 5, 12)
    same(jc.dual_function(jres, jreg, to_jax(W), to_jax(nu), to_jax(x)),
         tc.dual_function(tres, treg, to_torch(W), to_torch(nu), to_torch(x)), "g")


def test_thresholds_and_bad_inputs():
    from repro.core import conjugates as jc
    from repro_torch.core import conjugates as tc

    s = np.linspace(-2, 2, 41).astype(np.float32)
    for jf, tf in ((jc.soft_threshold, tc.soft_threshold),
                   (jc.soft_threshold_pos, tc.soft_threshold_pos)):
        np.testing.assert_allclose(as_np(tf(to_torch(s), 0.3)), as_np(jf(to_jax(s), 0.3)),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        tc.make_elastic_net(0.1, 0.0)
    with pytest.raises(KeyError):
        tc.make_task("nope")
