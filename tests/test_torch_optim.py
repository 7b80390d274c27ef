"""Port parity: the optimizers, schedules and gradient compression
(repro_torch/optim) against src/repro/optim on the CPU.

The same numpy params and gradients go through the JAX update (returning new
trees) and the port's (in place); every param and state leaf within 1e-6
(rtol and atol) after one update and after several.  Schedules at steps
0-200 within 1e-7.  Also clipping, bf16 params with fp32 state, and the
JAX suite's quadratic test on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, to_torch

TOL = 1e-6
SCHED_TOL = 1e-7


def _jax_opt(name):
    from repro.optim import adafactor, adamw, error_feedback_q8, sgd

    return {
        "sgd": lambda: sgd(0.05),
        "sgd_momentum": lambda: sgd(0.05, momentum=0.9),
        "sgd_clip": lambda: sgd(0.05, clip_norm=0.5),
        "adamw": lambda: adamw(1e-2),
        "adamw_schedule": lambda: adamw(_jax_sched(), weight_decay=0.0),
        "adafactor": lambda: adafactor(1e-2),
        "adafactor_wd_clip": lambda: adafactor(1e-2, weight_decay=0.1, clip_norm=0.5),
        "efq8_adamw": lambda: error_feedback_q8(adamw(1e-2)),
        "efq8_sgd": lambda: error_feedback_q8(sgd(0.05)),
    }[name]()


def _torch_opt(name):
    from repro_torch.optim import adafactor, adamw, error_feedback_q8, sgd

    return {
        "sgd": lambda: sgd(0.05),
        "sgd_momentum": lambda: sgd(0.05, momentum=0.9),
        "sgd_clip": lambda: sgd(0.05, clip_norm=0.5),
        "adamw": lambda: adamw(1e-2),
        "adamw_schedule": lambda: adamw(_torch_sched(), weight_decay=0.0),
        "adafactor": lambda: adafactor(1e-2),
        "adafactor_wd_clip": lambda: adafactor(1e-2, weight_decay=0.1, clip_norm=0.5),
        "efq8_adamw": lambda: error_feedback_q8(adamw(1e-2)),
        "efq8_sgd": lambda: error_feedback_q8(sgd(0.05)),
    }[name]()


def _jax_sched():
    from repro.optim.schedules import cosine_warmup

    return cosine_warmup(1e-2, warmup=3, total=8)


def _torch_sched():
    from repro_torch.optim.schedules import cosine_warmup

    return cosine_warmup(1e-2, warmup=3, total=8)


OPTS = ["sgd", "sgd_momentum", "sgd_clip", "adamw", "adamw_schedule", "adafactor",
        "adafactor_wd_clip", "efq8_adamw", "efq8_sgd"]


def _params(rng):
    """A small tree with a matrix, a 3-d stack, a vector, a (1, d) edge and a
    nested dict (the layouts the LM state has)."""
    return {
        "w": rng.standard_normal((6, 10)).astype(np.float32),
        "stack": {"u": rng.standard_normal((3, 4, 5)).astype(np.float32)},
        "b": rng.standard_normal((10,)).astype(np.float32),
        "edge": rng.standard_normal((1, 7)).astype(np.float32),
    }


def _grads(rng, like, scale=1.0):
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
                        like)


def _tt(tree, dtype=None):
    from repro_torch.pytree import tree_map

    return tree_map(lambda a: to_torch(np.array(a), dtype), tree)


def _check_trees(got, want, tol=TOL):
    from repro_torch.pytree import leaves

    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("name", OPTS)
def test_update_matches_jax(name, n_steps):
    rng = np.random.default_rng(0)
    p_np = _params(rng)
    grads = [_grads(rng, p_np, scale=3.0 if "clip" in name else 1.0) for _ in range(n_steps)]
    jopt, topt = _jax_opt(name), _torch_opt(name)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jopt.init(jp)
    tp = _tt(p_np)
    ts = topt.init(tp)
    _check_trees(ts, js)  # the same state structure, in JAX's leaf order
    for i, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(i, jnp.int32))
        tp2, ts2 = topt.update(_tt(g), ts, tp, torch.tensor(i, dtype=torch.int32))
        assert tp2 is tp and ts2 is ts  # in place
    _check_trees(tp, jp)
    _check_trees(ts, js)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd_momentum"])
def test_bf16_params_keep_fp32_state(name):
    """bf16 params: the state stays fp32, the update runs in fp32 and casts
    back; the port's bf16 params equal JAX's bit for bit after one step (both
    round one fp32 value), the state within 1e-6."""
    rng = np.random.default_rng(1)
    p_np, g_np = _params(rng), None
    g_np = _grads(rng, p_np)
    jopt, topt = _jax_opt(name), _torch_opt(name)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p_np)
    js = jopt.init(jp)
    jp, js = jopt.update(jax.tree.map(jnp.asarray, g_np), js, jp, jnp.asarray(0, jnp.int32))
    tp = _tt(p_np, torch.bfloat16)
    ts = topt.init(tp)
    topt.update(_tt(g_np), ts, tp, 0)
    from repro_torch.pytree import leaves

    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    assert all(s.dtype == torch.float32 for s in leaves(ts))
    _check_trees(ts, js)


def test_grad_clipping():
    """The JAX suite's clipping test on the port, and the clipped update
    against JAX's."""
    from repro_torch.optim import adamw

    opt = adamw(1e-2, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    huge = {"w": torch.full((4,), 1e9)}
    opt.update(huge, state, params, 0)
    assert bool(torch.isfinite(params["w"]).all())
    assert float(params["w"].abs().max()) < 1.0
    from repro.optim import adamw as jadamw

    jo = jadamw(1e-2, clip_norm=1.0)
    jp = {"w": jnp.zeros(4)}
    jp, js = jo.update({"w": jnp.full((4,), 1e9)}, jo.init(jp), jp, jnp.asarray(0, jnp.int32))
    _check_trees(params, jp)
    _check_trees(state, js)


def _quadratic_problem(seed=0, n=12):
    """tests/test_optim.py's problem, in torch."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T / n + np.eye(n, dtype=np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    params = {"w": torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32)),
              "bias": torch.zeros(1)}
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def loss(p):
        w = p["w"][:, 0]
        return 0.5 * w @ At @ w - bt @ w + p["bias"][0] ** 2

    return params, loss


def _grad(loss, params):
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    g = torch.autograd.grad(loss(ps), [ps[k] for k in sorted(ps)])
    return dict(zip(sorted(ps), g))


@pytest.mark.parametrize("which", ["sgd", "sgd_momentum", "adamw", "adafactor", "efq8_adamw"])
def test_optimizers_minimize_quadratic(which):
    """tests/test_optim.py::test_optimizers_minimize_quadratic on the port."""
    from repro_torch.optim import adafactor, adamw, error_feedback_q8, sgd

    opt = {"sgd": lambda: sgd(0.05), "sgd_momentum": lambda: sgd(0.05, momentum=0.9),
           "adamw": lambda: adamw(0.05, weight_decay=0.0), "adafactor": lambda: adafactor(0.2),
           "efq8_adamw": lambda: error_feedback_q8(adamw(0.05, weight_decay=0.0))}[which]()
    params, loss = _quadratic_problem()
    state = opt.init(params)
    l0 = float(loss(params))
    for i in range(200):
        opt.update(_grad(loss, params), state, params, i)
    l1 = float(loss(params))
    assert l1 < 0.05 * abs(l0) + 1e-3, (l0, l1)


def test_adafactor_memory_is_factored():
    from repro_torch.optim import adafactor
    from repro_torch.pytree import leaves

    state = adafactor(1e-2).init({"big": torch.zeros(512, 1024)})
    assert sum(t.numel() for t in leaves(state)) == 512 + 1024


def test_for_arch_picks_the_jax_optimizer():
    from repro.configs import get_config as jax_config
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro_torch.configs import get_config
    from repro_torch.optim import for_arch

    for arch in ("olmo_1b", "gemma_2b", "xlstm_1p3b"):
        assert for_arch(get_config(arch)).name == jax_for_arch(jax_config(arch)).name
    # the bf16-param (1T-class) choice, on a port config made bf16
    import dataclasses

    bf16 = dataclasses.replace(get_config("olmo_1b"), param_dtype="bfloat16")
    assert for_arch(bf16).name == "adafactor"


@pytest.mark.parametrize("which", ["cosine_warmup", "inverse_sqrt", "constant"])
def test_schedules_match_jax(which):
    from repro.optim import schedules as js
    from repro_torch.optim import schedules as ts

    args = {"cosine_warmup": ((3e-4,), dict(warmup=20, total=150)),
            "inverse_sqrt": ((1e-3,), dict(warmup=16)),
            "constant": ((0.3,), {})}[which]
    jf, tf = getattr(js, which)(*args[0], **args[1]), getattr(ts, which)(*args[0], **args[1])
    for step in range(0, 201):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(step)
        assert isinstance(got, float)
        assert abs(got - want) <= SCHED_TOL * max(1.0, abs(want)), (step, got, want)


def test_schedule_shapes():
    """tests/test_optim.py::test_schedules on the port."""
    from repro_torch.optim.schedules import constant, cosine_warmup, inverse_sqrt

    cw = cosine_warmup(1.0, warmup=10, total=100)
    assert cw(0) < 0.11
    assert cw(10) == pytest.approx(1.0, rel=1e-5)
    assert cw(99) < 0.2
    isr = inverse_sqrt(1.0, warmup=16)
    assert isr(16) == pytest.approx(1.0, rel=1e-5)
    assert isr(64) == pytest.approx(0.5, rel=1e-5)
    assert constant(0.3)(5) == pytest.approx(0.3)


def test_q8_channel_matches_jax():
    from repro.optim.compression import compress_decompress as jcd
    from repro_torch.optim.compression import compress_decompress as tcd

    rng = np.random.default_rng(3)
    for shape in [(5, 9), (2, 3, 17), (11,), ()]:
        a = (rng.standard_normal(shape) * 4).astype(np.float32)
        np.testing.assert_array_equal(tcd(to_torch(a)).numpy(), np.asarray(jcd(jnp.asarray(a))))
