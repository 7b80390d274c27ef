"""Port parity: the MoE layer (models/moe.py) against src/repro/models/moe.py.

Inputs and JAX's params (`init_moe`, numpy-mapped) cross as numpy arrays
made from a seed; everything runs in fp32 on the CPU.  For each case the
port's `apply_moe` is held against JAX's: the output within 1e-5, the aux
loss within 1e-6, token_of_slot and filled exactly, and gate_of_slot with
the same support and values within GATE_RTOL: the two frameworks' fp32
`exp` in the softmax may differ by an ulp, so a gate may too.  Fed JAX's
own routing (its top-k ids and values), the port's `dispatch_tables` gives
all three tables bit for bit.  JAX's `apply_moe` does not return its
tables, so the test evaluates its jaxpr with an interpreter that records
the top-k and the three scatters building them.  The cases:
tests/test_models.py's shape (nothing drops at factor 4.0), the same at
1.25 (drops), a capacity that lands on x.5 (Python's round: half to even),
a token count the group count does not divide, one group of 4 tokens (a
decode step) and a shared expert.
The gradient of sum(out * w) + 0.01 aux with respect to every parameter
and x against jax.grad within 1e-4 of each leaf's largest |value|, with
and without drops; `moe_ref` against JAX's at 1e-5; and the dispatch and
combine Functions under torch.autograd.gradcheck in float64.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, to_torch  # noqa: I001 (puts src on the path)
from repro_torch.pytree import leaves, unflatten

OUT_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
GATE_RTOL = 1e-6  # a few fp32 ulps of a gate in (0, 1]

# name: (x shape (B, S, D), d_ff, experts, top_k, n_groups, capacity_factor,
#        shared experts, the capacity JAX's expression gives)
CASES = {
    "no drops": ((2, 24, 32), 16, 8, 2, 2, 4.0, 0, 24),
    "drops": ((2, 24, 32), 16, 8, 2, 2, 1.25, 0, 8),      # 7.5 rounds to 8
    "half to even": ((2, 8, 32), 16, 8, 2, 2, 1.25, 0, 2),  # 2.5 rounds to 2, not 3
    "groups do not divide": ((1, 21, 32), 16, 8, 2, 4, 1.25, 0, 2),  # g 3, tg 7
    "decode": ((4, 1, 32), 16, 8, 2, 1, 1.25, 0, 1),
    "shared expert": ((2, 24, 32), 16, 8, 2, 2, 1.25, 1, 8),
}


def _jax_moe():
    from repro.models import moe

    return moe


def _moe():
    from repro_torch.models import moe

    return moe


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX params, port params, x numpy, kwargs) of a case."""
    import jax

    from repro.models.layers import split_tree

    shape, f, e, k, groups, factor, shared, _ = CASES[name]
    vals, _ = split_tree(_jax_moe().init_moe(jax.random.PRNGKey(0), shape[-1], f, e,
                                             n_shared=shared))
    vals = jax.tree.map(np.asarray, vals)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), vals)
    return vals, params, x, dict(top_k=k, n_groups=groups, capacity_factor=factor)


def jax_apply_moe_with_tables(params, x, **kw):
    """JAX's apply_moe evaluated from its jaxpr: (out, aux, {"token_of_slot",
    "filled", "gate_of_slot", "top_k": (values, ids)}), the tables being the
    results of the three scatters that build them, in program order, and
    "top_k" the router's top-k before the renormalisation."""
    import jax
    from jax.extend import core as jcore

    closed = jax.make_jaxpr(functools.partial(_jax_moe().apply_moe, **kw))(params, x)
    scatters, top_k = [], []

    def run(jaxpr, consts, args):
        env = {}

        def read(v):
            return v.val if isinstance(v, jcore.Literal) else env[v]

        env.update(zip(jaxpr.constvars, consts))
        env.update(zip(jaxpr.invars, args))
        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            if "jaxpr" in eqn.params and eqn.primitive.name in ("pjit", "jit", "closed_call"):
                sub = eqn.params["jaxpr"]
                outs = run(sub.jaxpr, sub.consts, ins)
            else:
                outs = eqn.primitive.bind(*ins, **eqn.params)
                outs = outs if eqn.primitive.multiple_results else [outs]
                if eqn.primitive.name == "scatter":
                    scatters.append(np.asarray(outs[0]))
                elif eqn.primitive.name == "top_k":
                    top_k.append(tuple(np.asarray(o) for o in outs))
            env.update(zip(eqn.outvars, outs))
        return [read(v) for v in jaxpr.outvars]

    out, aux = run(closed.jaxpr, closed.consts, jax.tree.leaves((params, x)))
    assert [t.dtype for t in scatters] == [np.int32, np.bool_, np.float32] and len(top_k) == 1
    tables = dict(zip(("token_of_slot", "filled", "gate_of_slot"), scatters))
    return np.asarray(out), float(aux), {**tables, "top_k": top_k[0]}


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_and_its_tables_match_jax(name):
    vals, params, x, kw = _case(name)
    want, want_aux, want_tables = jax_apply_moe_with_tables(vals, x, **kw)
    got, aux, tables = _moe().apply_moe(params, to_torch(x), return_tables=True, **kw)
    assert tables["cap"] == CASES[name][-1]
    assert tuple(got.shape) == x.shape and aux.dtype == torch.float32
    assert_close(got, want, rtol=OUT_TOL, atol=OUT_TOL, what="output")
    assert abs(float(aux) - want_aux) <= AUX_TOL
    for key in ("token_of_slot", "filled"):
        w = want_tables[key]
        np.testing.assert_array_equal(tables[key].numpy().astype(w.dtype), w, err_msg=key)
    gate, want_gate = tables["gate_of_slot"].numpy(), want_tables["gate_of_slot"]
    np.testing.assert_array_equal(gate != 0, want_gate != 0)
    np.testing.assert_allclose(gate, want_gate, rtol=GATE_RTOL, atol=0)

    # The dispatch on JAX's own routing: every table bit for bit.
    values, ids = want_tables["top_k"]
    jax_gates = _moe()._renormalise(torch.from_numpy(np.array(values)))
    again = _moe().dispatch_tables(torch.from_numpy(np.array(ids)).long(), jax_gates, tables["cap"],
                                   CASES[name][2])
    for key in ("token_of_slot", "filled", "gate_of_slot"):
        w = want_tables[key]
        np.testing.assert_array_equal(again[key].numpy().astype(w.dtype), w, err_msg=key)
    n_filled = int(tables["filled"].sum())
    n_assign = x.shape[0] * x.shape[1] * kw["top_k"]
    if name == "no drops":
        assert n_filled == n_assign
    elif name in ("drops", "half to even", "decode"):
        assert n_filled < n_assign  # the capacity drops some


def test_capacity_and_groups_follow_the_jax_expressions():
    moe = _moe()
    assert moe.capacity(8, 2, 8, 1.25) == 2  # round(2.5): half to even
    assert moe.capacity(24, 2, 8, 1.25) == 8  # round(7.5)
    assert moe.capacity(4, 8, 32, 1.25) == 1 and moe.capacity(4, 8, 384, 1.25) == 1
    assert moe.capacity(512, 8, 32, 1.25) == 160  # granite-moe, 16 groups of 4 x 2048
    assert moe.n_groups_for(21, 4) == 3 and moe.n_groups_for(4, 16) == 4
    assert moe.n_groups_for(8192, 16) == 16 and moe.n_groups_for(7, 16) == 7


@pytest.mark.parametrize("name", ["no drops", "drops", "shared expert"])
def test_gradient_matches_jax(name):
    import jax
    import jax.numpy as jnp

    vals, params, x, kw = _case(name)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = _jax_moe().apply_moe(p, xx, **kw)
        return jnp.sum(out * w) + 0.01 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, vals), jnp.asarray(x))
    flat = [t.clone().requires_grad_(True) for t in leaves(params)]
    xt = to_torch(x).requires_grad_(True)
    out, aux = _moe().apply_moe(unflatten(params, flat), xt, **kw)
    loss = torch.sum(out * to_torch(w)) + 0.01 * aux
    grads = torch.autograd.grad(loss, flat + [xt])
    want = jax.tree.leaves(jg_p) + [jg_x]  # sorted-key order, as leaves()
    assert len(want) == len(grads)
    for g, wv in zip(grads, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=0,
                                   atol=GRAD_TOL * max(float(np.abs(wv).max()), 1e-30))


@pytest.mark.parametrize("name", ["no drops", "shared expert"])
def test_moe_ref_matches_jax(name):
    vals, params, x, kw = _case(name)
    want = _jax_moe().moe_ref(vals, x, top_k=kw["top_k"])
    got = _moe().moe_ref(params, to_torch(x), top_k=kw["top_k"])
    assert_close(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    if name == "no drops":  # nothing dropped: the dispatch computes the dense reference
        out, _ = _moe().apply_moe(params, to_torch(x), **kw)
        assert_close(out, got, rtol=OUT_TOL, atol=OUT_TOL)


def test_dispatch_and_combine_functions_pass_gradcheck():
    """ToSlots and FromSlots in float64, on the tables of a dispatch with
    drops: each Function's backward is the other's forward."""
    moe = _moe()
    torch.manual_seed(0)
    g, tg, k, e, cap = 2, 6, 2, 4, 3
    # every token's first choice expert 0 (6 a group for 3 places: drops),
    # its second one of experts 1-3 (fewer than 3 each: empty slots)
    second = torch.randint(1, e, (g, tg, 1))
    ids = torch.cat([torch.zeros_like(second), second], dim=-1)
    gates = torch.rand(g, tg, k, dtype=torch.float64)
    tables = moe.dispatch_tables(ids, gates, cap, e)
    assert bool((tables["slot"] == e * cap).any()) and not bool(tables["filled"].all())
    gslot, _, token, filled = moe._expert_major(tables, cap, e, tg, k)
    t = g * tg
    inv = gslot.view(t, k)
    x = torch.randn(t, 3, dtype=torch.float64, requires_grad=True)
    y = torch.randn(e * g * cap, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: moe.ToSlots.apply(a, token, filled, inv), (x,))
    assert torch.autograd.gradcheck(lambda a: moe.FromSlots.apply(a, inv, token, filled), (y,))
    # the pair are transposes: <ToSlots(x), y> == <x, FromSlots(y)>
    lhs = torch.sum(moe.ToSlots.apply(x, token, filled, inv) * y)
    rhs = torch.sum(x * moe.FromSlots.apply(y, inv, token, filled))
    assert torch.allclose(lhs, rhs, rtol=1e-12, atol=1e-12)
