"""Port parity: the gradient of K3's recurrence (kernels/slstm_step/backward.py
and ops.SlstmSeq), backpropagation through time in plain PyTorch.

Held on the same numpy inputs against
  * `jax.vjp` of the JAX package's recurrence: the `lax.scan` of
    `_slstm_cell` that `slstm_block` runs, with the input projections
    given (dx_proj, dR, db), and `slstm_block` itself (the gradients of its
    params w_*, r_*, b_* and of x, through the port's `stack_gates`);
  * autograd through `ref.slstm_seq_ref` in fp64 (the exact gradient).
fp32 within FP32_TOL of each gradient's largest |value|.  bf16 inputs
(both sides widen them exactly and compute in fp32): the port rounds each
gradient to bf16 once, at the end, and is held to the exact gradient of
the same (bf16-valued) inputs within one bf16 ulp of the largest |value|
(BF16_ULP); JAX's scan adds each step's cotangent of the closed-over bf16
R into a bf16 sum (measured 2 ulps from the port at S 24), so against JAX
the bf16 rule is the suite's BF16_TOL.  The
shapes take S 1 and 2, a ragged batch (5 rows, one full group of K3's 4
and one row), H 1 and 4, and a strongly negative forget gate.  Also the
two facts the backward's design rests on (n_t >= 1 at every step; the
input-gate bias has no gradient), the refusal of a gradient for the final
(c, n, m), and, on the card only, the Function (K3 forward, the plain
backward) against the exact gradient.
"""

import numpy as np
import pytest
import torch

from test_torch_common import BF16_TOL, require_cuda, to_torch

FP32_TOL = 1e-5  # tests/test_moe_a2a.py's sLSTM tolerance
BF16_ULP = 2.0 ** -7  # one bf16 ulp at the largest |value|
CARD_TOL = 1e-3  # chip_smoke.py's SLSTM_GRAD_RTOL
# (B, S, D, H, forget-gate bias)
CASES = [
    (2, 24, 32, 4, 0.0),
    (5, 1, 16, 1, 0.0),    # S 1: dR is exactly 0 (h_{-1} = 0)
    (5, 2, 64, 4, 3.0),    # S 2, ragged B, the model's forget bias
    (3, 17, 48, 1, 3.0),   # H 1
    (2, 30, 32, 2, -8.0),  # a strongly negative forget gate: f_s ~ 3e-4
]
GATES = ("i", "f", "z", "o")


def _inputs(b, s, d, h, f_bias, seed=0):
    """x_proj (4, S, B, D), R (4, H, P, P) x min(0.2, P^-0.5), bias (4, D)
    x 0.1 with f_bias added to the forget gate's, the output cotangent
    (S, B, D)."""
    rng = np.random.default_rng(seed)
    p = d // h
    xp = rng.standard_normal((4, s, b, d)).astype(np.float32)
    R = (rng.standard_normal((4, h, p, p)) * min(0.2, p ** -0.5)).astype(np.float32)
    bias = (rng.standard_normal((4, d)) * 0.1).astype(np.float32)
    bias[1] += f_bias
    dh = rng.standard_normal((s, b, d)).astype(np.float32)
    return xp, R, bias, dh


def _jax_seq_vjp(xp, R, bias, dh, dtype):
    """(h, (dx_proj, dR, db)) of JAX's scan of `_slstm_cell` (the body of
    `slstm_block`, projections given), inputs cast to `dtype`."""
    import jax
    import jax.numpy as jnp

    from repro.models.xlstm import _slstm_cell

    n_heads = R.shape[1]

    def f(x_proj, r, b):
        _, _, batch, d = x_proj.shape
        params = {**{f"r_{g}": r[i] for i, g in enumerate(GATES)},
                  **{f"b_{g}": b[i] for i, g in enumerate(GATES)}}
        state0 = {"h": jnp.zeros((batch, d), jnp.float32), "c": jnp.zeros((batch, d), jnp.float32),
                  "n": jnp.zeros((batch, d), jnp.float32),
                  "m": jnp.full((batch, d), -1e30, jnp.float32)}

        def body(state, xp_t):
            return _slstm_cell(params, None, state, n_heads,
                               x_proj={g: xp_t[i] for i, g in enumerate(GATES)})

        _, hs = jax.lax.scan(body, state0, jnp.moveaxis(x_proj, 1, 0))
        return hs

    args = (jnp.asarray(xp, dtype), jnp.asarray(R, dtype), jnp.asarray(bias, jnp.float32))
    h, vjp = jax.vjp(f, *args)
    return np.asarray(h), [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dh))]


def _exact(xp, R, bias, dh):
    """The gradient by autograd through slstm_seq_ref in fp64."""
    from repro_torch.kernels.slstm_step.ref import slstm_seq_ref

    args = [torch.as_tensor(a).double().requires_grad_(True) for a in (xp, R, bias)]
    h, _ = slstm_seq_ref(*args)
    return torch.autograd.grad(h, args, torch.as_tensor(dh).double())


def _assert_grads(got, want, tol, names=("dx_proj", "dR", "db"), rounding=False):
    """Each gradient within tol of its largest |value|; with `rounding` a
    bf16 gradient also within bf16's unit roundoff (2^-8) of each element,
    its own rounding from the fp32 value the backward computed."""
    for name, g, w in zip(names, got, want):
        rtol = 2.0 ** -8 if rounding and g.dtype == torch.bfloat16 else 0.0
        g = g.detach().float().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol * scale, err_msg=name)


def _port_grads(xp, R, bias, dh, dtype=torch.float32):
    """(h, grads) through ops.slstm_seq under autograd (SlstmSeq)."""
    from repro_torch.kernels.slstm_step import ops

    args = [to_torch(xp).to(dtype).requires_grad_(True), to_torch(R).to(dtype).requires_grad_(True),
            to_torch(bias).requires_grad_(True)]
    h, _ = ops.slstm_seq(*args)
    return h, torch.autograd.grad(h, args, to_torch(dh))


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_jax_vjp_of_the_scan(case):
    xp, R, bias, dh = _inputs(*case)
    h, grads = _port_grads(xp, R, bias, dh)
    jh, jgrads = _jax_seq_vjp(xp, R, bias, dh, np.float32)
    np.testing.assert_allclose(h.detach().numpy(), jh, rtol=0, atol=FP32_TOL)
    _assert_grads(grads, jgrads, FP32_TOL)
    assert [g.dtype for g in grads] == [torch.float32] * 3


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_fp64_autograd(case):
    """slstm_backward itself (called directly) against the exact gradient."""
    from repro_torch.kernels.slstm_step.backward import slstm_backward
    from repro_torch.kernels.slstm_step.ref import slstm_seq_ref

    xp, R, bias, dh = _inputs(*case, seed=1)
    x_t, R_t, b_t = to_torch(xp), to_torch(R), to_torch(bias)
    h, _ = slstm_seq_ref(x_t, R_t, b_t)
    _assert_grads(slstm_backward(x_t, R_t, b_t, h, to_torch(dh)), _exact(xp, R, bias, dh),
                  FP32_TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]])
def test_bf16_inputs_match_jax_vjp(case):
    """bf16 x_proj and R (the model's compute dtype): the gradients come
    back in bf16 (b stays fp32, as the block's bias, and so does its
    gradient), one ulp of the largest |value| from the exact gradient of the
    bf16-valued inputs and within BF16_TOL of JAX's."""
    import jax.numpy as jnp

    xp, R, bias, dh = _inputs(*case, seed=2)
    h, grads = _port_grads(xp, R, bias, dh, torch.bfloat16)
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.bfloat16, torch.float32]
    xp16, R16 = (to_torch(a).bfloat16().float().numpy() for a in (xp, R))
    _assert_grads(grads, _exact(xp16, R16, bias, dh), BF16_ULP)
    _, jgrads = _jax_seq_vjp(xp, R, bias, dh, jnp.bfloat16)
    _assert_grads(grads, jgrads, BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gradient_matches_jax_slstm_block(dtype):
    """xlstm.slstm_block under autograd (stack_gates, then SlstmSeq) against
    jax.vjp of JAX's slstm_block: the gradients of x and of every w_*, r_*
    (stacked over the gates) and b_* (stacked)."""
    import jax
    import jax.numpy as jnp

    from repro.models import xlstm as JX
    from repro_torch.models import xlstm

    b, s, d, h = 3, 20, 64, 4
    rng = np.random.default_rng(3)
    p = d // h
    params = {}
    for g in GATES:
        params[f"w_{g}"] = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
        params[f"r_{g}"] = (rng.standard_normal((h, p, p)) * p ** -0.5).astype(np.float32)
        params[f"b_{g}"] = (rng.standard_normal(d) * 0.1 + (3.0 if g == "f" else 0.0)).astype(
            np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    out, vjp = jax.vjp(lambda pp, xx: JX.slstm_block(pp, xx, n_heads=h), jp,
                       jnp.asarray(x, jdt))
    jgp, jgx = vjp(jnp.asarray(dout, jdt))

    tp = {k: to_torch(v).to(tdt).requires_grad_(True) for k, v in params.items()}
    tx = to_torch(x).to(tdt).requires_grad_(True)
    tout = xlstm.slstm_block(tp, tx, n_heads=h)
    keys = sorted(tp)
    grads = torch.autograd.grad(tout, [tp[k] for k in keys] + [tx], to_torch(dout).to(tdt))
    tg = dict(zip(keys + ["x"], grads))
    jg = {**{k: np.asarray(v.astype(jnp.float32)) for k, v in jgp.items()},
          "x": np.asarray(jgx.astype(jnp.float32))}
    tol = FP32_TOL if dtype == "float32" else BF16_ULP
    got = [tg["x"]] + [torch.stack([tg[f"{k}_{g}"] for g in GATES]) for k in "wrb"]
    want = [jg["x"]] + [np.stack([jg[f"{k}_{g}"] for g in GATES]) for k in "wrb"]
    _assert_grads(got, want, tol, names=("x", "w", "r", "b"))
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(out.astype(jnp.float32)), rtol=0,
                               atol=FP32_TOL if dtype == "float32" else BF16_ULP)


def test_normalizer_stays_at_least_one_and_the_input_bias_has_no_gradient():
    """The two facts behind the backward's design (backward.py): n_t >= 1
    at every step, so the 1e-6 clamp never binds and h = o c / n does not
    depend on the stabilizer m; and so h is invariant under a constant
    shift of raw_i, which scales c and n alike: the exact gradient of the
    input gate's bias is zero (fp64), and the backward's is at rounding."""
    from repro_torch.kernels.slstm_step.backward import slstm_backward
    from repro_torch.kernels.slstm_step.ref import slstm_seq_ref

    xp, R, bias, dh = _inputs(3, 40, 32, 2, -8.0, seed=4)
    xp *= 4.0  # wide gate pre-activations: m switches between its two branches
    x64 = torch.as_tensor(xp).double()
    for t in range(1, 41):
        _, (_, n, _) = slstm_seq_ref(x64[:, :t], torch.as_tensor(R).double(),
                                     torch.as_tensor(bias).double())
        assert float(n.min()) >= 1.0 - 1e-12, t
    exact = _exact(xp, R, bias, dh)[2]
    assert float(exact[0].abs().max()) <= 1e-12 * float(exact.abs().max())
    x_t, R_t, b_t = to_torch(xp), to_torch(R), to_torch(bias)
    db = slstm_backward(x_t, R_t, b_t, slstm_seq_ref(x_t, R_t, b_t)[0], to_torch(dh))[2]
    assert float(db[0].abs().max()) <= FP32_TOL * float(db.abs().max())
    assert float(db[1:].abs().max()) > 0


@pytest.mark.parametrize("which", ["c", "n", "m"])
def test_a_gradient_for_the_final_state_raises(which):
    from repro_torch.kernels.slstm_step import ops

    xp, R, bias, _ = _inputs(2, 6, 16, 2, 0.0)
    x_t = to_torch(xp).requires_grad_(True)
    h, (c, n, m) = ops.slstm_seq(x_t, to_torch(R), to_torch(bias))
    state = {"c": c, "n": n, "m": m}[which]
    with pytest.raises(RuntimeError, match="gradient for h only"):
        torch.autograd.grad(state.sum(), [x_t])
    with pytest.raises(RuntimeError, match="gradient for h only"):
        (h.sum() + state.sum()).backward()  # nothing is dropped silently


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_the_card_matches_fp64_autograd(dtype):
    """SlstmSeq on the card (K3 forward, one launch each, the plain
    backward) against autograd through slstm_seq_ref in fp64 on the same
    inputs widened, within CARD_TOL of each gradient's largest |value|
    beyond a bf16 gradient's own rounding (chip_smoke.py's rule)."""
    require_cuda()
    from repro_torch.kernels.slstm_step import ops

    for case in CASES + [(4, 64, 2048, 4, 3.0)]:
        xp, R, bias, dh = _inputs(*case, seed=5)
        args = [to_torch(xp).cuda().to(dtype).requires_grad_(True),
                to_torch(R).cuda().to(dtype).requires_grad_(True),
                to_torch(bias).cuda().requires_grad_(True)]
        before = ops.slstm_seq.launches
        h, _ = ops.slstm_seq(*args)
        assert ops.slstm_seq.launches == before + 1
        grads = torch.autograd.grad(h, args, to_torch(dh).cuda())
        wide = [a.detach().double().cpu().numpy() for a in args]
        _assert_grads(grads, _exact(*wide, dh), CARD_TOL, rounding=True)
