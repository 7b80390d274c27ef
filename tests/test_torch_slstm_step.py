"""Port parity: kernels/slstm_step (K3, the sLSTM sequence recurrence).

The port's wrapper on CPU tensors (its plain version) against the JAX
Pallas kernel in interpret mode and the JAX oracle, at the shapes of
tests/test_moe_a2a.py's two sLSTM tests and their 1e-5; the final
(c, n, m), which the JAX kernel does not return, against the final state of
`xlstm.slstm_block(return_cache=True)`; `slstm_block_kernel` against
`xlstm.slstm_block`; the stable logsig; the wrapper's input checks; the
kernel's cluster plan (`ops.variant`) as its source states it; and, on the
card only, the CUDA kernel against the plain version, on the plan's edges
too, and the bits of a repeated launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.slstm_step.ops import EDGE_SHAPES
from test_torch_common import assert_close, rand, require_cuda, to_jax, to_torch

TOL = 1e-5  # tests/test_moe_a2a.py's sLSTM tolerance
# (B, S, D, H) of tests/test_moe_a2a.py::test_slstm_kernel_vs_xla_scan, and
# the oracle test's x_proj (4, 20, 2, 32) with R (4, 4, 8, 8).
BLOCK_SHAPES = [(2, 24, 32, 4), (1, 16, 64, 2), (3, 33, 16, 4)]
SEQ_SHAPES = BLOCK_SHAPES + [(2, 20, 32, 4)]
# The card test's shapes; the plan's edges are ops.EDGE_SHAPES.
CARD_SHAPES = SEQ_SHAPES + [(5, 40, 96, 3), (4, 64, 2048, 4), (9, 17, 1024, 8)]
MAIN = (4, 2048, 2048, 4)  # chip_smoke.SL_MAIN: one xlstm-1.3b sLSTM block
# (cs, bt, clusters, ctas) by the source's make_plan: cs the smallest power
# of two with 4 P (P / cs) <= 65536, 4 batch rows a cluster, H ceil(B / 4)
# clusters.
PLANS = {
    MAIN: (16, 4, 4, 64), (2, 24, 32, 4): (1, 4, 4, 4), (1, 16, 64, 2): (1, 4, 2, 2),
    (3, 33, 16, 4): (1, 4, 4, 4), (2, 20, 32, 4): (1, 4, 4, 4), (5, 40, 96, 3): (1, 4, 6, 6),
    (4, 64, 2048, 4): (16, 4, 4, 64), (9, 17, 1024, 8): (1, 4, 24, 24),
    (1, 1, 2048, 4): (16, 4, 4, 64), (2, 7, 1536, 4): (16, 4, 4, 64),
    (3, 2, 2048, 4): (16, 4, 4, 64),
    (5, 33, 2048, 4): (16, 4, 8, 128), (9, 2, 1024, 4): (4, 4, 12, 48),
    (1, 2, 256, 2): (1, 4, 2, 2), (5, 40, 512, 2): (4, 4, 4, 16),
}


def _ops():
    from repro_torch.kernels.slstm_step import ops

    return ops


def _seq_inputs(b, s, d, h, seed):
    """x_proj (4, S, B, D), R (4, H, P, P) x 0.2, bias (4, D) x 0.1, as the
    JAX oracle test scales them.  At P > 25 R is scaled by P^-0.5 instead,
    as the model initialises it: 0.2 would give the recurrence a gain of
    0.2 sqrt(P) > 1, where fp32 rounding differences grow step by step."""
    rng = np.random.default_rng(seed)
    p = d // h
    return (rand(rng, 4, s, b, d), (rand(rng, 4, h, p, p) * min(0.2, p ** -0.5)).astype(np.float32),
            (rand(rng, 4, d) * 0.1).astype(np.float32))


def _jax_slstm_params(d, h, seed):
    """JAX init_slstm params as numpy, the f bias random as well so that
    every gate's bias is exercised."""
    import jax

    from repro.models.layers import split_tree
    from repro.models.xlstm import init_slstm

    ps, _ = split_tree(init_slstm(jax.random.PRNGKey(seed), d, h))
    ps = {k: np.asarray(v) for k, v in ps.items()}
    ps["b_f"] = ps["b_f"] + (rand(np.random.default_rng(seed), d) * 0.5).astype(np.float32)
    return ps


@pytest.mark.parametrize("b,s,d,h", SEQ_SHAPES)
def test_plain_matches_jax_pallas_interpret_and_oracle(b, s, d, h):
    from repro.kernels.slstm_step.kernel import slstm_seq_pallas
    from repro.kernels.slstm_step.ref import slstm_seq_ref as jax_ref

    xp, R, bias = _seq_inputs(b, s, d, h, seed=s * 10 + d)
    hs, (c, n, m) = _ops().slstm_seq(to_torch(xp), to_torch(R), to_torch(bias))
    assert tuple(hs.shape) == (s, b, d) and hs.dtype == torch.float32
    for t in (c, n, m):
        assert tuple(t.shape) == (b, d) and t.dtype == torch.float32
    assert_close(hs, slstm_seq_pallas(to_jax(xp), to_jax(R), to_jax(bias), interpret=True),
                 rtol=TOL, atol=TOL, what="vs the Pallas kernel (interpret)")
    assert_close(hs, jax_ref(to_jax(xp), to_jax(R), to_jax(bias)), rtol=TOL, atol=TOL,
                 what="vs the JAX oracle")


@pytest.mark.parametrize("b,s,d,h", BLOCK_SHAPES)
def test_final_state_matches_jax_slstm_block(b, s, d, h):
    """slstm_seq on x_proj = x @ w_g gives JAX slstm_block's final state."""
    from repro.models.xlstm import slstm_block as jax_block

    from repro_torch.kernels.slstm_step.ref import GATES

    ps = _jax_slstm_params(d, h, seed=b + s)
    x = rand(np.random.default_rng(s), b, s, d)
    _, final = jax_block({k: to_jax(v) for k, v in ps.items()}, to_jax(x), n_heads=h,
                         return_cache=True)
    xp = np.stack([np.swapaxes(x @ ps[f"w_{g}"], 0, 1) for g in GATES])
    R = np.stack([ps[f"r_{g}"] for g in GATES])
    bias = np.stack([ps[f"b_{g}"] for g in GATES])
    hs, (c, n, m) = _ops().slstm_seq(to_torch(xp), to_torch(R), to_torch(bias))
    for name, got in (("h", hs[-1]), ("c", c), ("n", n), ("m", m)):
        assert_close(got, final[name], rtol=TOL, atol=TOL, what=f"final {name}")


@pytest.mark.parametrize("b,s,d,h", BLOCK_SHAPES)
def test_block_kernel_matches_jax_slstm_block(b, s, d, h):
    """tests/test_moe_a2a.py::test_slstm_kernel_vs_xla_scan, the port's
    slstm_block_kernel against both JAX paths."""
    from repro.kernels.slstm_step.ops import slstm_block_kernel as jax_block_kernel
    from repro.models.xlstm import slstm_block as jax_block

    ps = _jax_slstm_params(d, h, seed=0)
    x = rand(np.random.default_rng(1), b, s, d)
    jps = {k: to_jax(v) for k, v in ps.items()}
    got = _ops().slstm_block_kernel({k: to_torch(v) for k, v in ps.items()}, to_torch(x),
                                    n_heads=h)
    assert tuple(got.shape) == (b, s, d) and got.dtype == torch.float32
    assert_close(got, jax_block(jps, to_jax(x), n_heads=h), rtol=TOL, atol=TOL,
                 what="vs xlstm.slstm_block")
    assert_close(got, jax_block_kernel(jps, to_jax(x), n_heads=h, interpret=True),
                 rtol=TOL, atol=TOL, what="vs the JAX slstm_block_kernel (interpret)")


def test_strongly_negative_forget_gate_stays_finite():
    """logsig(-200) is -200 with the stable form; log(sigmoid(-200)) is -inf
    in fp32, which would make f_s NaN once m is finite."""
    from repro.kernels.slstm_step.ref import slstm_seq_ref as jax_ref

    xp, R, bias = _seq_inputs(2, 6, 16, 2, seed=3)
    xp[1] -= 200.0
    hs, state = _ops().slstm_seq(to_torch(xp), to_torch(R), to_torch(bias))
    assert torch.isfinite(hs).all() and all(torch.isfinite(t).all() for t in state)
    assert_close(hs, jax_ref(to_jax(xp), to_jax(R), to_jax(bias)), rtol=TOL, atol=TOL)


def test_input_checks():
    ops = _ops()
    xp, R, bias = (to_torch(a) for a in _seq_inputs(2, 5, 16, 2, seed=0))
    with pytest.raises(ValueError, match="x_proj"):
        ops.slstm_seq(xp[:3], R, bias)
    with pytest.raises(ValueError, match="H x P"):
        ops.slstm_seq(xp, R[:, :1], bias)
    with pytest.raises(ValueError, match="b must be"):
        ops.slstm_seq(xp, R, bias[:, :8])
    with pytest.raises(TypeError):
        ops.slstm_seq(xp.bfloat16(), R, bias)
    with pytest.raises(TypeError):
        ops.slstm_seq(xp.double(), R.double(), bias)
    with pytest.raises(ValueError, match="empty"):
        ops.slstm_seq(xp[:, :0], R, bias)
    with pytest.raises(ValueError, match="heads"):
        ops.slstm_block_kernel({f"{k}_{g}": t for g in "ifzo" for k, t in
                                (("w", torch.zeros(16, 16)), ("r", R[0]), ("b", bias[0]))},
                               torch.zeros(1, 3, 16), n_heads=4)


@pytest.mark.parametrize("shape", sorted(PLANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_plan_follows_the_source_rule(shape, dtype):
    b, _, d, h = shape
    kind, plan = _ops().variant(dtype, b, d // h, h)
    assert kind == "cluster"
    assert (plan["cs"], plan["bt"], plan["clusters"], plan["ctas"]) == PLANS[shape]


def test_variant_plan_at_the_main_shape():
    """256 threads of 8 lanes per column (32 columns a CTA), 16 groups of 4
    inputs a lane; shared memory: two mbarriers (16 bytes), the h double
    buffer and the double-buffered stage, and in fp32 the lower halves of R
    (128 KB)."""
    ops = _ops()
    b, _, d, h = MAIN
    for dtype, smem in ((torch.bfloat16, 16 + 4 * (2 * 4 * 512 + 2 * 4 * 32)),
                        (torch.float32, 16 + 256 * 16 * 32 + 4 * (2 * 4 * 512 + 2 * 4 * 32))):
        plan = ops.plan(dtype, b, d // h, h)
        assert (plan["threads"], plan["ks"], plan["nj"], plan["smem"]) == (256, 8, 16, smem)
    assert ops.variant(torch.bfloat16, 1, 512) == ("cluster", ops.plan(torch.bfloat16, 1, 512, 1))


@pytest.mark.parametrize("p", [6, 132, 260, 1024])
def test_plan_refuses_head_dims_without_one(p):
    with pytest.raises(ValueError, match="P="):
        _ops().plan(torch.bfloat16, 4, p, 2)


def test_bf16_inputs_widen_like_fp32():
    """On the CPU, bf16 x_proj and R give what their fp32 widening gives:
    the recurrence widens its inputs and runs in fp32."""
    xp, R, bias = (to_torch(a) for a in _seq_inputs(2, 9, 32, 4, seed=5))
    xb, Rb = xp.bfloat16(), R.bfloat16()
    hb, sb = _ops().slstm_seq(xb, Rb, bias.bfloat16())
    hf, sf = _ops().slstm_seq(xb.float(), Rb.float(), bias.bfloat16().float())
    assert hb.dtype == torch.float32
    assert torch.equal(hb, hf) and all(torch.equal(a, b) for a, b in zip(sb, sf))


# ---------------------------------------------------------------------------
# On the card only
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    require_cuda()
    from repro_torch.kernels.slstm_step.ref import slstm_seq_ref

    ops = _ops()
    dev = torch.device("cuda")
    for (b, s, d, h) in CARD_SHAPES:
        xp, R, bias = (to_torch(a).to(dev) for a in _seq_inputs(b, s, d, h, seed=b + s + d))
        before = ops.slstm_seq.launches
        hs, state = ops.slstm_seq(xp, R, bias)
        assert ops.slstm_seq.launches == before + 1
        want, want_state = slstm_seq_ref(xp, R, bias)
        torch.cuda.synchronize()
        assert_close(hs, want, rtol=TOL, atol=TOL, what=f"h {(b, s, d, h)}")
        for name, got, ref in zip("cnm", state, want_state):
            assert_close(got, ref, rtol=TOL, atol=TOL, what=f"{name} {(b, s, d, h)}")
    # bf16 inputs: both widen them, so fp32 agreement holds.
    xp, R, bias = (to_torch(a).to(dev) for a in _seq_inputs(4, 48, 2048, 4, seed=7))
    hs, _ = ops.slstm_seq(xp.bfloat16(), R.bfloat16(), bias)
    want, _ = slstm_seq_ref(xp.bfloat16(), R.bfloat16(), bias)
    assert_close(hs, want, rtol=TOL, atol=TOL, what="bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_the_plan_edges(dtype):
    """Clusters of 16, 4 and 1 CTAs, ragged batch groups, S = 1 and 2, the
    launch's plan as ops.variant states it."""
    require_cuda()
    from repro_torch.kernels.slstm_step.ref import slstm_seq_ref

    ops = _ops()
    for (b, s, d, h) in EDGE_SHAPES:
        got = ops.library_plan(dtype, b, d // h, h)
        assert got["max_active_clusters"] >= 1
        assert {k: got[k] for k in ops.plan(dtype, b, d // h, h)} == ops.plan(dtype, b, d // h, h)
        xp, R, bias = (to_torch(a).cuda() for a in _seq_inputs(b, s, d, h, seed=b * s + d))
        xp, R = xp.to(dtype), R.to(dtype)
        hs, state = ops.slstm_seq(xp, R, bias)
        want, want_state = slstm_seq_ref(xp, R, bias)
        torch.cuda.synchronize()
        assert_close(hs, want, rtol=TOL, atol=TOL, what=f"h {(b, s, d, h)} {dtype}")
        for name, got_t, ref_t in zip("cnm", state, want_state):
            assert_close(got_t, ref_t, rtol=TOL, atol=TOL, what=f"{name} {(b, s, d, h)} {dtype}")


@pytest.mark.gpu
def test_repeated_launch_is_bit_identical():
    """The sums run in a fixed order (each lane's inputs, then a fixed
    shuffle tree), so a second launch on the same inputs gives the same bits."""
    require_cuda()
    ops = _ops()
    for (b, s, d, h) in [(4, 64, 2048, 4), (9, 17, 1024, 8)]:
        xp, R, bias = (to_torch(a).cuda() for a in _seq_inputs(b, s, d, h, seed=11))
        first = ops.slstm_seq(xp.bfloat16(), R.bfloat16(), bias)
        second = ops.slstm_seq(xp.bfloat16(), R.bfloat16(), bias)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0])
        assert all(torch.equal(u, v) for u, v in zip(first[1], second[1]))
