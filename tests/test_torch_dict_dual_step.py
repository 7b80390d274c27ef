"""Port parity: kernels/dict_dual_step.

The port's wrapper on CPU tensors (its plain version) against the JAX
wrapper running the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it, over the same DD_SHAPES sweep and tolerances; the wrapper's agent
batching, stride-0 and vector inputs, and input checks; and, on the card
only, the CUDA kernel against the plain version.
"""

import numpy as np
import pytest
import torch

from test_torch_common import (
    BF16_TOL, DD_G_ATOL, DD_G_RTOL, DD_Y_TOL, assert_close, rand, require_cuda,
    to_jax, to_torch, unit_cols,
)

DD_SHAPES = [
    # (M, K, B), aligned and not, as tests/test_kernels.py
    (128, 512, 128),
    (100, 49, 5),
    (96, 196, 1),
    (100, 196, 4),   # the paper's image-denoising geometry
    (257, 33, 17),
    (8, 1024, 256),
]


def _ops():
    from repro_torch.kernels.dict_dual_step import ops

    return ops


@pytest.mark.parametrize("m,k,b", DD_SHAPES)
@pytest.mark.parametrize("nonneg", [False, True])
def test_matches_pallas_interpret(m, k, b, nonneg):
    from repro.kernels.dict_dual_step.ops import dict_dual_step as jax_dd

    rng = np.random.default_rng(m * 1000 + k)
    W, nu = rand(rng, m, k), rand(rng, b, m)
    yj, gj = jax_dd(to_jax(W), to_jax(nu), gamma=0.1, delta=0.1, nonneg=nonneg, interpret=True)
    yt, gt = _ops().dict_dual_step(to_torch(W), to_torch(nu), gamma=0.1, delta=0.1,
                                   nonneg=nonneg)
    assert tuple(yt.shape) == (b, k) and tuple(gt.shape) == (b, m)
    assert_close(yt, yj, rtol=DD_Y_TOL, atol=DD_Y_TOL, what="y")
    assert_close(gt, gj, rtol=DD_G_RTOL, atol=DD_G_ATOL, what="g")


def test_bf16_matches_pallas_interpret():
    import jax.numpy as jnp

    from repro.kernels.dict_dual_step.ops import dict_dual_step as jax_dd

    rng = np.random.default_rng(0)
    W, nu = rand(rng, 64, 96), rand(rng, 16, 64)
    yj, gj = jax_dd(to_jax(W).astype(jnp.bfloat16), to_jax(nu).astype(jnp.bfloat16),
                    gamma=0.1, delta=0.1, interpret=True)
    yt, gt = _ops().dict_dual_step(to_torch(W, torch.bfloat16), to_torch(nu, torch.bfloat16),
                                   gamma=0.1, delta=0.1)
    assert yt.dtype == torch.bfloat16 and gt.dtype == torch.bfloat16
    assert_close(yt, yj, rtol=BF16_TOL, atol=BF16_TOL, what="y")
    assert_close(gt, gj, rtol=BF16_TOL, atol=5 * BF16_TOL, what="g")


def test_vector_input_matches_pallas_interpret():
    from repro.kernels.dict_dual_step.ops import dict_dual_step as jax_dd

    rng = np.random.default_rng(1)
    W, nu = rand(rng, 32, 48), rand(rng, 32)
    yj, gj = jax_dd(to_jax(W), to_jax(nu), gamma=0.05, delta=0.1, interpret=True)
    yt, gt = _ops().dict_dual_step(to_torch(W), to_torch(nu), gamma=0.05, delta=0.1)
    assert tuple(yt.shape) == (48,) and tuple(gt.shape) == (32,)
    assert_close(yt, yj, rtol=DD_Y_TOL, atol=DD_Y_TOL)
    assert_close(gt, gj, rtol=DD_G_RTOL, atol=DD_G_ATOL)


@pytest.mark.parametrize("nonneg", [False, True])
def test_agent_batch_equals_per_agent_loop_and_stride_zero(nonneg):
    ops = _ops()
    rng = np.random.default_rng(2)
    W, nu = to_torch(rand(rng, 3, 40, 24)), to_torch(rand(rng, 3, 6, 40))
    y, g = ops.dict_dual_step(W, nu, gamma=0.2, delta=0.3, nonneg=nonneg)
    assert tuple(y.shape) == (3, 6, 24) and tuple(g.shape) == (3, 6, 40)
    for a in range(3):
        ya, ga = ops.dict_dual_step(W[a], nu[a], gamma=0.2, delta=0.3, nonneg=nonneg)
        assert_close(y[a], ya, rtol=1e-6, atol=1e-6)
        assert_close(g[a], ga, rtol=1e-6, atol=1e-6)
    # one nu shared by every agent (agent stride 0), 2-D or explicitly expanded
    ys, gs = ops.dict_dual_step(W, nu[0], gamma=0.2, delta=0.3, nonneg=nonneg)
    ye, ge = ops.dict_dual_step(W, nu[0].expand(3, 6, 40), gamma=0.2, delta=0.3, nonneg=nonneg)
    for a in range(3):
        ya, ga = ops.dict_dual_step(W[a], nu[0], gamma=0.2, delta=0.3, nonneg=nonneg)
        assert_close(ys[a], ya, rtol=1e-6, atol=1e-6)
        assert_close(gs[a], ga, rtol=1e-6, atol=1e-6)
    assert torch.equal(ys, ye) and torch.equal(gs, ge)


def test_cpu_runs_plain_and_counts_no_launch():
    ops = _ops()
    from repro_torch.kernels.dict_dual_step.ref import dict_dual_step_ref

    before = ops.dict_dual_step.launches
    rng = np.random.default_rng(3)
    W, nu = to_torch(rand(rng, 2, 16, 8)), to_torch(rand(rng, 2, 4, 16))
    y, g = ops.dict_dual_step(W, nu, gamma=0.1, delta=0.2)
    yr, gr = dict_dual_step_ref(W, nu, gamma=0.1, delta=0.2)
    assert torch.equal(y, yr) and torch.equal(g, gr)
    assert ops.dict_dual_step.launches == before == 0


def test_rejects_what_the_kernel_does_not_take():
    ops = _ops()
    rng = np.random.default_rng(4)
    W, nu = to_torch(rand(rng, 2, 16, 8)), to_torch(rand(rng, 2, 4, 16))
    kw = dict(gamma=0.1, delta=0.2)
    with pytest.raises(TypeError):
        ops.dict_dual_step(W.double(), nu.double(), **kw)
    with pytest.raises(TypeError):
        ops.dict_dual_step(W, nu.bfloat16(), **kw)
    with pytest.raises(ValueError):
        ops.dict_dual_step(W, nu[:, :, :15], **kw)  # M mismatch
    with pytest.raises(ValueError):
        ops.dict_dual_step(W, nu[:1], **kw)  # agent count mismatch
    with pytest.raises(ValueError):
        ops.dict_dual_step(W.transpose(1, 2).contiguous().transpose(1, 2), nu, **kw)
    with pytest.raises(ValueError):
        ops.dict_dual_step(W, nu.transpose(1, 2).contiguous().transpose(1, 2), **kw)
    with pytest.raises(ValueError):
        ops.dict_dual_step(W[0, 0], nu, **kw)  # 1-D W


def _kernel_against_plain(W, nu, y_atol):
    """Launch on the card (agent-batched, then one nu at agent stride 0) and
    hold each result against the plain version."""
    ops = _ops()
    from repro_torch.kernels.dict_dual_step.ref import dict_dual_step_ref

    for nonneg in (False, True):
        before = ops.dict_dual_step.launches
        y, g = ops.dict_dual_step(W, nu, gamma=0.1, delta=0.1, nonneg=nonneg)
        torch.cuda.synchronize()
        assert ops.dict_dual_step.launches == before + 1
        yr, gr = dict_dual_step_ref(W, nu, gamma=0.1, delta=0.1, nonneg=nonneg)
        assert_close(y, yr, rtol=DD_Y_TOL, atol=y_atol)
        assert_close(g, gr, rtol=DD_G_RTOL, atol=DD_G_ATOL)
        ys, gs = ops.dict_dual_step(W, nu[0], gamma=0.1, delta=0.1, nonneg=nonneg)
        yr, gr = dict_dual_step_ref(W, nu[0].expand_as(nu), gamma=0.1, delta=0.1,
                                    nonneg=nonneg)
        assert_close(ys, yr, rtol=DD_Y_TOL, atol=y_atol)
        assert_close(gs, gr, rtol=DD_G_RTOL, atol=DD_G_ATOL)


# The two-pass kernel's tile edges: atom tiles of 256 (pass 1) and 32-atom
# stages (pass 2) cut by Kb = 127, 129 and the unaligned 33 (132-byte W
# rows: no 16-byte access), row tiles of 256 and 16-row stages cut by
# M = 63, 65, batch tiles of 16 cut by B = 1, 17 (and 256: 16 full tiles).
EDGE_SHAPES = [
    (63, 127, 1),
    (65, 129, 17),
    (65, 33, 256),
    (63, 33, 17),
    (300, 129, 16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,b", DD_SHAPES + EDGE_SHAPES)
def test_cuda_kernel_matches_plain(m, k, b):
    require_cuda()
    rng = np.random.default_rng(m + k + b)
    dev = torch.device("cuda")
    W = to_torch(rand(rng, 2, m, k)).to(dev)
    nu = to_torch(rand(rng, 2, b, m)).to(dev)
    _kernel_against_plain(W, nu, DD_Y_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2048, 16384])
def test_cuda_kernel_matches_plain_at_production_depth(k):
    """M = 8192 with unit-norm atoms, as on the main path.  The kernel and
    the plain product sum 8192 terms in other orders, so S differs by about
    1e-5 of its largest value and Y, whose slope is 1/delta, by about that
    over delta: y atol is 1e-4 ||S||_inf / delta (chip_smoke.py's rule)."""
    require_cuda()
    rng = np.random.default_rng(k)
    dev = torch.device("cuda")
    W = to_torch(unit_cols(rand(rng, 8192, k))).to(dev).expand(2, 8192, k).contiguous()
    nu = to_torch(rand(rng, 2, 16, 8192)).to(dev)
    s_inf = float(torch.matmul(nu, W).abs().max())
    _kernel_against_plain(W, nu, 1e-4 * s_inf / 0.1)


@pytest.mark.gpu
def test_cuda_kernel_bf16_and_vector():
    require_cuda()
    ops = _ops()
    from repro_torch.kernels.dict_dual_step.ref import dict_dual_step_ref

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    W = to_torch(rand(rng, 64, 96)).to(dev, torch.bfloat16)
    nu = to_torch(rand(rng, 16, 64)).to(dev, torch.bfloat16)
    y, g = ops.dict_dual_step(W, nu, gamma=0.1, delta=0.1)
    yr, gr = dict_dual_step_ref(W[None], nu[None], gamma=0.1, delta=0.1)
    assert_close(y, yr[0], rtol=BF16_TOL, atol=BF16_TOL)
    assert_close(g, gr[0], rtol=BF16_TOL, atol=5 * BF16_TOL)
    y, g = ops.dict_dual_step(W.float(), nu[0].float(), gamma=0.1, delta=0.1)
    assert tuple(y.shape) == (96,) and tuple(g.shape) == (64,)



@pytest.mark.gpu
@pytest.mark.parametrize("m,k,b", [(8192, 2048, 16), (65, 33, 17)])
def test_cuda_kernel_repeats_bit_for_bit(m, k, b):
    """Every output has one owner that sums in one fixed order: two launches
    on the same inputs give the same bits."""
    require_cuda()
    ops = _ops()
    rng = np.random.default_rng(m + k)
    dev = torch.device("cuda")
    W = to_torch(rand(rng, 2, m, k)).to(dev)
    nu = to_torch(rand(rng, 2, b, m)).to(dev)
    y1, g1 = ops.dict_dual_step(W, nu, gamma=0.05, delta=0.1)
    y2, g2 = ops.dict_dual_step(W, nu, gamma=0.05, delta=0.1)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)


@pytest.mark.gpu
def test_cuda_kernel_fills_the_card_at_the_main_shape():
    """At W (16, 8192, 16384), B = 16 each pass launches at least 128 CTAs
    (the card has 132 SMs)."""
    require_cuda()
    ops = _ops()
    assert ops.VARIANT == "two_pass"
    assert min(ops.ctas(16, 8192, 16384, 16)) >= 128
