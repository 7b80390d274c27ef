"""Port: the gradient through K2's wrapper, and through K3's.

`ops.flash_attention` runs through the `FlashAttention` autograd Function
when grad flows (on the CPU its forward is K2's plain version, as on the
card it is K2), and its backward is `backward.attention_backward`.  Held
against `jax.vjp` of the JAX package's training attention
(`_blockwise_attention`, the XLA scan JAX differentiates, and
`_dense_attention`) on the same numpy q, k, v and output cotangent: GQA,
causal and not, ragged S, T > S (queries at positions T - S .. T - 1, K2's
bottom-right alignment); fp32 within 1e-5, bf16 within BF16_TOL (5e-2,
rtol and atol x the gradient's largest |value|: JAX rounds the probability
cotangent to bf16 where the port keeps fp32).  Without grad the wrapper's
path is the bare forward.  `slstm_seq` under grad gives its inputs the
gradient of h (tests/test_torch_slstm_grad.py holds its values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import BF16_TOL, as_np, to_torch

FP32_TOL = 1e-5
# (B, Hq, Hkv, S, T, D, causal)
CASES = [
    (2, 4, 2, 48, 48, 16, True),    # GQA, causal
    (1, 2, 2, 40, 40, 32, False),   # MHA, not causal
    (2, 4, 1, 37, 37, 16, True),    # MQA, ragged S
    (1, 4, 2, 20, 52, 16, True),    # T > S, causal
    (2, 2, 1, 13, 29, 8, False),    # T > S, not causal
    (1, 4, 2, 40, 40, 96, True),    # phi-3-vision's head dim, causal, GQA
    (2, 2, 2, 33, 33, 80, False),   # hubert's head dim, not causal, ragged S
]


def _inputs(case, seed=0):
    b, hq, hkv, s, t, d, _ = case
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return f(b, hq, s, d), f(b, hkv, t, d), f(b, hkv, t, d), f(b, hq, s, d)


def _jax_grads(q, k, v, do, causal, impl, dtype):
    """jax.vjp of the JAX attention in its (B, S, H, D) layout."""
    from repro.models import attention as A

    s, t = q.shape[2], k.shape[2]
    q_pos = jnp.arange(s, dtype=jnp.int32) + (t - s)
    k_pos = jnp.arange(t, dtype=jnp.int32)

    def f(qq, kk, vv):
        if impl == "blockwise":
            return A._blockwise_attention(qq, kk, vv, causal=causal, q_pos=q_pos, k_pos=k_pos,
                                          block=16)
        return A._dense_attention(qq, kk, vv, causal=causal, q_pos=q_pos, k_pos=k_pos)

    bshd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), dtype)  # noqa: E731
    out, vjp = jax.vjp(f, bshd(q), bshd(k), bshd(v))
    grads = vjp(bshd(do).astype(out.dtype))
    return [np.asarray(g, np.float32).transpose(0, 2, 1, 3) for g in grads]


def _port_grads(q, k, v, do, causal, dtype):
    from repro_torch.kernels.flash_attention import ops

    qt, kt, vt = (to_torch(a).to(dtype).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, (qt, kt, vt), to_torch(do).to(dtype))
    assert all(g.dtype == dtype for g in grads)
    return [as_np(g) for g in grads]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(scale, 1.0), err_msg=what)


@pytest.mark.parametrize("impl", ["blockwise", "dense"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_fp32_gradient_matches_jax_vjp(case, impl):
    q, k, v, do = _inputs(case)
    causal = case[-1]
    want = _jax_grads(q, k, v, do, causal, impl, jnp.float32)
    got = _port_grads(q, k, v, do, causal, torch.float32)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, FP32_TOL, f"d{name}")


BF16_CASES = CASES[:2] + CASES[3:4] + CASES[5:]


@pytest.mark.parametrize("case", BF16_CASES, ids=[str(c) for c in BF16_CASES])
def test_bf16_gradient_matches_jax_vjp(case):
    q, k, v, do = _inputs(case, seed=1)
    causal = case[-1]
    want = _jax_grads(q, k, v, do, causal, "blockwise", jnp.bfloat16)
    got = _port_grads(q, k, v, do, causal, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, BF16_TOL, f"d{name}")


def test_chunked_backward_equals_one_chunk(monkeypatch):
    """Row chunks (each multiplying only the keys it sees under the causal
    mask) give the one-chunk result within fp32 rounding."""
    from repro_torch.kernels.flash_attention import backward

    case = (2, 4, 2, 50, 70, 16, True)
    q, k, v, do = (to_torch(a) for a in _inputs(case, seed=2))
    whole = backward.attention_backward(q, k, v, do, causal=True, scale=16 ** -0.5)
    monkeypatch.setattr(backward, "CHUNK_BYTES", 4 * 2 * 4 * 70 * 7)  # 7 rows a chunk
    assert backward.chunk_rows(2, 4, 50, 70) == 7
    chunked = backward.attention_backward(q, k, v, do, causal=True, scale=16 ** -0.5)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the flops it counts: 5 products over the (row, key) pairs the chunks see
    pairs = sum(min(7, 50 - r0) * min(70, min(50, r0 + 7) + 20) for r0 in range(0, 50, 7))
    assert backward.backward_flops(2, 4, 50, 70, 16, True) == 5 * 2 * 16 * 2 * 4 * pairs


@pytest.mark.parametrize("common", [0.0, 10.0])
def test_backward_stays_exact_where_keys_share_a_common_part(common):
    """bf16 q, k, v sharing a common part of `common` times a random row
    (as the deep layers of a random-weight stack do): dq, dk and dv within
    1e-2 of the fp64 gradient, relative to its largest |value|.  The
    softmax's D is summed from the chunk's P and dP; FlashAttention-2's
    rowsum(dO * O) from the bf16 output is 0.43 off in dq at 10."""
    from repro_torch.kernels.flash_attention import backward

    rng = np.random.default_rng(3)
    b, h, s, d = 1, 4, 256, 80
    base = rng.standard_normal((3, d))
    q, k, v = (to_torch(rng.standard_normal((b, h, s, d)) + common * base[i]).bfloat16()
               for i in range(3))
    do = to_torch(rng.standard_normal((b, h, s, d))).bfloat16()
    got = backward.attention_backward(q, k, v, do, causal=False, scale=d ** -0.5)
    q64, k64, v64 = (x.double().requires_grad_(True) for x in (q, k, v))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * d ** -0.5, dim=-1) @ v64
    want = torch.autograd.grad(out, (q64, k64, v64), do.double())
    for name, g, w in zip("qkv", got, want):
        err = float((g.double() - w).abs().max() / w.abs().max())
        assert err <= 1e-2, (name, err)


def test_no_grad_path_is_the_bare_forward():
    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v, _ = (to_torch(a) for a in _inputs(CASES[0]))
    q.requires_grad_(True)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    torch.testing.assert_close(out, ref.attention_ref(q.detach(), k, v, causal=True),
                               rtol=0, atol=0)
    out = ops.flash_attention(q.detach(), k, v, causal=True)  # nothing requires grad
    assert out.grad_fn is None


def test_model_gradient_reaches_every_attention_projection():
    """loss.backward() through the port's forward gives wq, wk and wv of
    every layer a nonzero gradient (the fault the Function repairs lost it on
    the card, where K2's output was outside autograd)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model

    cfg = get_smoke_config("olmo_1b")
    params = model.init(cfg, 0, "cpu")
    for t in params["layers"]["attn"].values():
        t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    loss, _ = model.loss_fn(cfg, params, {"tokens": toks})
    loss.backward()
    for name in ("wq", "wk", "wv"):
        g = params["layers"]["attn"][name].grad
        assert g is not None
        assert all(float(g[i].abs().max()) > 0 for i in range(cfg.n_layers)), name


@pytest.mark.parametrize("which", ["x_proj", "R", "b"])
def test_slstm_seq_raises_under_grad(which):
    """slstm_seq no longer raises under grad: the gradient of h reaches the
    one input that requires it (through `SlstmSeq`, with the plain
    version's forward on the CPU) and no other, and serving under no_grad
    is unchanged, the bare forward with the same bits."""
    from repro_torch.kernels.slstm_step import ops, ref

    rng = np.random.default_rng(0)
    x_proj = to_torch(rng.standard_normal((4, 6, 2, 8)).astype(np.float32))
    R = to_torch(rng.standard_normal((4, 2, 4, 4)).astype(np.float32) * 0.5)
    b = to_torch(rng.standard_normal((4, 8)).astype(np.float32))
    args = {"x_proj": x_proj, "R": R, "b": b}
    args[which].requires_grad_(True)
    h, _ = ops.slstm_seq(**args)
    assert h.grad_fn is not None
    (g,) = torch.autograd.grad(h.sum(), [args[which]])
    assert g.shape == args[which].shape and float(g.abs().max()) > 0
    assert all(t.grad is None for t in args.values())
    with torch.no_grad():
        h0, _ = ops.slstm_seq(**args)  # serving is unchanged
    assert h0.grad_fn is None
    torch.testing.assert_close(h0, ref.slstm_seq_ref(x_proj, R, b)[0], rtol=0, atol=0)
    torch.testing.assert_close(h.detach(), h0, rtol=0, atol=0)
