"""Port parity: the Mamba2 (SSD) mixer (models/ssm.py) against the JAX one.

The chunked SSD against JAX's `_ssd_chunked` and against the step-by-step
`ssd_ref` at the JAX suite's 1e-3 (tests/test_models.py::
test_ssd_chunked_vs_sequential), over lengths that make the chunk halve
(24 under a chunk of 16 runs three chunks of 8; 17 runs chunks of 1); the
port's `ssd_ref` against JAX's and the final state against JAX's at 1e-4;
the init tree against JAX's `init_mamba2`; the block with its cache
(prompts shorter than the convolution included) and decode steps against
JAX's at 1e-4 in fp32; the block in bf16, params cast as the model casts
them (A_log through bf16), against JAX's in bf16.  Inputs cross as numpy
arrays made from seeds.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, rand, to_jax, to_torch

TOL = 1e-4
CHUNK_TOL = 1e-3  # tests/test_models.py::test_ssd_chunked_vs_sequential
D, N, P, EXPAND = 32, 8, 16, 2  # d_model, d_state, head_dim (d_inner 64: 4 heads)
B = 2


def _S():
    from repro_torch.models import ssm

    return ssm


def _to_torch_tree(tree, dtype=None):
    return {k: _to_torch_tree(v, dtype) if isinstance(v, dict)
            else to_torch(np.array(v, np.float32), dtype) for k, v in tree.items()}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _ssd_inputs(b, s, h, p, nst, seed):
    rng = np.random.default_rng(seed)
    x = rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(rand(rng, b, s, h))).astype(np.float32)  # softplus
    A = (-np.exp(rand(rng, h) * 0.3)).astype(np.float32)
    return x, dt, A, rand(rng, b, s, nst), rand(rng, b, s, nst)


@pytest.mark.parametrize("b,s,h,p,nst,chunk", [
    (2, 48, 2, 16, 8, 16),   # three whole chunks
    (1, 24, 3, 8, 4, 16),    # 24 % 16: chunks of 8
    (2, 40, 1, 4, 8, 16),    # chunks of 8
    (1, 17, 2, 8, 4, 16),    # a prime length: chunks of 1
    (3, 16, 4, 16, 8, 64),   # one chunk shorter than the chunk length
])
def test_ssd_chunked_matches_jax_and_the_sequential_ref(b, s, h, p, nst, chunk):
    from repro.models.ssm import _ssd_chunked as jax_chunked
    from repro.models.ssm import ssd_ref as jax_ref

    args = _ssd_inputs(b, s, h, p, nst, seed=s * 7 + h)
    got, S = _S()._ssd_chunked(*(to_torch(a) for a in args), chunk)
    want, jS = jax_chunked(*(to_jax(a) for a in args), chunk)
    assert tuple(got.shape) == (b, s, h, p) and tuple(S.shape) == (b, h, nst, p)
    assert got.dtype == S.dtype == torch.float32
    assert_close(got, want, rtol=CHUNK_TOL, atol=CHUNK_TOL, what="y vs JAX")
    assert_close(S, jS, rtol=TOL, atol=TOL, what="final state vs JAX")
    port_ref = _S().ssd_ref(*(to_torch(a) for a in args))
    assert_close(port_ref, jax_ref(*(to_jax(a) for a in args)), rtol=TOL, atol=TOL,
                 what="ssd_ref vs JAX")
    assert_close(got, port_ref, rtol=CHUNK_TOL, atol=CHUNK_TOL, what="chunked vs sequential")


@functools.lru_cache(maxsize=None)
def _jax_mixer(seed=3):
    import jax

    from repro.models.layers import split_tree
    from repro.models.ssm import init_mamba2

    vals, _ = split_tree(init_mamba2(jax.random.PRNGKey(seed), D, d_state=N, head_dim=P,
                                     expand=EXPAND))
    return vals


def test_init_mamba2_has_the_jax_tree():
    """Shapes and dtypes leaf for leaf, with and without a layer axis; the
    deterministic leaves (zeros, ones) equal JAX's, A_log = log(1 .. H)
    within an fp32 ulp (the two frameworks' log)."""
    jp = _jax_mixer()
    gen = torch.Generator().manual_seed(0)
    ours = _S().init_mamba2(gen, D, d_state=N, head_dim=P, expand=EXPAND)
    stacked = _S().init_mamba2(gen, D, d_state=N, head_dim=P, expand=EXPAND, lead=(3,))
    assert set(ours) == set(jp) == set(stacked)
    for name, w in jp.items():
        assert tuple(ours[name].shape) == np.shape(w), name
        assert tuple(stacked[name].shape) == (3, *np.shape(w)), name
        assert ours[name].dtype == torch.float32
    for name in ("conv_b", "dt_bias", "A_log", "D", "norm_scale"):  # A_log: an fp32 ulp
        for got in (ours[name], stacked[name][2]):
            np.testing.assert_allclose(got.numpy(), np.asarray(jp[name]), rtol=2e-7, atol=0,
                                       err_msg=name)
    assert tuple(ours["in_proj"].shape) == (D, 2 * EXPAND * D + 2 * N + EXPAND * D // P)


@pytest.mark.parametrize("s,chunk", [(24, 16), (32, 8), (2, 16), (1, 16)])
def test_mamba2_block_and_decode_match_jax(s, chunk):
    """The block's output and cache (conv_buf: the last raw rows, fewer than
    3 for a short prompt; S) at 1e-4, then four decode steps continuing
    from it (a short prompt's cache padded with zero rows, as the model's
    prefill leaves it), the cache updated in place."""
    import jax

    from repro.models import ssm as JS

    kw = dict(d_state=N, head_dim=P, expand=EXPAND)
    jp = _jax_mixer()
    tp = _to_torch_tree(jp)
    x = rand(np.random.default_rng(4 + s), B, s, D)
    xs = rand(np.random.default_rng(5), 4, B, 1, D)
    want, jcache = JS.mamba2_block(jp, to_jax(x), chunk=chunk, return_cache=True, **kw)
    got, state = _S().mamba2_block(tp, to_torch(x), chunk=chunk, return_cache=True, **kw)
    assert tuple(got.shape) == (B, s, D)
    assert_close(got, want, rtol=TOL, atol=TOL, what="block out")
    assert_close(_S().mamba2_block(tp, to_torch(x), chunk=chunk, **kw), got, rtol=0, atol=0)
    assert tuple(state["conv_buf"].shape) == (B, min(s, 3), EXPAND * D + 2 * N)
    for name in ("conv_buf", "S"):
        assert_close(state[name], jcache[name], rtol=TOL, atol=TOL, what=f"cache {name}")

    cache = _S().init_mamba2_cache(B, D, device="cpu", **kw)
    cache["conv_buf"][:, -state["conv_buf"].shape[1]:] = state["conv_buf"]
    cache["S"].copy_(state["S"])
    # A copy: JAX may alias a numpy buffer, which the port then updates in place.
    jcache = {"conv_buf": to_jax(cache["conv_buf"].numpy().copy()), "S": jcache["S"]}
    step = jax.jit(functools.partial(JS.mamba2_decode, **kw))
    for i in range(xs.shape[0]):
        jout, jcache = step(jp, to_jax(xs[i]), jcache)
        out, cache2 = _S().mamba2_decode(tp, to_torch(xs[i]), cache, **kw)
        assert cache2 is cache  # updated in place
        assert tuple(out.shape) == (B, 1, D)
        assert_close(out, jout, rtol=TOL, atol=TOL, what=f"decode {i}")
        for name in ("conv_buf", "S"):
            assert_close(cache[name], jcache[name], rtol=TOL, atol=TOL,
                         what=f"decode {i} {name}")


def test_decode_continues_the_block():
    """Prefill of S tokens then decode of token S equals the block over S + 1
    tokens at its last position (the conv buffer holds raw rows)."""
    kw = dict(d_state=N, head_dim=P, expand=EXPAND)
    tp = _to_torch_tree(_jax_mixer())
    x = to_torch(rand(np.random.default_rng(9), B, 13, D))
    full = _S().mamba2_block(tp, x, chunk=4, **kw)
    _, cache = _S().mamba2_block(tp, x[:, :12], chunk=4, return_cache=True, **kw)
    cache = _clone(cache)
    out, _ = _S().mamba2_decode(tp, x[:, 12:], cache, **kw)
    assert_close(out[:, 0], full[:, 12], rtol=TOL, atol=TOL)


def test_bf16_block_matches_jax_bf16():
    """Params cast to bf16 as both models' casts do (A_log = log(1 .. H)
    loses bits there, and both widen the rounded value), compute in bf16:
    the port's block against JAX's within a few bf16 ulps of the output's
    scale (both round the same ops to bf16; fp32 sums in other orders can
    flip a rounding)."""
    import jax.numpy as jnp

    from repro.models import ssm as JS

    kw = dict(d_state=N, head_dim=P, expand=EXPAND, chunk=8)
    jp = _jax_mixer()
    jbf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in jp.items()}
    tbf = _to_torch_tree(jp, torch.bfloat16)
    assert not torch.equal(tbf["A_log"].float(), to_torch(np.asarray(jp["A_log"])))
    x = rand(np.random.default_rng(11), B, 24, D)
    want = np.asarray(JS.mamba2_block(jbf, to_jax(x).astype(jnp.bfloat16), **kw), np.float32)
    got = _S().mamba2_block(tbf, to_torch(x, torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 4 * 2.0 ** -8 * scale, err / scale
