"""Port parity: models/layers (norms, rotary, MLPs, embed, unembed).

Each function of repro_torch.models.layers against repro.models.layers on
the same numpy inputs, at 1e-5 (fp32), and the bf16 embedding scale
bit for bit (the scale is rounded to the table's dtype on both sides).
"""

import numpy as np
import pytest
import torch

from test_torch_common import as_np, assert_close, rand, to_jax, to_torch

TOL = 1e-5


def _layers():
    from repro_torch.models import layers

    return layers


def test_rmsnorm_and_nonparametric_layernorm():
    from repro.models import layers as J

    rng = np.random.default_rng(0)
    x, scale = rand(rng, 2, 5, 64), rand(rng, 64)
    assert_close(_layers().rmsnorm({"scale": to_torch(scale)}, to_torch(x)),
                 J.rmsnorm({"scale": to_jax(scale)}, to_jax(x)), rtol=TOL, atol=TOL)
    assert_close(_layers().nonparametric_layernorm(to_torch(3 * x + 1)),
                 J.nonparametric_layernorm(to_jax(3 * x + 1)), rtol=TOL, atol=TOL)
    for kind, p in (("rms", {"scale": scale}), ("nonparametric", {})):
        assert_close(_layers().apply_norm(kind, {k: to_torch(v) for k, v in p.items()}, to_torch(x)),
                     J.apply_norm(kind, {k: to_jax(v) for k, v in p.items()}, to_jax(x)),
                     rtol=TOL, atol=TOL)


def test_norms_keep_the_input_dtype():
    x = torch.randn(3, 16).bfloat16()
    assert _layers().rmsnorm({"scale": torch.ones(16)}, x).dtype == torch.bfloat16
    assert _layers().nonparametric_layernorm(x).dtype == torch.bfloat16


@pytest.mark.parametrize("head_dim,base", [(16, 10000.0), (256, 10000.0), (128, 1e6)])
def test_rotary(head_dim, base):
    from repro.models import layers as J

    rng = np.random.default_rng(head_dim)
    pos = np.arange(37, dtype=np.int32)
    sin_t, cos_t = _layers().rotary_angles(to_torch(pos), head_dim, base)
    sin_j, cos_j = J.rotary_angles(to_jax(pos), head_dim, base)
    assert_close(sin_t, sin_j, rtol=TOL, atol=TOL)
    assert_close(cos_t, cos_j, rtol=TOL, atol=TOL)
    x = rand(rng, 2, 37, 3, head_dim)
    got = _layers().apply_rotary(to_torch(x), sin_t[:, None, :], cos_t[:, None, :])
    want = J.apply_rotary(to_jax(x), sin_j[:, None, :], cos_j[:, None, :])
    assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    from repro.models import layers as J

    rng = np.random.default_rng(1)
    d, f = 32, 48
    p = {"wi": rand(rng, d, f) / 6, "wo": rand(rng, f, d) / 7}
    if act != "gelu":
        p["wg"] = rand(rng, d, f) / 6
    x = rand(rng, 2, 5, d)
    got = _layers().apply_mlp({k: to_torch(v) for k, v in p.items()}, to_torch(x), act)
    want = J.apply_mlp({k: to_jax(v) for k, v in p.items()}, to_jax(x), act)
    assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scale_by_dim", [False, True])
def test_embed(scale_by_dim):
    from repro.models import layers as J

    rng = np.random.default_rng(2)
    table = rand(rng, 50, 64)
    tokens = rng.integers(0, 50, (3, 7))
    got = _layers().embed({"table": to_torch(table)}, to_torch(tokens), scale_by_dim)
    want = J.embed({"table": to_jax(table)}, to_jax(tokens.astype(np.int32)), scale_by_dim)
    assert_close(got, want, rtol=TOL, atol=TOL)


def test_embed_scale_rounds_in_the_table_dtype():
    """gemma's sqrt(d) scale in bf16 (45.25 for d = 2048): bit for bit."""
    import jax.numpy as jnp

    from repro.models import layers as J

    rng = np.random.default_rng(3)
    table = rand(rng, 20, 2048)
    tokens = rng.integers(0, 20, (2, 5))
    got = _layers().embed({"table": to_torch(table, torch.bfloat16)}, to_torch(tokens), True)
    want = J.embed({"table": to_jax(table).astype(jnp.bfloat16)},
                   to_jax(tokens.astype(np.int32)), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_is_fp32(dtype):
    """Tied unembedding: fp32 logits of the compute-dtype product."""
    import jax.numpy as jnp

    from repro.models import layers as J

    rng = np.random.default_rng(4)
    table, x = rand(rng, 40, 32), rand(rng, 2, 3, 32)
    got = _layers().unembed({"table": to_torch(table, getattr(torch, dtype))},
                            to_torch(x, getattr(torch, dtype)))
    want = J.unembed({"table": to_jax(table).astype(getattr(jnp, dtype))},
                     to_jax(x).astype(getattr(jnp, dtype)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 40)
    assert_close(got, want, rtol=TOL, atol=TOL)
