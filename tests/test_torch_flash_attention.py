"""Port parity: kernels/flash_attention.

The port's wrapper on CPU tensors (its plain version) against the JAX
reference `attention_ref` and the JAX wrapper running the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it, over the same FA_SHAPES
sweep and tolerances (2e-4 fp32, 5e-2 bf16); `flash_decode` against the
JAX one (1e-4); the wrapper's input checks; and, on the card only, the CUDA
kernel against the plain version.
"""

import numpy as np
import pytest
import torch

from test_torch_common import (BF16_TOL, assert_bf16_close, assert_close, rand, require_cuda,
                               to_jax, to_torch)

FA_TOL = 2e-4  # tests/test_kernels.py's flash-attention sweep
DECODE_TOL = 1e-4

FA_SHAPES = [
    # (B, Hq, Hkv, S, T, D), as tests/test_kernels.py
    (1, 4, 4, 128, 128, 32),
    (2, 8, 2, 128, 128, 64),   # GQA 4:1
    (1, 4, 1, 256, 256, 32),   # MQA
    (2, 4, 4, 100, 100, 32),   # non-aligned seq
    (1, 2, 2, 64, 192, 32),    # cross: T > S (decode-history geometry)
]
# The kernel's other head dims (smoke configs 16, olmo/granite/qwen3 128,
# gemma 256), ragged, MQA and GQA among them.
GPU_SHAPES = FA_SHAPES + [
    (1, 4, 1, 77, 77, 16),
    (2, 8, 2, 130, 200, 128),
    (2, 8, 1, 200, 200, 256),
]


def _ops():
    from repro_torch.kernels.flash_attention import ops

    return ops


def _qkv(shape, seed):
    b, hq, hkv, s, t, d = shape
    rng = np.random.default_rng(seed)
    return rand(rng, b, hq, s, d), rand(rng, b, hkv, t, d), rand(rng, b, hkv, t, d)


@pytest.mark.parametrize("b,hq,hkv,s,t,d", FA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_ref_and_pallas_interpret(b, hq, hkv, s, t, d, causal):
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref

    q, k, v = _qkv((b, hq, hkv, s, t, d), s * 7 + t)
    got = _ops().flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal)
    assert tuple(got.shape) == (b, hq, s, d) and got.dtype == torch.float32
    assert_close(got, jax_ref(to_jax(q), to_jax(k), to_jax(v), causal=causal),
                 rtol=FA_TOL, atol=FA_TOL, what="vs attention_ref")
    assert_close(got, jax_fa(to_jax(q), to_jax(k), to_jax(v), causal=causal, interpret=True),
                 rtol=FA_TOL, atol=FA_TOL, what="vs the Pallas kernel")


def test_bf16_matches_pallas_interpret():
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jax_fa

    q, k, v = _qkv((1, 4, 4, 128, 128, 32), 0)
    want = jax_fa(*(to_jax(x).astype(jnp.bfloat16) for x in (q, k, v)), causal=True,
                  interpret=True)
    got = _ops().flash_attention(*(to_torch(x, torch.bfloat16) for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_scale_and_strided_layout():
    """An explicit scale, and (B, S, H, D) tensors viewed as (B, H, S, D)."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref

    q, k, v = _qkv((2, 4, 2, 40, 40, 16), 3)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    got = _ops().flash_attention(qt, kt, vt, causal=True, scale=0.3)
    assert_close(got, jax_ref(to_jax(q), to_jax(k), to_jax(v), causal=True, scale=0.3),
                 rtol=FA_TOL, atol=FA_TOL)


def test_flash_decode_lengths_match_jax():
    """flash_decode with per-sequence valid lengths, against the JAX one and
    against attention over each valid prefix."""
    from repro.kernels.flash_attention.ops import flash_decode as jax_decode
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref

    rng = np.random.default_rng(0)
    b, hq, hkv, t, d = 3, 8, 4, 64, 32
    q, k, v = rand(rng, b, hq, 1, d), rand(rng, b, hkv, t, d), rand(rng, b, hkv, t, d)
    lengths = np.asarray([5, 32, 64], np.int32)
    got = _ops().flash_decode(to_torch(q), to_torch(k), to_torch(v), length=to_torch(lengths))
    assert_close(got, jax_decode(to_jax(q), to_jax(k), to_jax(v), length=to_jax(lengths)),
                 rtol=DECODE_TOL, atol=DECODE_TOL)
    for i, n in enumerate(lengths):
        ref = jax_ref(to_jax(q[i:i + 1]), to_jax(k[i:i + 1, :, :n]), to_jax(v[i:i + 1, :, :n]),
                      causal=False)
        assert_close(got[i], ref[0], rtol=DECODE_TOL, atol=DECODE_TOL)
    full = _ops().flash_decode(to_torch(q), to_torch(k), to_torch(v))
    assert_close(full, jax_decode(to_jax(q), to_jax(k), to_jax(v)),
                 rtol=DECODE_TOL, atol=DECODE_TOL)


def test_causal_needs_t_at_least_s():
    q, k, v = _qkv((1, 2, 2, 64, 32, 16), 0)
    with pytest.raises(ValueError, match="T >= S"):
        _ops().flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=True)
    out = _ops().flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=False)
    assert tuple(out.shape) == (1, 2, 64, 16)


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "mixed", "empty", "kv"])
def test_rejects_bad_inputs(bad):
    q, k, v = (to_torch(x) for x in _qkv((1, 4, 2, 8, 8, 16), 0))
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        q = torch.zeros(1, 3, 8, 16)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        q = q.bfloat16()
    elif bad == "empty":
        q = q[:, :, :0]
    elif bad == "kv":
        v = v[:, :, :4]
    with pytest.raises((ValueError, TypeError)):
        _ops().flash_attention(q, k, v, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,t,d", GPU_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_the_card(b, hq, hkv, s, t, d, causal):
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    q, k, v = (to_torch(x).cuda() for x in _qkv((b, hq, hkv, s, t, d), s + t + d))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert_close(got, attention_ref(q, k, v, causal=causal), rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 256])
def test_kernel_bf16_and_strided_on_the_card(d):
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _qkv((2, 8, 1, 150, 150, d), d)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).cuda().bfloat16().transpose(1, 2)
                  for x in (q, k, v))
    got = _ops().flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16 and got.stride() == qt.stride()
    assert_bf16_close(got, attention_ref(qt, kt, vt, causal=True))
    with pytest.raises(ValueError, match="head_dim"):
        _ops().flash_attention(*(torch.zeros(1, 2, 8, 48, device="cuda") for _ in range(3)))
