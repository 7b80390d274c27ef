"""Port parity: kernels/flash_attention.

The port's wrapper on CPU tensors (its plain version) against the JAX
reference `attention_ref` and the JAX wrapper running the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it, over the same FA_SHAPES
sweep and tolerances (2e-4 fp32, 5e-2 bf16); `flash_decode` against the
JAX one (1e-4); head dims 112 (kimi-k2's), 96 (phi-3-vision's) and 80
(hubert-xlarge's) against the Pallas kernel; the wrapper's input checks;
and, on the card only, the CUDA kernel against the plain version.
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


# kimi-k2's head dim, which the Pallas kernel takes like any other; GQA,
# ragged S, T > S.
D112_SHAPES = [(1, 8, 2, 128, 128, 112), (2, 4, 1, 100, 160, 112)]


@pytest.mark.parametrize("b,hq,hkv,s,t,d", D112_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_112_matches_pallas_interpret(b, hq, hkv, s, t, d, causal):
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa

    q, k, v = _qkv((b, hq, hkv, s, t, d), s + t)
    got = _ops().flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal)
    assert tuple(got.shape) == (b, hq, s, d)
    assert_close(got, jax_fa(to_jax(q), to_jax(k), to_jax(v), causal=causal, interpret=True),
                 rtol=FA_TOL, atol=FA_TOL)


# phi-3-vision's head dim (MHA, causal in the model) and hubert-xlarge's
# (MHA, non-causal), each causal and not, with GQA, ragged S and T > S.
D96_D80_SHAPES = [(1, 4, 4, 128, 128, 96), (2, 4, 1, 100, 160, 96),
                  (1, 4, 4, 128, 128, 80), (2, 6, 2, 77, 130, 80)]


@pytest.mark.parametrize("b,hq,hkv,s,t,d", D96_D80_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_head_dims_96_and_80_match_pallas_interpret(b, hq, hkv, s, t, d, causal):
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa

    q, k, v = _qkv((b, hq, hkv, s, t, d), s + t + d)
    got = _ops().flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal)
    assert tuple(got.shape) == (b, hq, s, d)
    assert_close(got, jax_fa(to_jax(q), to_jax(k), to_jax(v), causal=causal, interpret=True),
                 rtol=FA_TOL, atol=FA_TOL)


def test_kernel_head_dims_include_96_and_80_and_refuse_others():
    """The CUDA kernel's instantiations take D 96 and 80 (bf16 on the
    tensor-core kernel, fp32 on the scalar one); `_launch` refuses a D it
    has none for before it reaches the library."""
    ops = _ops()
    assert {80, 96} <= set(ops.HEAD_DIMS)
    for d in (80, 96):
        assert ops.variant(torch.bfloat16, d) == "wgmma_tma"
        assert ops.variant(torch.float32, d) == "scalar_fp32"
    q = torch.zeros(1, 2, 8, 48)
    with pytest.raises(ValueError, match="head_dim"):
        ops._launch(q, q, q, causal=True, scale=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dims_96_and_80_kernel_match_plain_on_the_card(d, dtype, causal):
    """K2 at D 96 and 80 (bf16 on wgmma_tma, a zero-filled tail chunk; fp32
    on scalar_fp32, 6 and 5 accumulator columns a thread), the model's (B,
    S, H, D) layout read in place, one launch counted."""
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    want_kind = "wgmma_tma" if dtype == torch.bfloat16 else "scalar_fp32"
    assert ops.variant(dtype, d) == ops.library_variant(dtype, d) == want_kind
    q, k, v = _qkv((2, 8, 2, 300, 300 if causal else 333, d), d)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).cuda().to(dtype).transpose(1, 2)
                  for x in (q, k, v))
    before = ops.flash_attention.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = attention_ref(qt, kt, vt, causal=causal)
    if dtype == torch.float32:
        assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_112_kernel_matches_plain_on_the_card(dtype, causal):
    """K2 at D 112 (bf16 on wgmma_tma, 7 k-steps of S; fp32 on scalar_fp32,
    7 accumulator columns a thread), the model's (B, S, H, D) layout read in
    place."""
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    want_kind = "wgmma_tma" if dtype == torch.bfloat16 else "scalar_fp32"
    assert ops.variant(dtype, 112) == ops.library_variant(dtype, 112) == want_kind
    q, k, v = _qkv((2, 8, 2, 300, 300 if causal else 333, 112), 112)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).cuda().to(dtype).transpose(1, 2)
                  for x in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    want = attention_ref(qt, kt, vt, causal=causal)
    if dtype == torch.float32:
        assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)
    else:
        assert_bf16_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 96, 112])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_tail_chunk_keeps_to_its_head_on_the_card(d, causal):
    """wgmma_tma at a D that is not a multiple of 64, on the model's (B, S,
    H, D) layout, where columns D .. 127 of head h are head h + 1's: every
    head's output is checked on its own, so a store past D, which lands in
    the next head (or the last head's in the next row's first), fails."""
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    assert ops.variant(torch.bfloat16, d) == "wgmma_tma"
    q, k, v = _qkv((2, 8, 2, 300, 333, d), 3 * d + causal)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).cuda().bfloat16().transpose(1, 2)
                  for x in (q, k, v))
    assert ops._kernel_layout(qt, "wgmma_tma") is qt
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    assert got.stride() == qt.stride()
    want = attention_ref(qt, kt, vt, causal=causal)
    for h in range(8):
        assert_bf16_close(got[:, h], want[:, h])


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


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma_tma"), (torch.bfloat16, 128, "wgmma_tma"),
    (torch.bfloat16, 256, "wgmma_tma"), (torch.bfloat16, 16, "scalar_fp32"),
    (torch.bfloat16, 32, "scalar_fp32"), (torch.bfloat16, 112, "wgmma_tma"),
    (torch.float32, 16, "scalar_fp32"), (torch.float32, 112, "scalar_fp32"),
    (torch.float32, 64, "scalar_fp32"), (torch.float32, 256, "scalar_fp32"),
    (torch.bfloat16, 96, "wgmma_tma"), (torch.bfloat16, 80, "wgmma_tma"),
    (torch.float32, 96, "scalar_fp32"), (torch.float32, 80, "scalar_fp32"),
])
def test_variant_rule(dtype, d, want):
    """The fixed choice of kernel by dtype and head dim: bf16 at D = 64, 80
    (hubert), 96 (phi-3-vision), 112 (kimi-k2), 128 and 256 on the tensor
    cores; fp32 at every D and bf16 at the smoke configs' 16 and 32 on the
    scalar fp32 kernel."""
    assert _ops().variant(dtype, d) == want


def test_kernel_layout_rule():
    """In place when the kernel can read the strides, else a copy: multiples
    of 4 elements for scalar_fp32, of 8 (16 bytes, TMA's rule) for
    wgmma_tma, which never reads the stride of a dimension of size 1."""
    layout = _ops()._kernel_layout
    bsh = torch.zeros(2, 100, 8, 64, dtype=torch.bfloat16).transpose(1, 2)  # (B, S, H, D) view
    assert layout(bsh, "wgmma_tma") is bsh and layout(bsh, "scalar_fp32") is bsh
    four = torch.zeros(2, 4, 100, 68, dtype=torch.bfloat16)[..., :64]  # seq stride 68 = 4 mod 8
    assert layout(four, "scalar_fp32") is four
    copied = layout(four, "wgmma_tma")
    assert copied is not four and copied.is_contiguous() and torch.equal(copied, four)
    ones = torch.zeros(100 * 64, dtype=torch.bfloat16).as_strided((1, 1, 100, 64), (3, 5, 64, 1))
    assert layout(ones, "wgmma_tma") is ones
    odd = torch.zeros(2, 4, 100, 66, dtype=torch.bfloat16)[..., :64]  # seq stride 66: neither
    for kind in ("wgmma_tma", "scalar_fp32"):
        assert layout(odd, kind).is_contiguous()
    gapped = torch.zeros(2, 4, 100, 128, dtype=torch.bfloat16)[..., ::2]  # D not contiguous
    assert layout(gapped, "wgmma_tma").stride(-1) == 1


@pytest.mark.parametrize("heads,d", [(32, 96), (16, 80), (64, 112), (8, 112)])
def test_kernel_layout_reads_the_new_head_dims_in_place(heads, d):
    """The (B, S, H, D) views of phi-3-vision (H 32, D 96), hubert-xlarge
    (16, 80) and kimi-k2 (64 query and 8 KV heads, 112) go to wgmma_tma and
    are read in place (head stride D and seq stride H D are multiples of 8
    elements); a seq stride of 4 mod 8 is copied first."""
    ops = _ops()
    assert ops.variant(torch.bfloat16, d) == "wgmma_tma"
    bsh = torch.zeros(2, 40, heads, d, dtype=torch.bfloat16).transpose(1, 2)
    assert not bsh.is_contiguous() and ops._kernel_layout(bsh, "wgmma_tma") is bsh
    four = torch.randn(2, heads, 40, d + 4).bfloat16()[..., :d]  # seq stride d + 4 = 4 mod 8
    assert four.stride(2) % 8 == 4
    copied = ops._kernel_layout(four, "wgmma_tma")
    assert copied is not four and copied.is_contiguous() and torch.equal(copied, four)


WGMMA_CASES = [
    # (S, T, causal): ragged S = T, T > S, non-causal (ragged T too)
    (1000, 1000, True),
    (300, 1000, True),
    (1000, 1000, False),
    (200, 333, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s,t,causal", WGMMA_CASES)
def test_wgmma_kernel_bf16_on_the_card(d, s, t, causal):
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    assert ops.variant(torch.bfloat16, d) == ops.library_variant(torch.bfloat16, d) == "wgmma_tma"
    q, k, v = (to_torch(x).cuda().bfloat16() for x in _qkv((2, 4, 2, s, t, d), s + t + d))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, attention_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
def test_wgmma_kernel_strides_on_the_card(d):
    """The model's (B, S, H, D) layout read in place, and a seq stride of
    4 (mod 8) bf16 elements, which TMA cannot take, copied first."""
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    q, k, v = _qkv((2, 8, 1, 130, 130, d), d + 1)
    qt, kt, vt = (to_torch(x.transpose(0, 2, 1, 3)).cuda().bfloat16().transpose(1, 2)
                  for x in (q, k, v))
    assert ops._kernel_layout(qt, "wgmma_tma") is qt
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.stride() == qt.stride()
    assert_bf16_close(got, attention_ref(qt, kt, vt, causal=True))

    def padded(x):  # rows of D + 4 elements
        out = torch.zeros(*x.shape[:-1], d + 4, dtype=torch.bfloat16, device="cuda")
        out[..., :d] = to_torch(x).cuda().bfloat16()
        return out[..., :d]

    qp, kp, vp = (padded(x) for x in (q, k, v))
    assert qp.stride(2) % 8 == 4 and ops._kernel_layout(qp, "wgmma_tma") is not qp
    assert_bf16_close(ops.flash_attention(qp, kp, vp, causal=True),
                      attention_ref(qp, kp, vp, causal=True))


@pytest.mark.gpu
def test_wrapper_reports_wgmma_at_the_main_shape():
    """gemma-2b's prefill attention (chip_smoke.FA_MAIN: B 4, Hq 8, Hkv 1,
    S = T = 2048, D 256, bf16, causal) goes to the tensor-core kernel."""
    require_cuda()
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = _ops()
    b, hq, hkv, s, t, d = 4, 8, 1, 2048, 2048, 256
    assert ops.variant(torch.bfloat16, d) == ops.library_variant(torch.bfloat16, d) == "wgmma_tma"
    q, k, v = (to_torch(x).cuda().bfloat16() for x in _qkv((b, hq, hkv, s, t, d), 0))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert_bf16_close(got, attention_ref(q, k, v, causal=True))
