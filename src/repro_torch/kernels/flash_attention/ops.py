"""Public wrappers of flash attention.

Port of src/repro/kernels/flash_attention/ops.py.  `flash_attention`
checks its inputs, then runs the hand-written CUDA kernel
(`csrc/flash_attention.cu`) on CUDA tensors and the plain PyTorch version
(`ref.attention_ref`) on CPU tensors.  On a CUDA tensor it launches the
kernel or raises; it never falls back.  Each launch adds one to
`flash_attention.launches`.  The kernel masks ragged S and T itself, so the
TPU wrapper's padding copies and its equal-padding rule have no
counterpart here.

The source holds two kernels, and the choice between them is fixed by
dtype and head dim (`variant`, the same rule as the source's
`variant_of`): "wgmma_tma" (tensor cores, TMA-fed tiles) for bfloat16 at
D = 64, 80 (hubert-xlarge's head dim), 96 (phi-3-vision's), 112
(kimi-k2's), 128 or 256, "scalar_fp32" (CUDA-core fp32 FMAs) for float32 at
every D and for bfloat16 at D = 16 or 32.  The Pallas kernel takes any D, and
the plain version `ref.attention_ref` too; the CUDA kernel takes the
HEAD_DIMS it is instantiated for and raises on any other.

When grad is enabled and q, k or v requires it, `flash_attention` runs
through `FlashAttention`, an autograd Function on both devices: forward K2
on the card (its plain version on the CPU), backward
`backward.attention_backward`, FlashAttention-2's backward in plain PyTorch
with the softmax's D summed from P and dP, so the forward's output is not
kept (the JAX package differentiates its XLA scan and has no backward
kernel).  `launch_shapes` collects the (B, Hq, Hkv, S, T, D, dtype,
variant) of the launches, so a sharded run shows the heads each rank
attends over.
Without grad the path is the bare forward.

`flash_decode` is the single-token decode attention, plain PyTorch as the
JAX version is plain jnp.  On a cache sharded on its sequence (JAX's
"LSE-combine psum pattern", src/repro/models/attention.py:233-240), each
part of the cache gives `flash_decode_part` (the same arithmetic over the
part, its row max m and sum l kept) and `combine_decode_parts` weighs the
parts' outputs by l e^(m - max m).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.backward import attention_backward
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128, 256)  # the kernel's instantiations
WGMMA_HEAD_DIMS = (64, 80, 96, 112, 128, 256)  # the bf16 head dims of the wgmma_tma kernel
# (B, Hq, Hkv, S, T, D, dtype, variant) of every launch since it was cleared
launch_shapes: set = set()
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_variant.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_variant.restype = ctypes.c_char_p
    lib.flash_attention_ctas.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_ctas.restype = ctypes.c_longlong
    return lib


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel a launch of this dtype and head dim runs: "wgmma_tma" for
    bfloat16 at D in WGMMA_HEAD_DIMS (every bf16 head dim of the full-size
    configs), else "scalar_fp32" (float32 at every D, bfloat16 at 16 and
    32)."""
    return "wgmma_tma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "scalar_fp32"


def library_variant(dtype: torch.dtype, d: int) -> str:
    """The built library's own answer to `variant` (builds it if needed)."""
    return _library().flash_attention_variant(int(dtype == torch.bfloat16), d).decode()


def ctas(b: int, hq: int, s: int, dtype: torch.dtype, d: int) -> int:
    """CTAs of one launch at this shape, as the built library computes them."""
    return int(_library().flash_attention_ctas(b, hq, s, int(dtype == torch.bfloat16), d))


def _kernel_layout(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x itself when the kernel can read it in place, else a copy.  In place
    means D contiguous, the base 16-byte aligned, and every stride a multiple
    of 4 elements; for wgmma_tma, whose TMA tensor maps need 16-byte
    strides, a multiple of 8 (bf16) elements, where a dimension of size 1
    is never stepped and its stride is not read."""
    if kind == "wgmma_tma":
        ok = all(st % 8 == 0 for n, st in zip(x.shape[:-1], x.stride()[:-1]) if n > 1)
    else:
        ok = all(st % 4 == 0 for st in x.stride()[:-1])
    ok = ok and x.stride(-1) == 1 and x.data_ptr() % 16 == 0
    return x if ok else x.contiguous()


def _launch(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the kernel's grid (65535)")
    kind = variant(q.dtype, d)
    q, k, v = (_kernel_layout(x, kind) for x in (q, k, v))
    out = torch.empty_like(q)  # q's strides: a (B, S, H, D) view stays one
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in x.stride()[:3])
    )
    lib = _library()
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, t, d, ctypes.cast(strides, ctypes.c_void_p),
            float(scale), int(bool(causal)), stream,
        )
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    flash_attention.launches += 1
    launch_shapes.add((b, hq, hkv, s, t, d, str(q.dtype).replace("torch.", ""), kind))
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax GQA attention; returns (B, Hq, S, D) in q's dtype.

    Query head h reads kv head h // (Hq / Hkv).  Causal attention aligns the
    mask bottom-right (row r sees key c iff c <= r + T - S) and needs
    T >= S.  The scale defaults to D ** -0.5.  Inputs are float32 or
    bfloat16, of one dtype, on one device; any strides with D contiguous are
    read in place on the card."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k, v must be (B, H, S, D); got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if s == 0 or t == 0:
        raise ValueError(f"empty sequence: S={s}, T={t}")
    if causal and t < s:
        raise ValueError(f"causal attention needs T >= S, got S={s}, T={t}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    scale = d ** -0.5 if scale is None else float(scale)

    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale)


flash_attention.launches = 0


def _forward(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, scale=scale)
    return attention_ref(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """K2's forward (its plain version on the CPU) with
    `attention_backward`; saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_decode(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k: torch.Tensor,  # (B, Hkv, T, D) KV cache
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    length: Optional[torch.Tensor] = None,  # (B,) valid cache lengths
) -> torch.Tensor:
    """Single-token decode attention: fp32 logits, keys at or past `length`
    masked with -1e30, softmax in fp32, probabilities cast to v's dtype
    before the P V product (summed in fp32); returns (B, Hq, 1, D) in q's
    dtype."""
    b, hq, _, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, group, d)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k.float()) * scale
    if length is not None:
        pos = torch.arange(t, device=q.device)
        valid = pos[None, :] < length.to(q.device)[:, None]  # (B, T)
        logits = torch.where(valid[:, None, None, :], logits, logits.new_tensor(-1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def flash_decode_part(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k: torch.Tensor,  # (B, Hkv, T_part, D): one part of the cache's positions
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    length: Optional[torch.Tensor] = None,  # (B,) valid positions of this part
):
    """flash_decode over one part of the cache, normalised within the part:
    (out (B, Hq, D) fp32, row max m (B, Hq) fp32, row sum l (B, Hq) fp32).
    Keys at or past `length` are masked with -1e30, as flash_decode's: a
    part with no valid key has m = -1e30 and weighs exactly 0 in the
    combine (never NaN, as -inf would give)."""
    b, hq, _, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, group, d)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k.float()) * scale
    if length is not None:
        pos = torch.arange(t, device=q.device)
        valid = pos[None, :] < length.to(q.device)[:, None]  # (B, T_part)
        logits = torch.where(valid[:, None, None, :], logits, logits.new_tensor(-1e30))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l_sum = p.sum(dim=-1)
    probs = p / l_sum[..., None]
    out = torch.einsum("bhgt,bhtd->bhgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, d), m.reshape(b, hq), l_sum.reshape(b, hq)


def combine_decode_parts(out: torch.Tensor, m: torch.Tensor, l_sum: torch.Tensor) -> torch.Tensor:
    """The parts of `flash_decode_part` stacked on a leading dim (R, B, Hq,
    D), (R, B, Hq), (R, B, Hq) -> the attention over the whole cache (B,
    Hq, D) fp32: sum_r w_r out_r / sum_r w_r with w_r = l_r e^(m_r - m), m
    the largest m_r, summed over the parts in order."""
    w = l_sum * torch.exp(m - m.amax(dim=0, keepdim=True))
    return (w[..., None] * out).sum(dim=0) / w.sum(dim=0)[..., None]
