"""Public wrappers of flash attention.

Port of src/repro/kernels/flash_attention/ops.py.  `flash_attention`
checks its inputs, then runs the hand-written CUDA kernel
(`csrc/flash_attention.cu`) on CUDA tensors and the plain PyTorch version
(`ref.attention_ref`) on CPU tensors.  On a CUDA tensor it launches the
kernel or raises; it never falls back.  Each launch adds one to
`flash_attention.launches`.  The kernel masks ragged S and T itself, so the
TPU wrapper's padding copies and its equal-padding rule have no
counterpart here.

`flash_decode` is the single-token decode attention, plain PyTorch as the
JAX version is plain jnp.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
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
    return lib


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it in place (D contiguous, every
    stride a multiple of 4 elements, base 16-byte aligned), else a copy."""
    ok = (
        x.stride(-1) == 1
        and all(st % 4 == 0 for st in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )
    return x if ok else x.contiguous()


def _launch(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the kernel's grid (65535)")
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
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

    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


flash_attention.launches = 0


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
