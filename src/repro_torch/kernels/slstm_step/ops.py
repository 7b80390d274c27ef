"""Public wrappers of the sLSTM sequence recurrence.

Port of src/repro/kernels/slstm_step/ops.py.  `slstm_seq` checks its
inputs, then runs the hand-written CUDA kernel (`csrc/slstm_step.cu`) on
CUDA tensors and the plain PyTorch version (`ref.slstm_seq_ref`) on CPU
tensors.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  Each launch adds one to `slstm_seq.launches`.
`slstm_block_kernel` adapts the model's per-gate parameters (w_*, r_*,
b_*) to the stacked tensors the recurrence takes, as the JAX wrapper does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_step.ref import GATES, slstm_seq_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# One barrier counter per head, each on its own 128-byte line.
_BARRIER_STRIDE = 32

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = build.load("slstm_step")
    for fn in (lib.slstm_seq_f32, lib.slstm_seq_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.slstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.slstm_seq_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x_proj: torch.Tensor, R: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, State]:
    _, s, batch, d = x_proj.shape
    n_heads, p = R.shape[1], R.shape[2]
    x_proj, R = x_proj.contiguous(), R.contiguous()
    bias = b.float().contiguous()
    dev = x_proj.device
    h = torch.empty(s, batch, d, device=dev)
    c, n, m = (torch.empty(batch, d, device=dev) for _ in range(3))
    barrier = torch.zeros(n_heads * _BARRIER_STRIDE, dtype=torch.int32, device=dev)
    lib = _library()
    fn = lib.slstm_seq_f32 if x_proj.dtype == torch.float32 else lib.slstm_seq_bf16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x_proj.data_ptr(), R.data_ptr(), bias.data_ptr(), h.data_ptr(), c.data_ptr(),
            n.data_ptr(), m.data_ptr(), barrier.data_ptr(), s, batch, n_heads, p, stream,
        )
    if err:
        msg = lib.slstm_seq_error_string(err).decode()
        raise RuntimeError(f"slstm_seq kernel launch failed: {msg} ({err})")
    _counted.launches += 1
    return h, (c, n, m)


def slstm_seq(
    x_proj: torch.Tensor,  # (4, S, B, D) gate inputs i, f, z, o
    R: torch.Tensor,  # (4, H, P, P) recurrent weights, (in, out) per head
    b: torch.Tensor,  # (4, D)
) -> Tuple[torch.Tensor, State]:
    """The stabilized sLSTM recurrence over S steps from the zero state
    (m0 = -1e30).  Returns h (S, B, D) fp32 and the final (c, n, m), each
    (B, D) fp32; the final h is h[-1].  x_proj and R are float32 or
    bfloat16, of one dtype, widened to fp32 inside; b is any float dtype."""
    if x_proj.dim() != 4 or x_proj.shape[0] != 4:
        raise ValueError(f"x_proj must be (4, S, B, D), got {tuple(x_proj.shape)}")
    _, s, batch, d = x_proj.shape
    if R.dim() != 4 or R.shape[0] != 4 or R.shape[2] != R.shape[3]:
        raise ValueError(f"R must be (4, H, P, P), got {tuple(R.shape)}")
    if R.shape[1] * R.shape[2] != d:
        raise ValueError(f"R {tuple(R.shape)} does not tile D = {d} into H x P")
    if tuple(b.shape) != (4, d):
        raise ValueError(f"b must be (4, {d}), got {tuple(b.shape)}")
    if s == 0 or batch == 0:
        raise ValueError(f"empty input: S={s}, B={batch}")
    if x_proj.dtype not in _DTYPES or R.dtype != x_proj.dtype or not b.is_floating_point():
        raise TypeError(
            f"slstm_seq takes x_proj and R in float32 or bfloat16, of one dtype, and a "
            f"float b; got {x_proj.dtype}, {R.dtype}, {b.dtype}"
        )
    if not (x_proj.device == R.device == b.device):
        raise ValueError(f"x_proj on {x_proj.device}, R on {R.device}, b on {b.device}")

    if x_proj.device.type == "cpu":
        return slstm_seq_ref(x_proj, R, b)
    if x_proj.device.type == "cuda":
        return _launch(x_proj, R, b)
    raise ValueError(f"slstm_seq runs on cuda or cpu, not {x_proj.device}")


slstm_seq.launches = 0
_counted = slstm_seq  # the count stays on the wrapper while a check patches the name


def stack_gates(params: dict, x: torch.Tensor, n_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence's inputs from the model's sLSTM params and x (B, S, D):
    x_proj (4, S, B, D) = x @ w_g hoisted over the sequence, in x's dtype;
    R (4, H, P, P) and b (4, D) stacked over the gates i, f, z, o, with H
    checked against n_heads.  Where R's dtype is not x's, both are widened
    to fp32 (exactly), as the recurrence would widen them."""
    x_proj = torch.stack([(x @ params[f"w_{g}"].to(x.dtype)).transpose(0, 1) for g in GATES])
    R = torch.stack([params[f"r_{g}"] for g in GATES])
    bias = torch.stack([params[f"b_{g}"] for g in GATES])
    if R.shape[1] != n_heads:
        raise ValueError(f"r_* have {R.shape[1]} heads, n_heads={n_heads}")
    if R.dtype != x_proj.dtype:  # the recurrence widens both: do it here, exactly
        x_proj, R = x_proj.float(), R.float()
    return x_proj, R, bias


def slstm_block_kernel(params: dict, x: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """The sLSTM block's mixer over x (B, S, D) through `slstm_seq`; returns
    (B, S, D) in x's dtype."""
    h, _ = slstm_seq(*stack_gates(params, x, n_heads))
    return h.transpose(0, 1).to(x.dtype)
