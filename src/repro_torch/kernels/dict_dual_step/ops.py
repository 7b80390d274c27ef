"""Public wrapper of the fused dict_dual_step kernel.

Port of src/repro/kernels/dict_dual_step/ops.py.  `dict_dual_step` checks
its inputs, then runs the hand-written CUDA kernel
(`csrc/dict_dual_step.cu`) on CUDA tensors and the plain PyTorch version
(`ref.dict_dual_step_ref`) on CPU tensors.  On a CUDA tensor it launches the
kernel or raises; it never falls back.  Each call on the card runs the
kernel's two passes (S and Y, then G; design "two_pass", see the source)
as two launches on the current stream and adds one to
`dict_dual_step.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dict_dual_step.ref import dict_dual_step_ref

_DTYPES = (torch.float32, torch.bfloat16)
VARIANT = "two_pass"  # the kernel's one design, for every dtype and shape
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _library() -> ctypes.CDLL:
    lib = build.load("dict_dual_step")
    for fn in (lib.dict_dual_step_f32, lib.dict_dual_step_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.dict_dual_step_error_string.argtypes = [ctypes.c_int]
    lib.dict_dual_step_error_string.restype = ctypes.c_char_p
    lib.dict_dual_step_ctas.argtypes = [ctypes.c_int] * 5
    lib.dict_dual_step_ctas.restype = ctypes.c_longlong
    return lib


def ctas(n: int, m: int, kb: int, b: int) -> Tuple[int, int]:
    """CTAs per launch of the kernel's two passes at this shape, as the
    built library computes them (builds it if needed)."""
    lib = _library()
    return tuple(int(lib.dict_dual_step_ctas(n, m, kb, b, p)) for p in (1, 2))


def _launch(W, nu, *, gamma, delta, nonneg):
    n, m, kb = W.shape
    b = nu.shape[1]
    y = torch.empty((n, b, kb), dtype=W.dtype, device=W.device)
    g = torch.empty((n, b, m), dtype=W.dtype, device=W.device)
    # Y in fp32 between the passes: y itself for fp32.
    scratch = y if W.dtype == torch.float32 else torch.empty(
        (n, b, kb), dtype=torch.float32, device=W.device
    )
    lib = _library()
    fn = lib.dict_dual_step_f32 if W.dtype == torch.float32 else lib.dict_dual_step_bf16
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            W.data_ptr(), nu.data_ptr(), y.data_ptr(), g.data_ptr(), scratch.data_ptr(),
            n, m, kb, b, nu.stride(0) if n > 1 else 0,
            float(gamma), float(delta), int(bool(nonneg)), stream,
        )
    if err:
        msg = lib.dict_dual_step_error_string(err).decode()
        raise RuntimeError(f"dict_dual_step kernel launch failed: {msg} ({err})")
    dict_dual_step.launches += 1
    return y, g


def dict_dual_step(
    W_blocks: torch.Tensor,
    nu: torch.Tensor,
    *,
    gamma: float,
    delta: float,
    nonneg: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused S = nu W; Y = T_gamma(S) / delta; G = Y W^T, for every agent.

    W_blocks is (N, M, Kb), contiguous, or one block (M, K).  nu is
    (N, B, M) (one estimate per agent, each (B, M) block contiguous), or
    (B, M) / (M,) shared by every agent: the kernel then reads it with
    agent stride 0.  Returns (Y (N, B, Kb), G (N, B, M)) in nu's dtype,
    without the agent axis for a 2-D W and without the batch axis for a
    1-D nu.  Both inputs are float32 or bfloat16, of one dtype, on one
    device."""
    if W_blocks.dim() not in (2, 3):
        raise ValueError(f"W_blocks must be (N, M, Kb) or (M, K), got {tuple(W_blocks.shape)}")
    W = W_blocks.unsqueeze(0) if W_blocks.dim() == 2 else W_blocks
    n, m, _ = W.shape
    if nu.dim() == 1:
        nu3 = nu.view(1, 1, -1).expand(n, 1, nu.shape[0])
    elif nu.dim() == 2:
        nu3 = nu.unsqueeze(0).expand(n, *nu.shape)
    elif nu.dim() == 3:
        nu3 = nu
    else:
        raise ValueError(f"nu must be (N, B, M), (B, M) or (M,), got {tuple(nu.shape)}")
    if nu3.shape[0] != n or nu3.shape[2] != m or nu3.shape[1] == 0:
        raise ValueError(
            f"nu {tuple(nu.shape)} does not match W_blocks {tuple(W_blocks.shape)}"
        )
    if W.dtype not in _DTYPES or nu.dtype != W.dtype:
        raise TypeError(
            f"dict_dual_step takes float32 or bfloat16 of one dtype, got "
            f"W {W.dtype} and nu {nu.dtype}"
        )
    if W.device != nu.device:
        raise ValueError(f"W on {W.device} but nu on {nu.device}")
    b = nu3.shape[1]
    if not W.is_contiguous():
        raise ValueError("W_blocks must be contiguous")
    if nu3.stride(2) != 1 or (b > 1 and nu3.stride(1) != m) or (
        n > 1 and nu3.stride(0) not in (0, b * m)
    ):
        raise ValueError(
            f"each agent's nu block must be a contiguous (B, M) block, with agent "
            f"stride 0 or B*M; got strides {nu3.stride()}"
        )

    if W.device.type == "cpu":
        y, g = dict_dual_step_ref(W, nu3, gamma=gamma, delta=delta, nonneg=nonneg)
    elif W.device.type == "cuda":
        y, g = _launch(W, nu3, gamma=gamma, delta=delta, nonneg=nonneg)
    else:
        raise ValueError(f"dict_dual_step runs on cuda or cpu, not {W.device}")

    if W_blocks.dim() == 2:
        y, g = y[0], g[0]
    if nu.dim() == 1:
        y, g = y[..., 0, :], g[..., 0, :]
    return y, g


dict_dual_step.launches = 0
