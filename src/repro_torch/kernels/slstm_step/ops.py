"""Public wrappers of the sLSTM sequence recurrence.

Port of src/repro/kernels/slstm_step/ops.py.  `slstm_seq` checks its
inputs, then runs the hand-written CUDA kernel (`csrc/slstm_step.cu`) on
CUDA tensors and the plain PyTorch version (`ref.slstm_seq_ref`) on CPU
tensors.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  Each launch adds one to `slstm_seq.launches`.

The kernel runs one thread-block cluster per (head, group of `BT` batch
rows), with the head's R on chip; its plan (cluster size, clusters, CTAs)
follows from (B, P) and the dtype by the source's `make_plan`, mirrored by
`plan` / `variant` here and read from the built library by
`library_plan`.  A head dim without a plan (see `plan`) raises before a
launch.

When grad is enabled and x_proj, R or b requires it, `slstm_seq` runs
through `SlstmSeq`, an autograd Function on both devices: forward K3 on the
card (its plain version on the CPU), backward `backward.slstm_backward`,
backpropagation through time in plain PyTorch (the JAX package
differentiates its `lax.scan` and has no backward kernel).  Only h has a
gradient: one arriving for the final (c, n, m) raises.  Without grad the
path is the bare forward.

`slstm_block_kernel` adapts the model's per-gate parameters (w_*, r_*,
b_*) to the stacked tensors the recurrence takes, as the JAX wrapper does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_step.backward import slstm_backward
from repro_torch.kernels.slstm_step.ref import GATES, slstm_seq_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

VARIANT = "cluster"
# The source's constants: batch rows per cluster, threads per CTA, the
# largest cluster, the values of R one CTA holds.
BT, MAX_THREADS, MAX_CLUSTER, BUDGET = 4, 256, 16, 65536
_PLAN_KEYS = ("cs", "bt", "clusters", "ctas", "threads", "ks", "nj", "smem",
              "max_active_clusters")
# (B, S, D, H) on the edges of the plan, where the card tests and
# chip_smoke.py hold the kernel against its plain version: P 512, 256, 128
# (clusters of 16, 4, 1 CTAs), B 1 .. 9 (a ragged last group of BT rows),
# S 1 and 2 and longer, and P 384 (16 CTAs of 24 columns: the P = 512
# kernel at a plan with less shared memory) between P = 512 shapes.
EDGE_SHAPES = ((1, 1, 2048, 4), (2, 7, 1536, 4), (3, 2, 2048, 4), (5, 33, 2048, 4),
               (9, 2, 1024, 4), (9, 17, 1024, 8), (1, 2, 256, 2), (5, 40, 512, 2))

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = build.load("slstm_step")
    for fn in (lib.slstm_seq_f32, lib.slstm_seq_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.slstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.slstm_seq_error_string.restype = ctypes.c_char_p
    lib.slstm_seq_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.slstm_seq_plan.restype = ctypes.c_int
    return lib


def plan(dtype: torch.dtype, b: int, p: int, n_heads: int = 1) -> Dict[str, int]:
    """The launch plan at batch b, head dim p and n_heads heads, by the
    source's `make_plan`: cluster size cs (the smallest power of two that
    leaves each CTA at most BUDGET values of the head's R), BT batch rows
    per cluster, clusters = n_heads * ceil(b / BT), ctas = clusters * cs,
    threads per CTA (P / cs columns, ks lanes each), nj 4-input groups per
    lane, and the dynamic shared memory in bytes (fp32 keeps the lower
    halves of R there).  Raises ValueError for a p without a plan: p must be
    a multiple of 4 and of 4 cs, and need nj <= 16 (every power of two from
    4 to 512 has a plan)."""
    if b < 1 or n_heads < 1 or p < 4 or p % 4:
        raise ValueError(f"slstm_seq's kernel takes a head dim P that is a multiple of 4, "
                         f"got P={p} (B={b}, H={n_heads})")
    cs = 1
    while 4 * p * (p // cs) > BUDGET:
        cs *= 2
    if cs > MAX_CLUSTER or p % (4 * cs):
        raise ValueError(f"slstm_seq's kernel has no plan for P={p}: its R needs a cluster "
                         f"of {cs} CTAs of P / {cs} columns, a multiple of 4, and at most "
                         f"{MAX_CLUSTER}")
    cols = p // cs
    lim = min(8, MAX_THREADS // cols, p // 4)
    ks = 1
    while ks * 2 <= lim:
        ks *= 2
    need = -(-p // (4 * ks))
    nj = 1
    while nj < need:
        nj *= 2
    if nj > 16:
        raise ValueError(f"slstm_seq's kernel has no plan for P={p}: a lane would hold "
                         f"{4 * nj} inputs of R, more than 64")
    threads = -(-cols * ks // 32) * 32
    if p > 2 * threads:  # a lane sends at most two 16-byte pieces of h_t a step
        raise ValueError(f"slstm_seq's kernel has no plan for P={p}: {threads} threads "
                         f"cannot send its h_t in two pieces each")
    clusters = n_heads * -(-b // BT)
    # Two mbarriers, fp32's lower halves of R, the h double buffer (rows
    # padded to 4 ks nj), the double-buffered stage of h_t's columns.
    smem = (16 + (threads * nj * 32 if dtype == torch.float32 else 0)
            + 4 * 2 * BT * (4 * ks * nj + cols))
    return {"cs": cs, "bt": BT, "clusters": clusters, "ctas": clusters * cs,
            "threads": threads, "ks": ks, "nj": nj, "smem": smem}


def variant(dtype: torch.dtype, b: int, p: int, n_heads: int = 1) -> Tuple[str, Dict[str, int]]:
    """The kernel a launch runs ("cluster", at every dtype and shape) and
    its plan (`plan`)."""
    return VARIANT, plan(dtype, b, p, n_heads)


def library_plan(dtype: torch.dtype, b: int, p: int, n_heads: int = 1) -> Dict[str, int]:
    """The built library's own plan at this shape (builds it if needed), with
    `max_active_clusters`: how many of its clusters fit on the card at once
    (cudaOccupancyMaxActiveClusters; 0 means a launch would fail)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    lib = _library()
    err = lib.slstm_seq_plan(b, n_heads, p, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err:
        msg = lib.slstm_seq_error_string(err).decode()
        raise RuntimeError(f"slstm_seq_plan failed: {msg} ({err})")
    return dict(zip(_PLAN_KEYS, (int(v) for v in out)))


def _launch(x_proj: torch.Tensor, R: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, State]:
    _, s, batch, d = x_proj.shape
    n_heads, p = R.shape[1], R.shape[2]
    plan(x_proj.dtype, batch, p, n_heads)  # raises for a head dim without a plan
    if x_proj.numel() > 0xFFFFFFFF:
        raise ValueError(f"slstm_seq's kernel indexes x_proj in 32 bits, got "
                         f"{tuple(x_proj.shape)}")
    x_proj, R = x_proj.contiguous(), R.contiguous()
    bias = b.float().contiguous()
    dev = x_proj.device
    h = torch.empty(s, batch, d, device=dev)
    c, n, m = (torch.empty(batch, d, device=dev) for _ in range(3))
    lib = _library()
    fn = lib.slstm_seq_f32 if x_proj.dtype == torch.float32 else lib.slstm_seq_bf16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x_proj.data_ptr(), R.data_ptr(), bias.data_ptr(), h.data_ptr(), c.data_ptr(),
            n.data_ptr(), m.data_ptr(), s, batch, n_heads, p, stream,
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
    bfloat16, of one dtype, widened to fp32 inside; b is any float dtype.
    Under grad, through `SlstmSeq` (the gradient of h only)."""
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
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slstm_seq runs on cuda or cpu, not {x_proj.device}")
    if torch.is_grad_enabled() and (x_proj.requires_grad or R.requires_grad or b.requires_grad):
        h, c, n, m = SlstmSeq.apply(x_proj, R, b)
        return h, (c, n, m)
    return _forward(x_proj, R, b)


slstm_seq.launches = 0
_counted = slstm_seq  # the count stays on the wrapper while a check patches the name


def _forward(x_proj: torch.Tensor, R: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, State]:
    if x_proj.device.type == "cuda":
        return _launch(x_proj, R, b)
    return slstm_seq_ref(x_proj, R, b)


class SlstmSeq(torch.autograd.Function):
    """K3's forward (its plain version on the CPU) with `slstm_backward`;
    saves x_proj, R, b and the output h.  Returns h, c, n, m; a gradient
    for the final c, n or m raises (it would need the stabilizer's
    derivative, which the backward leaves out: backward.py)."""

    @staticmethod
    def forward(ctx, x_proj, R, b):
        h, (c, n, m) = _forward(x_proj, R, b)
        ctx.save_for_backward(x_proj, R, b, h)
        ctx.set_materialize_grads(False)
        return h, c, n, m

    @staticmethod
    def backward(ctx, dh, dc, dn, dm):
        if dc is not None or dn is not None or dm is not None:
            raise RuntimeError("slstm_seq has a gradient for h only, not for the final "
                               "(c, n, m)")
        x_proj, R, b, h = ctx.saved_tensors
        return slstm_backward(x_proj, R, b, h, dh)


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
