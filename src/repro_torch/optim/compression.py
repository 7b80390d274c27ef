"""Gradient compression with error feedback.

Port of src/repro/optim/compression.py.  `error_feedback_q8(opt)` wraps an
Optimizer so the gradient each step is int8-quantized (per row of the last
axis, symmetric) with the quantization error accumulated into a feedback
buffer and re-injected next step, the scheme of the gossip engine's int8
wire lifted to the training path (Karimireddy et al., 2019).  State cost:
one fp32 buffer per param.
"""

from __future__ import annotations

import torch

from repro_torch.optim.optimizers import Optimizer
from repro_torch.pytree import tree_map


def _q8(x: torch.Tensor):
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """The lossy channel: what the wire would carry (int8 + fp32 row scales)."""
    gf = g.float()
    if gf.dim() == 0:
        return gf
    return _dq8(*_q8(gf))


def error_feedback_q8(opt: Optimizer) -> Optimizer:
    def init(params):
        return {
            "inner": opt.init(params),
            "ef": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           params),
        }

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        corrected = tree_map(lambda g, e: g.float() + e, grads, state["ef"])
        sent = tree_map(compress_decompress, corrected)
        tree_map(lambda e, c, s: e.copy_(c - s), state["ef"], corrected, sent)
        opt.update(sent, state["inner"], params, step, shards)
        return params, state

    def state_axes(param_axes):
        return {"inner": opt.state_axes(param_axes), "ef": param_axes}

    return Optimizer(init, update, state_axes, name=f"{opt.name}+efq8")
