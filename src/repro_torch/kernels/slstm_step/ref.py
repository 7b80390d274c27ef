"""Plain PyTorch version of the sLSTM sequence recurrence.

Port of src/repro/kernels/slstm_step/ref.py, the oracle of the Pallas
kernel: the stabilized sLSTM recurrence given PRE-PROJECTED gate inputs
(x @ W hoisted outside, as models/xlstm.py does), in fp32 whatever the
input dtype:

    raw_g[t] = x_proj[g, t] + (h_{t-1} @ blockdiag(R_g)) + b_g
    m_t = max(logsig(raw_f) + m_{t-1}, raw_i)
    c_t = exp(logsig(raw_f) + m_{t-1} - m_t) c_{t-1} + exp(raw_i - m_t) tanh(raw_z)
    n_t = (same decay) n_{t-1} + exp(raw_i - m_t)
    h_t = sigmoid(raw_o) * c_t / max(n_t, 1e-6)

from h = c = n = 0 and m = -1e30.  R is indexed (gate, head, in, out).
logsig is -softplus(-x), the stable form jax.nn.log_sigmoid uses (the
naive log(sigmoid(x)) underflows to -inf for a strongly negative gate).
Unlike the JAX oracle, it also returns the final (c, n, m), which the
decode cache needs; the final h is the last row of h.  Float64 inputs
stay float64 (an exact reference for the gradient's checks).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GATES = ("i", "f", "z", "o")
NEG = -1e30


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def slstm_seq_ref(
    x_proj: torch.Tensor,  # (4, S, B, D) pre-projected gate inputs (i, f, z, o)
    R: torch.Tensor,  # (4, H, P, P) recurrent block-diagonal weights (in, out)
    b: torch.Tensor,  # (4, D) biases
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns h (S, B, D) fp32 and the final (c, n, m), each (B, D) fp32
    (fp64 for a float64 x_proj)."""
    _, s, batch, d = x_proj.shape
    n_heads, p = R.shape[1], R.shape[2]
    dt = torch.float64 if x_proj.dtype == torch.float64 else torch.float32
    # R once in the layout of the step's product, [h, in, g P + out]: under
    # autograd every step then saves this one tensor, not a copy of it.
    R_in = R.to(dt).permute(1, 2, 0, 3).reshape(n_heads, p, 4 * p)
    bf = b.to(dt)[:, None, :]
    dev = x_proj.device
    h = torch.zeros(batch, d, dtype=dt, device=dev)
    c = torch.zeros(batch, d, dtype=dt, device=dev)
    n = torch.zeros(batch, d, dtype=dt, device=dev)
    m = torch.full((batch, d), NEG, dtype=dt, device=dev)
    hs = torch.empty(s, batch, d, dtype=dt, device=dev)
    for t in range(s):
        rec = torch.bmm(h.view(batch, n_heads, p).transpose(0, 1), R_in)  # (H, B, 4 P)
        rec = rec.view(n_heads, batch, 4, p).permute(2, 1, 0, 3).reshape(4, batch, d)
        raw = x_proj[:, t].to(dt) + rec + bf
        i_raw, f_raw, z_raw, o_raw = raw.unbind(0)
        lf = log_sigmoid(f_raw)
        m_new = torch.maximum(lf + m, i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_raw)
        n = f_s * n + i_s
        h = torch.sigmoid(o_raw) * c / n.clamp_min(1e-6)
        m = m_new
        hs[t] = h
    return hs, (c, n, m)
