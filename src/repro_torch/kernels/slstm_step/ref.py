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
decode cache needs; the final h is the last row of h.
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
    """Returns h (S, B, D) fp32 and the final (c, n, m), each (B, D) fp32."""
    _, s, batch, d = x_proj.shape
    n_heads, p = R.shape[1], R.shape[2]
    Rf, bf = R.float(), b.float()[:, None, :]
    dev = x_proj.device
    h = torch.zeros(batch, d, device=dev)
    c = torch.zeros(batch, d, device=dev)
    n = torch.zeros(batch, d, device=dev)
    m = torch.full((batch, d), NEG, device=dev)
    hs = torch.empty(s, batch, d, device=dev)
    for t in range(s):
        rec = torch.einsum("bhp,ghpq->gbhq", h.view(batch, n_heads, p), Rf)
        raw = x_proj[:, t].float() + rec.reshape(4, batch, d) + bf
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
