"""The gradient of the sLSTM sequence recurrence: backpropagation through
time in plain PyTorch, fp32 whatever the input dtype.

The JAX package has no backward kernel: its training path runs the
recurrence as a `lax.scan` of `_slstm_cell` (src/repro/models/xlstm.py),
which XLA differentiates, and the Pallas kernel has no gradient.  This is
the port's counterpart, the backward of the function K3 computes
(`ref.slstm_seq_ref`).  Nothing of the forward is kept but its inputs and
its output h; the work that does not depend on the recurrence runs outside
the time loops:

  * the raw gates x_proj + h_{t-1} R + b of every step, from the saved h,
    in one batched product (a (S B, P) x (P, 4 P) product per head);
  * dR = sum_t h_{t-1}^T draw_t as one batched product after the loops,
    db as one sum, dx_proj = draw itself.

What stays sequential, in plain loops over S: the elementwise forward scan
of the stabilizer m and of (c, n), and the reverse loop, which carries dh,
dc and dn and makes one (B, 4 P) x (4 P, P) product per head and step for
the recurrent term draw_t R^T.

The stabilizer m carries no gradient, and that is exact.  In the forward
n_0 = 1 (m_0 = raw_i, so i_s = 1), and n_t >= 1 at every later step:
either m_t = raw_i, so i_s = 1, or m_t = lf + m_{t-1}, so f_s = 1, and
n_t = f_s n_{t-1} + i_s.  So the 1e-6 clamp of n never binds, and h = o c
/ n does not depend on m: shifting m scales c and n alike.  The exact
derivative through m is therefore zero, and the backward holds m constant:

    d i_s = i_s d raw_i,   d f_s = f_s d lf,   d raw_f = sigmoid(-raw_f) d lf.

`jax.grad` of the scan differentiates through `jnp.maximum` as well and
carries terms that cancel; the two differ only by rounding
(tests/test_torch_slstm_grad.py holds them together).  The final (c, n, m)
do depend on m, and `ops.SlstmSeq` refuses a gradient for them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.slstm_step.ref import NEG, log_sigmoid


def previous(hs: torch.Tensor) -> torch.Tensor:
    """h_{t-1} for every step t of hs (S, ...): zero, then hs[:-1]."""
    return torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])


def transposed(Rf: torch.Tensor) -> torch.Tensor:
    """R (4, H, P, P), (in, out) per head, as R^T stacked over the gates:
    (H, 4 P, P) indexed [h, g P + out, in], the recurrent term's matrix."""
    n_heads, p = Rf.shape[1], Rf.shape[2]
    return Rf.permute(1, 0, 3, 2).reshape(n_heads, 4 * p, p)


def carried(dcn: torch.Tensor, f_s: torch.Tensor) -> torch.Tensor:
    """The (dc, dn) carry into step t - 1: (dc_t, dn_t) f_s, in dcn's
    storage."""
    return dcn.mul_(f_s)


def slstm_backward(
    x_proj: torch.Tensor,  # (4, S, B, D) gate inputs i, f, z, o
    R: torch.Tensor,  # (4, H, P, P) recurrent weights, (in, out) per head
    b: torch.Tensor,  # (4, D)
    h: torch.Tensor,  # (S, B, D) the forward's output
    dh: torch.Tensor,  # (S, B, D) the cotangent of h
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx_proj, dR, db) of `slstm_seq`'s h at (x_proj, R, b), each in its
    input's dtype."""
    _, s, batch, d = x_proj.shape
    nh, p = R.shape[1], R.shape[2]
    dev = x_proj.device
    Rf = R.float()

    def heads(t: torch.Tensor) -> torch.Tensor:  # (S, B, D) -> (S, H, B, P)
        return t.float().reshape(s, batch, nh, p).transpose(1, 2).contiguous()

    hs = heads(h)
    # The raw gates of every step in one product per head: (S B, P) x (P, 4 P).
    R_in = Rf.permute(1, 2, 0, 3).reshape(nh, p, 4 * p)  # [h, in, g P + out]
    hp_rows = previous(hs).transpose(0, 1).reshape(nh, s * batch, p)  # h_{t-1} rows
    raw = torch.bmm(hp_rows, R_in).view(nh, s, batch, 4, p).permute(1, 0, 2, 3, 4)
    raw = raw + (x_proj.float().view(4, s, batch, nh, p).permute(1, 3, 2, 0, 4)
                 + b.float().view(4, 1, nh, 1, p).permute(1, 2, 3, 0, 4))
    gi, gf, gz, go = raw.unbind(3)  # each (S, H, B, P)
    del raw

    # The forward scan: m step by step, then (c, n) as one stacked recurrence.
    lf = log_sigmoid(gf)
    m = torch.empty_like(gi)
    m_prev = torch.full_like(gi[0], NEG)
    for t in range(s):
        m_prev = torch.maximum(lf[t] + m_prev, gi[t], out=m[t])
    m_before = torch.cat([torch.full_like(m[:1], NEG), m[:-1]])
    i_s = torch.exp(gi - m)
    f_s = torch.exp(lf + m_before - m)
    del m, m_before
    tz = torch.tanh(gz)
    cn_in = torch.stack([i_s * tz, i_s], dim=3)  # (S, H, B, 2, P)
    cn = torch.empty_like(cn_in)
    f_b = f_s.unsqueeze(3)
    prev = torch.zeros_like(cn_in[0])
    for t in range(s):
        prev = torch.addcmul(cn_in[t], f_b[t], prev, out=cn[t])
    del cn_in
    c, n = cn.unbind(3)
    cn_before = torch.cat([torch.zeros_like(cn[:1]), cn[:-1]])

    # The reverse loop's coefficients, all steps at once.  At step t, with
    # dh the cotangent of h_t (incoming and recurrent):
    #   (dc, dn) = carry + dh (o_s / n, -h / n)
    #   draw_{i,f,z} = dc K_c + dn K_n,   draw_o = dh h (1 - o_s)
    #   carry = (dc, dn) f_s,   dh_{t-1} += sum_g draw_g R_g^T
    o_s = torch.sigmoid(go)
    dcn_of_dh = torch.stack([o_s / n, -hs / n], dim=3)  # (S, H, B, 2, P)
    df = f_s * torch.sigmoid(-gf)
    # K[:, :, :, j, g]: the weight of dc (j 0) or dn (j 1) in draw_g, g i, f, z.
    K = torch.stack([
        torch.stack([i_s * tz, cn_before[:, :, :, 0] * df, i_s * (1 - tz * tz)], dim=3),
        torch.stack([i_s, cn_before[:, :, :, 1] * df, torch.zeros_like(i_s)], dim=3),
    ], dim=3)  # (S, H, B, 2, 3, P)
    d_o = hs * (1 - o_s)
    del gi, gf, gz, go, lf, i_s, tz, o_s, df, c, n, cn, cn_before

    R_out = transposed(Rf)
    dhs = heads(dh)
    draw = torch.empty(s, nh, batch, 4, p, device=dev)
    carry = torch.zeros(nh, batch, 2, p, device=dev)
    dh_t = dhs[-1].clone()
    for t in range(s - 1, -1, -1):
        dcn = torch.addcmul(carry, dh_t.unsqueeze(2), dcn_of_dh[t])  # (H, B, 2, P)
        torch.sum(dcn.unsqueeze(3) * K[t], dim=2, out=draw[t, :, :, :3])
        torch.mul(dh_t, d_o[t], out=draw[t, :, :, 3])
        carry = carried(dcn, f_b[t])
        if t:
            dh_t = torch.baddbmm(dhs[t - 1], draw[t].view(nh, batch, 4 * p), R_out)
    del K, dcn_of_dh, d_o, f_b, carry, dhs

    # dR = sum over steps and rows of h_{t-1}^T draw_t, per head and gate.
    draw_rows = draw.transpose(0, 1).reshape(nh, s * batch, 4 * p)
    dR = torch.bmm(hp_rows.transpose(1, 2), draw_rows).view(nh, p, 4, p).permute(2, 0, 1, 3)
    del hp_rows, draw_rows
    db = draw.sum(dim=(0, 2)).permute(1, 0, 2).reshape(4, d)
    dx = draw.permute(3, 0, 2, 1, 4).reshape(4, s, batch, d)
    return dx.to(x_proj.dtype), dR.to(R.dtype), db.to(b.dtype)


def backward_flops(b: int, s: int, d: int, n_heads: int) -> int:
    """Multiply-add flops of slstm_backward's three products as it runs
    them: the raw gates' recompute h_{t-1} R, the recurrent term draw R^T
    (every step but the first) and dR = h^T draw, each 2 x 4 P per (step,
    row, column of D)."""
    p = d // n_heads
    return 2 * 4 * p * b * d * (3 * s - 1)
