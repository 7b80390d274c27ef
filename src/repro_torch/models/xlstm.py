"""xLSTM blocks: mLSTM (matrix memory, chunked parallel form) and sLSTM
(scalar memory, true recurrence), per arXiv:2405.04517.

Port of src/repro/models/xlstm.py.  mLSTM per head (state C: (dk, dv)
matrix, normalizer n: (dk,)):

    m_t = max(f~_t + m_{t-1}, i~_t)                (log-space stabilizer)
    C_t = exp(f~_t + m_{t-1} - m_t) C_{t-1} + exp(i~_t - m_t) k_t (x) v_t
    n_t = exp(f~_t + m_{t-1} - m_t) n_{t-1} + exp(i~_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

The JAX side has no kernel for the mLSTM: its chunked form is plain torch
here, as XLA products there.  The intra-chunk terms of every chunk are
batched products (the elementwise decay weights are multiplied first, so
no (B, Q, Q, H, P) intermediate is built); only the state path, q C and
the C update, walks the chunks in order.  All of it in IEEE fp32.

The sLSTM block always runs its recurrence through
`kernels.slstm_step.ops.slstm_seq` (K3): the CUDA kernel on the card, its
plain version on the CPU.  The JAX side's manual-over-DP wrapper
(`slstm_block_auto`) has no meaning on one card.  Decode steps stay plain
(one cell step; K3 is a sequence kernel) and update the cache in place
(JAX returns a new one); the cache layouts are the JAX ones.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.slstm_step import ops
from repro_torch.kernels.slstm_step.ref import GATES, log_sigmoid
from repro_torch.models.layers import dense_init

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(
    gen: torch.Generator, d_model: int, n_heads: int, *, proj_factor: int = 2,
    conv_width: int = 4, dtype: torch.dtype = torch.float32, lead: Tuple[int, ...] = (),
) -> dict:
    """mLSTM params (with optional leading layer dims) in the JAX layouts;
    q/k/v are block-diagonal per head, (H, P, P)."""
    d_inner = proj_factor * d_model
    p = d_inner // n_heads
    dev = gen.device
    return {
        "up": dense_init(gen, (*lead, d_model, d_inner), dtype, fan_in=d_model),
        "gate": dense_init(gen, (*lead, d_model, d_inner), dtype, fan_in=d_model),
        "conv_w": dense_init(gen, (*lead, conv_width, d_inner), dtype, fan_in=conv_width),
        "conv_b": torch.zeros(*lead, d_inner, dtype=dtype, device=dev),
        "wq": dense_init(gen, (*lead, n_heads, p, p), dtype, fan_in=p),
        "wk": dense_init(gen, (*lead, n_heads, p, p), dtype, fan_in=p),
        "wv": dense_init(gen, (*lead, n_heads, p, p), dtype, fan_in=p),
        "wi": dense_init(gen, (*lead, d_inner, n_heads), dtype, fan_in=d_inner),
        "wf": dense_init(gen, (*lead, d_inner, n_heads), dtype, fan_in=d_inner),
        "f_bias": torch.full((*lead, n_heads), 3.0, dtype=dtype, device=dev),
        "norm_scale": torch.ones(*lead, d_inner, dtype=dtype, device=dev),
        "down": dense_init(gen, (*lead, d_inner, d_model), dtype, fan_in=d_inner),
    }


def _mlstm_chunked(
    q: torch.Tensor,  # (B, S, H, P)
    k: torch.Tensor,
    v: torch.Tensor,
    ig: torch.Tensor,  # (B, S, H) raw input-gate logits
    fg: torch.Tensor,  # (B, S, H) raw forget-gate logits (log f via logsigmoid)
    chunk: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Stabilized chunkwise mLSTM: h (B, S, H, P) fp32 and the final
    (C (B, H, P, P), n (B, H, P), m (B, H))."""
    b, s, h, p = q.shape
    qn = min(chunk, s)
    while s % qn:
        qn //= 2
    nc = s // qn

    def chunks(t: torch.Tensor) -> torch.Tensor:  # (B, S, H, ...) -> (B, H, nc, Q, ...)
        return t.float().reshape(b, nc, qn, h, *t.shape[3:]).movedim(3, 1).contiguous()

    qf = chunks(q) * (p ** -0.5)
    kf, vf = chunks(k), chunks(v)
    igf = chunks(ig)  # (B, H, nc, Q)
    Fc = torch.cumsum(log_sigmoid(chunks(fg)), dim=-1)  # inclusive log-decay in the chunk
    Ftot = Fc[..., -1]  # (B, H, nc)

    # Intra-chunk log weights D[i, j] = F_i - F_j + ig_j (i >= j).
    D = Fc[..., :, None] - Fc[..., None, :] + igf[..., None, :]  # (B, H, nc, Q, Q)
    causal = torch.ones(qn, qn, dtype=torch.bool, device=q.device).tril()
    D = D.masked_fill(~causal, NEG)
    m_intra = D.amax(-1)  # (B, H, nc, Q)
    # Decay of contribution j to the chunk end, and its per-chunk stabilizer.
    w = Ftot[..., None] - Fc + igf  # (B, H, nc, Q)
    m_w = w.amax(-1)  # (B, H, nc)

    # The carried stabilizer at each chunk's start and end (a scan of scalars).
    m = torch.full((b, h), NEG, device=q.device)
    m_start, m_end = [], []
    for c in range(nc):
        m_start.append(m)
        m = torch.maximum(Ftot[..., c] + m, m_w[..., c])
        m_end.append(m)
    m_start, m_end = torch.stack(m_start, -1), torch.stack(m_end, -1)  # (B, H, nc)

    # Position stabilizer: intra vs. inter (state) path.
    m_inter = Fc + m_start[..., None]  # (B, H, nc, Q)
    m_i = torch.maximum(m_intra, m_inter)

    # Intra contributions, every chunk at once: weights times q.k, then one product.
    wqk = torch.exp(D - m_i[..., None]) * (qf @ kf.transpose(-1, -2))  # (B, H, nc, Q, Q)
    num = wqk @ vf  # (B, H, nc, Q, P)
    den = wqk.sum(-1)  # (B, H, nc, Q)
    del wqk, D

    # Inter (state) contributions: q C_prev, then the carry update, chunk by chunk.
    s_carry = torch.exp(Ftot + m_start - m_end)  # (B, H, nc)
    kw = kf * torch.exp(w - m_end[..., None])[..., None]  # (B, H, nc, Q, P)
    C = torch.zeros(b, h, p, p, device=q.device)
    n = torch.zeros(b, h, p, device=q.device)
    qC = torch.empty_like(num)
    qnv = torch.empty_like(den)
    for c in range(nc):
        qc = qf[:, :, c]
        qC[:, :, c] = qc @ C
        qnv[:, :, c] = (qc @ n[..., None])[..., 0]
        sc = s_carry[..., c]
        C = sc[..., None, None] * C + kw[:, :, c].transpose(-1, -2) @ vf[:, :, c]
        n = sc[..., None] * n + kw[:, :, c].sum(-2)

    scale_state = torch.exp(m_inter - m_i)  # (B, H, nc, Q)
    num = num + scale_state[..., None] * qC
    den = den + scale_state * qnv
    h_out = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
    return h_out.movedim(1, 3).reshape(b, s, h, p), (C, n, m)


def _conv_heads(params: dict, conv: torch.Tensor, u: torch.Tensor, n_heads: int):
    """q, k from the convolved stream and v from the up projection, each
    through its block-diagonal per-head matrix: (..., H, P) each."""
    dt = conv.dtype
    conv_h = conv.reshape(*conv.shape[:-1], n_heads, -1)
    u_h = u.reshape(*u.shape[:-1], n_heads, -1)
    q = torch.einsum("...hp,hpq->...hq", conv_h, params["wq"].to(dt))
    k = torch.einsum("...hp,hpq->...hq", conv_h, params["wk"].to(dt))
    v = torch.einsum("...hp,hpq->...hq", u_h, params["wv"].to(dt))
    return q, k, v


def _out(params: dict, h: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """RMS-normalize the fp32 cell output, gate it, project down."""
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()
    h = h.to(gate.dtype) * F.silu(gate)
    return h @ params["down"].to(gate.dtype)


def mlstm_block(params: dict, x: torch.Tensor, *, n_heads: int, proj_factor: int = 2,
                chunk: int = 128, return_cache: bool = False):
    """The mLSTM mixer over x (B, S, D) (pre-norm is the caller's); with
    return_cache also {"conv_buf" (B, w-1, d_inner), "C", "n", "m"}."""
    b, s, d_model = x.shape
    d_inner = proj_factor * d_model
    dt = x.dtype

    u = x @ params["up"].to(dt)
    gate = x @ params["gate"].to(dt)

    conv_w = params["conv_w"].to(dt)
    w = conv_w.shape[0]
    pad = F.pad(u, (0, 0, w - 1, 0))
    conv = torch.zeros_like(u)
    for i in range(w):
        conv = conv + pad[:, i: i + s, :] * conv_w[i]
    conv = F.silu(conv + params["conv_b"].to(dt))

    q, k, v = _conv_heads(params, conv, u, n_heads)
    ig = conv @ params["wi"].to(dt)  # (B, S, H)
    fg = conv @ params["wf"].to(dt) + params["f_bias"].to(dt)

    h, (C, n, m) = _mlstm_chunked(q, k, v, ig, fg, chunk)  # fp32
    out = _out(params, h.reshape(b, s, d_inner), gate)
    if not return_cache:
        return out
    return out, {"conv_buf": u[:, -(w - 1):, :], "C": C, "n": n, "m": m}


def init_mlstm_cache(batch: int, d_model: int, n_heads: int, *, proj_factor: int = 2,
                     conv_width: int = 4, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = "cuda", lead: Tuple[int, ...] = ()) -> dict:
    """The mLSTM decode state, with optional leading (layer) dims: conv_buf
    in `dtype`, C, n and m in fp32; m = -1e30, the rest zero.  On the card
    unless the CPU is asked for."""
    dev = resolve_device(device)
    d_inner = proj_factor * d_model
    p = d_inner // n_heads
    return {
        "conv_buf": torch.zeros(*lead, batch, conv_width - 1, d_inner, dtype=dtype, device=dev),
        "C": torch.zeros(*lead, batch, n_heads, p, p, device=dev),
        "n": torch.zeros(*lead, batch, n_heads, p, device=dev),
        "m": torch.full((*lead, batch, n_heads), NEG, device=dev),
    }


def mlstm_decode(params: dict, x: torch.Tensor, cache: dict, *, n_heads: int,
                 proj_factor: int = 2) -> Tuple[torch.Tensor, dict]:
    """One recurrent mLSTM step on x (B, 1, D); the cache is updated in
    place and returned."""
    d_model = x.shape[-1]
    d_inner = proj_factor * d_model
    p = d_inner // n_heads
    dt = x.dtype

    u = x[:, 0] @ params["up"].to(dt)
    gate = x[:, 0] @ params["gate"].to(dt)
    buf = torch.cat([cache["conv_buf"], u[:, None, :]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", buf, params["conv_w"].to(dt))
                  + params["conv_b"].to(dt))

    q, k, v = (t.float() for t in _conv_heads(params, conv, u, n_heads))  # (B, H, P)
    q = q * (p ** -0.5)
    ig = (conv @ params["wi"].to(dt)).float()
    fg = log_sigmoid((conv @ params["wf"].to(dt) + params["f_bias"].to(dt)).float())

    m_new = torch.maximum(fg + cache["m"], ig)
    sf = torch.exp(fg + cache["m"] - m_new)
    si = torch.exp(ig - m_new)
    bh = q.shape[0] * n_heads
    C = cache["C"]  # (B, H, P, P): C <- sf C + (si k) (x) v, in place
    C.mul_(sf[..., None, None]).view(bh, p, p).baddbmm_(
        (si[..., None] * k).reshape(bh, p, 1), v.reshape(bh, 1, p))
    n = cache["n"].mul_(sf[..., None]).add_(si[..., None] * k)
    num = (q[..., None, :] @ C)[..., 0, :]  # (B, H, P)
    den = torch.maximum((q * n).sum(-1).abs(), torch.exp(-m_new))
    cache["m"].copy_(m_new)
    cache["conv_buf"].copy_(buf[:, 1:, :])

    out = _out(params, (num / den[..., None]).reshape(-1, d_inner), gate)
    return out[:, None, :], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int, *,
               dtype: torch.dtype = torch.float32, lead: Tuple[int, ...] = ()) -> dict:
    """sLSTM params per gate g in i, f, z, o: w_g (D, D), r_g (H, P, P)
    indexed (in, out), b_g (D) (3.0 for f, else 0)."""
    p = d_model // n_heads
    dev = gen.device
    params = {}
    for g in GATES:
        params[f"w_{g}"] = dense_init(gen, (*lead, d_model, d_model), dtype, fan_in=d_model)
        params[f"r_{g}"] = dense_init(gen, (*lead, n_heads, p, p), dtype, fan_in=p)
        params[f"b_{g}"] = torch.full((*lead, d_model), 3.0 if g == "f" else 0.0,
                                      dtype=dtype, device=dev)
    return params


def init_slstm_cache(batch: int, d_model: int, *, device: DeviceLike = "cuda",
                     lead: Tuple[int, ...] = ()) -> dict:
    """The sLSTM decode state {h, c, n, m} (*lead, B, D) in fp32, m = -1e30.
    On the card unless the CPU is asked for."""
    dev = resolve_device(device)
    state = {name: torch.zeros(*lead, batch, d_model, device=dev) for name in ("h", "c", "n")}
    state["m"] = torch.full((*lead, batch, d_model), NEG, device=dev)
    return state


def _slstm_cell(params: dict, x_t: torch.Tensor, state: dict, n_heads: int) -> Tuple[dict, torch.Tensor]:
    """One sLSTM time step. x_t (B, D), fp32 state; returns the new state and h."""
    d = state["h"].shape[-1]
    h_prev = state["h"].reshape(-1, n_heads, d // n_heads)

    def gate(name):
        rec = torch.einsum("bhp,hpq->bhq", h_prev, params[f"r_{name}"].float())
        inp = (x_t @ params[f"w_{name}"].to(x_t.dtype)).float()
        return inp + rec.reshape(-1, d) + params[f"b_{name}"].float()

    i_raw, f_raw, z_raw, o_raw = gate("i"), gate("f"), gate("z"), gate("o")
    lf = log_sigmoid(f_raw)
    m_new = torch.maximum(lf + state["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(lf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_raw)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(o_raw) * c / n.clamp_min(1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}, h


def slstm_block(params: dict, x: torch.Tensor, *, n_heads: int, return_cache: bool = False):
    """The sLSTM mixer over x (B, S, D): the four input projections hoisted
    over the sequence, then the whole recurrence in one `slstm_seq` call
    (one K3 launch on the card).  With return_cache also the final state
    {"h", "c", "n", "m"} (B, D) fp32."""
    hs, (c, n, m) = ops.slstm_seq(*ops.stack_gates(params, x, n_heads))  # h (S, B, D) fp32
    out = hs.transpose(0, 1).to(x.dtype)
    if not return_cache:
        return out
    return out, {"h": hs[-1].clone(), "c": c, "n": n, "m": m}


def slstm_decode(params: dict, x: torch.Tensor, cache: dict, *, n_heads: int) -> Tuple[torch.Tensor, dict]:
    """One sLSTM step on x (B, 1, D); the cache is updated in place and returned."""
    state, h = _slstm_cell(params, x[:, 0], cache, n_heads)
    for name, t in state.items():
        cache[name].copy_(t)
    return h[:, None, :].to(x.dtype), cache


# ---------------------------------------------------------------------------
# Sequential mLSTM reference (tests only)
# ---------------------------------------------------------------------------


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ig: torch.Tensor,
              fg: torch.Tensor) -> torch.Tensor:
    """Step-by-step stabilized recurrence; the oracle of _mlstm_chunked."""
    b, s, h, p = q.shape
    qf = q.float() * (p ** -0.5)
    kf, vf, igf = k.float(), v.float(), ig.float()
    lff = log_sigmoid(fg.float())
    C = torch.zeros(b, h, p, p, device=q.device)
    n = torch.zeros(b, h, p, device=q.device)
    m = torch.full((b, h), NEG, device=q.device)
    hs = []
    for t in range(s):
        m_new = torch.maximum(lff[:, t] + m, igf[:, t])
        sf = torch.exp(lff[:, t] + m - m_new)
        si = torch.exp(igf[:, t] - m_new)
        C = sf[..., None, None] * C + si[..., None, None] * (kf[:, t, :, :, None] * vf[:, t, :, None, :])
        n = sf[..., None] * n + si[..., None] * kf[:, t]
        num = (qf[:, t, :, None, :] @ C)[..., 0, :]
        den = torch.maximum((qf[:, t] * n).sum(-1).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1)
