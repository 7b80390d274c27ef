"""Centralized baselines the paper compares against.

Port of src/repro/core/baselines.py.

1. `fista_coder`: primal FISTA sparse coding on the *full* dictionary with
   elastic-net / nonneg-elastic-net regularizers (the role SPAMS/LARS plays
   in the paper's experiments).  Also the independent oracle for the dual
   engines: by strong duality the primal FISTA objective and the dual value
   coincide at the optimum.

2. `MairalLearner`: Mairal et al. (2010) online dictionary learning with the
   (A_t, B_t) sufficient-statistic accumulators and block-coordinate
   dictionary updates; the "[6] centralized" column of the paper's Fig. 5 /
   Table III.

Plain PyTorch on `device` (the card unless the CPU is asked for).  As in the
reference, `MairalLearner.fit` drops a final partial minibatch, where
`DictionaryLearner.fit` processes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.conjugates import Regularizer, soft_threshold, soft_threshold_pos
from repro_torch.core.dictionary import init_dictionary
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Primal FISTA (elastic net; l2 residual)
# ---------------------------------------------------------------------------


@torch.no_grad()
def fista_coder(reg: Regularizer, W: Tensor, x: Tensor, iters: int = 200) -> Tensor:
    """argmin_y 0.5||x - W y||^2 + gamma|y|_1(+) + delta/2 ||y||^2 via FISTA.

    The smooth part is 0.5||x - Wy||^2 + delta/2||y||^2 with Lipschitz
    constant sigma_max(W)^2 + delta, estimated by 30 power iterations from
    1/sqrt(K) (the last norm); the prox of gamma|.|_1 is the soft threshold
    (one-sided for the nonneg variant).
    """
    thresh = soft_threshold_pos if reg.nonneg else soft_threshold
    k = W.shape[1]
    v = torch.full((k,), 1.0 / math.sqrt(k), dtype=W.dtype, device=W.device)
    for _ in range(30):
        v = W.T @ (W @ v)
        sig = torch.linalg.vector_norm(v)
        v = v / (sig + 1e-30)
    L = sig + reg.delta

    def smooth_grad(y):
        r = y @ W.T - x
        return r @ W + reg.delta * y

    y = torch.zeros(x.shape[:-1] + (k,), dtype=x.dtype, device=x.device)
    z, t = y, 1.0
    for _ in range(iters):
        y_next = thresh(z - smooth_grad(z) / L, reg.gamma / L)
        t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        z = y_next + ((t - 1.0) / t_next) * (y_next - y)
        y, t = y_next, t_next
    return y


# ---------------------------------------------------------------------------
# Mairal et al. (2010) online dictionary learning
# ---------------------------------------------------------------------------


class MairalState(NamedTuple):
    W: Tensor  # (M, K)
    A: Tensor  # (K, K) sum y y^T
    B: Tensor  # (M, K) sum x y^T
    t: int  # sample counter


@dataclasses.dataclass(frozen=True)
class MairalConfig:
    m: int
    k: int
    gamma: float = 0.1
    delta: float = 0.1
    nonneg: bool = False
    code_iters: int = 200
    dict_bcd_iters: int = 2
    seed: int = 0


class MairalLearner:
    """Centralized online dictionary learning (the paper's benchmark [6])."""

    def __init__(self, cfg: MairalConfig, reg: Regularizer, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.reg = reg
        self.device = resolve_device(device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> MairalState:
        """Random unit-norm W from `generator` (default: seeded with cfg.seed)
        and zero statistics."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        W = init_dictionary(generator, cfg.m, cfg.k, nonneg=cfg.nonneg, device=self.device)
        return MairalState(
            W=W,
            A=torch.zeros((cfg.k, cfg.k), device=self.device),
            B=torch.zeros((cfg.m, cfg.k), device=self.device),
            t=0,
        )

    def _proj_col(self, c: Tensor) -> Tensor:
        if self.cfg.nonneg:
            c = torch.clamp(c, min=0.0)
        return c / torch.clamp(torch.linalg.vector_norm(c), min=1.0)

    def _dict_bcd(self, W: Tensor, A: Tensor, B: Tensor) -> Tensor:
        """Block-coordinate dictionary update (Mairal Alg. 2): Gauss-Seidel
        over the columns, each update seeing the columns updated before it."""
        W = W.clone()
        diag = torch.diagonal(A)
        for _ in range(self.cfg.dict_bcd_iters):
            for j in range(self.cfg.k):
                a_jj = torch.clamp(diag[j], min=1e-8)
                u = (B[:, j] - W @ A[:, j]) / a_jj + W[:, j]
                W[:, j] = self._proj_col(u)
        return W

    @torch.no_grad()
    def fit_batch(self, state: MairalState, x) -> Tuple[MairalState, Tensor]:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = fista_coder(self.reg, state.W, x, iters=self.cfg.code_iters)
        bsz = x.shape[0]
        A = state.A + y.T @ y / bsz
        B = state.B + x.T @ y / bsz
        W = self._dict_bcd(state.W, A, B)
        obj = (
            0.5 * torch.sum((x - y @ W.T) ** 2, dim=-1)
            + self.reg.gamma * torch.sum(torch.abs(y), dim=-1)
            + 0.5 * self.reg.delta * torch.sum(y * y, dim=-1)
        ).mean()
        return MairalState(W=W, A=A, B=B, t=state.t + 1), obj

    def fit(self, state: MairalState, X, batch_size: int = 4):
        """One pass over the full minibatches of X; a final partial minibatch
        is dropped, as in the reference."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        n = (X.shape[0] // batch_size) * batch_size
        obj = None
        for xb in X[:n].reshape(-1, batch_size, X.shape[1]):
            state, obj = self.fit_batch(state, xb)
        return state, obj
