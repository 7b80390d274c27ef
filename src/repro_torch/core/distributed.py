"""Production engine for model-distributed dictionary learning.

Port of `DistributedSparseCoder` in src/repro/core/distributed.py, every
gossip mode, in two layouts:

  * one process (no `mesh`): all N agents live on one device as the
    leading axis of every tensor: the dictionary is (N, M, Kb), the
    per-agent duals (N, B, M), the codes (N, B, Kb);
  * on a mesh (`mesh=`, runtime/mesh.py), as the JAX engine: agent k is
    rank k of the `model` axis (the hierarchical modes: the flat
    outermost-major rank of the level axes, `pod` x `model` for hier, one
    `pod<i>` axis more per outer chain level), and holds only its block W_k
    as (1, M, Kb); the sample batch is split over `data`, each data rank
    coding its rows.  The step size is pmax'd (psum'd, exact modes) over
    the agent axes, `fit_batch` sums nu^T y and the row count over `data`,
    `score` sums h* over the agent axes.

Gossip goes through the single seam `repro_torch.runtime.comm`: its local
wire (a roll of the agent axis) in one process, its mesh wire
(`Mesh.ppermute` rounds, one `psum`) on a mesh; the solver body is the
same code in both layouts.

Every iteration of every mode spends its time in one per-agent product,
S = nu W_k, Y = T_gamma(S)/delta, G = Y W_k^T.  It always goes through
`kernels.dict_dual_step.ops.dict_dual_step`: the hand-written CUDA kernel
on a CUDA tensor (launched or raising, never a fallback), its plain
version on a CPU tensor; a solve makes iters + 1 calls.  The exact modes
share one nu between all agents and pass it with agent stride 0.

Modes (JAX's, in its order):
  exact        projected gradient on the summed dual: one sum over agents
               of the back-projections per iteration (fully-connected A).
  exact_fista  exact + strongly-convex Nesterov momentum, beta from c_f and
               L = 1/mu.
  ring         diffusion with the constant-weight [beta, 1-2beta, beta]
               ring combiner; the combine projects after mixing.
  ring_q8      ring over the int8 wire: each agent quantizes its message
               psi + err once per iteration (per-row scale, error feedback
               err), the neighbors dequantize what they receive.
  ring_async   ring combining the neighbors' messages of the previous
               iteration (zero at the first).
  graph        diffusion under any doubly-stochastic combiner of
               core/topology.make_topology, compiled to edge-offset rounds.
  graph_q8     graph over the int8 wire, as ring_q8.
  graph_async  graph combining the previous iteration's round messages.
  graph_tv     diffusion under a time-varying sequence A_t
               (core/topology.TopologySchedule, `topology_schedule`),
               optionally with seeded link failures (`failure_p`); the
               iteration t0 + i of a solve uses A_{(t0 + i) mod P}.
  graph_tv_q8  graph_tv over the int8 wire.
  push         push-sum: a weight w (1 at the start) rides beside w psi,
               the update divides by the combined weight, so A need only
               be row stochastic (directed kinds "dicycle", "distar").
  push_q8      push with the int8 wire on w psi; the weight stays fp32.
  hier         two-level Kronecker diffusion A_pod (x) A_model: `topology`
               inside a pod, `pod_topology` between pods, the pod hop
               every `pod_gossip_every` iterations.
  hier_q8      hier with the int8 wire on the pod hop.
  chain        N-level Kronecker chain from `levels` (core/topology.
               LevelSpec, innermost first), each level with its own
               kind, stride, wire and, outermost only, staleness.

In the hierarchical modes the agent axis is the flat outermost-major rank
of the level grid, viewed as (n_{L-1}, ..., n_0): the order of the JAX
engine's (outer, ..., pod, model) devices, so `blocks_from_full(W, N)`
gives each agent the columns its JAX device owns.

Elastic growth and agent drain (paper Sec. IV-C) act on the model level:
`grown` appends fresh unit-norm blocks (in every outer group of a
hierarchical coder) and `shrunk` keeps the survivors' blocks bit for bit,
both on the device; the new coder re-derives its combiners from the old
one's (`grown_from` / `shrunk_from`), erdos neighbourhoods kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.conjugates import Regularizer, Residual
from repro_torch.core.dictionary import dict_update, full_from_blocks, init_dictionary
from repro_torch.core.inference import power_sigma2
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dict_dual_step import ops
from repro_torch.runtime import comm

Tensor = torch.Tensor

# The JAX engine's mesh axis names, which name the levels in stats and byte
# accounting (level 0 "model", level 1 "pod", level i >= 2 "pod<i>") and,
# on a mesh, the axes the levels run on; samples split over "data".
MODEL_AXIS, POD_AXIS, DATA_AXIS = "model", "pod", "data"
# ROADMAP section 1's items for what a mesh does not run yet.
MESH_GROWTH_ITEM = "ROADMAP section 1, item 8 (growth and drain on a mesh)"


@dataclasses.dataclass(frozen=True)
class ModeCaps:
    """One row of the mode registry: the solver branch (`family`) and
    whether the mode quantizes its messages, runs a time-varying combiner
    sequence, spans several levels, or combines one-step-stale messages."""

    family: str
    quantized: bool = False
    time_varying: bool = False
    hierarchical: bool = False
    stale: bool = False


MODE_REGISTRY = {
    "exact": ModeCaps(family="exact"),
    "exact_fista": ModeCaps(family="exact"),
    "ring": ModeCaps(family="ring"),
    "ring_q8": ModeCaps(family="ring", quantized=True),
    "ring_async": ModeCaps(family="ring", stale=True),
    "graph": ModeCaps(family="graph"),
    "graph_q8": ModeCaps(family="graph", quantized=True),
    "graph_async": ModeCaps(family="graph", stale=True),
    "graph_tv": ModeCaps(family="tv", time_varying=True),
    "graph_tv_q8": ModeCaps(family="tv", quantized=True, time_varying=True),
    "push": ModeCaps(family="push"),
    "push_q8": ModeCaps(family="push", quantized=True),
    "hier": ModeCaps(family="chain", hierarchical=True),
    "hier_q8": ModeCaps(family="chain", quantized=True, hierarchical=True),
    "chain": ModeCaps(family="chain", hierarchical=True),
}
MODES = tuple(MODE_REGISTRY)
PORTED_MODES = MODES
HIER_MODES = ("hier", "hier_q8")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Configuration of the dual solver (the JAX `DistConfig` fields that
    change what the coder computes; the mesh axis names and the Pallas
    switches are JAX-only).

      mode               one of MODES.
      iters              dual iterations per solve.
      mu                 dual step size; <= 0 selects the curvature-adaptive
                         safe step (max over agents for the gossip modes,
                         the loose summed bound for the exact modes).
      beta               ring combiner weight, in [0, 1/2].
      topology           combiner kind (core/topology.make_topology): the
                         graph modes', the intra-pod kind of hier; the
                         directed kinds only for the push modes.
      topology_p         erdos edge probability.
      topology_seed      seed of every topology draw (static and sequence).
      topology_schedule  time-varying modes: a make_topology_schedule spec
                         ("fixed:<kind>", "alternating:<k1>,<k2>,...",
                         "erdos_resampled"); "" or "fixed" wraps `topology`.
      schedule_period    period of "erdos_resampled".
      failure_p          time-varying modes: per-step, per-edge link
                         dropout probability in [0, 1).
      failure_seed       seed of the failure draws.
      failure_steps      failure realizations before the trace repeats
                         (0 = the base schedule's period).
      pod_topology       hier modes (required): the inter-pod kind.
      pod_gossip_every   hier modes: the pod hop every k-th iteration.
      levels             mode="chain" only: LevelSpecs innermost first, or
                         a core/topology.parse_level_specs string.
      informed           "all" (every agent sees x) or "one" (only flat
                         agent 0).
    """

    mode: str = "exact_fista"
    iters: int = 100
    mu: float = -1.0
    beta: float = 1.0 / 3.0
    topology: str = "ring_metropolis"
    topology_p: float = 0.5
    topology_seed: int = 0
    topology_schedule: Optional[str] = "alternating:ring_metropolis,torus"
    schedule_period: int = 2
    failure_p: float = 0.0
    failure_seed: int = 0
    failure_steps: int = 0
    pod_topology: str = ""
    pod_gossip_every: int = 1
    levels: Tuple[topo.LevelSpec, ...] = ()
    informed: str = "all"

    def __post_init__(self):
        if isinstance(self.levels, str):
            object.__setattr__(
                self, "levels", topo.parse_level_specs(self.levels) if self.levels else ()
            )
        else:
            object.__setattr__(self, "levels", tuple(self.levels))
        caps = MODE_REGISTRY.get(self.mode)
        if caps is None:
            raise KeyError(f"unknown mode {self.mode!r}; options: {MODES}")
        if not 0.0 <= self.beta <= 0.5:
            raise ValueError(
                f"DistConfig.beta={self.beta} outside the admissible range "
                f"[0, 1/2]: the ring combiner [beta, 1-2*beta, beta] needs "
                f"beta <= 1/2 to keep all weights nonnegative"
            )
        if self.informed not in ("all", "one"):
            raise ValueError(f"informed must be 'all' or 'one', got {self.informed!r}")
        if self.iters < 0:
            raise ValueError(f"iters must be >= 0, got {self.iters}")
        kinds = topo.GRAPH_KINDS + (topo.DIRECTED_KINDS if caps.family == "push" else ())
        if self.topology not in kinds:
            raise ValueError(
                f"topology {self.topology!r} is not a kind mode={self.mode!r} "
                f"runs; options: {kinds} (the directed kinds are for push modes)"
            )
        if caps.time_varying and self.topology_schedule is None:
            raise ValueError(
                f"mode={self.mode!r} needs a combiner sequence but "
                f"topology_schedule is None; pass a make_topology_schedule spec "
                f"('fixed:<kind>', 'alternating:<k1>,<k2>,...', or "
                f"'erdos_resampled'), or '' for the static `topology` kind"
            )
        if self.mode in HIER_MODES and not self.pod_topology:
            raise ValueError(
                f"mode={self.mode!r} composes an inter-pod combiner with the "
                f"intra-pod one but pod_topology is not set; pass a "
                f"core/topology.make_topology kind (e.g. pod_topology='ring_metropolis')"
            )
        if self.mode == "chain" and not self.levels:
            raise ValueError(
                "mode='chain' runs an N-level Kronecker chain but levels is "
                "empty; pass LevelSpecs (innermost level first) or a "
                "parse_level_specs string like 'torus,ring_metropolis:2:q8,ring:4:q8'"
            )
        if self.levels and self.mode != "chain":
            raise ValueError(
                f"levels is only consumed by mode='chain' (got mode={self.mode!r}); "
                f"the hier modes configure their two levels via "
                f"topology/pod_topology/pod_gossip_every"
            )
        if self.pod_gossip_every < 1:
            raise ValueError(
                f"pod_gossip_every must be >= 1 (the inter-pod hop fires every "
                f"k-th iteration), got {self.pod_gossip_every}"
            )
        if not 0.0 <= self.failure_p < 1.0:
            raise ValueError(
                f"failure_p must be in [0, 1) (a per-edge dropout probability), "
                f"got {self.failure_p}"
            )
        if self.failure_p > 0 and not caps.time_varying:
            raise ValueError(
                f"failure_p > 0 injects a per-step failure realization sequence, "
                f"which only the time-varying modes run (got mode={self.mode!r}); "
                f"use mode='graph_tv'/'graph_tv_q8'"
            )
        if self.failure_steps < 0:
            raise ValueError(
                f"failure_steps must be >= 0 (0 = the base schedule's period), "
                f"got {self.failure_steps}"
            )

    def chain_levels(self) -> Tuple[topo.LevelSpec, ...]:
        """The Kronecker-chain levels, innermost first: `levels` for
        mode="chain"; for the hier modes the two-level shim (model level
        from `topology`, pod level from `pod_topology` with the
        `pod_gossip_every` stride and, for hier_q8, the q8 wire); () for the
        flat modes."""
        if not MODE_REGISTRY[self.mode].hierarchical:
            return ()
        if self.mode == "chain":
            return self.levels
        return (
            topo.LevelSpec(kind=self.topology, axis=MODEL_AXIS),
            topo.LevelSpec(
                kind=self.pod_topology, gossip_every=self.pod_gossip_every,
                wire="q8" if MODE_REGISTRY[self.mode].quantized else "fp32",
                axis=POD_AXIS,
            ),
        )

    def level_axis(self, i: int) -> str:
        """Name of chain level i: its spec's `axis`, else "model" (level 0),
        "pod" (level 1), "pod<i>" (level i >= 2)."""
        specs = self.chain_levels()
        if specs and specs[i].axis:
            return specs[i].axis
        if i == 0:
            return MODEL_AXIS
        if i == 1:
            return POD_AXIS
        return f"{POD_AXIS}{i}"


def _c_f(res: Residual, like: Tensor) -> Tensor:
    """Curvature of f*: grad f*(1) (1 for l2, eta for Huber)."""
    return res.grad_fstar(torch.ones((1,), dtype=like.dtype, device=like.device))[0]


def _safe_mu_local(res: Residual, reg: Regularizer, W: Tensor, n_agents: int,
                   wire: comm.LocalWire) -> Tensor:
    """Globally safe diffusion step 0.9 / (c_f/N + max_k sigma_max(W_k)^2/delta):
    every agent steps with the one mu that is safe for the worst block (the
    max over the blocks W holds, pmax'd over the agent axes on a mesh)."""
    sig2_max = wire.agent_max(power_sigma2(W))
    return 0.9 / (_c_f(res, W) / n_agents + sig2_max / reg.delta)


def _safe_mu_exact(res: Residual, reg: Regularizer, W: Tensor,
                   wire: comm.LocalWire) -> Tensor:
    """1/L for the summed dual with the loose bound
    sigma_max(W)^2 <= sum_k sigma_max(W_k)^2 (as the JAX engine: not
    estimate_dual_curvature); one psum over the agent axes on a mesh."""
    sig2_sum = wire.agent_sum(power_sigma2(W))
    return 1.0 / (_c_f(res, W) + sig2_sum / reg.delta)


class DistributedSparseCoder:
    """Dual-domain sparse coder over an atom-sharded dictionary: N agents
    on one device, or one agent a rank of `mesh`.

    `agents` is the number of agents N for the flat modes, and for the
    hierarchical modes (hier, hier_q8, chain) the agents of each level,
    innermost first, in the order of `cfg.chain_levels()` (N is their
    product).  On a mesh each level's mesh axis (`cfg.level_axis(i)`:
    `model`, `pod`, `pod<i>`) has that many ranks, and the `data` axis
    splits the samples; the coder's device is the mesh's.

    Usage:
        coder = DistributedSparseCoder(n_agents, res, reg, cfg, device="cuda")
        W, x = coder.shard(W_full, x)         # (N, M, Kb) blocks, (B, M)
        nu, y = coder.solve(W, x, t0=0)
        W2 = coder.fit_batch(W, x, mu_w)      # one dictionary step

    On a mesh (every rank runs the same calls, in the same order):
        coder = DistributedSparseCoder(n_agents, res, reg, cfg, mesh=mesh)
        W, x = coder.shard(W_full, x)         # this rank's (1, M, Kb), rows
        nu, y = coder.solve(W, x)             # this rank's (nu_k, y_k)
        W2 = coder.fit_batch(W, x, mu_w)      # this rank's new block
        W_full = coder.gather(W2)             # (M, K) on mesh rank 0
    """

    def __init__(
        self,
        agents: Union[int, Sequence[int]],
        res: Residual,
        reg: Regularizer,
        cfg: DistConfig,
        device: DeviceLike = "cuda",
        grown_from: Optional["DistributedSparseCoder"] = None,
        shrunk_from: Optional[Tuple["DistributedSparseCoder", Tuple[int, ...]]] = None,
        mesh=None,
    ):
        """`grown_from` and `shrunk_from` are the hooks of `grown` and
        `shrunk`: an erdos combiner (the static kind, every erdos step of a
        schedule, the erdos model level of a chain) then grows from the old
        coder's adjacency (`erdos_renyi_grow`, existing edges kept) or is
        restricted to the survivors (`shrink_adjacency`) instead of being
        drawn afresh; structured kinds re-derive at the new size, and a
        chain carries its outer levels verbatim.  `mesh` (a
        runtime/mesh.Mesh) puts one agent on each of its ranks."""
        if grown_from is not None and shrunk_from is not None:
            raise ValueError("grown_from and shrunk_from are mutually exclusive "
                             "construction hooks")
        caps = MODE_REGISTRY[cfg.mode]
        level_specs = cfg.chain_levels()
        sizes = (int(agents),) if isinstance(agents, (int, np.integer)) else tuple(
            int(a) for a in agents)
        if caps.hierarchical and len(sizes) != len(level_specs):
            raise ValueError(
                f"mode={cfg.mode!r} has {len(level_specs)} levels; pass the agents "
                f"of each level, innermost first, got {sizes}"
            )
        if not caps.hierarchical and len(sizes) != 1:
            raise ValueError(f"mode={cfg.mode!r} is flat: pass one agent count, got {sizes}")
        if min(sizes) < 1:
            raise ValueError(f"agent counts must be >= 1, got {sizes}")
        self.n_agents = math.prod(sizes)
        self.level_sizes = sizes  # agents per level, innermost first
        self.res = res
        self.reg = reg
        self.cfg = cfg
        self._caps = caps
        n = self.n_agents
        self.mesh = mesh
        level_axes = tuple(cfg.level_axis(i) for i in range(len(sizes))) \
            if caps.hierarchical else (MODEL_AXIS,)
        self._agent_axes = tuple(reversed(level_axes))  # outermost first, as JAX's
        if mesh is None:
            self.device = resolve_device(device)
            self._wire: comm.LocalWire = comm.LOCAL
            self._n_local = n  # agents this process holds
        else:
            self.device = mesh.device
            if torch.device(device).type != self.device.type:
                raise ValueError(f"device {device!r} but the mesh's ranks run on "
                                 f"{self.device.type}")
            if grown_from is not None or shrunk_from is not None:
                raise NotImplementedError(f"a grown or drained coder on a mesh: "
                                          f"{MESH_GROWTH_ITEM}")
            want = dict(zip(level_axes, sizes))
            got = {a: mesh.size(a) for a in level_axes}
            stray = [a for a in mesh.axis_names
                     if a not in level_axes and a != DATA_AXIS and mesh.size(a) > 1]
            if got != want or stray:
                raise ValueError(
                    f"mode={cfg.mode!r} with agents {sizes} (innermost first) needs the "
                    f"mesh axes {want} (one agent a rank) and {DATA_AXIS!r} for the "
                    f"samples; the mesh is {mesh.shape}")
            self._wire = comm.MeshWire(mesh, level_axes)
            self._n_local = 1
        self._A: Optional[np.ndarray] = None
        self._adj: Optional[np.ndarray] = None  # static erdos adjacency
        self._gsched: Optional[comm.GraphSchedule] = None
        self._tsched: Optional[topo.TopologySchedule] = None
        self._gscheds: Optional[Tuple[comm.GraphSchedule, ...]] = None
        self._gweights: Tuple[comm.Weights, ...] = ()
        self._htopo: Optional[topo.HierarchicalTopology] = None
        self._hsched: Optional[comm.HierSchedule] = None
        self._chain: Optional[topo.KroneckerChain] = None
        self._csched: Optional[comm.ChainSchedule] = None
        self._cweights: Tuple[comm.Weights, ...] = ()
        f32 = torch.float32
        if caps.family in ("graph", "push"):
            if cfg.topology == "erdos":
                if grown_from is not None and grown_from._adj is not None:
                    # stream (seed, step 0, n): the one TopologySchedule.grown
                    # uses for its step 0, so "fixed:erdos" grows alike
                    self._adj = topo.erdos_renyi_grow(
                        grown_from._adj, n, p=cfg.topology_p,
                        seed=topo.derive_seed(cfg.topology_seed, 0, n))
                elif shrunk_from is not None and shrunk_from[0]._adj is not None:
                    self._adj = topo.shrink_adjacency(shrunk_from[0]._adj, shrunk_from[1])
                else:
                    self._adj = topo.erdos_renyi_adjacency(
                        n, p=cfg.topology_p, seed=cfg.topology_seed)
                self._A = topo.metropolis_weights(self._adj)
            else:
                self._A = topo.make_topology(
                    cfg.topology, n, p=cfg.topology_p, seed=cfg.topology_seed, beta=cfg.beta
                )
            if caps.family == "push":
                self._gsched = comm.graph_schedule(self._A, row_stochastic=True)
            elif cfg.topology == "torus":
                self._gsched = comm.torus_schedule(*topo.torus_dims(n), self._A)
            else:
                self._gsched = comm.graph_schedule(self._A)
            self._gweights = (comm.schedule_weights(self._gsched, f32, self.device,
                                                    index=self._wire.index(0)),)
        elif caps.family == "tv":
            if grown_from is not None and grown_from._tsched is not None:
                # a LinkFailureSchedule re-applies its dropout over the grown base
                self._tsched = grown_from._tsched.grown(n)
            elif shrunk_from is not None and shrunk_from[0]._tsched is not None:
                self._tsched = shrunk_from[0]._tsched.shrunk(shrunk_from[1])
            else:
                spec = cfg.topology_schedule or "fixed"
                if spec == "fixed":
                    spec = f"fixed:{cfg.topology}"
                self._tsched = topo.make_topology_schedule(
                    spec, n, p=cfg.topology_p, seed=cfg.topology_seed,
                    beta=cfg.beta, period=cfg.schedule_period,
                )
                if cfg.failure_p > 0:
                    self._tsched = topo.link_failure_schedule(
                        self._tsched, cfg.failure_p, failure_seed=cfg.failure_seed,
                        steps=cfg.failure_steps or None,
                    )
            self._gscheds = comm.graph_schedule_sequence(
                self._tsched.combiners, self._tsched.kinds
            )
            self._gweights = tuple(comm.schedule_weights(s, f32, self.device,
                                                         index=self._wire.index(0))
                                   for s in self._gscheds)
        elif caps.hierarchical:
            # growth and drain touch the model level only: outer levels verbatim
            if grown_from is not None and grown_from._chain is not None:
                self._chain = grown_from._chain.grown(sizes[0])
            elif shrunk_from is not None and shrunk_from[0]._chain is not None:
                self._chain = shrunk_from[0]._chain.shrunk(shrunk_from[1])
            else:
                self._chain = topo.make_kronecker_chain(
                    level_specs, sizes, p=cfg.topology_p, seed=cfg.topology_seed,
                    beta=cfg.beta,
                )
            self._csched = comm.chain_schedule(
                self._chain, tuple(cfg.level_axis(i) for i in range(len(sizes)))
            )
            self._cweights = comm.chain_weights(self._csched, f32, self.device, self._wire)
            if cfg.mode in HIER_MODES:
                self._htopo = topo.HierarchicalTopology(
                    pod_kind=cfg.pod_topology, model_kind=cfg.topology,
                    n_pods=sizes[1], n_model=sizes[0],
                    A_pod=self._chain.combiners[1], A_model=self._chain.combiners[0],
                    gossip_every=cfg.pod_gossip_every, p=cfg.topology_p,
                    seed=cfg.topology_seed, beta=cfg.beta,
                    model_adjacency=self._chain.adjacencies[0],
                )
                self._hsched = comm.HierSchedule(
                    model=self._csched.levels[0].sched, pod=self._csched.levels[1].sched,
                    gossip_every=cfg.pod_gossip_every,
                )
        # Informed-agent weighting (theta, |N_I|) of paper Eq. 29; "one" is
        # flat agent 0 (pod-major rank 0 in the hierarchical modes).
        held = torch.arange(n) if mesh is None else torch.tensor([self.agent_index])
        if cfg.informed == "all":
            theta = torch.ones(len(held), dtype=torch.float32)
            n_inf = float(n)
        else:
            theta = (held == 0).to(torch.float32)
            n_inf = 1.0
        self._theta = theta.reshape(len(held), 1, 1).to(self.device)
        self._n_inf = torch.tensor(n_inf, dtype=torch.float32, device=self.device)

    # -- the per-agent hot loop --------------------------------------------

    def _code_and_back(self, W: Tensor, nu: Tensor) -> Tuple[Tensor, Tensor]:
        """y = ystar(W_k^T nu), back = y W_k^T for every agent, fused."""
        reg = self.reg
        return ops.dict_dual_step(
            W, nu, gamma=reg.gamma, delta=reg.delta, nonneg=reg.nonneg
        )

    def _local_grad(self, W: Tensor, x: Tensor, nu: Tensor) -> Tensor:
        """grad J_k for every agent (mirrors core/inference.agent_grad)."""
        _, back = self._code_and_back(W, nu)
        return (
            -(self._theta / self._n_inf) * x
            + self.res.grad_fstar(nu) / self.n_agents
            + back
        )

    def _mu_for(self, W: Tensor) -> Tensor:
        """THE step-size rule, shared by the solver and `adaptive_mu`.  The
        adaptive step re-runs 20 power iterations per block on every call."""
        if self.cfg.mu > 0:
            return torch.tensor(self.cfg.mu, dtype=W.dtype, device=W.device)
        if self._caps.family == "exact":
            return _safe_mu_exact(self.res, self.reg, W, self._wire)
        return _safe_mu_local(self.res, self.reg, W, self.n_agents, self._wire)

    def _solve_body(self, W: Tensor, x: Tensor, t0: int = 0) -> Tuple[Tensor, Tensor]:
        """cfg.iters iterations from nu = 0, the combiner sequence starting
        at iteration t0; returns the per-agent (nu (N, B, M), y (N, B, Kb))
        of the agents held here (N = 1 on a mesh)."""
        res, cfg, caps, wire = self.res, self.cfg, self._caps, self._wire
        n = self._n_local
        mu = self._mu_for(W)

        if caps.family == "exact":
            def total_grad(nu):  # nu (B, M), shared by every agent
                _, back = self._code_and_back(W, nu)
                return res.grad_fstar(nu) - x + comm.gossip_psum(back, wire)

            nu = torch.zeros_like(x)
            if cfg.mode == "exact":
                for _ in range(cfg.iters):
                    nu = res.project_dual(nu - mu * total_grad(nu))
            else:  # exact_fista: kappa from the same bound, m >= c_f
                c_f = _c_f(res, W)
                L = 1.0 / mu
                beta = (torch.sqrt(L) - torch.sqrt(c_f)) / (torch.sqrt(L) + torch.sqrt(c_f))
                nu_prev = nu
                for _ in range(cfg.iters):
                    z = nu + beta * (nu - nu_prev)
                    z = res.project_dual(z - mu * total_grad(z))
                    nu, nu_prev = z, nu
            y, _ = self._code_and_back(W, nu)
            return nu.expand(n, *nu.shape), y

        nu = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        zero = torch.zeros_like(nu)

        def psi_of(nu):
            return nu - mu * self._local_grad(W, x, nu)

        if caps.family == "ring":
            beta = torch.tensor(cfg.beta, dtype=x.dtype, device=x.device)

            def combine(psi, left, right):
                return res.project_dual((1.0 - 2.0 * beta) * psi + beta * left + beta * right)

            if cfg.mode == "ring":
                for _ in range(cfg.iters):
                    psi = psi_of(nu)
                    nu = combine(psi, *comm.ring_shift(psi, wire))
            elif cfg.mode == "ring_q8":
                err = zero
                for _ in range(cfg.iters):
                    psi = psi_of(nu)
                    # only the message is quantized; psi stays full precision
                    q, s, err = comm.quantize_with_feedback(psi, err)
                    (ql, qr), (sl, sr) = comm.ring_shift(q, wire), comm.ring_shift(s, wire)
                    nu = combine(psi, comm.dequantize_q8(ql, sl), comm.dequantize_q8(qr, sr))
            else:  # ring_async: the neighbors' messages of the previous iteration
                left, right = zero, zero
                for _ in range(cfg.iters):
                    psi = psi_of(nu)
                    nu = combine(psi, left, right)
                    left, right = comm.ring_shift(psi, wire)

        elif caps.family == "graph":
            sched, weights = self._gsched, self._gweights[0]
            if cfg.mode == "graph":
                for _ in range(cfg.iters):
                    nu = res.project_dual(comm.graph_combine(psi_of(nu), sched, weights, wire))
            elif cfg.mode == "graph_q8":
                err = zero
                for _ in range(cfg.iters):
                    psi = psi_of(nu)
                    q, s, err = comm.quantize_with_feedback(psi, err)
                    nu = res.project_dual(
                        comm.graph_combine_quantized(psi, q, s, sched, weights, wire))
            else:  # graph_async: the previous iteration's round messages
                recv = tuple(zero for _ in sched.steps)
                for _ in range(cfg.iters):
                    psi = psi_of(nu)
                    nu = res.project_dual(comm.graph_accumulate(psi, recv, weights))
                    recv = comm.graph_shift(psi, sched, wire=wire)

        elif caps.family == "tv":
            period = len(self._gscheds)
            err = zero
            for t in range(t0, t0 + cfg.iters):
                psi = psi_of(nu)
                sched, weights = self._gscheds[t % period], self._gweights[t % period]
                if caps.quantized:
                    q, s, err = comm.quantize_with_feedback(psi, err)
                    comb = comm.graph_combine_quantized(psi, q, s, sched, weights, wire)
                else:
                    comb = comm.graph_combine(psi, sched, weights, wire)
                nu = res.project_dual(comb)

        elif caps.family == "push":
            sched, weights = self._gsched, self._gweights[0]
            w = torch.ones((n, 1, 1), dtype=x.dtype, device=x.device)
            err = zero
            for _ in range(cfg.iters):
                psi = psi_of(nu)
                if caps.quantized:
                    # error feedback on the weighted message v = w psi
                    v = w * psi
                    q, s, err = comm.quantize_with_feedback(v, err)
                    v, w = comm.push_graph_combine_quantized(v, q, s, w, sched, weights, wire)
                else:
                    v, w = comm.push_graph_combine(psi, w, sched, weights, wire)
                nu = res.project_dual(v / w)

        else:  # the chain family: hier, hier_q8, chain
            cs = self._csched
            state = comm.chain_state_init(nu, cs)
            for t in range(t0, t0 + cfg.iters):
                comb, state = comm.chain_combine(psi_of(nu), cs, t, state, self._cweights, wire)
                nu = res.project_dual(comb)

        y, _ = self._code_and_back(W, nu)
        return nu, y

    # -- public API ----------------------------------------------------------

    @property
    def agent_index(self) -> int:
        """This rank's flat agent index on a mesh: outermost-major over the
        agent axes (pod-major for hier), as the JAX engine's `_iter_setup`;
        0 in one process."""
        if self.mesh is None:
            return 0
        k = 0
        for axis in self._agent_axes:
            k = k * self.mesh.size(axis) + self.mesh.index(axis)
        return k

    def _check_blocks(self, W: Tensor) -> Tensor:
        if W.dim() != 3 or W.shape[0] != self._n_local or W.device != self.device:
            raise ValueError(
                f"W must be the ({self._n_local}, M, Kb) blocks on {self.device} "
                f"(see shard/snapshot), got {tuple(W.shape)} on {W.device}"
            )
        return W

    def _check(self, W: Tensor, x) -> Tuple[Tensor, Tensor]:
        W = self._check_blocks(W)
        x = torch.as_tensor(x, dtype=W.dtype, device=self.device)
        if x.dim() != 2 or x.shape[1] != W.shape[1]:
            raise ValueError(f"x must be (B, {W.shape[1]}), got {tuple(x.shape)}")
        return W, x

    def _gather_agents(self, t: Tensor, dim: int) -> Tensor:
        """Every agent's t, concatenated along `dim` outermost-major (a mesh
        gathers over the agent axes; one process holds them all)."""
        if self.mesh is None:
            return t
        for axis in reversed(self._agent_axes):  # innermost first
            t = self.mesh.all_gather_tiled(t, axis, dim)
        return t

    def _gather_rows(self, t: Tensor, dim: int = 0) -> Tensor:
        """Every data rank's rows of t, in data order (a no-op off a mesh)."""
        return t if self.mesh is None else self.mesh.all_gather_tiled(t, DATA_AXIS, dim)

    def _data_sum(self, t: Tensor) -> Tensor:
        """The sum of t over the data ranks (`fit_batch`'s Eq. 51 gradient)."""
        return self.mesh.psum(t, DATA_AXIS)

    def _of_agent0(self, t: Tensor) -> Tensor:
        """Flat agent 0's t (leading agent axis) on every agent: t[0] in one
        process, a psum of t masked to agent 0 on a mesh (exact: the other
        ranks add zeros)."""
        if self.mesh is None:
            return t[0]
        keep = t if self.agent_index == 0 else torch.zeros_like(t)
        return self._wire.agent_sum(keep)

    @torch.no_grad()
    def solve(self, W: Tensor, x, t0: int = 0) -> Tuple[Tensor, Tensor]:
        """Dual inference on blocks W (N, M, Kb) for a batch x (B, M).

        Returns (nu (B, M), y (B, K)): nu is agent 0's estimate (the gossip
        modes reach approximate consensus, so agents differ slightly; the
        exact modes share one nu), and y is the per-agent blocks laid side
        by side, agent-major, in the column order of blocks_from_full.
        `t0` is the combiner-schedule offset: iteration i of this solve runs
        the network of iteration t0 + i (time-varying modes; the strides'
        phase in the hierarchical modes).  Static modes ignore it.  On a
        mesh W is this rank's (1, M, Kb) block and x its data rank's rows,
        and the result is this rank's (nu_k (B_loc, M), y_k (B_loc, Kb));
        `gather_solution` assembles the one-process result from them."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x, int(t0))
        return nu[0], y.permute(1, 0, 2).reshape(x.shape[0], -1)

    @torch.no_grad()
    def gather_solution(self, nu: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
        """On a mesh, `solve`'s per-rank (nu_k, y_k) -> what one process's
        solve returns over every data rank's rows, on every rank: agent 0's
        nu (B, M) and y (B, K) agent-major.  Collective."""
        return (self._gather_rows(self._of_agent0(nu[None])),
                self._gather_rows(self._gather_agents(y, 1)))

    @torch.no_grad()
    def solve_per_agent(self, W: Tensor, x, t0: int = 0) -> Tuple[Tensor, Tensor]:
        """Dual inference with per-agent outputs: nu (N, B, M) and
        y (N, B, Kb), the reference engine's layout.  On a mesh every rank
        gets every agent's over every data rank's rows (gathered, for the
        checks)."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x, int(t0))
        nu = self._gather_agents(self._gather_rows(nu.contiguous(), 1), 0)
        return nu, self._gather_agents(self._gather_rows(y, 1), 0)

    @torch.no_grad()
    def fit_batch(self, W: Tensor, x, mu_w: float, t0: int = 0) -> Tensor:
        """One dictionary-learning step (Alg. 1, Eq. 51) with the solve at
        schedule offset t0; returns a NEW (N, M, Kb) buffer and never writes
        W.  Each agent updates its block with its own nu_k:
        W_k + mu_w * nu_k^T y_k / B, clamped at 0 for a nonneg task, then
        each column divided by max(||column||, 1).  On a mesh nu_k^T y_k and
        the row count B are summed over the data ranks first (JAX's psum
        over the data axes), so the step is the whole batch's."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x, int(t0))
        spread = self.mesh is not None and self.mesh.size(DATA_AXIS) > 1
        return dict_update(W, nu, y, mu_w, nonneg=self.reg.nonneg,
                           reduce=self._data_sum if spread else None)

    @torch.no_grad()
    def score(self, W: Tensor, h, t0: int = 0) -> Tensor:
        """Novelty scores (B,) for a test batch h (paper Eq. 63-66), the
        dual value of the fit aggregated exactly over all agents:
        -(f*(nu) - nu^T h + sum_k h*(W_k^T nu_k)), nu agent 0's estimate
        (each agent's own in its h* term).  On a mesh: the scores of this
        data rank's rows, h* psum'd over the agent axes with agent 0's
        first two terms (one psum)."""
        W, h = self._check(W, h)
        nu, _ = self._solve_body(W, h, int(t0))
        hstar = self.reg.hstar(torch.matmul(nu, W))  # (agents held, B)
        own = self.res.fstar(nu[0]) - torch.sum(nu[0] * h, dim=-1)
        if self.mesh is None:
            return -(own + hstar.sum(dim=0))
        keep = own if self.agent_index == 0 else torch.zeros_like(own)
        own0, hstar_sum = self._wire.agent_sum(torch.stack([keep, hstar[0]])[None])
        return -(own0 + hstar_sum)

    @torch.no_grad()
    def adaptive_mu(self, W: Tensor) -> Tensor:
        """The step size every agent's solve uses, as (N,); all equal (on a
        mesh each rank's own, gathered)."""
        mu = self._mu_for(self._check_blocks(W))
        if self.mesh is None:
            return mu.expand(self.n_agents).clone()
        return self._gather_agents(mu.reshape(1), 0)

    def snapshot(self, W) -> Tensor:
        """The (N, M, Kb) blocks of W on this coder's device: W is either
        (M, K) (split as blocks_from_full does, into one allocation on the
        device, block by block, wherever W lives) or already (N, M, Kb).
        Does not copy blocks that are already contiguous there; `fit_batch`
        never writes its input, so readers may share the buffer.  On a mesh
        the (1, M, Kb) block of this rank's agent, from (M, K), from every
        agent's (N, M, Kb) blocks, or from that one block."""
        W = torch.as_tensor(W)
        n = self.n_agents
        if W.dim() == 2:
            m, k = W.shape
            if k % n:
                raise ValueError(f"K={k} not divisible by N={n}")
            kb = k // n
            held = range(n) if self.mesh is None else (self.agent_index,)
            blocks = torch.empty((len(held), m, kb), dtype=W.dtype, device=self.device)
            for j, i in enumerate(held):
                blocks[j].copy_(W[:, i * kb:(i + 1) * kb])
            return blocks
        if W.dim() == 3 and self.mesh is not None and W.shape[0] == n:
            W = W[self.agent_index:self.agent_index + 1]
        if W.dim() != 3 or W.shape[0] != self._n_local:
            raise ValueError(f"cannot place W {tuple(W.shape)} on {self._n_local} agents")
        return W.to(self.device).contiguous()

    def local_rows(self, x) -> Tensor:
        """This data rank's rows of x (B, M) on this coder's device (all of
        them off a mesh); B must divide by the data ranks."""
        x = torch.as_tensor(x)
        if self.mesh is not None:
            d, i = self.mesh.size(DATA_AXIS), self.mesh.index(DATA_AXIS)
            if x.shape[0] % d:
                raise ValueError(f"{x.shape[0]} rows do not split over {d} data ranks")
            b = x.shape[0] // d
            x = x[i * b:(i + 1) * b]
        return x.to(self.device)

    def shard(self, W, x) -> Tuple[Tensor, Tensor]:
        """(blocks (N, M, Kb), x (B, M)) on this coder's device; on a mesh
        this rank's block and its data rank's rows of x."""
        W = self.snapshot(W)
        return W, self.local_rows(x).to(W.dtype)

    @torch.no_grad()
    def gather(self, W: Tensor) -> Optional[Tensor]:
        """The whole (M, K) dictionary from every rank's block, on mesh rank
        0 (None on the others; collective: each block of data rank 0's
        ranks crosses the wire once); `full_from_blocks` in one process."""
        W = self._check_blocks(W)
        if self.mesh is None:
            return full_from_blocks(W)
        if self.mesh.index(DATA_AXIS):
            return None  # every data rank holds the same blocks
        for axis in reversed(self._agent_axes):  # innermost first, onto index 0
            W = self.mesh.gather_first(W, axis)
            if W is None:
                return None
        return full_from_blocks(W)

    # -- elastic growth and agent drain --------------------------------------

    def _resized(self, n_model: int, **hook) -> "DistributedSparseCoder":
        """A coder like this one with n_model agents on the model level."""
        sizes = (n_model,) + self.level_sizes[1:]
        return DistributedSparseCoder(sizes if self._caps.hierarchical else n_model,
                                      self.res, self.reg, self.cfg, self.device, **hook)

    @torch.no_grad()
    def grown(self, W: Tensor, extra_model: int,
              generator: torch.Generator) -> Tuple["DistributedSparseCoder", Tensor]:
        """Elastic growth (paper Sec. IV-C: new atoms and agents arrive
        mid-stream): (new coder with `extra_model` more agents on the model
        level, its (N', M, Kb) blocks).  Every old agent keeps its block bit
        for bit; each fresh block is unit-norm (nonneg when the task asks)
        from `init_dictionary(generator, M, Kb * extra_model)`, one draw per
        outer group in group order.  The hierarchical modes view the agent
        axis as (outer, n_model, M, Kb), outermost-major as the JAX engine's
        devices, and append each group's fresh agents after its own, so
        every outer group grows and no old agent changes rank within its
        group.  The combiners grow as `__init__`'s `grown_from` says.  W2
        is one allocation on this coder's device, filled there."""
        if self.mesh is not None:
            raise NotImplementedError(f"growth on a mesh: {MESH_GROWTH_ITEM}")
        if extra_model <= 0:
            raise ValueError(f"extra_model must be positive, got {extra_model}")
        W = self._check_blocks(W)
        n_old = self.level_sizes[0]
        n_new = n_old + int(extra_model)
        outer = self.n_agents // n_old
        new_coder = self._resized(n_new, grown_from=self)
        _, m, kb = W.shape
        W2 = torch.empty((outer, n_new, m, kb), dtype=W.dtype, device=self.device)
        W2[:, :n_old].copy_(W.view(outer, n_old, m, kb))
        for i in range(outer):
            fresh = init_dictionary(generator, m, kb * int(extra_model), nonneg=self.reg.nonneg,
                                    dtype=W.dtype, device=generator.device)
            W2[i, n_old:].copy_(fresh.view(m, int(extra_model), kb).permute(1, 0, 2))
            del fresh
        return new_coder, W2.view(outer * n_new, m, kb)

    @torch.no_grad()
    def shrunk(self, W: Tensor,
               departing_ranks: Sequence[int]) -> Tuple["DistributedSparseCoder", Tensor]:
        """Agent drain, the inverse of `grown`: the model ranks
        `departing_ranks` leave (in every outer group for the hierarchical
        modes) and the survivors keep their blocks bit for bit (no
        re-initialisation, no renormalisation): one `index_select` on this
        coder's device.  The combiners shrink as `__init__`'s `shrunk_from`
        says."""
        if self.mesh is not None:
            raise NotImplementedError(f"agent drain on a mesh: {MESH_GROWTH_ITEM}")
        W = self._check_blocks(W)
        n_old = self.level_sizes[0]
        departing = sorted(set(int(r) for r in departing_ranks))
        if not departing:
            raise ValueError("departing_ranks is empty: nothing to drain")
        if departing[0] < 0 or departing[-1] >= n_old:
            raise ValueError(f"departing_ranks {departing} out of range for a model level "
                             f"of {n_old} agents")
        survivors = tuple(r for r in range(n_old) if r not in set(departing))
        if not survivors:
            raise ValueError(f"cannot drain all {n_old} model ranks: at least one survivor "
                             f"is required")
        new_coder = self._resized(len(survivors), shrunk_from=(self, survivors))
        outer = self.n_agents // n_old
        _, m, kb = W.shape
        sel = torch.tensor(survivors, dtype=torch.long, device=self.device)
        W2 = W.view(outer, n_old, m, kb).index_select(1, sel)
        return new_coder, W2.view(outer * len(survivors), m, kb)

    # -- the combiner, its schedules and its byte accounting ---------------

    def combiner(self) -> np.ndarray:
        """The combination matrix this mode realizes (A[l, k] = a_{lk}): the
        graph or push combiner, the constant-weight ring, or 11^T/N; for the
        time-varying modes the one-period window product A_0 ... A_{P-1};
        for the hierarchical modes the dense chain (its window product over
        the stride LCM)."""
        if self._chain is not None:
            return self._chain.window_combiner()
        if self._tsched is not None:
            return self._tsched.window_combiner()
        if self._A is not None:
            return np.array(self._A)
        if self._caps.family == "exact":
            return topo.uniform_weights(self.n_agents)
        return topo.ring_weights(self.n_agents, self.cfg.beta)

    def combiner_sequence(self) -> Tuple[np.ndarray, ...]:
        """The per-iteration combiners A_0 .. A_{P-1} (P = 1 for a static
        mode, the stride LCM for the hierarchical modes)."""
        if self._chain is not None:
            return tuple(np.array(a) for a in self._chain.sequence())
        if self._tsched is not None:
            return tuple(np.array(a) for a in self._tsched.combiners)
        return (self.combiner(),)

    def _levels_info(self) -> list:
        """Per-level rows (kind, axis, n, gossip_every, wire, stale),
        innermost first; one row for a flat mode."""
        if self._chain is not None:
            return [
                {"kind": spec.kind, "axis": lvl.axis, "n": int(n),
                 "gossip_every": spec.gossip_every, "wire": spec.wire, "stale": spec.stale}
                for spec, n, lvl in zip(self._chain.specs, self._chain.ns, self._csched.levels)
            ]
        caps = self._caps
        if caps.family == "tv":
            kind = f"tv:{self._tsched.spec}"
        elif caps.family in ("graph", "push"):
            kind = self.cfg.topology
        elif caps.family == "ring":
            kind = "ring"
        else:
            kind = "full"
        return [{"kind": kind, "axis": MODEL_AXIS, "n": self.n_agents, "gossip_every": 1,
                 "wire": "q8" if caps.quantized else "fp32", "stale": caps.stale}]

    def combiner_info(self) -> Dict:
        """Topology label and mixing rate for stats, with the JAX engine's
        keys: the mixing rate is sigma_2(A) for a static mode, the windowed
        per-step rate for the time-varying modes and the effective chain
        rate for the hierarchical modes; `schedule` (the spec, None when
        static), `schedule_period`, the hier `pod_topology` /
        `pod_gossip_every` (None / 1 otherwise) and the per-level rows."""
        caps, cfg = self._caps, self.cfg
        info = {"schedule": None, "schedule_period": 1, "pod_topology": None,
                "pod_gossip_every": 1}
        if caps.hierarchical:
            if cfg.mode in HIER_MODES:
                label = f"hier:{cfg.topology}+{cfg.pod_topology}"
                info.update(pod_topology=cfg.pod_topology, pod_gossip_every=cfg.pod_gossip_every)
            else:
                label = "chain:" + "+".join(s.kind for s in self._chain.specs)
            rate = self._chain.effective_mixing_rate()
            info["schedule_period"] = self._chain.period
        elif caps.family == "tv":
            label = f"tv:{self._tsched.spec}"
            rate = self._tsched.windowed_mixing_rate()
            info.update(schedule=self._tsched.spec, schedule_period=self._tsched.period)
        else:
            label = {"graph": cfg.topology, "push": cfg.topology, "ring": "ring"}.get(
                caps.family, "full")
            rate = topo.mixing_rate(self.combiner())
        return {"topology": label, "mixing_rate": rate, **info,
                "levels": self._levels_info()}

    @property
    def gossip_schedule(self) -> Optional[comm.GraphSchedule]:
        """The compiled schedule of a static graph or push mode (else None)."""
        return self._gsched

    @property
    def gossip_schedules(self) -> Optional[Tuple[comm.GraphSchedule, ...]]:
        """The per-step schedules: P of them for the time-varying modes, one
        for a static graph or push mode, None otherwise."""
        if self._gscheds is not None:
            return self._gscheds
        if self._gsched is not None:
            return (self._gsched,)
        return None

    @property
    def topology_schedule(self) -> Optional[topo.TopologySchedule]:
        """The `TopologySchedule` of a time-varying coder (else None)."""
        return self._tsched

    @property
    def hier_topology(self) -> Optional[topo.HierarchicalTopology]:
        """The two-level combiner of a hier coder (else None)."""
        return self._htopo

    @property
    def hier_gossip_schedule(self) -> Optional[comm.HierSchedule]:
        """The two-level plan of a hier coder (else None)."""
        return self._hsched

    @property
    def chain(self) -> Optional[topo.KroneckerChain]:
        """The Kronecker chain of a hierarchical coder (else None)."""
        return self._chain

    @property
    def chain_gossip_schedule(self) -> Optional[comm.ChainSchedule]:
        """The per-level plan of a hierarchical coder (else None)."""
        return self._csched

    @property
    def schedule_period(self) -> int:
        """Iterations before the combiner sequence repeats: the schedule's
        period, the stride LCM of a chain, 1 for a static mode.  The
        service's schedule clock reduces its offset modulo this."""
        if self._tsched is not None:
            return self._tsched.period
        if self._chain is not None:
            return self._chain.period
        return 1

    @property
    def is_time_varying(self) -> bool:
        """Whether the combiner changes per iteration (the service then
        threads its schedule offset t0 through solve and fit): the graph_tv
        modes, and the hierarchical modes with a stride LCM above 1."""
        return self._caps.time_varying or (
            self._caps.hierarchical and self.schedule_period > 1
        )

    def wire_bytes_per_iter(self, b_loc: int, m: int) -> Tuple[Tuple[str, float], ...]:
        """Analytic wire bytes per solve iteration per agent, by level:
        ((name, bytes), ...) innermost first, for a (b_loc, m) dual block,
        as the JAX engine counts them: one fp32 message 4 b_loc m bytes, one
        q8 message b_loc (m + 4); the exact modes' all-reduce at twice the
        operand; time-varying modes averaged over the period and strided
        levels over their stride; push adds 4 bytes a round for its weight."""
        caps = self._caps
        fp32, q8 = 4 * b_loc * m, b_loc * (m + 4)
        if caps.family == "exact":
            return ((MODEL_AXIS, 2.0 * fp32),)
        if caps.family == "ring":
            return ((MODEL_AXIS, 2.0 * (q8 if caps.quantized else fp32)),)
        if caps.family in ("graph", "tv", "push"):
            scheds = self.gossip_schedules
            rounds = sum(s.messages_per_iter for s in scheds) / len(scheds)
            msg = float(q8 if caps.quantized else fp32)
            if caps.family == "push":
                msg += 4.0
            return ((MODEL_AXIS, rounds * msg),)
        per_level = comm.wire_bytes_per_level(self._csched, b_loc, m)
        return tuple((lvl.axis, b) for lvl, b in zip(self._csched.levels, per_level))
