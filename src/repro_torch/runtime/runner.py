"""Fault-tolerant training runner: checkpoint/restart, failure recovery,
straggler detection, elastic rescale.

Port of src/repro/runtime/runner.py.  The runner wraps the train step
(runtime/steps.make_train_step) with:
  * resume-on-start from the newest complete checkpoint;
  * periodic async checkpoints (keep-k) and one at `n_steps`;
  * failure recovery: an exception raised from the step (or from the fault
    hook before it) triggers restore-from-last-checkpoint and replay, up to
    `max_restarts`; the data stream is step-indexed, so replayed batches are
    identical;
  * straggler detection: steps slower than `deadline_factor` x the rolling
    median of the last 20 are logged as straggler events;
  * elastic rescale: `TrainRunner.rescale(...)` builds a new runner whose
    `restore_or_init` reloads the latest checkpoint onto its device.

The `mesh` argument is one device (None, "1x1" or (1, 1)), the runner
then running on `device`, or a runtime/mesh.Mesh, whose ranks each run
this runner over their shards (launch/train spawns them through
mesh.launch): the state is sharded by the config's rules, the step is
the sharded one of runtime/steps, the checkpoints hold the whole tensors
(rank 0 writes them, every rank restores its shard, so a run resumes on
another mesh), the fault hook runs on every rank before the step (an
injected fault raises on all ranks at the same step), restore and replay
are collective, and the straggler events are rank 0's.  A mesh takes the
dense, MoE, hybrid and xlstm families (FSDP configs too: their shards'
cut by the rules, restored onto any mesh as any other; Mamba2's fused
leaves cut segment by segment, runtime/sharding) without a `pod` axis;
the others raise, naming the ROADMAP item that lifts each (`check_mesh`).  A
recoverable fault is an exception raised in Python, like the injected one.  A CUDA error that
poisons the context (an illegal address, a device-side assert) is not
recoverable in the same process: every later call on the card fails too,
and the restart is the process's, from the checkpoint.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import check_mesh_supported, require_ported
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import steps as S
from repro_torch.runtime.mesh import Mesh, default_axes, parse_mesh


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = True
    max_restarts: int = 3
    deadline_factor: float = 3.0  # straggler threshold vs rolling median
    log_every: int = 10


def check_mesh(mesh, cfg: Optional[ArchConfig] = None) -> None:
    """Accept one device (None, "1x1" or (1, 1)), and for the families
    model.check_mesh_supported takes (without a `pod` axis) a "DxM" shape or a Mesh;
    raise NotImplementedError for any other, naming the ROADMAP item that
    lifts it (model.MESH_ITEMS)."""
    if mesh is None:
        return
    sizes = mesh.shape if isinstance(mesh, Mesh) else dict(zip(
        default_axes(parse_mesh(mesh)), parse_mesh(mesh)))
    if all(n == 1 for n in sizes.values()):
        return
    if cfg is not None:
        check_mesh_supported(cfg, sizes)


class TrainRunner:
    def __init__(
        self,
        cfg: ArchConfig,
        mesh,
        opt: Optimizer,
        run_cfg: RunnerConfig,
        *,
        device: DeviceLike = "cuda",
        fault_hook: Optional[Callable[[int], None]] = None,
    ):
        check_mesh(mesh, cfg)
        require_ported(cfg)
        self.cfg = cfg
        self.mesh = mesh if isinstance(mesh, Mesh) else None
        if self.mesh is None and mesh is not None and any(n != 1 for n in parse_mesh(mesh)):
            raise ValueError(f"mesh {mesh!r}: a sharded runner runs on each rank of a Mesh "
                             f"(runtime.mesh.launch spawns them; launch/train --mesh)")
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device)
        self.lead = self.mesh is None or self.mesh.rank == 0
        self.opt = opt
        self.run_cfg = run_cfg
        specs = S.state_shardings(cfg, opt, self.mesh) if self.mesh is not None else None
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep, mesh=self.mesh,
                                      specs=specs)
        self.fault_hook = fault_hook
        self.step_times: List[float] = []
        self.events: List[Dict[str, Any]] = []
        self._like = S.abstract_train_state(cfg, opt)
        self.step_fn = S.make_train_step(cfg, opt, self.mesh)  # (state, batch) -> (state, metrics)

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int = 0):
        return S.init_train_state(self.cfg, self.opt, seed, self.device, self.mesh)

    def restore_or_init(self, seed: int = 0, step: Optional[int] = None):
        """The checkpoint of `step` (the latest when None) on this runner's
        device or mesh, else a fresh state from `seed`."""
        restored, step = self.ckpt.restore(self._like, step, device=self.device)
        if restored is None:
            self.events.append({"kind": "init", "step": 0})
            return self.init_state(seed)
        self.events.append({"kind": "restore", "step": step})
        return restored

    # -- main loop ----------------------------------------------------------

    def run(
        self,
        batches: Callable[[int], Any],
        n_steps: int,
        *,
        seed: int = 0,
        metrics_cb: Optional[Callable[[int, dict], None]] = None,
    ):
        """batches(step) -> batch dict (numpy arrays or tensors, moved to the
        state's device by the step).  Step-indexed, so replay after a
        restore sees identical data.  Returns (state, per-step metrics as
        floats)."""
        rc = self.run_cfg
        state = self.restore_or_init(seed)
        step = int(state["step"])
        restarts = 0
        history = []
        while step < n_steps:
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)  # may raise (injected failure)
                state, metrics = self.step_fn(state, batches(step))
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception as e:  # noqa: BLE001 -- any fault => restore path
                restarts += 1
                self.events.append({"kind": "fault", "step": step, "error": repr(e)})
                if restarts > rc.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={rc.max_restarts}; last error: {e!r}"
                    ) from e
                self.ckpt.wait()
                state = None  # free the faulted state before the restore
                state = self.restore_or_init(seed)
                step = int(state["step"])
                continue

            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = statistics.median(self.step_times[-20:])
            if self.lead and len(self.step_times) > 5 and dt > rc.deadline_factor * med:
                self.events.append({"kind": "straggler", "step": step, "dt": dt, "median": med})

            step += 1
            history.append(metrics)
            if metrics_cb and step % rc.log_every == 0:
                metrics_cb(step, metrics)
            if step % rc.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, state, blocking=not rc.async_ckpt)
        self.ckpt.wait()
        return state, history

    # -- elastic rescale -----------------------------------------------------

    @classmethod
    def rescale(
        cls,
        cfg: ArchConfig,
        new_mesh,
        opt: Optimizer,
        run_cfg: RunnerConfig,
        *,
        device: DeviceLike = "cuda",
    ) -> "TrainRunner":
        """A new runner over the same checkpoints, on `device` or on the
        ranks of `new_mesh` (a Mesh): restore_or_init() places the latest
        checkpoint (whole tensors, whatever mesh wrote it) there."""
        return cls(cfg, new_mesh, opt, run_cfg, device=device)
