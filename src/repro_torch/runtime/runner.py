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

Where the JAX runner takes a mesh, this one takes a `device`; its `mesh`
argument accepts only one device (None, "1x1" or (1, 1)): a sharded
run is ROADMAP section 1's sharded-training item.  A recoverable fault is
an exception raised in Python, like the injected one.  A CUDA error that
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
from repro_torch.models.model import require_ported
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import steps as S


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = True
    max_restarts: int = 3
    deadline_factor: float = 3.0  # straggler threshold vs rolling median
    log_every: int = 10


def check_mesh(mesh) -> None:
    """Accept one device (None, "1x1" or (1, 1)); refuse any other mesh."""
    if mesh is None:
        return
    shape = tuple(int(x) for x in mesh.split("x")) if isinstance(mesh, str) else tuple(mesh)
    if any(n != 1 for n in shape):
        raise NotImplementedError(
            f"mesh {mesh!r}: the port trains on one device (mesh 1x1); a sharded run is "
            f"not ported yet (ROADMAP section 1, the sharded-training item)"
        )


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
        check_mesh(mesh)
        require_ported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.opt = opt
        self.run_cfg = run_cfg
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep)
        self.fault_hook = fault_hook
        self.step_times: List[float] = []
        self.events: List[Dict[str, Any]] = []
        self._like = S.abstract_train_state(cfg, opt)
        self._step = S.make_train_step(cfg, opt)

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int = 0):
        return S.init_train_state(self.cfg, self.opt, seed, self.device)

    def restore_or_init(self, seed: int = 0):
        restored, step = self.ckpt.restore(self._like, device=self.device)
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
                state, metrics = self._step(state, batches(step))
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
            if len(self.step_times) > 5 and dt > rc.deadline_factor * med:
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
        """A new runner over the same checkpoints, on `device`:
        restore_or_init() places the latest (device-agnostic) checkpoint
        there."""
        return cls(cfg, new_mesh, opt, run_cfg, device=device)
