"""Online streaming dictionary service: the serving path of the engine.

Port of the single-service path of src/repro/runtime/service.py, over the
port's `DistributedSparseCoder` (N agents on one device):

  * micro-batching: requests are queued and flushed as micro-batches of
    `micro_batch` rows (zero-padded to that size; zero rows code to nu = 0
    and cost nothing), each sample coded once and resolved on a Future;
  * a double-buffered dictionary: readers code against the published
    snapshot while `fit_batch` advances the live copy.  `fit_batch` returns
    a NEW buffer and never writes its input, so a snapshot is never updated
    in place and publishing is a reference swap;
  * online learning: every flushed micro-batch is also fed, once, to the
    learner thread, which runs one dictionary step on the live copy and
    republishes every `publish_every` steps.  When the learner lags, the
    buffered batches are thinned by a seeded Algorithm-R reservoir
    (`_LearnReservoir`, numpy's RNG: the same seed keeps the same set as
    the JAX service);
  * one execution at a time: solves and fit steps take `_exec_lock`, so a
    coding batch waits at most one fit step;
  * a warmup solve and fit on a zero batch before serving (which also
    builds the kernels).

Elastic growth, drain, `install_snapshot`, `load` and `kill` are not ported
yet (ROADMAP section 1: 6d and the checkpoint manager).  The flat modes are
static, so there is no schedule clock: `active_schedule` stays 0.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.distributed import DistributedSparseCoder
from repro_torch.core.dictionary import full_from_blocks


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs for the streaming service (the JAX ServiceConfig's)."""

    micro_batch: int = 16  # samples per coding micro-batch (padded to this)
    max_wait_s: float = 0.02  # flush a partial micro-batch after this long
    learn: bool = True  # online dictionary learning on the live copy
    mu_w: float = 0.05  # dictionary step size
    warmup: bool = True  # one solve (and fit) on a zero batch before serving
    publish_every: int = 1  # fit steps between snapshot publishes
    queue_capacity: int = 8192  # submit() blocks when this many are pending
    learn_queue_cap: int = 64  # learn batches buffered before the reservoir
    # samples (0 = unbounded, nothing discarded)
    learn_seed: int = 0  # seed of the reservoir's eviction draws
    latency_window: int = 100_000  # per-sample latencies kept for stats


class _Item:
    __slots__ = ("x", "future", "t_submit")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Terminal-state a Future without raising: a client may have cancelled
    it, and an InvalidStateError must not kill a worker thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass  # already cancelled/resolved by the client


class _LearnReservoir:
    """Seeded Algorithm-R reservoir between the batcher and the learner
    (the JAX service's, with the same numpy RNG draws).

    Below `cap` buffered batches it is a FIFO.  Once saturated, the t-th
    offer of the window is kept with probability cap/t, evicting a uniform
    buffered batch, so what the learner fits is a uniform sample of the lag
    window.  `cap=0` disables sampling (unbounded, nothing discarded).
    """

    def __init__(self, cap: int, seed: int = 0):
        if cap < 0:
            raise ValueError(f"learn_queue_cap must be >= 0, got {cap}")
        self.cap = int(cap)
        self._rng = np.random.default_rng(seed)
        self._buf: List[np.ndarray] = []
        self._window = 0  # offers since the buffer last saturated
        self.seen = 0  # total batches offered
        self.discarded = 0  # batches that will never reach the learner
        self._cond = threading.Condition(threading.Lock())

    def offer(self, xb: np.ndarray) -> bool:
        """Offer one learn batch; True when a batch was discarded."""
        with self._cond:
            self.seen += 1
            if self.cap == 0 or len(self._buf) < self.cap:
                self._buf.append(xb)
                self._window = len(self._buf)
                self._cond.notify()
                return False
            self._window += 1
            j = int(self._rng.integers(self._window))
            if j < self.cap:
                self._buf[j] = xb
            self.discarded += 1
            return True

    def take(self, timeout: float) -> np.ndarray:
        """Oldest kept batch; raises queue.Empty after `timeout` seconds."""
        with self._cond:
            if not self._buf:
                self._cond.wait(timeout)
            if not self._buf:
                raise queue.Empty
            return self._buf.pop(0)

    def empty(self) -> bool:
        with self._cond:
            return not self._buf

    def qsize(self) -> int:
        with self._cond:
            return len(self._buf)


def _wait(t: torch.Tensor) -> None:
    """Wait for the device work that produces `t` (errors surface here)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class DictionaryService:
    """Continuously-learning dictionary server over N agents on one device.

    Usage:
        coder = DistributedSparseCoder(n_agents, res, reg, dist_cfg)
        with DictionaryService(coder, W0, ServiceConfig()) as svc:
            futs = [svc.submit(x_i) for x_i in stream]
            results = [f.result() for f in futs]     # (nu_i, y_i) each
    """

    def __init__(self, coder: DistributedSparseCoder, W0, cfg: ServiceConfig = ServiceConfig()):
        self.cfg = cfg
        self._lock = threading.Lock()  # guards the counters and (live, snapshot)
        self._exec_lock = threading.Lock()  # one engine execution at a time
        # Makes the running-check + enqueue in submit() atomic w.r.t. stop().
        self._submit_lock = threading.Lock()
        self._coder = coder
        self._live = coder.snapshot(W0)
        self._snap = self._live
        self._m = int(self._live.shape[1])
        self._pad = cfg.micro_batch  # one device: the data extent is 1
        self._queue: "queue.Queue[_Item]" = queue.Queue(maxsize=cfg.queue_capacity)
        self._learn_q = _LearnReservoir(cfg.learn_queue_cap, cfg.learn_seed)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t_start: Optional[float] = None
        self._comb_info: Dict = coder.combiner_info()
        self.submitted = 0
        self.coded = 0
        self.fit_steps = 0
        self.fit_failures = 0
        self.learn_dropped = 0
        self.fit_first_error: Optional[str] = None
        self.published = 0
        self._latencies = collections.deque(maxlen=cfg.latency_window)
        self._snap_version = 0
        self._serving_version = 0

    # -- helpers ----------------------------------------------------------

    def _pad_rows(self, xb: np.ndarray) -> np.ndarray:
        """Zero-pad a batch to the fixed micro-batch size."""
        b = xb.shape[0]
        if b >= self._pad:
            return xb
        return np.concatenate(
            [xb, np.zeros((self._pad - b, xb.shape[1]), xb.dtype)], axis=0
        )

    def _solve_padded(self, snap: torch.Tensor, xb: np.ndarray):
        """Code a real batch of b rows against `snap`; host numpy results."""
        b = xb.shape[0]
        with self._exec_lock:
            nu, y = self._coder.solve(snap, self._pad_rows(xb))
            nu, y = nu[:b].cpu().numpy(), y[:b].cpu().numpy()
        return nu, y

    # -- lifecycle --------------------------------------------------------

    def _warmup(self) -> None:
        """One solve (and one fit with mu_w = 0) on a zero micro-batch, so
        the kernels are built and the allocator warm before the first
        request.  Runs before the worker threads exist."""
        z = np.zeros((self._pad, self._m), np.float32)
        _wait(self._coder.solve(self._snap, z)[1])
        if self.cfg.learn:
            _wait(self._coder.fit_batch(self._snap, z, 0.0))

    def start(self) -> "DictionaryService":
        if self._threads:
            raise RuntimeError("service already started")
        if self._stop.is_set():
            raise RuntimeError(
                "service cannot be restarted after stop(); create a new "
                "DictionaryService (counters and queues are single-run)"
            )
        if self.cfg.warmup:
            self._warmup()
        self._t_start = time.perf_counter()
        self._threads = [
            threading.Thread(target=self._batcher_loop, name="dict-batcher", daemon=True),
            threading.Thread(target=self._learner_loop, name="dict-learner", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Code every queued sample, let the learner consume what it was
        given, then join the workers; a request that raced the shutdown is
        failed, never left hanging."""
        self._stop.set()
        for t in self._threads:
            t.join()
        err = RuntimeError("service stopped before this request was processed")
        with self._submit_lock:
            self._threads = []
            while True:
                try:
                    _resolve(self._queue.get_nowait().future, exc=err)
                except queue.Empty:
                    break

    def __enter__(self) -> "DictionaryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -------------------------------------------------------

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one sample (M,); the Future resolves to (nu (M,), y (K,))."""
        x = np.asarray(x, np.float32)
        if x.shape != (self._m,):
            raise ValueError(f"expected sample shape ({self._m},), got {x.shape}")
        item = _Item(x)
        with self._submit_lock:
            if self._stop.is_set() or not self._threads:
                raise RuntimeError(
                    "service is not running (submit() before start() or after "
                    "stop() would enqueue a sample no worker will ever code)"
                )
            self._queue.put(item)
        with self._lock:
            self.submitted += 1
        return item.future

    def submit_many(self, X: np.ndarray) -> List[Future]:
        return [self.submit(x) for x in X]

    def snapshot(self) -> torch.Tensor:
        """The currently published (N, M, Kb) snapshot (never written)."""
        with self._lock:
            return self._snap

    def dictionary(self) -> np.ndarray:
        """Host (M, K) copy of the currently published snapshot."""
        return full_from_blocks(self.snapshot()).cpu().numpy()

    def running(self) -> bool:
        """True while the workers are up and shutdown hasn't begun."""
        return bool(self._threads) and not self._stop.is_set()

    def stats(self) -> Dict:
        """One consistent snapshot of the counters, with the JAX service's
        keys: throughput, latency percentiles, learner progress and the
        gossip identity."""
        elapsed = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            out = {
                "submitted": self.submitted,
                "coded": self.coded,
                "fit_steps": self.fit_steps,
                "fit_failures": self.fit_failures,
                "fit_first_error": self.fit_first_error,
                "learn_dropped": self.learn_dropped,
                "learn_seen": self._learn_q.seen,
                "published": self.published,
                "snapshot_version": self._snap_version,
                "serving_version": self._serving_version,
                "grow_events": [],
                "drain_events": [],
                "topology": self._comb_info["topology"],
                "mixing_rate": self._comb_info["mixing_rate"],
                "schedule": self._comb_info.get("schedule"),
                "schedule_period": self._comb_info.get("schedule_period", 1),
                "active_schedule": 0,
                "pod_topology": self._comb_info.get("pod_topology"),
                "pod_gossip_every": self._comb_info.get("pod_gossip_every", 1),
                "levels": self._comb_info.get("levels"),
                "elapsed_s": elapsed,
                "samples_per_s": (self.coded / elapsed) if elapsed > 0 else 0.0,
            }
        if lat.size:
            out["latency_ms"] = {
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p95": float(np.percentile(lat, 95) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
                "max": float(lat.max() * 1e3),
            }
        return out

    # -- worker loops -----------------------------------------------------

    def _collect(self) -> List[_Item]:
        """Block for the first item, then fill up to micro_batch until the
        max_wait deadline passes (size-or-deadline batcher)."""
        items: List[_Item] = []
        try:
            items.append(self._queue.get(timeout=0.01))
        except queue.Empty:
            return items
        deadline = time.perf_counter() + self.cfg.max_wait_s
        while len(items) < self.cfg.micro_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                items.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return items

    def _batcher_loop(self) -> None:
        while True:
            items = self._collect()
            if not items:
                if self._stop.is_set() and self._queue.empty():
                    return
                continue
            xb = np.stack([it.x for it in items])
            with self._lock:
                snap, ver = self._snap, self._snap_version
            try:
                nu, y = self._solve_padded(snap, xb)
            except Exception as e:  # resolve futures so clients never hang
                for it in items:
                    _resolve(it.future, exc=e)
                continue
            dropped = self._learn_q.offer(xb) if self.cfg.learn else False
            # Account before resolving: a client woken by the last result
            # may read stats() at once and must see this batch counted.
            t_done = time.perf_counter()
            with self._lock:
                for it in items:
                    self._latencies.append(t_done - it.t_submit)
                self.coded += len(items)
                self._serving_version = ver
                if dropped:
                    self.learn_dropped += 1
            for i, it in enumerate(items):
                _resolve(it.future, (nu[i], y[i]))

    def _learner_loop(self) -> None:
        while True:
            try:
                xb = self._learn_q.take(timeout=0.02)
            except queue.Empty:
                # Exit only once the batcher has exited (it may be mid-solve,
                # about to offer the final batch) and everything is consumed.
                batcher = self._threads[0] if self._threads else None
                if (
                    self._stop.is_set()
                    and (batcher is None or not batcher.is_alive())
                    and self._learn_q.empty()
                ):
                    return
                continue
            with self._lock:
                live = self._live
            b = xb.shape[0]
            xb = self._pad_rows(xb)
            # Zero pad rows code to nu = 0 and add nothing to the gradient
            # sum; rescale mu_w so the mean is over the real samples.
            mu_w_eff = self.cfg.mu_w * (xb.shape[0] / b)
            try:
                with self._exec_lock:
                    live2 = self._coder.fit_batch(live, xb, mu_w_eff)
                    _wait(live2)
            except Exception as e:
                # A failed fit step must not take down serving, nor be
                # invisible: count it and keep the first error for stats().
                with self._lock:
                    self.fit_failures += 1
                    if self.fit_first_error is None:
                        self.fit_first_error = repr(e)
                continue
            with self._lock:
                self.fit_steps += 1
                self._live = live2
                if self.fit_steps % self.cfg.publish_every == 0:
                    self._snap = live2
                    self.published += 1
                    self._snap_version += 1
