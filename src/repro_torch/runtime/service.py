"""Online streaming dictionary service: the serving path of the engine.

Port of src/repro/runtime/service.py over the port's
`DistributedSparseCoder` (N agents on one device, or one agent a rank of
a mesh):

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
  * a schedule clock for time-varying coders (the graph_tv modes, and the
    hierarchical modes whose strides give a period above 1): each solve or
    fit claims the next cfg.iters iterations of the combiner sequence under
    `_exec_lock`, so the stream runs one continuous network instead of
    restarting at A_0 every micro-batch; a fit that raised gives its
    window back;
  * elastic growth and agent drain: `grow(extra_model, generator)` and
    `drain(departing_ranks)` queue a swap that the learner thread applies at
    its next step boundary (`DistributedSparseCoder.grown` / `.shrunk`:
    old or surviving blocks bit for bit, combiners re-derived with erdos
    neighbourhoods kept).  The new coder's warmup runs under `_exec_lock`
    off the serving path, then (coder, live, snapshot) swap in one `_lock`
    acquisition; a drain keeps the schedule clock, reduced modulo the new
    coder's period at the next claim.  The batcher reads (coder, snapshot,
    version) together and codes with that coder, and the learner publishes
    a fit only if no swap replaced the coder it fitted with, so a batch
    never pairs one era's snapshot with another era's coder;
  * the serving plane's hooks (repro_torch.runtime.serving):
    `install_snapshot` (an external publish, refused at the wrong shape or
    when a swap changed the coder meanwhile), `load` (queue depth and
    versions for the router) and `kill` (fail everything pending, the
    router's re-route signal);
  * one CUDA stream per service (`stream`; by default the constructing
    thread's current stream, the serving plane gives each replica a stream
    of its own): the batcher, the learner, the warmups and
    `install_snapshot` all run on it (a thread starts on the default
    stream, so each enters the service's), and waiting for a result waits
    for that stream only, so replicas sharing the card do not wait for
    each other's work.  On the CPU there is no stream;
  * on a mesh (a coder built with `mesh=`), SPMD with mesh rank 0 as the
    controller: rank 0 runs the service above (its batcher and learner
    threads, micro-batching, snapshots); under `_exec_lock`, before each
    engine call, it broadcasts a small header (op: solve / fit / warm fit
    / stop; the snapshot version or the version a fit publishes as; t0;
    mu_w; rows) and then the micro-batch, zero-padded to a multiple of the
    data extent as the JAX service pads it.  Every other rank runs
    `follow`, which makes the same coder call on its block and its data
    rows, so every rank issues one collective order whatever rank 0's
    thread timing; the codes are gathered to every rank, rank 0 resolves
    the futures.  A follower waits for the next header on the mesh's
    `io_group` (the world's timeout): an idle stream may last longer than
    the axis groups' 2 minutes.  Growth, drain and `install_snapshot`
    (the fleet's publish) raise on a mesh (ROADMAP section 1, items 8, 9).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import MESH_GROWTH_ITEM, DistributedSparseCoder
from repro_torch.core.dictionary import full_from_blocks

# The mesh protocol: the header rank 0 broadcasts before each engine call
# (op, version, t0, mu_w, rows), and its ops.
OP_STOP, OP_SOLVE, OP_FIT, OP_WARM_FIT = 0, 1, 2, 3
MESH_FLEET_ITEM = "ROADMAP section 1, item 9 (the fleet on disjoint meshes)"


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

    def clear(self) -> int:
        """Discard everything buffered (the kill path); returns the count."""
        with self._cond:
            n = len(self._buf)
            self._buf.clear()
            self.discarded += n
            return n


def _sweep(q: "queue.Queue", future_of, err: BaseException) -> None:
    """Fail the Future of every item still in `q`."""
    while True:
        try:
            _resolve(future_of(q.get_nowait()), exc=err)
        except queue.Empty:
            return


class DictionaryService:
    """Continuously-learning dictionary server over N agents on one device.

    Usage:
        coder = DistributedSparseCoder(n_agents, res, reg, dist_cfg)
        with DictionaryService(coder, W0, ServiceConfig()) as svc:
            futs = [svc.submit(x_i) for x_i in stream]
            svc.grow(2, torch.Generator().manual_seed(2))   # optional
            svc.drain([1, 3])                               # optional
            results = [f.result() for f in futs]     # (nu_i, y_i) each

    `stream`: the CUDA stream this service runs on (the serving plane gives
    each replica its own); None takes the constructing thread's current
    stream on the card (every stream that runs a matmul keeps a cuBLAS
    workspace for the life of the process, so a lone service makes none),
    and none on the CPU.
    """

    def __init__(self, coder: DistributedSparseCoder, W0, cfg: ServiceConfig = ServiceConfig(),
                 stream: Optional["torch.cuda.Stream"] = None, record_fits: bool = False):
        """`record_fits` keeps every fit step's (padded batch, mu_w, t0) in
        `fit_log`, in execution order (for a replay of the run)."""
        self.cfg = cfg
        self._lock = threading.Lock()  # guards the counters and (coder, live, snapshot)
        self._exec_lock = threading.Lock()  # one engine execution at a time
        # Makes the running-check + enqueue in submit()/grow()/drain() atomic
        # w.r.t. stop() and kill().
        self._submit_lock = threading.Lock()
        if coder.device.type == "cuda":
            current = torch.cuda.current_stream(coder.device)
            self._stream = current if stream is None else stream
            # the caller's work (W0 among it) comes first
            self._stream.wait_stream(current)
        else:
            self._stream = None
        self._coder = coder
        with self._on_stream():
            self._live = coder.snapshot(W0)
        self._snap = self._live
        self._m = int(self._live.shape[1])
        self._mesh = coder.mesh
        d = 1 if self._mesh is None else self._mesh.size("data")
        # padded to a multiple of the data extent, so the rows split evenly
        self._pad = max(cfg.micro_batch, d) + (-max(cfg.micro_batch, d)) % d
        self.fit_log: Optional[List[Tuple[np.ndarray, float, int]]] = [] if record_fits else None
        self._released = False  # the followers were sent OP_STOP
        # On a mesh, the published snapshots still referenced, by version
        # (a solve names its snapshot's version to the followers).
        self._snap_refs: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
            weakref.WeakValueDictionary()
        self._queue: "queue.Queue[_Item]" = queue.Queue(maxsize=cfg.queue_capacity)
        self._learn_q = _LearnReservoir(cfg.learn_queue_cap, cfg.learn_seed)
        self._grow_q: "queue.Queue[Tuple[int, torch.Generator, Future]]" = queue.Queue()
        self._drain_q: "queue.Queue[Tuple[Tuple[int, ...], Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t_start: Optional[float] = None
        self._comb_info: Dict = coder.combiner_info()
        # The schedule clock: the combiner-sequence offset of the next
        # execution (an unbounded int; static coders leave it at 0).
        self._sched_t = 0
        self.submitted = 0
        self.coded = 0
        self.fit_steps = 0
        self.fit_failures = 0
        self.learn_dropped = 0
        self.fit_first_error: Optional[str] = None
        self.published = 0
        self.grow_events: List[Dict] = []
        self.drain_events: List[Dict] = []
        self._latencies = collections.deque(maxlen=cfg.latency_window)
        # The published snapshot's version (bumped by every publish: learner,
        # install_snapshot, grow/drain swap) and the version the last
        # completed solve coded against.
        self._snap_version = 0
        self._serving_version = 0
        self._remember_snapshot()

    # -- helpers ----------------------------------------------------------

    def _on_stream(self):
        """Context that runs the calling thread's device work on this
        service's stream (a no-op on the CPU)."""
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    def _wait(self) -> None:
        """Wait for this service's device work (errors surface here); other
        streams on the card are not waited for."""
        if self._stream is not None:
            self._stream.synchronize()

    def _pad_rows(self, xb: np.ndarray) -> np.ndarray:
        """Zero-pad a batch to the fixed micro-batch size."""
        b = xb.shape[0]
        if b >= self._pad:
            return xb
        return np.concatenate(
            [xb, np.zeros((self._pad - b, xb.shape[1]), xb.dtype)], axis=0
        )

    def _advance_schedule(self, coder: DistributedSparseCoder) -> int:
        """Claim the next cfg.iters iterations of a time-varying coder's
        combiner sequence; returns the offset t0 this execution starts
        from, reduced mod the coder's schedule period (0 for a static
        coder).  Call it holding `_exec_lock`, so claim order is execution
        order."""
        if not coder.is_time_varying:
            return 0
        with self._lock:
            t0 = self._sched_t
            self._sched_t += coder.cfg.iters
        return t0 % coder.schedule_period

    def _rollback_schedule(self, coder: DistributedSparseCoder) -> None:
        """Give back a claimed window that never ran (a fit that raised);
        the caller still holds `_exec_lock`, so no later claim built on it."""
        if not coder.is_time_varying:
            return
        with self._lock:
            self._sched_t -= coder.cfg.iters

    def _announce(self, op: int, ver: int = 0, t0: int = 0, mu_w: float = 0.0,
                  xb: Optional[np.ndarray] = None) -> None:
        """On a mesh, rank 0 tells the followers the next engine call (hold
        `_exec_lock`, or run before the workers exist): the header, then
        the padded batch."""
        if self._mesh is None:
            return
        rows = 0 if xb is None else xb.shape[0]
        header = torch.tensor([op, ver, t0, mu_w, rows], dtype=torch.float64,
                              device=self._mesh.device)
        self._mesh.broadcast(header, 0, io=True)
        if xb is not None:
            self._mesh.broadcast(torch.as_tensor(xb, device=self._mesh.device))

    def _release_followers(self) -> None:
        """Send the followers OP_STOP, once (after the workers joined)."""
        if self._mesh is not None and not self._released:
            self._released = True
            with self._exec_lock, self._on_stream():
                self._announce(OP_STOP)

    def _remember_snapshot(self) -> None:
        """On a mesh, file the published snapshot under its version (hold
        `_lock`, or run before the workers exist)."""
        if self._mesh is not None:
            self._snap_refs[self._snap_version] = self._snap

    def _version_of(self, snap: torch.Tensor) -> int:
        """The version a published snapshot was filed under (on a mesh)."""
        if self._mesh is None:
            return 0
        with self._lock:
            for ver, s in self._snap_refs.items():
                if s is snap:
                    return ver
        raise RuntimeError("a solve against a snapshot that was never published")

    def _code(self, coder: DistributedSparseCoder, W: torch.Tensor, xb: np.ndarray,
              t0: Optional[int]):
        """One solve of a padded batch on every rank; (nu, y) over all its
        rows.  t0 None: a warmup, which claims no window of the clock."""
        self._announce(OP_SOLVE, self._version_of(W), t0 or 0, xb=xb)
        return _engine(coder, OP_SOLVE, W, xb, t0)

    def _solve_padded(self, coder: DistributedSparseCoder, snap: torch.Tensor, xb: np.ndarray):
        """Code a real batch of b rows against `snap` with `coder`, the pair
        read together; host numpy results."""
        b = xb.shape[0]
        with self._exec_lock:
            t0 = self._advance_schedule(coder)
            nu, y = self._code(coder, snap, self._pad_rows(xb), t0)
            nu, y = nu[:b].cpu().numpy(), y[:b].cpu().numpy()
        return nu, y

    # -- lifecycle --------------------------------------------------------

    def _warmup(self, coder: DistributedSparseCoder, W: torch.Tensor) -> None:
        """One solve (and one fit with mu_w = 0) on a zero micro-batch, so
        the kernels are built and the allocator warm before the first
        request (or before a swap publishes a new coder).  Takes no lock
        itself: start() runs it before the workers exist, the swaps under
        `_exec_lock`."""
        z = np.zeros((self._pad, self._m), np.float32)
        self._code(coder, W, z, None)
        if self.cfg.learn:
            self._announce(OP_WARM_FIT, xb=z)
            _engine(coder, OP_WARM_FIT, W, z, None, 0.0)
        self._wait()

    def start(self) -> "DictionaryService":
        if self._threads:
            raise RuntimeError("service already started")
        if self._stop.is_set():
            raise RuntimeError(
                "service cannot be restarted after stop(); create a new "
                "DictionaryService (counters and queues are single-run)"
            )
        if self.cfg.warmup:
            with self._on_stream():
                self._warmup(self._coder, self._snap)
        self._t_start = time.perf_counter()
        self._threads = [
            threading.Thread(target=self._batcher_loop, name="dict-batcher", daemon=True),
            threading.Thread(target=self._learner_loop, name="dict-learner", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def _fail_pending(self, err: BaseException) -> None:
        """Fail every queued request, grow and drain (hold `_submit_lock`)."""
        _sweep(self._queue, lambda it: it.future, err)
        _sweep(self._grow_q, lambda g: g[2], err)
        _sweep(self._drain_q, lambda d: d[1], err)

    def stop(self) -> None:
        """Code every queued sample, let the learner consume what it was
        given, then join the workers; a request, grow or drain that raced
        the shutdown is failed, never left hanging."""
        self._stop.set()
        for t in self._threads:
            t.join()
        self._release_followers()
        with self._submit_lock:
            self._threads = []
            self._fail_pending(RuntimeError("service stopped before this request was processed"))

    def kill(self) -> None:
        """Hard stop for fault drills: fail everything still queued instead
        of coding it (stop() codes the backlog first; a crashed replica must
        not).  The failed Futures are the signal the serving plane's Router
        re-routes on.  Idempotent; stop() after kill() is a no-op sweep."""
        err = RuntimeError("replica killed")
        with self._submit_lock:
            self._stop.set()
            _sweep(self._queue, lambda it: it.future, err)
        # the batcher first (it may still offer one last learn batch), then
        # purge the reservoir so the learner's exit check sees it empty
        for t in self._threads[:1]:
            t.join()
        self._learn_q.clear()
        for t in self._threads[1:]:
            t.join()
        self._release_followers()
        with self._submit_lock:
            self._threads = []
            self._fail_pending(err)

    def __enter__(self) -> "DictionaryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -------------------------------------------------------

    def _enqueue(self, q: "queue.Queue", item, what: str) -> None:
        with self._submit_lock:
            if self._stop.is_set() or not self._threads:
                raise RuntimeError(
                    f"service is not running ({what} before start() or after stop() "
                    f"would wait for a worker that never comes)"
                )
            q.put(item)

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one sample (M,); the Future resolves to (nu (M,), y (K,))."""
        x = np.asarray(x, np.float32)
        if x.shape != (self._m,):
            raise ValueError(f"expected sample shape ({self._m},), got {x.shape}")
        item = _Item(x)
        self._enqueue(self._queue, item, "submit()")
        with self._lock:
            self.submitted += 1
        return item.future

    def submit_many(self, X: np.ndarray) -> List[Future]:
        return [self.submit(x) for x in X]

    def grow(self, extra_model: int, generator: torch.Generator) -> Future:
        """Request elastic growth by `extra_model` model-level agents, fresh
        atoms from `generator` (`DistributedSparseCoder.grown`).  Applied by
        the learner at its next step boundary; the Future resolves to the
        grow event (an info dict) once the new coder and snapshot are live.
        Raises on a mesh."""
        if self._mesh is not None:
            raise NotImplementedError(f"growth on a mesh: {MESH_GROWTH_ITEM}")
        fut: Future = Future()
        self._enqueue(self._grow_q, (int(extra_model), generator, fut), "grow()")
        return fut

    def drain(self, departing_ranks: Sequence[int]) -> Future:
        """Request that the model ranks `departing_ranks` leave (the inverse
        of grow()).  Applied by the learner at its next step boundary; the
        Future resolves to the drain event once the shrunk coder and
        snapshot are live.  Survivors keep their blocks bit for bit, and the
        schedule clock carries over.  Raises on a mesh."""
        if self._mesh is not None:
            raise NotImplementedError(f"agent drain on a mesh: {MESH_GROWTH_ITEM}")
        departing = tuple(sorted(set(int(r) for r in departing_ranks)))
        if not departing:
            raise ValueError("departing_ranks is empty: nothing to drain")
        fut: Future = Future()
        self._enqueue(self._drain_q, (departing, fut), "drain()")
        return fut

    def snapshot(self) -> torch.Tensor:
        """The currently published (N, M, Kb) snapshot (never written)."""
        with self._lock:
            return self._snap

    def live(self) -> torch.Tensor:
        """The live blocks the learner advances (the snapshot lags it by up
        to publish_every - 1 fit steps; never written)."""
        with self._lock:
            return self._live

    def dictionary(self) -> np.ndarray:
        """Host (M, K) copy of the currently published snapshot (one
        process; on a mesh every rank holds one block: `coder.gather`)."""
        if self._mesh is not None:
            raise RuntimeError("on a mesh each rank holds one block; gather the dictionary "
                               "with the coder's collective `gather` on every rank")
        return full_from_blocks(self.snapshot()).cpu().numpy()

    @property
    def sample_dim(self) -> int:
        """Row dimension M a submitted sample must have."""
        return self._m

    def running(self) -> bool:
        """True while the workers are up and shutdown hasn't begun."""
        return bool(self._threads) and not self._stop.is_set()

    def install_snapshot(self, W) -> int:
        """Publish an external dictionary (the fan-out of
        serving.ReplicaSet.publish): `W` (M, K), host or device, is placed
        as this coder's blocks on the service's stream and swapped in as
        both the live copy and the published snapshot.  Returns the new
        snapshot version.  Batches in flight finish on the old snapshot;
        the next one codes against `W`.  Refused when W's shape is not the
        live dictionary's, or when a grow or drain changed the coder while
        W was being placed.  Raises on a mesh."""
        if self._mesh is not None:
            raise NotImplementedError(f"install_snapshot on a mesh: {MESH_FLEET_ITEM}")
        with self._submit_lock:
            if self._stop.is_set() or not self._threads:
                raise RuntimeError("service is not running; cannot install a snapshot")
        with self._lock:
            coder, live = self._coder, self._live
        want = (self._m, int(live.shape[0]) * int(live.shape[2]))
        if tuple(W.shape) != want:
            raise ValueError(
                f"snapshot shape {tuple(W.shape)} does not match the live dictionary "
                f"{want} (grow/drain the replica first, then publish)"
            )
        # Placed outside _lock, on this service's stream (the publisher's
        # thread would otherwise use its own) after the publisher's work that
        # made a device W, and finished before the swap.
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self._stream.device))
        with self._on_stream():
            W_dev = coder.snapshot(torch.as_tensor(W, dtype=torch.float32))
            self._wait()
        with self._lock:
            if self._coder is not coder:
                raise RuntimeError(
                    "coder changed (grow/drain) during install_snapshot; retry "
                    "against the new geometry"
                )
            self._live = W_dev
            self._snap = W_dev
            self.published += 1
            self._snap_version += 1
            return self._snap_version

    def load(self) -> Dict:
        """The router's routing signal, in one consistent read: queue depth
        and the snapshot and serving versions."""
        with self._lock:
            return {
                "queue_depth": self._queue.qsize(),
                "snapshot_version": self._snap_version,
                "serving_version": self._serving_version,
                "coded": self.coded,
            }

    def stats(self) -> Dict:
        """One consistent snapshot of the counters, with the JAX service's
        keys: throughput, latency percentiles, learner progress, the grow
        and drain events and the gossip identity."""
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
                "grow_events": [dict(ev) for ev in self.grow_events],
                "drain_events": [dict(ev) for ev in self.drain_events],
                "topology": self._comb_info["topology"],
                "mixing_rate": self._comb_info["mixing_rate"],
                "schedule": self._comb_info.get("schedule"),
                "schedule_period": self._comb_info.get("schedule_period", 1),
                # the combiner the next execution starts from
                "active_schedule": self._sched_t % self._comb_info.get("schedule_period", 1),
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
        with self._on_stream():
            self._batch_forever()

    def _batch_forever(self) -> None:
        while True:
            items = self._collect()
            if not items:
                if self._stop.is_set() and self._queue.empty():
                    return
                continue
            xb = np.stack([it.x for it in items])
            with self._lock:  # one era: the coder with its own snapshot
                coder, snap, ver = self._coder, self._snap, self._snap_version
            try:
                nu, y = self._solve_padded(coder, snap, xb)
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
        with self._on_stream():
            self._learn_forever()

    def _learn_forever(self) -> None:
        while True:
            self._maybe_grow()
            self._maybe_drain()
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
                coder, live = self._coder, self._live
            b = xb.shape[0]
            xb = self._pad_rows(xb)
            # Zero pad rows code to nu = 0 and add nothing to the gradient
            # sum; rescale mu_w so the mean is over the real samples.
            mu_w_eff = self.cfg.mu_w * (xb.shape[0] / b)
            try:
                with self._exec_lock:
                    t0 = self._advance_schedule(coder)
                    try:
                        # the version this fit publishes as (0: not published)
                        publish_as = self._snap_version + 1 \
                            if (self.fit_steps + 1) % self.cfg.publish_every == 0 else 0
                        self._announce(OP_FIT, publish_as, t0, mu_w_eff, xb)
                        live2 = _engine(coder, OP_FIT, live, xb, t0, mu_w_eff)
                        self._wait()
                        if self.fit_log is not None:
                            self.fit_log.append((xb, mu_w_eff, t0))
                    except Exception:
                        self._rollback_schedule(coder)  # the window never ran
                        raise
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
                # publish only if no swap replaced the coder underneath us
                if self._coder is coder:
                    self._live = live2
                    if self.fit_steps % self.cfg.publish_every == 0:
                        self._snap = live2
                        self.published += 1
                        self._snap_version += 1
                        self._remember_snapshot()

    def _maybe_grow(self) -> None:
        self._maybe_swap(self._grow_q, lambda c, W, req: c.grown(W, req[0], req[1]))

    def _maybe_drain(self) -> None:
        self._maybe_swap(self._drain_q, lambda c, W, req: c.shrunk(W, req[0]))

    def _maybe_swap(self, q: "queue.Queue", build) -> None:
        """Apply one queued grow (q = _grow_q) or drain (_drain_q): build
        the new (coder, W2) from the live pair, warm the new coder under
        `_exec_lock` (readers keep coding on the old pair meanwhile), swap
        coder, live copy and snapshot in one `_lock` acquisition and resolve
        the request's Future with the event.  The schedule clock is not
        reset: the next claim reduces it mod the new coder's period."""
        try:
            req = q.get_nowait()
        except queue.Empty:
            return
        fut = req[-1]
        drain = q is self._drain_q
        try:
            with self._lock:
                coder, live = self._coder, self._live
            new_coder, W2 = build(coder, live, req)
            if self.cfg.warmup:
                with self._exec_lock:
                    self._warmup(new_coder, W2)
            new_info = new_coder.combiner_info()
            with self._lock:
                self._coder, self._live, self._snap = new_coder, W2, W2
                self._comb_info = new_info
                self.published += 1
                self._snap_version += 1
                info = {"at_coded": self.coded}
                if drain:
                    info["departed"] = list(req[0])
                info.update({
                    "k_old": coder.n_agents * int(live.shape[2]),
                    "k_new": new_coder.n_agents * int(W2.shape[2]),
                    "model_old": coder.level_sizes[0],
                    "model_new": new_coder.level_sizes[0],
                })
                if drain:
                    info["sched_t"] = self._sched_t
                info.update({
                    "topology": new_info["topology"],
                    "mixing_rate": new_info["mixing_rate"],
                    "schedule": new_info.get("schedule"),
                    "schedule_period": new_info.get("schedule_period", 1),
                    "pod_topology": new_info.get("pod_topology"),
                    "pod_gossip_every": new_info.get("pod_gossip_every", 1),
                    "levels": new_info.get("levels"),
                })
                (self.drain_events if drain else self.grow_events).append(info)
            del coder, live
            _resolve(fut, info)
        except Exception as e:
            _resolve(fut, exc=e)


def _engine(coder: DistributedSparseCoder, op: int, W: torch.Tensor, xb, t0: Optional[int],
            mu_w: float = 0.0):
    """The coder call of one op, the same on every rank: a solve (its
    result gathered over a mesh) or a fit step on this rank's rows; t0 None
    (a warmup) leaves the coder's default offset."""
    x = coder.local_rows(xb)
    _engine.calls += 1
    at = () if t0 is None else (t0,)
    if op == OP_SOLVE:
        nu, y = coder.solve(W, x, *at)
        return (nu, y) if coder.mesh is None else coder.gather_solution(nu, y)
    return coder.fit_batch(W, x, mu_w, *at)


_engine.calls = 0  # engine calls in this process (each one solve: iters + 1 K1 launches)


@torch.no_grad()
def follow(coder: DistributedSparseCoder, W0) -> torch.Tensor:
    """A follower rank's side of a `DictionaryService` that mesh rank 0
    runs with the same coder (its own mesh rank): take each header, make
    the coder call rank 0 makes, on this rank's block and data rows, until
    OP_STOP; returns this rank's live block.  Each fit that rank 0 publishes
    becomes the snapshot of that version; a solve codes against the
    version rank 0 names (versions only grow, so older ones are dropped)."""
    mesh = coder.mesh
    live = coder.snapshot(W0)
    snaps = {0: live}
    m = live.shape[1]
    while True:
        header = mesh.broadcast(torch.zeros(5, dtype=torch.float64, device=mesh.device), 0,
                                io=True)
        op, ver, t0, mu_w, rows = header.tolist()
        op, ver, t0, rows = int(op), int(ver), int(t0), int(rows)
        if op == OP_STOP:
            return live
        xb = mesh.broadcast(torch.empty((rows, m), dtype=live.dtype, device=mesh.device))
        if op == OP_SOLVE:
            _engine(coder, op, snaps[ver], xb, t0)
            for v in [v for v in snaps if v < ver]:
                del snaps[v]
        elif op == OP_FIT:
            live = _engine(coder, op, live, xb, t0, mu_w)
            if ver:
                snaps[ver] = live
        elif op == OP_WARM_FIT:
            _engine(coder, op, live, xb, t0, mu_w)
        else:
            raise RuntimeError(f"unknown service op {op} from mesh rank 0")
