"""Multi-replica serving plane: router and snapshot fan-out over a fleet.

Port of src/repro/runtime/serving.py.  `runtime/service.DictionaryService`
serves one dictionary from one coder; this module puts several of them
behind one front-end, the regime where many consumers read a dictionary
that keeps changing:

  * `ReplicaSet`: N replicas, each a `DictionaryService` with its own
    published snapshot.  `publish(W)` fans a new dictionary out to the
    replicas one at a time (rolling), each an atomic `install_snapshot`,
    so every replica always serves a whole snapshot and the fleet never
    pauses; during the roll the fleet is mixed-version, which the router's
    staleness term absorbs.  Publishes serialize on `_exec_lock`.
  * `Router`: admits single requests into micro-batches (size or
    deadline, as the service does), places each batch on the replica
    minimizing

        score(r) = depth_weight * queue_depth(r)
                 + stale_penalty * (fleet_version - snapshot_version(r))

    (`pick_replica`; fleet_version is the newest version a live replica
    holds, ties broken by one draw from a seeded numpy Generator, so the
    placements are JAX's for the same load history), and re-routes a
    request whose replica failed it (`DictionaryService.kill`) to a
    survivor, up to `max_retries` times.

Mapping onto one card: a JAX pool is a disjoint set of devices; here every
replica shares the one H100, and a pool (`device_pools`) is the card and a
CUDA stream of its own, so the replicas' engine executions interleave on
the card without waiting for each other.  On the CPU a pool is the CPU and
no stream.  `device_pools` refuses more replicas than the card's free
memory holds at the service's width (`replica_bytes`).

The router speaks a small replica protocol (`submit`, `load`,
`install_snapshot`, `running`, `start`/`stop`/`kill`), not the service
class, so tests can drive it with in-process fakes.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.service import _resolve

__all__ = [
    "Pool",
    "RouterConfig",
    "Replica",
    "ReplicaSet",
    "Router",
    "pick_replica",
    "device_pools",
    "replica_bytes",
]


@dataclasses.dataclass(frozen=True)
class Pool:
    """Where one replica runs: its device and, on the card, its own stream
    (None on the CPU)."""

    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None


def replica_bytes(n_agents: int, m: int, kb: int, learn: bool, itemsize: int = 4) -> int:
    """Device bytes one replica needs at the service's width: copies of the
    (N, M, Kb) dictionary, each N * M * Kb * itemsize bytes: the published
    snapshot, one more while a snapshot is installed or a fit builds its
    result, and with learning on the live copy, which runs ahead of the
    snapshot."""
    copies = 3 if learn else 2
    return copies * int(n_agents) * int(m) * int(kb) * int(itemsize)


def device_pools(n_replicas: int, per_replica_bytes: int = 0, device: DeviceLike = "cuda",
                 free_bytes: Optional[int] = None) -> List[Pool]:
    """One `Pool` per replica on `device` (the card by default): on the
    card each with a new CUDA stream, on the CPU without one.  Refuses
    n_replicas * per_replica_bytes above `free_bytes`, by default the
    card's free memory (`torch.cuda.mem_get_info`); the CPU is not
    checked unless `free_bytes` is given."""
    if n_replicas < 1:
        raise ValueError(f"need at least one replica, got {n_replicas}")
    dev = resolve_device(device)
    if free_bytes is None and dev.type == "cuda":
        free_bytes = torch.cuda.mem_get_info(dev)[0]
    need = int(n_replicas) * int(per_replica_bytes)
    if free_bytes is not None and need > free_bytes:
        raise ValueError(
            f"{n_replicas} replicas x {per_replica_bytes / 1e9:.2f} GB need "
            f"{need / 1e9:.2f} GB, {dev} has {free_bytes / 1e9:.2f} GB free"
        )
    if dev.type == "cuda":
        return [Pool(dev, torch.cuda.Stream(dev)) for _ in range(n_replicas)]
    return [Pool(dev) for _ in range(n_replicas)]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Knobs for the serving-plane front-end (the JAX RouterConfig's)."""

    micro_batch: int = 16  # admission batch size (routing granularity)
    max_wait_s: float = 0.02  # flush a partial admission batch after this
    depth_weight: float = 1.0  # score weight per queued request
    stale_penalty: float = 8.0  # score weight per snapshot version behind
    # the fleet head: a replica one publish behind costs as much as
    # `stale_penalty` queued requests, so it sheds (but is not banned)
    seed: int = 0  # tie-break draws; placement is deterministic in this
    max_retries: int = 2  # re-route attempts per request after failures
    queue_capacity: int = 8192  # submit() blocks when this many are pending


@dataclasses.dataclass
class Replica:
    """One named member of the fleet.  `service` is anything speaking the
    replica protocol (a DictionaryService, or a fake in unit tests)."""

    name: str
    service: object


def pick_replica(
    loads: Sequence[Optional[Dict]],
    fleet_version: int,
    cfg: RouterConfig,
    rng: np.random.Generator,
) -> int:
    """Index of the replica minimizing the depth + staleness score.
    `loads[i]` is replica i's `load()` dict, or None when it is dead (never
    picked).  Only ties draw from `rng`, so the placement sequence is
    deterministic in (seed, load history)."""
    scores: List[Optional[float]] = []
    for ld in loads:
        if ld is None:
            scores.append(None)
            continue
        gap = max(0, int(fleet_version) - int(ld["snapshot_version"]))
        scores.append(cfg.depth_weight * float(ld["queue_depth"]) + cfg.stale_penalty * gap)
    live = [s for s in scores if s is not None]
    if not live:
        raise ValueError("pick_replica: no live replicas")
    best = min(live)
    cands = [i for i, s in enumerate(scores) if s is not None and s == best]
    if len(cands) == 1:
        return cands[0]
    return cands[int(rng.integers(len(cands)))]


class ReplicaSet:
    """The fleet: named replicas and the rolling snapshot fan-out.

    Usage:
        pools = device_pools(2, replica_bytes(n, m, kb, learn=False))
        services = [DictionaryService(coder_i, W0, cfg, stream=pool.stream)
                    for coder_i, pool in zip(coders, pools)]
        with ReplicaSet(services) as fleet:
            with Router(fleet) as router:
                futs = [router.submit(x) for x in stream]
                fleet.publish(W_new)          # rolling, never pauses
                results = [f.result() for f in futs]
    """

    def __init__(self, services: Sequence[object], names: Optional[Sequence[str]] = None):
        if not services:
            raise ValueError("ReplicaSet needs at least one replica service")
        if names is None:
            names = [f"r{i}" for i in range(len(services))]
        if len(names) != len(services) or len(set(names)) != len(names):
            raise ValueError(f"need {len(services)} unique replica names, got {names}")
        self.replicas = [Replica(n, s) for n, s in zip(names, services)]
        self._lock = threading.Lock()  # guards publishes, publish_events
        self._exec_lock = threading.Lock()  # one install_snapshot at a time
        self.publishes = 0  # completed publish() rounds
        self.publish_events: List[Dict] = []  # one per round: name -> version

    def __len__(self) -> int:
        return len(self.replicas)

    def start(self) -> "ReplicaSet":
        for rep in self.replicas:
            rep.service.start()
        return self

    def stop(self) -> None:
        """Graceful fleet shutdown: each replica codes its backlog (killed
        replicas are a no-op sweep)."""
        for rep in self.replicas:
            rep.service.stop()

    def kill(self, name: str) -> None:
        """Hard-stop one replica (fault drill): its queued requests fail,
        the signal the Router re-routes them on."""
        self[name].service.kill()

    def __getitem__(self, name: str) -> Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}; have {[r.name for r in self.replicas]}")

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def alive(self) -> List[str]:
        return [rep.name for rep in self.replicas if rep.service.running()]

    def fleet_version(self) -> int:
        """Newest snapshot version any live replica holds."""
        versions = [rep.service.load()["snapshot_version"]
                    for rep in self.replicas if rep.service.running()]
        return max(versions) if versions else 0

    def publish(self, W) -> Dict[str, int]:
        """Rolling fan-out of a new dictionary: install on the live replicas
        one at a time, in fleet order, while the others keep serving.
        Returns {replica name: new version} for the replicas reached; a dead
        replica, or one that dies mid-roll, is skipped, not an error."""
        installed: Dict[str, int] = {}
        for rep in self.replicas:
            if not rep.service.running():
                continue
            try:
                with self._exec_lock:
                    installed[rep.name] = int(rep.service.install_snapshot(W))
            except RuntimeError:
                # died (or began shutdown) between the check and the swap
                if rep.service.running():
                    raise
        with self._lock:
            self.publishes += 1
            self.publish_events.append(dict(installed))
        return installed

    def stats(self) -> Dict:
        with self._lock:
            out = {
                "publishes": self.publishes,
                "publish_events": [dict(ev) for ev in self.publish_events],
            }
        out["alive"] = self.alive()
        # a stopped or killed service's stats stay readable: the run's record
        out["replicas"] = {rep.name: rep.service.stats() for rep in self.replicas}
        return out


class _RouterItem:
    __slots__ = ("x", "future", "t_submit", "retries")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.retries = 0


class Router:
    """Continuous-batching front-end over a ReplicaSet (or any sequence of
    replica-protocol services).

    One admission thread collects submitted samples into micro-batches
    (size or deadline), scores the live replicas and places the whole batch
    on the best one.  The outer per-sample Future resolves when the
    replica's does; a failed inner Future (replica killed) re-admits the
    sample instead, up to `max_retries` times while any replica lives.
    """

    def __init__(self, replicas, cfg: RouterConfig = RouterConfig()):
        self.cfg = cfg
        if isinstance(replicas, ReplicaSet):
            self._replicas = list(replicas.replicas)
        else:
            self._replicas = [
                rep if isinstance(rep, Replica) else Replica(f"r{i}", rep)
                for i, rep in enumerate(replicas)
            ]
        if not self._replicas:
            raise ValueError("Router needs at least one replica")
        self._lock = threading.Lock()  # guards the counters below
        # Makes the running-check + enqueue in submit() atomic w.r.t. stop().
        self._submit_lock = threading.Lock()
        self._queue: "queue.Queue[_RouterItem]" = queue.Queue(maxsize=cfg.queue_capacity)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._rng = np.random.default_rng(cfg.seed)  # admission thread only
        # Sample dim, when a replica exposes one (real services do), so a
        # bad shape is refused at the door.
        self._m: Optional[int] = None
        for rep in self._replicas:
            m = getattr(rep.service, "sample_dim", None)
            if m is not None:
                self._m = int(m)
                break
        self.admitted = 0
        self.rerouted = 0  # re-admissions after an inner-future failure
        self.failed = 0  # outer futures resolved exceptionally
        self._inflight = 0  # admitted, not yet resolved either way
        self._route_counts = [0] * len(self._replicas)
        self._latencies = collections.deque(maxlen=100_000)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Router":
        if self._threads:
            raise RuntimeError("router already started")
        if self._stop.is_set():
            raise RuntimeError("router cannot be restarted after stop(); create a new Router")
        self._threads = [
            threading.Thread(target=self._admit_loop, name="router-admit", daemon=True)
        ]
        self._threads[0].start()
        return self

    def stop(self) -> None:
        """Every admitted sample resolves (with its result, or with the
        terminal error after retries) before the admission thread joins.
        Does not stop the replicas: stop the router, then the fleet."""
        with self._submit_lock:
            self._stop.set()
        for t in self._threads:
            t.join()
        err = RuntimeError("router stopped before this request was processed")
        with self._submit_lock:
            self._threads = []
            while True:  # failsafe: the loop exits only once drained
                try:
                    _resolve(self._queue.get_nowait().future, exc=err)
                except queue.Empty:
                    break

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -------------------------------------------------------

    def submit(self, x: np.ndarray) -> Future:
        """Admit one sample (M,); the Future resolves to (nu (M,), y (K,))
        from whichever replica (first placed or re-routed) coded it."""
        x = np.asarray(x, np.float32)
        if self._m is not None and x.shape != (self._m,):
            raise ValueError(f"expected sample shape ({self._m},), got {x.shape}")
        item = _RouterItem(x)
        with self._submit_lock:
            if self._stop.is_set() or not self._threads:
                raise RuntimeError(
                    "router is not running (submit() before start() or after "
                    "stop() would admit a sample no thread will ever place)"
                )
            with self._lock:
                self.admitted += 1
                self._inflight += 1
            self._queue.put(item)
        return item.future

    def submit_many(self, X: np.ndarray) -> List[Future]:
        return [self.submit(x) for x in X]

    def stats(self) -> Dict:
        """Consistent router counters with per-replica placement and load."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            out = {
                "admitted": self.admitted,
                "rerouted": self.rerouted,
                "failed": self.failed,
                "inflight": self._inflight,
                "routed": {rep.name: int(c)
                           for rep, c in zip(self._replicas, self._route_counts)},
            }
        out["replicas"] = {
            rep.name: (rep.service.load() if rep.service.running() else None)
            for rep in self._replicas
        }
        if lat.size:
            out["latency_ms"] = {
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p95": float(np.percentile(lat, 95) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
                "max": float(lat.max() * 1e3),
            }
        return out

    # -- admission thread -------------------------------------------------

    def _collect(self) -> List[_RouterItem]:
        """Size-or-deadline admission: block briefly for a first sample,
        then fill up to micro_batch until max_wait_s from the first one."""
        items: List[_RouterItem] = []
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

    def _admit_loop(self) -> None:
        while True:
            items = self._collect()
            if items:
                self._dispatch(items)
                continue
            with self._lock:
                drained = self._inflight == 0
            # Exit only when nothing is queued and nothing is in flight: a
            # killed replica's failures re-admit through the queue.
            if self._stop.is_set() and self._queue.empty() and drained:
                return

    def _observe(self) -> List[Optional[Dict]]:
        """One load observation per replica (None = dead), in fleet order."""
        loads: List[Optional[Dict]] = []
        for rep in self._replicas:
            if not rep.service.running():
                loads.append(None)
                continue
            try:
                loads.append(rep.service.load())
            except Exception:
                loads.append(None)  # died between the check and the read
        return loads

    def _dispatch(self, items: List[_RouterItem]) -> None:
        """Place a batch on the best replica; if it dies mid-placement,
        re-pick from the survivors for the unplaced rest."""
        while items:
            loads = self._observe()
            if all(ld is None for ld in loads):
                err = RuntimeError("no live replicas")
                with self._lock:
                    self.failed += len(items)
                    self._inflight -= len(items)
                for it in items:
                    _resolve(it.future, exc=err)
                return
            fleet = max(ld["snapshot_version"] for ld in loads if ld is not None)
            idx = pick_replica(loads, fleet, self.cfg, self._rng)
            rep = self._replicas[idx]
            sent, place_err = 0, None
            try:
                for it in items:
                    inner = rep.service.submit(it.x)
                    inner.add_done_callback(lambda f, it=it: self._on_inner_done(it, f))
                    sent += 1
            except Exception as e:
                place_err = e
            if sent:
                with self._lock:
                    self._route_counts[idx] += sent
            items = items[sent:]
            if not items:
                return
            if not rep.service.running():
                continue  # died mid-placement: re-pick for the rest
            # submit() refused on a live replica (a bad shape): terminal
            with self._lock:
                self.failed += len(items)
                self._inflight -= len(items)
            for it in items:
                _resolve(it.future, exc=place_err)
            return

    def _on_inner_done(self, item: _RouterItem, inner: Future) -> None:
        """Completion callback (on the replica's worker thread): pass a
        result to the outer Future; re-admit on failure while retries and
        live replicas remain."""
        try:
            exc = inner.exception()
        except BaseException as e:  # includes CancelledError
            exc = e
        if exc is None:
            t_done = time.perf_counter()
            # Account before resolving, like the service.
            with self._lock:
                self._latencies.append(t_done - item.t_submit)
                self._inflight -= 1
            _resolve(item.future, inner.result())
            return
        # Re-admission stays open during stop(): the admission loop drains
        # the queue until nothing is in flight.
        alive = any(rep.service.running() for rep in self._replicas)
        if item.retries < self.cfg.max_retries and alive:
            item.retries += 1
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                pass  # overloaded: fall through to terminal failure
            else:
                with self._lock:
                    self.rerouted += 1
                return
        with self._lock:
            self.failed += 1
            self._inflight -= 1
        _resolve(item.future, exc=exc)
