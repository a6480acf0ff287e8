"""Elastic shard dispatch: heartbeats + re-dispatch at the loader level.

The port's copy of ``mgl_tpu/parallel/elastic.py`` (the standard library
only), unchanged but for its imports.

The reference library has no failure story beyond library-load fallback
(NativeLibraryLoader.java:51-87); its unit of work is one in-process call.
A multi-host TPU deployment needs one: the dataset is cut into work shards
(read batches), hosts *lease* shards from a coordinator queue, and a host
that stops heartbeating has its in-flight leases returned to the queue for
live hosts to pick up.  Results are collected idempotently (first
completion of a shard wins), so a re-dispatched shard that later completes
twice is harmless — alignment/likelihood work is pure.

This module is the coordinator-side state machine plus an in-process
worker-pool driver.  It is deliberately transport-agnostic: in a real pod
deployment the coordinator lives on host 0 (or a CPU job) and the three
calls (lease / heartbeat / complete) travel over whatever RPC the cluster
already has; the state machine and its guarantees are what matter and
what is tested.

Guarantees:
* every shard is completed exactly once in the output (idempotent commit);
* a worker marked dead (missed heartbeats) loses its leases, which become
  leasable again immediately;
* a worker that re-appears after being marked dead can keep working (its
  stale completions still commit if the shard wasn't finished elsewhere);
* progress is monotonic: completed shards never return to the queue.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterable


@dataclasses.dataclass
class _Shard:
    shard_id: int
    payload: Any
    state: str = "queued"            # queued | leased | done
    owner: str | None = None
    lease_deadline: float = 0.0
    attempts: int = 0


class ShardCoordinator:
    """Lease-based work queue with heartbeat-driven re-dispatch."""

    def __init__(self, shards: Iterable[Any], *, lease_ttl: float = 10.0,
                 heartbeat_ttl: float = 5.0, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._shards = [_Shard(i, p) for i, p in enumerate(shards)]
        self._results: dict[int, Any] = {}
        self._lease_ttl = lease_ttl
        self._hb_ttl = heartbeat_ttl
        self._last_beat: dict[str, float] = {}
        self._dead: set[str] = set()
        self._max_gap: dict[str, float] = {}   # worst inter-beat gap seen

    # -- worker API ---------------------------------------------------

    def heartbeat(self, worker: str) -> None:
        """Record liveness and renew the worker's in-flight leases."""
        with self._lock:
            now = self._clock()
            prev = self._last_beat.get(worker)
            if prev is not None:
                self._max_gap[worker] = max(self._max_gap.get(worker, 0.0),
                                            now - prev)
            self._last_beat[worker] = now
            self._dead.discard(worker)
            for sh in self._shards:
                if sh.state == "leased" and sh.owner == worker:
                    sh.lease_deadline = now + self._lease_ttl

    def lease(self, worker: str) -> tuple[int, Any] | None:
        """Next shard for ``worker``; None when nothing is leasable."""
        with self._lock:
            now = self._clock()
            self._last_beat[worker] = now
            self._dead.discard(worker)
            self._reap(now)
            for sh in self._shards:
                if sh.state == "queued":
                    sh.state = "leased"
                    sh.owner = worker
                    sh.lease_deadline = now + self._lease_ttl
                    sh.attempts += 1
                    return sh.shard_id, sh.payload
            return None

    def complete(self, worker: str, shard_id: int, result: Any) -> bool:
        """Commit a result.  Returns False if another worker already did."""
        with self._lock:
            sh = self._shards[shard_id]
            if sh.state == "done":
                return False
            sh.state = "done"
            sh.owner = worker
            self._results[shard_id] = result
            return True

    # -- coordinator internals -----------------------------------------

    def _reap(self, now: float) -> None:
        """Return leases of dead/expired workers to the queue."""
        for w, t in self._last_beat.items():
            if now - t > self._hb_ttl:
                self._dead.add(w)
        for sh in self._shards:
            if sh.state != "leased":
                continue
            if sh.owner in self._dead or now > sh.lease_deadline:
                sh.state = "queued"
                sh.owner = None

    # -- inspection -----------------------------------------------------

    def done(self) -> bool:
        with self._lock:
            return all(s.state == "done" for s in self._shards)

    def results(self) -> dict[int, Any]:
        with self._lock:
            if not all(s.state == "done" for s in self._shards):
                raise RuntimeError("not all shards completed")
            return dict(self._results)

    def stats(self) -> dict:
        with self._lock:
            states = [s.state for s in self._shards]
            return {
                "queued": states.count("queued"),
                "leased": states.count("leased"),
                "done": states.count("done"),
                "attempts": sum(s.attempts for s in self._shards),
                "dead_workers": sorted(self._dead),
                "max_heartbeat_gap": dict(self._max_gap),
            }


def run_elastic(
    shards: list[Any],
    work_fn: Callable[[Any], Any],
    n_workers: int = 2,
    *,
    lease_ttl: float = 10.0,
    heartbeat_ttl: float = 5.0,
    fail: Callable[[str, int], bool] | None = None,
    poll: float = 0.01,
    stats_out: dict | None = None,
    clock: Callable[[], float] = time.monotonic,
) -> dict[int, Any]:
    """In-process elastic pool: N worker threads drain the coordinator.

    ``fail(worker, shard_id)`` (test hook) makes a worker die mid-shard:
    it stops heartbeating and abandons the shard, which the coordinator
    re-dispatches to the surviving workers.

    Each worker runs a background heartbeat thread so shards that take
    longer than heartbeat_ttl/lease_ttl are not falsely reaped from a
    healthy owner (heartbeats renew lease deadlines).

    ``clock`` feeds the coordinator's lease/heartbeat timing; tests
    inject a virtual clock so ttl expiry is driven deterministically
    instead of racing wall-time margins against host scheduling.
    """
    coord = ShardCoordinator(shards, lease_ttl=lease_ttl,
                             heartbeat_ttl=heartbeat_ttl, clock=clock)
    errors: list[BaseException] = []

    def worker(name: str):
        alive = threading.Event()
        alive.set()

        def beat():
            while alive.is_set():
                coord.heartbeat(name)
                time.sleep(heartbeat_ttl / 3.0)

        hb = threading.Thread(target=beat, daemon=True)
        hb.start()
        try:
            while True:
                got = coord.lease(name)
                if got is None:
                    if coord.done():
                        return
                    time.sleep(poll)
                    continue
                sid, payload = got
                if fail is not None and fail(name, sid):
                    alive.clear()     # dies: heartbeats stop, lease expires
                    return
                coord.complete(name, sid, work_fn(payload))
        except BaseException as e:  # pragma: no cover
            errors.append(e)
        finally:
            alive.clear()

    threads = [threading.Thread(target=worker, args=(f"host{i}",))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if stats_out is not None:
        stats_out.update(coord.stats())
    return coord.results()
