"""TCP transport for the elastic shard coordinator.

The port's copy of ``mgl_tpu/parallel/transport.py`` (the standard library
only), unchanged but for its imports.

parallel/elastic.py's ShardCoordinator is the tested state machine
(lease / heartbeat / complete with heartbeat-driven re-dispatch); this
module gives it a process boundary: a newline-delimited-JSON TCP server
on the coordinator host and a small client + worker loop for the other
hosts.  This is the multi-host failure story SURVEY.md §5 calls for —
the reference's only analogue is the in-process library-load fallback
chain (NativeLibraryLoader.java:51-87).

Protocol (one JSON object per line, persistent connections):

    {"op": "lease",     "worker": w}                -> {"ok": true, "shard": [id, payload] | null}
    {"op": "heartbeat", "worker": w}                -> {"ok": true}
    {"op": "complete",  "worker": w, "shard_id": i,
     "result": r}                                   -> {"ok": true, "committed": bool}
    {"op": "done"}                                  -> {"ok": true, "done": bool}
    {"op": "stats"}                                 -> {"ok": true, "stats": {...}}
    {"op": "results"}                               -> {"ok": true, "results": {id: r}}

Shard payloads and results must be JSON-serializable (work shards are
descriptors — file ranges, batch indices — not bulk data).  Workers that
die (process kill, network drop) simply stop heartbeating; the
coordinator state machine returns their leases to the queue, exactly as
in-process.  Completions are idempotent, so a worker that re-appears can
keep committing.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Callable

from mgl_tpu_torch.parallel.elastic import ShardCoordinator


class CoordinatorServer:
    """Serve a ShardCoordinator over TCP (newline-delimited JSON)."""

    def __init__(self, coord: ShardCoordinator, host: str = "127.0.0.1",
                 port: int = 0):
        self.coord = coord
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        resp = outer._dispatch(json.loads(line))
                    except Exception as e:  # malformed request
                        resp = {"ok": False, "error": str(e)}
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address  # (host, bound_port)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def _dispatch(self, req: dict) -> dict:
        op = req["op"]
        c = self.coord
        if op == "lease":
            got = c.lease(req["worker"])
            return {"ok": True, "shard": list(got) if got else None}
        if op == "heartbeat":
            c.heartbeat(req["worker"])
            return {"ok": True}
        if op == "complete":
            committed = c.complete(req["worker"], int(req["shard_id"]),
                                   req["result"])
            return {"ok": True, "committed": committed}
        if op == "done":
            return {"ok": True, "done": c.done()}
        if op == "stats":
            return {"ok": True, "stats": c.stats()}
        if op == "results":
            return {"ok": True, "results": c.results()}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def start(self) -> tuple[str, int]:
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class CoordinatorClient:
    """Blocking JSON-line client; one persistent connection, reconnect on
    failure (the coordinator is the single source of truth, so a retried
    request is safe — all ops are idempotent)."""

    def __init__(self, address: tuple[str, int], timeout: float = 30.0,
                 retries: int = 3, retry_wait: float = 0.5):
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self.retries = retries
        self.retry_wait = retry_wait
        self._sock: socket.socket | None = None
        self._file = None

    def _connect(self):
        self.close()
        self._sock = socket.create_connection(self.address,
                                              timeout=self.timeout)
        self._file = self._sock.makefile("rwb")

    def _call(self, req: dict) -> dict:
        last: Exception | None = None
        for _ in range(self.retries):
            try:
                if self._file is None:
                    self._connect()
                self._file.write(json.dumps(req).encode() + b"\n")
                self._file.flush()
                line = self._file.readline()
                if not line:
                    raise ConnectionError("coordinator closed connection")
                resp = json.loads(line)
                if not resp.get("ok"):
                    raise RuntimeError(resp.get("error", "request failed"))
                return resp
            except (OSError, ConnectionError, json.JSONDecodeError) as e:
                last = e
                self.close()
                time.sleep(self.retry_wait)
        raise ConnectionError(f"coordinator unreachable: {last}")

    def lease(self, worker: str):
        got = self._call({"op": "lease", "worker": worker})["shard"]
        return (int(got[0]), got[1]) if got else None

    def heartbeat(self, worker: str) -> None:
        self._call({"op": "heartbeat", "worker": worker})

    def complete(self, worker: str, shard_id: int, result: Any) -> bool:
        return self._call({"op": "complete", "worker": worker,
                           "shard_id": shard_id, "result": result})["committed"]

    def done(self) -> bool:
        return self._call({"op": "done"})["done"]

    def stats(self) -> dict:
        return self._call({"op": "stats"})["stats"]

    def results(self) -> dict[int, Any]:
        res = self._call({"op": "results"})["results"]
        return {int(k): v for k, v in res.items()}

    def close(self) -> None:
        for h in (self._file, self._sock):
            try:
                if h is not None:
                    h.close()
            except OSError:
                pass
        self._file = self._sock = None


def run_worker(address: tuple[str, int], work_fn: Callable[[Any], Any],
               worker: str, *, heartbeat_ttl: float = 5.0,
               poll: float = 0.05) -> int:
    """Drain shards from a remote coordinator until everything is done.

    Runs a background heartbeat thread (separate connection) so long
    shards keep their leases.  Returns the number of shards this worker
    committed.
    """
    client = CoordinatorClient(address)
    hb_client = CoordinatorClient(address)
    alive = threading.Event()
    alive.set()

    def beat():
        while alive.is_set():
            try:
                hb_client.heartbeat(worker)
            except ConnectionError:
                return                     # coordinator gone: stop
            time.sleep(heartbeat_ttl / 3.0)

    hb = threading.Thread(target=beat, daemon=True)
    hb.start()
    committed = 0
    try:
        while True:
            got = client.lease(worker)
            if got is None:
                if client.done():
                    return committed
                time.sleep(poll)
                continue
            sid, payload = got
            if client.complete(worker, sid, work_fn(payload)):
                committed += 1
    finally:
        alive.clear()
        client.close()
        hb_client.close()
