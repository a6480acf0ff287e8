"""Multi-process scale-out launcher: transport + checkpoint + pipeline.

The port of ``mgl_tpu/parallel/launcher.py``.  It composes the elastic
coordinator over TCP (``parallel/elastic.py``, ``parallel/transport.py``),
the atomic chunk ledger (``pipelines/checkpoint.py``) and the sharded
step (``parallel/pipeline.py``) into one runtime, in two shapes:

1. **SPMD mode** - every process calls :func:`init_runtime`
   (``torch.distributed.init_process_group``: NCCL between cards, gloo
   between CPU processes), builds its rank of one global mesh
   (``parallel/mesh.make_mesh``) and runs the same ``pipeline_step``; the
   collectives cross the process boundary.  One rank is one process on one
   device.  A failure aborts the step; recovery is restart plus ledger.

2. **Elastic shard mode** - :func:`run_scaleout` (the driver) and N
   :func:`worker_main` processes.  Each worker runs the step on its own
   card (a 1 x 1 mesh), leases chunk descriptors from the TCP coordinator
   and commits results with atomic renames.  A worker that dies stops
   heartbeating, its chunks are dispatched again, and the output is
   bit-identical to a single-process run.  :func:`map_worker_main` does
   the same for the read mapper (BASELINE config 4, data-parallel across
   hosts).

Work travels as descriptors (chunk index ranges); bulk data rides the
shared filesystem (input .npz, one output .npz a chunk).

    python -m mgl_tpu_torch.parallel.launcher worker HOST PORT NAME \\
        WORKLOAD OUT_DIR [--device cuda] [--mesh 1x1]
    python -m mgl_tpu_torch.parallel.launcher map-worker HOST PORT NAME \\
        WORKLOAD OUT_DIR [--cigar] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.parallel.mesh import (AXES, Mesh, all_gather, make_mesh,
                                         shard_host_arrays)
from mgl_tpu_torch.parallel.pipeline import (HAP_KEYS, READ_KEYS, REF_KEYS,
                                             example_arrays, pipeline_step)

OUT_KEYS = ("likelihoods", "best_hap_lik", "sw_scores",
            "sorted_key_hi", "sorted_key_lo")
MAP_OUT_KEYS = ("pos", "score", "strand", "mapq", "offset",
                "pos2", "score2", "votes", "votes2")


def init_runtime(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 device: str | torch.device = "cuda") -> None:
    """Join the process group of a multi-process run: NCCL on ``cuda``
    (this process's card: ``LOCAL_RANK``, else ``process_id`` modulo the
    cards of the host), gloo on ``cpu``.  ``coordinator_address``
    (``host:port`` or ``tcp://host:port``) with the world size and this
    rank, or none of them to read ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment.  Raises where the
    device or the backend is missing; nothing falls back to the other."""
    dev = resolve_device(torch.device(device).type)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("device 'cuda' needs NCCL, which this torch "
                               "build does not have")
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator_address is not None:
        addr = coordinator_address
        if not addr.startswith("tcp://"):
            addr = f"tcp://{addr}"
        kwargs = {"init_method": addr, "world_size": num_processes,
                  "rank": process_id}
    else:
        kwargs = {"init_method": "env://"}
    if backend == "nccl":
        rank = (process_id if process_id is not None
                else int(os.environ["RANK"]))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kwargs)


def collect_global(mesh: Mesh, t: torch.Tensor,
                   axes: tuple[str, ...] = ("dp",)) -> np.ndarray:
    """The global array of a step output on the host of every rank:
    ``t``'s blocks all-gathered along each of ``axes`` (its first dimension
    on 'dp', the second on 'hp'), in index order."""
    for dim, axis in enumerate(AXES):
        if axis in axes:
            t = all_gather(mesh, t, axis, dim=dim)
    return t.cpu().numpy()


def make_chunks(n_reads: int, chunk_size: int) -> list[dict]:
    """Equal-size chunk descriptors.  n_reads must divide evenly; pad the
    workload to a multiple upstream (make_workload does)."""
    if n_reads % chunk_size:
        raise ValueError(f"n_reads={n_reads} not a multiple of "
                         f"chunk_size={chunk_size}")
    return [{"chunk": c, "lo": c * chunk_size, "hi": (c + 1) * chunk_size}
            for c in range(n_reads // chunk_size)]


def make_workload(path: str | os.PathLike, n_reads: int = 64,
                  n_haps: int = 8, read_len: int = 24, hap_len: int = 40,
                  seed: int = 0) -> None:
    """Write a self-contained workload .npz (host arrays, unsharded) that
    workers load and slice per chunk: the JAX package's keys and arrays
    for the same arguments."""
    reads, haps, ref = example_arrays(1, 1, r_per_dev=n_reads,
                                      h_per_dev=n_haps, read_len=read_len,
                                      hap_len=hap_len, seed=seed)
    out = {f"read_{k}": v for k, v in reads.items()}
    out.update({f"hap_{k}": v for k, v in haps.items()})
    out.update({f"ref_{k}": v for k, v in ref.items()})
    np.savez(path, **out)


def load_workload(path: str | os.PathLike):
    with np.load(path) as z:
        reads = {k: z[f"read_{k}"] for k in READ_KEYS}
        haps = {k: z[f"hap_{k}"] for k in HAP_KEYS}
        ref = {k: z[f"ref_{k}"] for k in REF_KEYS}
    return reads, haps, ref


class ChunkRunner:
    """Pipeline executor for equal-size read chunks on one (one-rank or
    global) mesh: every rank calls :meth:`run` with the same chunk and
    gets the chunk's global outputs."""

    def __init__(self, mesh: Mesh, haps: dict, ref: dict):
        self.mesh = mesh
        self.step = pipeline_step(mesh)
        self.haps = shard_host_arrays(mesh, haps, "hp")
        self.ref = ref

    def run(self, reads: dict, lo: int, hi: int) -> dict[str, np.ndarray]:
        sub = {k: np.ascontiguousarray(reads[k][lo:hi]) for k in READ_KEYS}
        out = self.step(shard_host_arrays(self.mesh, sub, "dp"), self.haps,
                        self.ref)
        got = {k: collect_global(self.mesh, out[k],
                                 AXES if k == "likelihoods" else ("dp",))
               for k in OUT_KEYS}
        for k in ("sorted_key_hi", "sorted_key_lo"):
            got[k] = got[k].astype(np.uint32)
        return got


def _wedge(log, name: str, chunk: int) -> None:
    log.warning("%s wedging on chunk %d (test hook)", name, chunk)
    time.sleep(3600)


def worker_main(host: str, port: int, name: str, workload: str,
                out_dir: str, mesh_shape: tuple[int, int] = (1, 1),
                device: str = "cuda", heartbeat_ttl: float = 5.0,
                hang_chunk: int = -1) -> int:
    """Elastic worker process: a mesh of this process (1 x 1 on its own
    card, unless it runs inside a process group), drain chunks, atomic
    commits.

    ``hang_chunk``: test hook - on leasing that chunk the worker wedges
    mid-shard (its heartbeat thread keeps the lease alive) so the harness
    can kill -9 it; only then do heartbeats stop and the lease re-queue.
    """
    from mgl_tpu_torch.parallel.transport import run_worker
    from mgl_tpu_torch.pipelines.checkpoint import save_chunk_atomic
    from mgl_tpu_torch.utils.logging import get_logger

    log = get_logger("launcher")
    mesh = make_mesh(*mesh_shape, device=device)
    reads, haps, ref = load_workload(workload)
    runner = ChunkRunner(mesh, haps, ref)

    def work(payload):
        c = payload["chunk"]
        if c == hang_chunk:
            _wedge(log, name, c)
        save_chunk_atomic(out_dir, c, runner.run(reads, payload["lo"],
                                                 payload["hi"]))
        return c

    n = run_worker((host, port), work, name, heartbeat_ttl=heartbeat_ttl)
    log.info("%s committed %d chunks", name, n)
    return n


def serve_chunks(n_items: int, out_dir: str, chunk_size: int,
                 port: int = 0, lease_ttl: float = 10.0,
                 heartbeat_ttl: float = 5.0, tag: str = "scaleout"):
    """Driver core: serve pending chunk descriptors over TCP until
    workers finish them.

    Returns (server, run, chunks): the caller spawns/points workers at
    ``server.address``, then calls :func:`finish` to wait + assemble.
    Restart-safe: completed chunks (from the ledger OR orphaned chunk
    files of a previous crashed run) are never re-dispatched.
    """
    from mgl_tpu_torch.parallel.elastic import ShardCoordinator
    from mgl_tpu_torch.parallel.transport import CoordinatorServer
    from mgl_tpu_torch.pipelines.checkpoint import CheckpointedRun

    chunks = make_chunks(n_items, chunk_size)
    run = CheckpointedRun(out_dir, len(chunks), tag=tag)
    run.rescan()
    pending = [chunks[c] for c in run.pending_chunks()]
    coord = ShardCoordinator(pending, lease_ttl=lease_ttl,
                             heartbeat_ttl=heartbeat_ttl)
    server = CoordinatorServer(coord, port=port)
    server.start()
    return server, run, chunks


def run_scaleout(workload: str, out_dir: str, chunk_size: int,
                 port: int = 0, lease_ttl: float = 10.0,
                 heartbeat_ttl: float = 5.0, tag: str = "scaleout"):
    """Pipeline (PairHMM + SW + sort) scale-out driver over a
    :func:`make_workload` .npz."""
    reads, _, _ = load_workload(workload)
    return serve_chunks(len(reads["rslen"]), out_dir, chunk_size,
                        port=port, lease_ttl=lease_ttl,
                        heartbeat_ttl=heartbeat_ttl, tag=tag)


def save_map_workload(path: str | os.PathLike, ref: np.ndarray,
                      reads: np.ndarray, k: int = 16) -> None:
    """Mapping workload .npz (BASELINE config 4 across hosts): one
    reference sequence + fixed-length reads.  Workers replicate the
    k-mer index from ``ref`` and lease read-chunk descriptors."""
    np.savez(path, map_ref=np.asarray(ref, np.uint8),
             map_reads=np.asarray(reads, np.uint8), map_k=np.int64(k))


def load_map_workload(path: str | os.PathLike):
    with np.load(path) as z:
        return z["map_ref"], z["map_reads"], int(z["map_k"])


def map_worker_main(host: str, port: int, name: str, workload: str,
                    out_dir: str, with_cigar: bool = False,
                    device: str = "cuda", heartbeat_ttl: float = 5.0,
                    hang_chunk: int = -1) -> int:
    """Elastic mapping worker: build the index once (replicated per
    host), drain read-chunk leases through ``map_reads_stream`` on
    ``device``, commit chunk outputs atomically.  Same failure story as
    :func:`worker_main`.  Logs the index build's and each chunk's time."""
    from mgl_tpu_torch.parallel.transport import run_worker
    from mgl_tpu_torch.pipelines.checkpoint import save_chunk_atomic
    from mgl_tpu_torch.pipelines.mapper import ReferenceIndex, map_reads_stream
    from mgl_tpu_torch.utils.logging import get_logger

    log = get_logger("launcher")
    dev = resolve_device(device)
    ref, reads, k = load_map_workload(workload)
    t0 = time.perf_counter()
    index = ReferenceIndex.build(ref, k=k)
    log.info("%s built the index in %.3f s", name, time.perf_counter() - t0)

    def work(payload):
        c = payload["chunk"]
        if c == hang_chunk:
            _wedge(log, name, c)
        lo, hi = payload["lo"], payload["hi"]
        t0 = time.perf_counter()
        out = map_reads_stream(index, reads[lo:hi], chunk=hi - lo,
                               with_cigar=with_cigar, device=dev)
        arrays = {key: np.asarray(out[key]) for key in MAP_OUT_KEYS}
        if with_cigar:
            arrays["cigar"] = np.array([s.encode() for s in out["cigar"]],
                                       dtype=np.bytes_)
        log.info("%s mapped chunk %d (%d reads) in %.3f s", name, c,
                 hi - lo, time.perf_counter() - t0)
        save_chunk_atomic(out_dir, c, arrays)
        return c

    n = run_worker((host, port), work, name, heartbeat_ttl=heartbeat_ttl)
    log.info("%s committed %d map chunks", name, n)
    return n


def run_scaleout_map(workload: str, out_dir: str, chunk_size: int,
                     port: int = 0, lease_ttl: float = 10.0,
                     heartbeat_ttl: float = 5.0):
    """Mapping scale-out driver over a :func:`save_map_workload` .npz."""
    _, reads, _ = load_map_workload(workload)
    return serve_chunks(len(reads), out_dir, chunk_size, port=port,
                        lease_ttl=lease_ttl, heartbeat_ttl=heartbeat_ttl,
                        tag="scaleout-map")


def assemble_map_output(run) -> dict:
    """Chunk ledger -> global mapping output (chunk-ordered concat; read
    order is the workload order, so this is bit-comparable to a
    single-process ``map_reads_stream`` over the same chunk size)."""
    if not run.complete():
        raise RuntimeError("chunk files missing")
    out = {k: run.assemble(k) for k in MAP_OUT_KEYS}
    if "cigar" in run.load_chunk(0):
        out["cigar"] = np.array([c.decode() for c in run.assemble("cigar")],
                                dtype=object)
    return out


def assemble_output(run) -> dict:
    """Chunk ledger -> global output: chunk-ordered concat of the dense
    arrays plus a global key order from merging the chunk-local sorts
    (hierarchical sort - the same result as one global sort)."""
    if not run.complete():
        raise RuntimeError("chunk files missing")
    out = {k: run.assemble(k) for k in ("likelihoods", "best_hap_lik",
                                        "sw_scores")}
    his, los = [], []
    for c in range(run.n_chunks):
        z = run.load_chunk(c)
        his.append(z["sorted_key_hi"])
        los.append(z["sorted_key_lo"])
    hi = np.concatenate(his).astype(np.uint64)
    lo = np.concatenate(los).astype(np.uint64)
    keys = (hi << np.uint64(32)) | lo
    out["sorted_keys"] = keys[np.argsort(keys, kind="stable")]
    return out


def finish(server, run, poll: float = 0.1, timeout: float = 600.0,
           assemble=None) -> dict:
    """Wait for the coordinator to drain, reconcile the ledger, and
    assemble the global output (``assemble``: :func:`assemble_output`
    for pipeline runs - the default - or :func:`assemble_map_output`)."""
    deadline = time.monotonic() + timeout
    while not server.coord.done():
        if time.monotonic() > deadline:
            raise TimeoutError(f"scale-out stalled: {server.coord.stats()}")
        time.sleep(poll)
    server.stop()
    run.rescan()
    return (assemble or assemble_output)(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mgl-scaleout-torch")
    sub = p.add_subparsers(dest="role", required=True)
    w = sub.add_parser("worker", help="elastic shard worker")
    m = sub.add_parser("map-worker", help="elastic mapping worker")
    for q in (w, m):
        q.add_argument("host")
        q.add_argument("port", type=int)
        q.add_argument("name")
        q.add_argument("workload")
        q.add_argument("out_dir")
        q.add_argument("--device", default="cuda")
        q.add_argument("--heartbeat-ttl", type=float, default=5.0)
        q.add_argument("--hang-chunk", type=int, default=-1)
    w.add_argument("--mesh", default="1x1")
    m.add_argument("--cigar", action="store_true")
    args = p.parse_args(argv)
    if args.role == "worker":
        dp, hp = (int(x) for x in args.mesh.split("x"))
        worker_main(args.host, args.port, args.name, args.workload,
                    args.out_dir, mesh_shape=(dp, hp), device=args.device,
                    heartbeat_ttl=args.heartbeat_ttl,
                    hang_chunk=args.hang_chunk)
    else:
        map_worker_main(args.host, args.port, args.name, args.workload,
                        args.out_dir, with_cigar=args.cigar,
                        device=args.device, heartbeat_ttl=args.heartbeat_ttl,
                        hang_chunk=args.hang_chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
