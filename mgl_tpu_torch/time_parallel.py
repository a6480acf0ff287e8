"""Time the parallel layer across ranks: the sharded sort's bitonic
exchanges and the pipeline step split over a mesh, each held to one
rank's answer.

    python -m mgl_tpu_torch.time_parallel --ranks 4 --device cuda \\
        --out time_parallel.json

Spawns ``--ranks`` processes (``parallel/dryrun.run_ranks``: NCCL ranks,
one a card, on ``cuda``; gloo processes on ``cpu``).  On a (ranks x 1)
mesh it sorts ``--sort-keys`` random uint64 keys (each total split evenly
over the ranks) with ``distributed_sort``: the local sort alone and the
whole network, median of 5 (host clock after a device sync and a
barrier), the result gathered and held to a stable NumPy sort.  On a
(ranks / 2 x 2) mesh it runs the step at ``testing.step_inputs``' shape
(4,096 reads of 151 bp x 12 haps of 420 bp by default), warm median of
5, and this process then runs the same global problem on a one-rank mesh
and requires every gathered output to be bit-equal.  Prints one JSON
object (and writes it to ``--out``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from mgl_tpu_torch.device import card_name

STEP_SHAPE = (4096, 12, 151, 420)


def _clock(device: torch.device) -> float:
    """Host seconds once this rank's device work and every rank are done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    return time.perf_counter()


def _median_s(fn, device: torch.device, runs: int = 5) -> tuple[float, list]:
    fn()
    times = []
    for _ in range(runs):
        t0 = _clock(device)
        fn()
        times.append(_clock(device) - t0)
    return float(np.median(times)), times


def _rank(rank: int, sort_keys: tuple, step_shape: tuple,
          out_path: str) -> None:
    from mgl_tpu_torch.parallel.launcher import collect_global
    from mgl_tpu_torch.parallel.mesh import AXES, make_mesh, shard_host_arrays
    from mgl_tpu_torch.parallel.pipeline import pipeline_step
    from mgl_tpu_torch.parallel.sort import (_sort_records, distributed_sort,
                                             host_key, key_to_host)
    from mgl_tpu_torch.testing import step_inputs

    out = {"sort": [], "step": None}
    world = dist.get_world_size()
    mesh = make_mesh(world, 1)
    dev = mesh.device
    for total in sort_keys:
        per = total // world
        keys = np.random.default_rng(total).integers(
            0, 2**64 - 1, per * world, dtype=np.uint64, endpoint=True)
        k = host_key(keys[rank * per:(rank + 1) * per]).to(dev)
        v = torch.arange(rank * per, (rank + 1) * per, dtype=torch.int32,
                         device=dev)
        sk, sv = distributed_sort(k, v, mesh)
        got_k = collect_global(mesh, sk)
        got_v = collect_global(mesh, sv)
        order = np.argsort(keys, kind="stable") if rank == 0 else None
        if rank == 0 and not (
                np.array_equal(key_to_host(torch.from_numpy(got_k)),
                               keys[order])
                and np.array_equal(got_v, order.astype(np.int32))):
            raise AssertionError(f"distributed_sort != NumPy at {total} keys")
        pos = torch.arange(per, dtype=torch.int64, device=dev)
        local, local_s = _median_s(lambda: _sort_records(
            torch.stack([k, v.to(torch.int64), pos], 1)), dev)
        whole, whole_s = _median_s(lambda: distributed_sort(k, v, mesh), dev)
        out["sort"].append({"keys": per * world, "per_rank": per,
                            "local_ms": local * 1e3, "sort_ms": whole * 1e3,
                            "runs_ms": [t * 1e3 for t in whole_s],
                            "stage_bytes": per * 24})

    n_hp = 2 if world % 2 == 0 else 1
    mesh2 = make_mesh(world // n_hp, n_hp)
    reads, haps, ref = step_inputs(0, *step_shape)
    local = (shard_host_arrays(mesh2, reads, "dp"),
             shard_host_arrays(mesh2, haps, "hp"), ref)
    step = pipeline_step(mesh2)
    med, runs = _median_s(lambda: step(*local), dev)
    got = {k: collect_global(mesh2, t, AXES if k == "likelihoods" else ("dp",))
           for k, t in step(*local).items()}
    out["step"] = {"mesh": [mesh2.n_dp, mesh2.n_hp], "ms": med * 1e3,
                   "runs_ms": [t * 1e3 for t in runs]}
    if rank == 0:
        np.savez(out_path + ".npz", **got)
        with open(out_path, "w") as f:
            json.dump(out, f)


def main(argv=None) -> int:
    from mgl_tpu_torch.parallel.dryrun import run_ranks
    from mgl_tpu_torch.parallel.mesh import make_mesh
    from mgl_tpu_torch.parallel.pipeline import pipeline_step
    from mgl_tpu_torch.testing import step_inputs

    p = argparse.ArgumentParser(prog="mgl-time-parallel")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sort-keys", default="262144,10000000",
                   help="comma-separated totals of keys over all ranks")
    p.add_argument("--step-shape", default=",".join(map(str, STEP_SHAPE)),
                   help="reads,haps,read_len,hap_len of the step")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sort_keys = tuple(int(x) for x in args.sort_keys.split(","))
    shape = tuple(int(x) for x in args.step_shape.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank, args.ranks, args.device, (sort_keys, shape, path),
                  timeout=900)
        with open(path) as f:
            res = json.load(f)
        with np.load(path + ".npz") as z:
            got = {k: z[k] for k in z.files}

    # the same global problem on one rank, in this process
    mesh1 = make_mesh(1, 1, device=args.device)
    reads, haps, ref = step_inputs(0, *shape)
    step = pipeline_step(mesh1)
    one = {k: t.cpu().numpy() for k, t in step(reads, haps, ref).items()}
    for k in one:
        if not np.array_equal(got[k], one[k]):
            raise AssertionError(f"the {res['step']['mesh']} step's {k} != "
                                 f"one rank's")
    dev = mesh1.device
    times = []
    for _ in range(6):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step(reads, haps, ref)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    res["one_rank_step_ms"] = float(np.median(times[1:])) * 1e3
    res["ranks"] = args.ranks
    res["device"] = (card_name() if dev.type == "cuda"
                     else "cpu (gloo; not a device measurement)")
    res["step_shape"] = shape
    res["held"] = ("sorts equal to a stable NumPy sort; the step's outputs "
                   "bit-equal to one rank's")
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
