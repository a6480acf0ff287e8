"""Multi-rank dry-run of the sharded pipeline step, with its parity check.

The counterpart of ``__graft_entry__.py:37 dryrun_multichip``: run the
full step (dp x hp mesh: data-parallel reads, hap-parallel likelihood
columns, MAX over hp, the bitonic merge-split sort over dp) over
``n_ranks`` ranks on small shapes, check the sort order and the best hap,
and replay the same global problem on one rank: the likelihood matrix and
the sorted keys must be equal.

On the CPU the ranks are gloo processes; on a host with ``n_ranks`` cards
they are NCCL processes, one a card.  Ranks are never stacked on one card
(NCCL refuses two ranks on one GPU).

    python -m mgl_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that nothing listens on just now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, device: str,
               args: tuple) -> None:
    from mgl_tpu_torch.parallel.launcher import init_runtime

    init_runtime(f"tcp://127.0.0.1:{port}", world, rank, device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device: str, args: tuple = (),
              timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    process group (gloo on ``cpu``, NCCL on ``cuda``: one card a rank).
    ``fn`` must be importable by name.  Raises if a rank fails or the run
    outlasts ``timeout`` seconds; every process is ended either way."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, this "
                           f"host has {torch.cuda.device_count()}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), device,
                                               args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _dryrun_rank(rank: int, n_dp: int, n_hp: int, out_path: str) -> None:
    from mgl_tpu_torch.parallel.launcher import collect_global
    from mgl_tpu_torch.parallel.mesh import AXES, make_mesh
    from mgl_tpu_torch.parallel.pipeline import (make_example_inputs,
                                                 pipeline_step)

    mesh = make_mesh(n_dp, n_hp)
    _, local = make_example_inputs(mesh)
    out = pipeline_step(mesh)(*local)
    got = {k: collect_global(mesh, v, AXES if k == "likelihoods" else ("dp",))
           for k, v in out.items()}
    if rank == 0:
        np.savez(out_path, **got)


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """Run the step over an ``n_ranks`` mesh (2 x hp where n_ranks is even,
    as ``__graft_entry__.py:80``), then check it against a one-rank run of
    the same global problem in this process.  Returns the gathered
    outputs; raises on any disagreement."""
    from mgl_tpu_torch.parallel.mesh import make_mesh
    from mgl_tpu_torch.parallel.pipeline import (make_example_inputs,
                                                 pipeline_step)
    from mgl_tpu_torch.parallel.sort import join_u64

    n_hp = 2 if n_ranks % 2 == 0 else 1
    n_dp = n_ranks // n_hp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.npz")
        run_ranks(_dryrun_rank, n_ranks, device, (n_dp, n_hp, path))
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
    lik, best = got["likelihoods"], got["best_hap_lik"]
    keys = join_u64(got["sorted_key_hi"], got["sorted_key_lo"])
    if not (keys[1:] >= keys[:-1]).all():
        raise AssertionError("sort not ordered")
    if not np.array_equal(best, lik.max(axis=1)):
        raise AssertionError("the hp MAX differs from the block's row maxima")

    # the same global problem on one rank: make_example_inputs is seeded,
    # so equal global R and H give the same arrays
    mesh1 = make_mesh(1, 1, device=device)
    _, local = make_example_inputs(mesh1, r_per_dev=8 * n_dp,
                                   h_per_dev=4 * n_hp)
    one = pipeline_step(mesh1)(*local)
    lik1 = one["likelihoods"].cpu().numpy()
    keys1 = join_u64(one["sorted_key_hi"].cpu().numpy(),
                     one["sorted_key_lo"].cpu().numpy())
    if lik.shape != lik1.shape or not np.array_equal(lik, lik1):
        raise AssertionError(f"{n_ranks}-rank likelihoods differ from one "
                             f"rank's ({lik.shape} vs {lik1.shape})")
    if not np.array_equal(keys, keys1):
        raise AssertionError("sorted keys differ from one rank's")
    print(f"dryrun_multichip({n_ranks}): mesh={n_dp}x{n_hp} device={device} "
          f"lik={lik.shape} sorted={keys.shape} parity_vs_1rank=OK")
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mgl-dryrun-torch")
    p.add_argument("n_ranks", type=int)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
