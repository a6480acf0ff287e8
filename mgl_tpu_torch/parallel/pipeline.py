"""Sharded end-to-end pipeline step over a ('dp', 'hp') mesh of ranks.

The port of ``mgl_tpu/parallel/pipeline.py`` (``pipeline_step`` :173,
``make_example_inputs`` :247):

* reads are data-parallel along 'dp' (each rank owns a read shard);
* haplotypes are split along 'hp' (each rank owns a hap shard and computes
  its block of the likelihood matrix);
* the best haplotype of each read is an all-reduce (MAX) over 'hp';
* the globally ordered keys come from the bitonic merge-split over 'dp'
  (``parallel/sort.py:distributed_sort``).

Each rank calls the step on its own shards, with the SPMD semantics of
the JAX package's ``shard_map``.  The per-rank compute is the port's
kernels: the likelihood block is ``pairhmm_banded_f32``
(``csrc/pairhmm_banded.cu``, the counterpart of ``_pairhmm_block_pallas``
:56) over the block's product, and the SW scores are ``sw_banded`` in
score-only mode (``csrc/sw_banded.cu``, the counterpart of
``_sw_block_pallas`` :106).  The mesh's device chooses the route, as the
JAX package's ``impl=`` does: ``cuda`` runs the kernels, ``cpu`` their
plain versions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mgl_tpu_torch.core.context import CTX_F32, read_transition_rows
from mgl_tpu_torch.core.params import STANDARD_NGS, SWParameters
from mgl_tpu_torch.kernels.pairhmm_cuda import pairhmm_banded_f32
from mgl_tpu_torch.kernels.sw_cuda import sw_banded
from mgl_tpu_torch.ops.pairhmm import BAND, N_PLANES
from mgl_tpu_torch.parallel.mesh import Mesh, shard_host_arrays
from mgl_tpu_torch.parallel.sort import (distributed_sort, host_key,
                                         join_u64, split_key, split_u64)
from mgl_tpu_torch.tables import BASE_ENC

READ_KEYS = ("rchar", "rslen", "trans", "query", "qlen", "key_hi", "key_lo")
HAP_KEYS = ("hap", "haplen", "y_init")
REF_KEYS = ("target", "tlen")


def _tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device
            ) -> torch.Tensor:
    """A host array as ``dtype`` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def likelihood_planes(rchar: torch.Tensor, rslen: torch.Tensor,
                      trans: torch.Tensor, enc: torch.Tensor):
    """The per-pair kernel's read inputs from the pipeline's arrays:
    (planes (r, 7, 32k+2) float32, rchar (r, 32k+2) int32 one-hot).

    ``trans`` (r, 7, rows) holds row r of the matrix at index r, as
    ``read_transition_rows`` builds it, and ``rchar`` (r, rows) ASCII bases
    from column 1.  The kernel's planes hold matrix row r at index r too,
    with 32k + 2 rows, and rows 0 and past each read zero (row 0 of the
    matrix is the boundary, which the recurrence never reads: ``trans[:, 5,
    0]`` is 1 - 0 there).  So the planes are ``trans`` itself, padded,
    masked to rows 1 .. rslen; the kernel's Y seed on row 0 is the hap's
    ``y_init``, as in ``pairhmm_forward_f32``."""
    r_l, rows_in = rchar.shape
    rows = -(-(rows_in - 1) // BAND) * BAND + 2
    row = torch.arange(rows, device=rchar.device)
    live = (row[None, :] >= 1) & (row[None, :] <= rslen[:, None])
    planes = torch.zeros((r_l, N_PLANES, rows), dtype=torch.float32,
                         device=rchar.device)
    planes[:, :, :rows_in] = trans
    planes = torch.where(live[:, None, :], planes, torch.zeros_like(planes))
    rc = torch.zeros((r_l, rows), dtype=torch.int32, device=rchar.device)
    rc[:, :rows_in] = enc[rchar.long()]
    return planes, torch.where(live, rc, torch.zeros_like(rc))


def pairhmm_block(rchar, rslen, trans, y_init, hap, haplen, enc):
    """The (r_l, h_l) likelihood block, 2^120-scaled float32, through
    ``pairhmm_banded_f32`` over every (read, hap) pair of the block, with
    ``ridx``/``hidx`` as ``_pairhmm_block_pallas`` lays its lanes out."""
    r_l, h_l = rchar.shape[0], hap.shape[0]
    planes, rc = likelihood_planes(rchar, rslen, trans, enc)
    pair = torch.arange(r_l * h_l, device=rchar.device)
    score = pairhmm_banded_f32(planes, rc, rslen, enc[hap.long()], haplen,
                               y_init, pair // h_l, pair % h_l)
    return score.reshape(r_l, h_l)


def sw_block(target, tlen, query, qlen, params: SWParameters):
    """Best SW score of each read against the replicated reference window:
    ``sw_banded`` in score-only mode with the window expanded to every
    read, its ScoreMax ``max`` row (``ez[2]``, the overall best)."""
    r_l = query.shape[0]
    tgt = target.to(torch.uint8).expand(r_l, -1).contiguous()
    ez, _ = sw_banded(tgt, query.to(torch.uint8).contiguous(),
                      tlen.expand(r_l).contiguous(), qlen,
                      params.match, params.mismatch, params.gap_open,
                      params.gap_extend, indel_init=False,
                      with_traceback=False)
    return ez[2]


def pipeline_step(mesh: Mesh, sw_params: SWParameters | None = None):
    """The step for this rank of ``mesh``.

    ``sw_params``: the verify stage's SWParameters (the kernel's sign
    convention, as in ``pipelines/mapper.py``); defaults to the GATK NGS
    set (25, -50, 110, 6).

    Returns fn(reads, haps, ref_window) -> dict of this rank's outputs,
    tensors on the mesh's device; each rank passes its own shards as host
    arrays:
      reads: this rank's dp shard: rchar (r_l, rows) i32 ASCII from column
        1, rslen (r_l,) i32, trans (r_l, 7, rows) f32, query (r_l, Q) i32,
        qlen (r_l,) i32, key_hi / key_lo (r_l,) uint32 halves of the keys
      haps: this rank's hp shard: hap (h_l, L) i32 ASCII, haplen (h_l,)
        i32, y_init (h_l,) f32
      ref_window (replicated): target (1, T) i32, tlen (1,) i32
    Outputs: likelihoods (r_l, h_l) f32, this rank's block; best_hap_lik
    (r_l,) f32; sw_scores (r_l,) i32; sorted_key_hi / sorted_key_lo (r_l,)
    int64 holding the uint32 halves and sorted_order (r_l,) i32 (the
    global read index), this rank's slice of the global key order."""
    params = sw_params or STANDARD_NGS
    dev = mesh.device
    enc = torch.from_numpy(BASE_ENC.copy()).to(dev)
    i32, f32, i64 = torch.int32, torch.float32, torch.int64

    def step(reads: dict, haps: dict, ref_window: dict) -> dict:
        rchar = _tensor(reads["rchar"], i32, dev)
        rslen = _tensor(reads["rslen"], i32, dev)
        query = _tensor(reads["query"], i32, dev)
        qlen = _tensor(reads["qlen"], i32, dev)
        # 1. the likelihood block (a dp x hp block of the R x H matrix)
        lik = pairhmm_block(rchar, rslen, _tensor(reads["trans"], f32, dev),
                            _tensor(haps["y_init"], f32, dev),
                            _tensor(haps["hap"], i32, dev),
                            _tensor(haps["haplen"], i32, dev), enc)
        # 2. the best hap of each read across the hp axis
        best = lik.max(dim=1).values
        if mesh.n_hp > 1:
            dist.all_reduce(best, op=dist.ReduceOp.MAX,
                            group=mesh.group("hp"))
        # 3. the SW score of each read against the window (dp-local)
        sw = sw_block(_tensor(ref_window["target"], i32, dev)[0],
                      _tensor(ref_window["tlen"], i32, dev), query, qlen,
                      params)
        # 4. the global sort of the read keys over dp; every hp column
        # sorts the same keys and must agree
        r_l = query.shape[0]
        order = (mesh.index("dp") * r_l
                 + torch.arange(r_l, dtype=i32, device=dev))
        skey, sorder = distributed_sort(
            host_key(join_u64(reads["key_hi"], reads["key_lo"])).to(dev),
            order, mesh, "dp")
        if mesh.n_hp > 1:
            rec = torch.stack([skey, sorder.to(i64)])
            lo, hi = rec.clone(), rec.clone()
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group("hp"))
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group("hp"))
            if not torch.equal(lo, hi):
                raise RuntimeError("the hp columns of the mesh sorted "
                                   "different keys")
        khi, klo = split_key(skey)
        return {"likelihoods": lik, "best_hap_lik": best, "sw_scores": sw,
                "sorted_key_hi": khi, "sorted_key_lo": klo,
                "sorted_order": sorder}

    return step


def example_arrays(n_dp: int, n_hp: int, r_per_dev: int = 8,
                   h_per_dev: int = 4, read_len: int = 24, hap_len: int = 40,
                   seed: int = 0):
    """The global host arrays (reads, haps, ref_window) of
    :func:`make_example_inputs` for an n_dp x n_hp mesh: byte for byte the
    JAX package's for the same arguments."""
    R = r_per_dev * n_dp
    H = h_per_dev * n_hp
    rows = read_len + 1
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(R, read_len))
    quals = rng.integers(20, 50, size=(R, read_len)).astype(np.uint8)
    gcp = np.full((R, read_len), 10, np.uint8)

    trans = np.zeros((R, 7, rows), np.float32)
    one = np.float32(1.0)
    third = np.float32(1.0) / np.float32(3.0)
    for r in range(R):
        t = read_transition_rows(quals[r], quals[r], quals[r], gcp[r], CTX_F32)
        distm = t[5]
        for k in range(5):
            trans[r, k] = t[k]
        trans[r, 5] = (one - distm).astype(np.float32)
        trans[r, 6] = (distm * third).astype(np.float32)

    rchar = np.zeros((R, rows), np.int32)
    rchar[:, 1:] = bases
    haps = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=(H, hap_len)).astype(np.int32)
    keys = rng.integers(0, 2**62, size=R).astype(np.uint64)
    key_hi, key_lo = split_u64(keys)
    reads = {
        "rchar": rchar,
        "rslen": np.full(R, read_len, np.int32),
        "trans": trans,
        "query": bases.astype(np.int32),
        "qlen": np.full(R, read_len, np.int32),
        "key_hi": key_hi,
        "key_lo": key_lo,
    }
    hap_d = {
        "hap": haps,
        "haplen": np.full(H, hap_len, np.int32),
        "y_init": (np.float32(CTX_F32.initial_constant) / np.float32(hap_len)
                   ) * np.ones(H, np.float32),
    }
    ref_window = {
        "target": rng.choice(np.frombuffer(b"ACGT", np.uint8),
                             size=(1, 64)).astype(np.int32),
        "tlen": np.full(1, 64, np.int32),
    }
    return reads, hap_d, ref_window


def make_example_inputs(mesh: Mesh, r_per_dev: int = 8, h_per_dev: int = 4,
                        read_len: int = 24, hap_len: int = 40, seed: int = 0):
    """Small inputs for dry-runs and tests: ((reads, haps, ref_window) as
    global host arrays, equal to the JAX package's, and the same three
    dicts as this rank's shards, the step's arguments)."""
    full = example_arrays(mesh.n_dp, mesh.n_hp, r_per_dev, h_per_dev,
                          read_len, hap_len, seed)
    reads, haps, ref = full
    return full, (shard_host_arrays(mesh, reads, "dp"),
                  shard_host_arrays(mesh, haps, "hp"), ref)
