"""Record sort by uint64 keys with an int32 payload: on one device, and
across the ranks of a mesh axis by a bitonic merge-split.

The port of ``mgl_tpu/parallel/sort.py``.  The JAX package sorts the
keys' (hi32, lo32) halves lexicographically with
``jax.lax.sort(num_keys=2)``, an XLA library sort; here the halves are
joined into one int64 key with the sign bit flipped (so signed order is
the unsigned order of the uint64 keys) and ``torch.sort`` orders it on
the device.

``distributed_sort`` (:62) sorts each rank's shard, then runs the bitonic
network of ``_bitonic_stages`` (:53) over the axis: at each stage a rank
swaps its whole shard with its partner (``dist.batch_isend_irecv``, the
counterpart of ``ppermute``), merges the two and keeps the low or the high
half (``_merge_keep``, :43).  Merge-split comparators preserve sorting
networks, so the block version sorts.  Records carry their global input
position as a last key, so the order is total: the result equals a stable
sort of the shards concatenated in rank order, ties included, and the two
partners of a merge see the same merged sequence (``lax.sort`` in the
JAX package promises no order among ties).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.parallel.mesh import all_gather

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def split_u64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = keys.astype(np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi, np.uint64) << np.uint64(32))
            | np.asarray(lo, np.uint64))


def host_key(keys: np.ndarray) -> torch.Tensor:
    """int64 sort keys of host uint64 keys: the top bit flipped, so that
    (hi - 2^31) * 2^32 + lo runs over int64 in the order of the (hi32,
    lo32) halves."""
    return torch.from_numpy(
        (np.asarray(keys, np.uint64) ^ np.uint64(1 << 63)).view(np.int64))


def split_key(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi32, lo32) halves, as int64 tensors, of :func:`host_key`'s
    keys."""
    return (k >> 32) + 2**31, k & 0xFFFFFFFF


def key_to_host(k: torch.Tensor) -> np.ndarray:
    """uint64 host keys of int64 sort keys."""
    return k.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)


def sort_records_single(keys: np.ndarray, vals: np.ndarray,
                        device: str | torch.device = "cuda"):
    """One-device sort of uint64 keys, lexicographic in their (hi32, lo32)
    halves, carrying an int32 payload.  Returns (sorted_keys uint64,
    sorted_vals int32) on the host.  Stable: records whose keys tie keep
    their input order (``lax.sort`` in the JAX package promises no
    order among ties)."""
    dev = resolve_device(device)
    k = host_key(keys).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(vals, np.int32)).to(dev)
    sk, sv = sort_device(k, v)
    return key_to_host(sk), sv.cpu().numpy()


def sort_device(k: torch.Tensor, v: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of :func:`sort_records_single`: a stable sort of
    :func:`host_key`'s int64 keys ``k`` where they lie, and the payload
    ``v`` gathered into their order."""
    sk, order = torch.sort(k, stable=True)
    return sk, v[order]


def _sort_records(rec: torch.Tensor) -> torch.Tensor:
    """Rows of (key, payload, position) int64 in (key, position) order."""
    by_pos = torch.sort(rec[:, 2], stable=True)[1]
    rec = rec[by_pos]
    return rec[torch.sort(rec[:, 0], stable=True)[1]]


def _merge_keep(mine: torch.Tensor, other: torch.Tensor, is_lower: bool,
                keep_low: bool) -> torch.Tensor:
    """Merge two sorted shards of records and keep the low or high half.
    Both partners concatenate the lower rank's shard first, so they merge
    the same sequence and their halves partition it."""
    n = mine.shape[0]
    both = torch.cat([mine, other] if is_lower else [other, mine])
    merged = _sort_records(both)
    return merged[:n] if keep_low else merged[n:]


def _bitonic_stages(p: int):
    """(partner_xor, ascending_mask_bit) stages of a bitonic sorting
    network over p = 2^k participants."""
    k = p.bit_length() - 1
    for major in range(1, k + 1):
        for minor in range(major - 1, -1, -1):
            yield (1 << minor), (1 << major)


def _exchange(mesh, axis: str, t: torch.Tensor, partner: int) -> torch.Tensor:
    """``t`` sent to and the same-shaped block received from the rank at
    index ``partner`` along ``axis``."""
    got = torch.empty_like(t)
    peer = mesh.global_rank(axis, partner)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer, group),
                                   dist.P2POp(dist.irecv, got, peer, group)])
    for r in reqs:
        r.wait()
    return got


def distributed_sort(keys: torch.Tensor, vals: torch.Tensor, mesh,
                     axis: str = "dp") -> tuple[torch.Tensor, torch.Tensor]:
    """Globally sort (keys, vals) sharded along ``axis``.

    ``keys``: this rank's int64 sort keys (:func:`host_key`), ``vals`` its
    int32 payload, on the mesh's device; every rank of the axis holds the
    same number.  Returns this rank's sorted (keys, vals): rank i of the
    axis holds the i-th contiguous slice of the global order, which is a
    stable sort of the shards in rank order."""
    p = mesh.shape[axis]
    if p & (p - 1):
        raise ValueError("device count on sort axis must be a power of two")
    idx = mesh.index(axis)
    n = keys.shape[0]
    pos = idx * n + torch.arange(n, dtype=torch.int64, device=keys.device)
    rec = _sort_records(torch.stack([keys, vals.to(torch.int64), pos], 1))
    for partner_xor, major_bit in _bitonic_stages(p):
        ascending = (idx & major_bit) == 0
        is_lower = (idx & partner_xor) == 0
        other = _exchange(mesh, axis, rec, idx ^ partner_xor)
        rec = _merge_keep(rec, other, is_lower, is_lower == ascending)
    return rec[:, 0].contiguous(), rec[:, 1].to(torch.int32)


def sort_records(keys: np.ndarray, vals: np.ndarray, mesh, axis: str = "dp"):
    """Host convenience on every rank: pad to equal shards with the
    all-ones key, sort this rank's shard across ``axis``, gather the
    global order and strip the padding (which sorts after every real key,
    the all-ones key included).  Returns (sorted_keys uint64,
    sorted_vals int32)."""
    p = mesh.shape[axis]
    n = len(keys)
    per = -(-n // p)
    kp = np.full(per * p, SENTINEL, dtype=np.uint64)
    vp = np.zeros(per * p, dtype=np.int32)
    kp[:n] = keys
    vp[:n] = vals
    i = mesh.index(axis)
    lo, hi = i * per, (i + 1) * per
    sk, sv = distributed_sort(host_key(kp[lo:hi]).to(mesh.device),
                              torch.from_numpy(vp[lo:hi]).to(mesh.device),
                              mesh, axis)
    sk = all_gather(mesh, sk, axis)
    sv = all_gather(mesh, sv, axis)
    return key_to_host(sk)[:n], sv.cpu().numpy()[:n]
