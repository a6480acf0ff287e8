"""Record sort by uint64 keys with an int32 payload, on one device.

The port of ``mgl_tpu/parallel/sort.py``'s one-device path
(``sort_records_single`` :95, with ``split_u64`` and ``join_u64``).  The
JAX package sorts the keys' (hi32, lo32) halves lexicographically with
``jax.lax.sort(num_keys=2)``, an XLA library sort; here the halves are
joined into one int64 key with the sign bit flipped (so signed order is
the unsigned order of the uint64 keys) and ``torch.sort`` orders it on
the device.  The sharded sort across a mesh (``distributed_sort``) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch.device import resolve_device


def split_u64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keys = keys.astype(np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi, np.uint64) << np.uint64(32))
            | np.asarray(lo, np.uint64))


def sort_records_single(keys: np.ndarray, vals: np.ndarray,
                        device: str | torch.device = "cuda"):
    """One-device sort of uint64 keys, lexicographic in their (hi32, lo32)
    halves, carrying an int32 payload.  Returns (sorted_keys uint64,
    sorted_vals int32) on the host.  Stable: records whose keys tie keep
    their input order (``lax.sort`` in the JAX package promises no
    order among ties)."""
    dev = resolve_device(device)
    hi, lo = split_u64(np.asarray(keys))
    # (hi - 2^31) * 2^32 + lo runs over int64 in the order of (hi, lo)
    k = ((torch.from_numpy(hi.astype(np.int64)).to(dev) - 2**31) * 2**32
         + torch.from_numpy(lo.astype(np.int64)).to(dev))
    v = torch.from_numpy(np.ascontiguousarray(vals, np.int32)).to(dev)
    sk, order = torch.sort(k, stable=True)
    sv = v[order]
    # adding 2^63 back modulo 2^64 flips the top bit again
    sk = sk.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
    return sk, sv.cpu().numpy()
