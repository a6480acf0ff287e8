"""End-to-end align + global coordinate sort (BASELINE.json config 5).

The port of ``mgl_tpu/pipelines/align_sort.py``: maps a read batch against
a reference (``pipelines/mapper.py``, score mode), builds 64-bit
coordinate keys (contig << 48 | position << 16 | tiebreak), and sorts them
on one device (``parallel/sort.py:sort_records_single``) or across the
ranks of a mesh's dp axis (``parallel/sort.py:sort_records``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.parallel.sort import sort_records, sort_records_single
from mgl_tpu_torch.pipelines.mapper import ReferenceIndex, map_reads


def coordinate_keys(contig: np.ndarray, pos: np.ndarray,
                    tiebreak: np.ndarray) -> np.ndarray:
    """(contig, position, tiebreak) -> uint64 sort keys.  Unmapped reads
    (pos < 0) sort to the end (contig 0xFFFF)."""
    c = np.where(pos >= 0, contig.astype(np.uint64), np.uint64(0xFFFF))
    p = np.where(pos >= 0, pos, 0).astype(np.uint64)
    t = tiebreak.astype(np.uint64) & np.uint64(0xFFFF)
    return (c << np.uint64(48)) | (p << np.uint64(16)) | t


def align_and_sort(index: ReferenceIndex, reads: np.ndarray, mesh=None,
                   device: str | torch.device = "cuda"):
    """Map reads, then emit them in global coordinate order.

    Multi-contig indexes (ReferenceIndex.build_multi) sort by
    (contig, local position); single-contig by position.  Returns dict:
    order (read indices sorted by coordinate), keys (sorted), pos/score
    per read (original order), plus contig/local_pos per read.  Mapping
    runs on ``device``, and so does the sort without a mesh or on a
    one-rank mesh; on a larger ``mesh`` (``parallel/mesh.make_mesh``, every
    rank calling with the same reads) the keys are sorted across its dp
    axis on the mesh's device, and every rank gets the whole result.
    """
    dev = resolve_device(device)
    res = map_reads(index, reads, device=dev)
    n = len(reads)
    # effective alignment start: window start + in-window offset where the
    # exact tier pinned it; otherwise the window centre (the seed's
    # expected start) as the best estimate
    off = res["offset"]
    pad = res["window_pad"]
    eff = np.where(res["pos"] >= 0,
                   res["pos"] + np.where(off >= 0, off, pad),
                   -1)
    contig, local = index.locate(eff)
    res["contig"], res["local_pos"] = contig, local
    keys = coordinate_keys(np.where(contig >= 0, contig, 0),
                           np.where(local >= 0, local, -1),
                           np.arange(n) & 0xFFFF)
    vals = np.arange(n, dtype=np.int32)
    if mesh is not None and mesh.size > 1:
        skeys, order = sort_records(keys, vals, mesh, "dp")
    else:
        skeys, order = sort_records_single(keys, vals, device=dev)
    out = dict(res)
    out.update({"order": order, "keys": skeys})
    return out
