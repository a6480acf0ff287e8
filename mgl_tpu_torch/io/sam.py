"""SAM output writer for mapped/sorted reads.

Completes the align->sort pipeline's output story: coordinate-sorted
records (pipelines/align_sort.py) emit as standard SAM, consumable by
samtools/GATK.  Plain text; BGZF/BAM emission is downstream tooling's job
(the reference library itself emits nothing — GATK owns output — so this
is additive capability).

The port's copy of ``mgl_tpu/io/sam.py``: the same bytes for the same
result, ``program="mgl-tpu"`` in the header included.
"""

from __future__ import annotations

import numpy as np

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10


def sam_header(ref_names: list[str], ref_lengths: list[int],
               program: str = "mgl-tpu") -> str:
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    for name, length in zip(ref_names, ref_lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    lines.append(f"@PG\tID:{program}\tPN:{program}")
    return "\n".join(lines) + "\n"


def sam_record(name: str, flag: int, rname: str, pos0: int, mapq: int,
               cigar: str, seq: bytes, qual: np.ndarray | None) -> str:
    """One alignment line.  ``pos0`` is 0-based (SAM POS is emitted
    1-based); unmapped records use rname '*' / pos 0 per spec."""
    if flag & FLAG_UNMAPPED or pos0 < 0:
        rname, p, cigar, mapq = "*", 0, "*", 0
        flag |= FLAG_UNMAPPED
    else:
        p = pos0 + 1
    q = "*" if qual is None else (np.asarray(qual, np.uint8) + 33
                                  ).tobytes().decode("ascii")
    return (f"{name}\t{flag}\t{rname}\t{p}\t{mapq}\t{cigar}\t*\t0\t0\t"
            f"{bytes(seq).decode('ascii')}\t{q}\n")


def write_sam(path, index, reads: np.ndarray, result: dict,
              ref_name: str = "ref", quals: np.ndarray | None = None,
              names: list[str] | None = None) -> int:
    """Emit a map_reads/align_and_sort result as coordinate-sorted SAM.

    ``result``: dict with pos (window start per read), plus either
    ``order`` (from align_and_sort, coordinate order) and optional
    cigar/offset arrays (map_reads with_cigar=True).  Multi-contig
    indexes emit per-contig @SQ lines and contig-local positions.
    Returns the number of records written.
    """
    n = len(reads)
    cigars = result.get("cigar")
    offsets = result.get("offset")
    # effective alignment start = window start + in-window offset when the
    # aligner pinned it (CIGAR mode or the exact tier); score-only SW
    # verified reads have no pinned offset and emit CIGAR '*' at the
    # seed-estimated position
    pos = np.asarray(result["pos"], np.int64)
    pad = result.get("window_pad", 24)
    if offsets is not None:
        off = np.asarray(offsets, np.int64)
        pinned = off >= 0
        eff = np.where(pos >= 0, pos + np.where(pinned, off, pad), -1)
    else:
        pinned = np.zeros(len(pos), bool)
        eff = np.where(pos >= 0, pos + pad, -1)
    order = result.get("order")
    if order is None:
        # sort by the same effective position emitted as POS (offsets can
        # reorder records within a window; sorting raw window starts would
        # violate the SO:coordinate header)
        order = np.argsort(np.where(eff >= 0, eff,
                                    np.iinfo(np.int64).max), kind="stable")
    contig, local = index.locate(eff)
    if index.contig_names is not None:
        rnames = index.contig_names
        rlens = [int(x) for x in index.contig_lengths]
    else:
        rnames, rlens = [ref_name], [len(index.ref)]
    L = reads.shape[1]
    strand = result.get("strand")
    mapqs = result.get("mapq")
    written = 0
    with open(path, "w") as f:
        f.write(sam_header(rnames, rlens))
        for i in map(int, order):
            pos_out = int(local[i])
            if cigars is not None and pos_out >= 0:
                cig = cigars[i] or "*"
            elif pos_out >= 0 and pinned[i]:
                cig = f"{L}M"            # exact tier: provably all-match
            else:
                cig = "*"                # mapped but CIGAR not computed
            name = names[i] if names is not None else f"read{i}"
            flag = 0 if pos_out >= 0 else FLAG_UNMAPPED
            rev = (pos_out >= 0 and strand is not None
                   and int(strand[i]) == 1)
            if rev:
                flag |= FLAG_REVERSE
            if mapqs is not None:
                mapq = int(mapqs[i]) if pos_out >= 0 else 0
            else:
                mapq = min(60, int(result.get("votes", np.zeros(n))[i]) * 7) \
                    if pos_out >= 0 else 0
            rn = rnames[int(contig[i])] if pos_out >= 0 else "*"
            # SEQ/QUAL in aligned (reference) orientation per SAM spec
            if rev:
                from mgl_tpu_torch.pipelines.mapper import revcomp

                seq = revcomp(reads[i])
                q = None if quals is None else quals[i][::-1]
            else:
                seq = reads[i]
                q = None if quals is None else quals[i]
            f.write(sam_record(name, flag, rn, pos_out, mapq, cig,
                               seq.tobytes(), q))
            written += 1
    return written
