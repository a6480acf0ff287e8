"""The port's command line: ``mgl-map-torch`` (``python -m mgl_tpu_torch.cli``).

Reference FASTA + reads FASTQ -> coordinate-sorted SAM, the port of
``mgl_tpu/cli.py:18 map_main`` (``mgl-map``): index -> two-strand seed ->
exact tier -> SW verify on the card -> coordinate sort -> SAM; with
``--cigar``, real CIGARs (the certified-diagonal tier and the banded
traceback with the device CIGAR walk) instead of score-only verification.
``--device cpu`` runs the kernels' plain versions; the default is the
card, and the command fails without one.

Reads are cut or zero-padded to the modal read length, as ``mgl-map``
does, so the two write the same SAM bytes; a line before the mapping
counts the reads that were cut and padded.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def map_main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="mgl-map-torch")
    ap.add_argument("ref_fa")
    ap.add_argument("reads_fq")
    ap.add_argument("out_sam")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--cigar", action="store_true",
                    help="emit real CIGARs (certified-diagonal tier + "
                         "banded traceback for indel/edge reads) instead "
                         "of score-only verification")
    ap.add_argument("--max-reads", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain torch versions)")
    args = ap.parse_args(argv)

    from mgl_tpu_torch.io.fasta import read_fasta, read_fastq
    from mgl_tpu_torch.io.sam import write_sam
    from mgl_tpu_torch.pipelines.align_sort import align_and_sort
    from mgl_tpu_torch.pipelines.mapper import (ReferenceIndex,
                                                map_reads_stream)

    contigs = list(read_fasta(args.ref_fa).items())
    total_bp = sum(len(s) for _, s in contigs)
    print(f"reference: {len(contigs)} contig(s), {total_bp/1e6:.1f} Mbp",
          flush=True)
    t0 = time.time()
    if len(contigs) == 1:
        index = ReferenceIndex.build(contigs[0][1], k=args.k)
        index.contig_names = [contigs[0][0]]
        index.contig_offsets = np.array([0], np.int64)
        index.contig_lengths = np.array([len(contigs[0][1])], np.int64)
    else:
        index = ReferenceIndex.build_multi(contigs, k=args.k)
    print(f"index built in {time.time()-t0:.1f}s", flush=True)

    names, bases, quals = [], [], []
    for name, b, q in read_fastq(args.reads_fq, max_reads=args.max_reads):
        names.append(name)
        bases.append(b)
        quals.append(q)
    if not names:
        sys.exit("no reads")
    lens = np.array([len(b) for b in bases])
    L = int(np.bincount(lens).argmax())
    reads = np.zeros((len(bases), L), np.uint8)
    qmat = np.zeros((len(bases), L), np.uint8)
    for i, (b, q) in enumerate(zip(bases, quals)):
        m = min(len(b), L)
        reads[i, :m] = b[:m]
        qmat[i, :m] = q[:m]
    print(f"{len(reads)} reads @ {L} bp", flush=True)
    print(f"read length {L} (the most common): {int((lens > L).sum())} "
          f"reads cut to it, {int((lens < L).sum())} zero-padded to it",
          flush=True)

    t0 = time.time()
    if args.cigar:
        res = map_reads_stream(index, reads, with_cigar=True,
                               device=args.device)
    else:
        res = align_and_sort(index, reads, device=args.device)
    dt = time.time() - t0
    mapped = (res["pos"] >= 0).mean()
    print(f"mapped {mapped:.1%} at {len(reads)/dt:.0f} reads/s", flush=True)

    n = write_sam(args.out_sam, index, reads, res, quals=qmat, names=names)
    print(f"wrote {n} records to {args.out_sam}")


if __name__ == "__main__":
    map_main()
