"""Device time of the mapper's window gather kernel
(``kernels.window_cuda.window_gather``) at one mapper chunk, with a
checksum of what it wrote.

    python -m mgl_tpu_torch.time_window_gather [--label NAME] [--out FILE]

Shape: 131,072 windows of 198 bases (150 bp reads, window pad 24) and
their reads, from a flat word-packed reference of 64 Mbp (8M words of
random ACGT codes) and from the same reference as overlapping rows of
2^27 bases made blocked by hand; starts random from a fixed seed.  The
reads are what ``map_reads_stream`` uploads: one chunk of 131,072 ASCII
reads as they came, random ACGT, and each window a row of them (a
permutation, so every read once) and a strand (half reverse
complemented).  Each is timed by CUDA events: after a warm-up call, three
times the mean of 20 calls; ``ms`` is the median, ``ms_runs`` all three.
The bound is the bytes the gather must move over 3.35 TB/s
(``window_cuda.window_gather_bytes``).  The checksums let two builds with
this interface run one after the other on the same card be held to each
other.  The last line is the report as one JSON object; ``--out`` writes
it to a file too.  Needs one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels.window_cuda import (window_gather,
                                               window_gather_bytes)
from mgl_tpu_torch.testing import cuda_ms

REF_BASES = 64_000_000
N_WINDOWS = 131_072
READ_LEN = 150
WLEN = READ_LEN + 48
BYTES_PER_S = 3.35e12
ROW_BITS = 27
OVERLAP_WORDS = 4096 // 8 + 8


def checksum(*tensors) -> int:
    """A position-weighted sum of every byte, mod 2**61 - 1."""
    total = 0
    for t in tensors:
        flat = t.reshape(-1).long()
        w = torch.arange(1, flat.numel() + 1, device=t.device) % 1_000_003
        total = (total + int((flat * w).sum())) % (2**61 - 1)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_window_gather needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_name()
    rng = np.random.default_rng(0)
    n_words = -(-REF_BASES // 8)
    nib = rng.integers(0, 4, (n_words + OVERLAP_WORDS, 8), dtype=np.uint32)
    words = (nib << (4 * np.arange(8, dtype=np.uint32))).sum(1).astype(
        np.uint32)
    starts = rng.integers(0, REF_BASES - WLEN, N_WINDOWS)
    reads = torch.from_numpy(np.frombuffer(b"ACGT", np.uint8)[rng.integers(
        0, 4, (N_WINDOWS, READ_LEN))]).to(dev)
    read_row = torch.from_numpy(
        rng.permutation(N_WINDOWS).astype(np.int32)).to(dev)
    rc = torch.from_numpy(rng.integers(0, 2, N_WINDOWS, dtype=np.uint8)).to(
        dev)
    flat = torch.from_numpy(words.view(np.int32)).to(dev)
    row_w = 1 << (ROW_BITS - 3)
    n_rows = -(-n_words // row_w)
    padded = np.concatenate([words, np.zeros(row_w, np.uint32)])
    rows = np.stack([padded[r * row_w: r * row_w + row_w + OVERLAP_WORDS]
                     for r in range(n_rows)])
    off = starts & ((1 << ROW_BITS) - 1)
    layouts = {
        "flat": (flat, ((starts >> 3).astype(np.int32),
                        (starts & 7).astype(np.int32))),
        "blocked": (torch.from_numpy(rows.view(np.int32)).to(dev),
                    ((starts >> ROW_BITS).astype(np.int32),
                     (off >> 3).astype(np.int32),
                     (starts & 7).astype(np.int32)))}
    report = {"label": args.label, "card": card, "shapes": []}
    sums = []
    for name, (ref, st) in layouts.items():
        st = tuple(torch.from_numpy(s).to(dev) for s in st)

        def run():
            return window_gather(ref, st, reads, read_row, rc, WLEN,
                                 READ_LEN)

        runs = [cuda_ms(run, 20) for _ in range(3)]
        out = run()
        torch.cuda.synchronize()
        sums.append(checksum(*out))
        bound_ms = window_gather_bytes(N_WINDOWS, WLEN, READ_LEN,
                                       name == "blocked") / BYTES_PER_S * 1e3
        ms = sorted(runs)[1]
        report["shapes"].append({
            "layout": name, "windows": N_WINDOWS, "wlen": WLEN,
            "read_len": READ_LEN, "ms": ms, "ms_runs": runs,
            "bound_ms": bound_ms, "bound_share": bound_ms / ms,
            "checksum": sums[-1]})
        print(f"{args.label} {name}: {N_WINDOWS} windows of {WLEN} + reads "
              f"of {READ_LEN}: {ms:.4f} ms (runs "
              f"{', '.join(f'{r:.4f}' for r in runs)}); bound "
              f"{bound_ms:.4f} ms (bytes), share {bound_ms / ms:.3f}; "
              f"checksum {sums[-1]}; card {card}", flush=True)
    if sums[0] != sums[1]:
        raise AssertionError("flat and blocked layouts gave other bytes")
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
