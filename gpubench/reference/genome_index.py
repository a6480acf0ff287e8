"""The k-mer index of a whole genome that the plain mapper needs for a
sample of reads, in plain torch.

``mapper.KmerIndex`` holds an int64 value, position and forward bit for
every position of the reference: ~25 GB an array at 3.1 Gbp, more than a
card holds.  ``GenomeIndex`` keeps only the canonical values that the
sampled reads' seeds ask for, and of those every position in the genome:
it scans the joined genome on ``device`` in blocks, works out each
k-mer's canonical value as ``KmerIndex`` does, and keeps the positions
whose value is among the seeds'.  So ``mapper.seed`` finds for each seed
the hits the whole genome has, and drops the same seeds for more than
``max_hits``; ``mapper.map_reads`` takes it in ``KmerIndex``'s place, and
the mapping's semantics are that module's."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.mapper import _CODE, KmerIndex


class GenomeIndex(KmerIndex):
    """``KmerIndex``'s attributes (``k``, ``device``, ``ref``, ``values``,
    ``positions``, ``fwd_bit``) for the canonical values of ``reads``'
    seeds alone, over the whole of ``genome`` (ASCII uint8)."""

    def __init__(self, genome: np.ndarray, k: int, reads: np.ndarray, device,
                 block: int = 1 << 26):
        # no matmul runs here; the flags are set as for every reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.k, self.device = k, device
        self.ref = np.asarray(genome, np.uint8)
        fv, rv, valid, _ = self.seed_values(np.asarray(reads, np.uint8))
        want = torch.from_numpy(np.unique(np.minimum(fv, rv)[valid])).to(
            device)
        lut = torch.from_numpy(_CODE).to(device)
        up = torch.from_numpy(self.ref).to(device)
        n = len(self.ref) - k + 1
        vals, poss, fwds = [], [], []
        for lo in range(0, max(n, 0), block):
            m = min(block, n - lo)
            code = lut[up[lo:lo + m + k - 1].to(torch.int64)]
            fwd = torch.zeros(m, dtype=torch.int64, device=device)
            rev = torch.zeros(m, dtype=torch.int64, device=device)
            bad = torch.zeros(m, dtype=torch.bool, device=device)
            for t in range(k):
                c = code[t:t + m]
                bad |= c > 3
                fwd = fwd * 4 + c.clamp(max=3)
                rev = rev + ((3 - c.clamp(max=3)) << (2 * t))
            canon = torch.minimum(fwd, rev)
            at = torch.searchsorted(want, canon).clamp_(max=len(want) - 1)
            keep = torch.nonzero(~bad & (want[at] == canon))[:, 0] \
                if len(want) else torch.zeros(0, dtype=torch.int64,
                                              device=device)
            vals.append(canon[keep])
            poss.append(keep + lo)
            fwds.append((fwd <= rev)[keep])
        values = torch.cat(vals) if vals else torch.zeros(
            0, dtype=torch.int64, device=device)
        order = torch.argsort(values, stable=True)
        self.values = values[order]
        self.positions = torch.cat(poss)[order] if poss else values.clone()
        self.fwd_bit = torch.cat(fwds)[order] if fwds else values.bool()
