"""GATK's Smith-Waterman with its CIGAR walk, batched in plain torch.

The semantics of the reference library's ``sw.cpp`` (the aligner behind
GATK's ``SmithWatermanAligner``), cell (i, j) of target row i and query
column j:

* diag = H[i-1][j-1] + (t[i-1] == q[j-1] ? match : mismatch); down = E
  from the row above (a deletion), right = F from the column before (an
  insertion).  The cell takes diag if diag >= down and diag >= right, else
  right if right >= down, else down; there is no clamp at zero.
* E and F open on strictly greater: E = H - open if H - open > E - extend,
  else E - extend, and the run length restarts at 1 or grows by one.
* Row 0 and column 0 are 0, or -open - (n - 1) * extend under INDEL (and
  LEADING_INDEL); E of row 0 and F of column 0 are that less open.
* The best end: over the last column, the largest score, the last row on
  ties; then along the last row, a larger score, or an equal one closer to
  the diagonal.
* The walk from that end (from the corner under INDEL) follows the stored
  moves (a run length for a gap), merges equal moves into CIGAR elements,
  and adds the overhang: a soft clip and the target offset under
  SOFTCLIP, a deletion or insertion and offset 0 under INDEL.

The DP runs over anti-diagonals, every pair of a block at once; ``dtype``
is the precision of the scores (int32 for the reference, int16 or int8
for the control).  The walk runs on the same device, a step for every
pair at once, and the CIGAR strings are put together on the host.
"""

from __future__ import annotations

import numpy as np
import torch

SOFTCLIP = "SOFTCLIP"
INDEL = "INDEL"
NEG = -(2**30)
_STATE = np.array(["M", "I", "D"])


def align(targets: list[np.ndarray], queries: list[np.ndarray],
          params: tuple[int, int, int, int], strategy: str, device,
          dtype: torch.dtype = torch.int32, block: int = 1024
          ) -> tuple[list[tuple[str, int]], np.ndarray]:
    """([(cigar, offset)], best scores) of each (target, query) pair.
    ``params`` = (match, mismatch, gap open, gap extend) with mismatch
    negative and the gap costs positive."""
    if strategy not in (SOFTCLIP, INDEL):
        raise ValueError(f"strategy {strategy!r} is not implemented")
    res: list[tuple[str, int]] = []
    best = np.empty(len(targets), np.int64)
    # one block a length class keeps the padded matrices small
    order = sorted(range(len(targets)),
                   key=lambda k: (len(queries[k]), len(targets[k])))
    for lo in range(0, len(order), block):
        idx = order[lo:lo + block]
        got, sc = _align_block([targets[k] for k in idx],
                               [queries[k] for k in idx], params, strategy,
                               device, dtype)
        res.extend(got)
        best[idx] = sc
    out: list = [None] * len(targets)
    for k, r in zip(order, res):
        out[k] = r
    return out, best


def _pack(seqs: list[np.ndarray], fill: int, device) -> torch.Tensor:
    n = max(len(s) for s in seqs)
    a = np.full((len(seqs), n), fill, np.int64)
    for k, s in enumerate(seqs):
        a[k, :len(s)] = np.asarray(s, np.uint8)
    return torch.from_numpy(a).to(device)


def _edge(n: torch.Tensor, indel: bool, go: int, ge: int, dtype):
    """Row 0 / column 0 score at index n (tensor of ints)."""
    if not indel:
        return torch.zeros_like(n, dtype=dtype)
    v = torch.where(n > 0, -go - (n - 1) * ge, torch.zeros_like(n))
    return v.to(dtype)


def _align_block(targets, queries, params, strategy, device, dtype):
    match, mismatch, go, ge = (int(v) for v in params)
    indel = strategy == INDEL
    B = len(targets)
    tl = torch.tensor([len(t) for t in targets], device=device)
    ql = torch.tensor([len(q) for q in queries], device=device)
    T, Q = int(tl.max()), int(ql.max())
    tgt = _pack(targets, -1, device)
    qry = _pack(queries, -2, device)
    j_idx = torch.arange(Q + 1, device=device)
    # btrack by (diagonal, query column): 0 diag, -L insertion, +L deletion
    bt = torch.zeros((B, T + Q + 1, Q + 1), dtype=torch.int16, device=device)
    lastrow = torch.full((B, Q + 1), NEG, dtype=torch.int64, device=device)
    mqe = torch.full((B,), NEG, dtype=torch.int64, device=device)
    mqe_t = torch.full((B,), -1, dtype=torch.int64, device=device)

    c = lambda v: torch.tensor(v, dtype=dtype, device=device)
    # diagonal 0 holds cell (0, 0), whose score is 0 under every strategy;
    # the rest of diagonals -1 and 0 reaches no inner cell
    sc2 = torch.zeros((B, Q + 1), dtype=dtype, device=device)
    sc1, e1, f1 = sc2.clone(), sc2.clone(), sc2.clone()
    gv1 = torch.ones((B, Q + 1), dtype=torch.int32, device=device)
    gh1 = gv1.clone()
    for d in range(1, T + Q + 1):
        i_idx = d - j_idx                                  # (Q+1,)
        tb = tgt[:, (i_idx - 1).clamp(0, T - 1)]
        qb = qry[:, (j_idx - 1).clamp(min=0)]
        sub = torch.where(tb == qb, c(match), c(mismatch))
        diag = torch.nn.functional.pad(sc2[:, :-1], (1, 0)) + sub
        down, g_down = e1, gv1
        right = torch.nn.functional.pad(f1[:, :-1], (1, 0))
        g_right = torch.nn.functional.pad(gh1[:, :-1], (1, 0))
        take_diag = (diag >= down) & (diag >= right)
        take_right = ~take_diag & (right >= down)
        sc = torch.where(take_diag, diag, torch.where(take_right, right, down))
        move = torch.where(take_diag, torch.zeros_like(g_down),
                           torch.where(take_right, -g_right, g_down))
        open_e = (sc - c(go)) > (down - c(ge))
        e = torch.where(open_e, sc - c(go), down - c(ge))
        gv = torch.where(open_e, torch.ones_like(g_down), g_down + 1)
        open_f = (sc - c(go)) > (right - c(ge))
        f = torch.where(open_f, sc - c(go), right - c(ge))
        gh = torch.where(open_f, torch.ones_like(g_right), g_right + 1)
        sc, e, f, gv, gh = _boundary(d, j_idx, sc, e, f, gv, gh, indel, go,
                                     ge, dtype)
        inside = ((i_idx >= 1) & (j_idx >= 1))[None, :]
        bt[:, d, :] = torch.where(inside, move, torch.zeros_like(move)).to(
            torch.int16)
        # the last column: cell (d - ql, ql)
        i_last = d - ql
        v = sc.gather(1, ql[:, None])[:, 0].long()
        ok = (i_last >= 1) & (i_last <= tl) & (v >= mqe)
        mqe = torch.where(ok, v, mqe)
        mqe_t = torch.where(ok, i_last, mqe_t)
        # the last row: cell (tl, d - tl)
        j_last = d - tl
        okr = (j_last >= 1) & (j_last <= ql)
        jl = j_last.clamp(0, Q)
        cur = lastrow.gather(1, jl[:, None])[:, 0]
        val = sc.gather(1, jl[:, None])[:, 0].long()
        lastrow.scatter_(1, jl[:, None], torch.where(okr, val, cur)[:, None])
        sc2, sc1 = sc1, sc
        e1, f1, gv1, gh1 = e, f, gv, gh
    # along the last row, after the last column's best is known
    best, max_t, max_q = mqe.clone(), mqe_t.clone(), ql.clone()
    seg = torch.zeros_like(ql)
    for j in range(1, Q + 1):
        v = lastrow[:, j]
        closer = (tl - j).abs() < (max_t - max_q).abs()
        take = (j <= ql) & ((v > best) | ((v == best) & closer))
        best = torch.where(take, v, best)
        max_t = torch.where(take, tl, max_t)
        max_q = torch.where(take, torch.full_like(max_q, j), max_q)
        seg = torch.where(take, ql - j, seg)
    return _walk(bt, tl, ql, best, max_t, max_q, seg, strategy), \
        best.cpu().numpy()


def _boundary(d, j_idx, sc, e, f, gv, gh, indel, go, ge, dtype):
    """Diagonal d's row-0 cell (0, d) and column-0 cell (d, 0), set in
    place."""
    edge = _edge(torch.tensor([d], device=sc.device), indel, go, ge, dtype)
    if d <= sc.shape[1] - 1:                   # row 0: cell (0, d)
        sc[:, d] = edge
        e[:, d] = edge - go
        gv[:, d] = 1
    sc[:, 0] = edge                            # column 0: cell (d, 0)
    f[:, 0] = edge - go
    gh[:, 0] = 1
    return sc, e, f, gv, gh


def _walk(bt, tl, ql, best, max_t, max_q, seg, strategy):
    """The CIGAR walk of every pair at once, then the strings."""
    if strategy == INDEL:
        I, J = tl.clone(), ql.clone()
        seg0 = torch.zeros_like(ql)
    else:
        I, J, seg0 = max_t.clone(), max_q.clone(), seg.clone()
    B = len(tl)
    steps_max = int((tl + ql).max()) + 1
    states = torch.full((B, steps_max), -1, dtype=torch.int8,
                        device=bt.device)
    lens = torch.zeros((B, steps_max), dtype=torch.int32, device=bt.device)
    active = torch.ones(B, dtype=torch.bool, device=bt.device)
    rows = torch.arange(B, device=bt.device)
    for s in range(steps_max):
        if not bool(active.any()):
            break
        v = bt[rows, (I + J).clamp(0, bt.shape[1] - 1),
               J.clamp(0, bt.shape[2] - 1)].long()
        st = torch.where(v == 0, 0, torch.where(v < 0, 1, 2))
        ln = torch.where(v == 0, torch.ones_like(v), v.abs())
        states[:, s] = torch.where(active, st, -1).to(torch.int8)
        lens[:, s] = torch.where(active, ln, 0).to(torch.int32)
        dI = torch.where(st == 1, 0, ln)
        dJ = torch.where(st == 2, 0, ln)
        I = torch.where(active, I - dI, I)
        J = torch.where(active, J - dJ, J)
        active = active & (I > 0) & (J > 0)
    states, lens = states.cpu().numpy(), lens.cpu().numpy()
    I, J, seg0 = I.cpu().numpy(), J.cpu().numpy(), seg0.cpu().numpy()
    return [_cigar(states[b], lens[b], int(I[b]), int(J[b]), int(seg0[b]),
                   strategy) for b in range(B)]


def _cigar(states, lens, I, J, seg0, strategy) -> tuple[str, int]:
    n = int((states >= 0).sum())
    st, ln = states[:n].astype(np.int64), lens[:n].astype(np.int64)
    out: list[tuple[str, int]] = []           # in walk order
    seg = seg0
    if seg > 0 and strategy == SOFTCLIP:
        out.append(("S", seg))
        seg = 0
    cut = np.nonzero(np.diff(st))[0] + 1
    starts = np.concatenate([[0], cut])
    g_state = st[starts]
    g_len = np.add.reduceat(ln, starts)
    state = 0
    for gs, gl in zip(g_state, g_len):
        if gs == state:
            seg += int(gl)
        else:
            out.append((_STATE[state], seg))
            seg, state = int(gl), int(gs)
    out.append((_STATE[state], seg))
    if strategy == SOFTCLIP:
        if J > 0:
            out.append(("S", J))
        offset = I
    else:
        if I > 0:
            out.append(("D", I))
        elif J > 0:
            out.append(("I", J))
        offset = 0
    return "".join(f"{n}{s}" for s, n in reversed(out) if n > 0), offset
