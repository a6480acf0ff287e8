"""mgl_tpu_torch's plane PairHMM kernel (``csrc/pairhmm_plane.cu``): a
pair's bands pipelined on the warps of a block, R read rows a lane.

On the CPU, where the kernel cannot run: a plain torch emulation of the
kernel's schedule - lanes x sub-rows x steps, the sub-row handoff in
registers, lane 0 taking the carry row from slots staged a 32-step chunk
ahead, lane 31's last sub-row writing the one carry row that crosses the
bands, rows at or past the planes' end reading 0 - bit-equal to the plain
version ``ops.pairhmm.forward_plain`` at the edges of a band (reads of 1
to 151 bases against haps of 1, 2, 33 and 420) and on a read of 300
bases (five bands at R = 2) against a hap shorter than a band's ramp;
the rule that picks R and W (``plane_layout``); and the refusal of a bad
forced R or W.  Small shapes and one thread.

On the card (``cuda``): every R and W bit-equal to the plain version with
the carry row in shared memory, on a 30 kb hap (the row in global
memory), and on reads of 8,000 bases against haps of 9,000, which the
kernel's first design refused.  ``python -m pytest
tests/test_torch_plane_pairhmm.py -m cuda``.
"""

import pytest
import torch

from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import forward_plain, normalize
from mgl_tpu_torch.tables import CTX_F32
from mgl_tpu_torch.testing import long_read_pairs, pair_edge_set

torch.set_num_threads(1)
H100_SMS = 132
LANES = 32


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def emulate_plane_kernel(planes, rchar, rslen, haps, haplen, y_init, ridx,
                         hidx, R: int) -> torch.Tensor:
    """The plane kernel's schedule in plain torch, over every pair at once:
    (B,) float32 scores.  Bands run one after another through one carry
    row, as at W = 1; the kernel's extra warps only overlap them.  Each
    pair runs the most bands and steps of any pair: the extra bands hold
    no last row, and the extra steps of a band write no slot and sum no
    cell, as the kernel's own steps past a hap's end do not."""
    p = planes[ridx]
    B, _, rows = p.shape
    H = haps.shape[1]
    rc = rchar[ridx]
    hp = haps[hidx]
    rl = torch.clamp(rslen[ridx].long(), max=rows - 2)[:, None, None]
    hl = torch.clamp(haplen[hidx].long(), max=H)
    hl3 = hl[:, None, None]
    u0 = y_init[hidx] * p[:, 1, 1]
    band = LANES * R
    v = torch.arange(band).view(LANES, R)      # R*s + j: lane s, sub-row j
    zero = torch.zeros((B, LANES, R), dtype=torch.float32)
    row = torch.zeros((B, H, 2), dtype=torch.float32)   # slot s: column s+1
    acc = torch.zeros((B,), dtype=torch.float32)
    n_bands = int(-(-int(rl.max()) // band))
    n_steps = int(hl.max()) + band - 1
    slot_of_lane = torch.arange(LANES)
    pair = torch.arange(B)

    def at(k, r):
        """plane k (or the read bases, k None) at rows r, 0 at or past the
        planes' end"""
        src = rc if k is None else p[:, k, :]
        got = src[:, torch.clamp(r, max=rows - 1)]
        return torch.where(r < rows, got, torch.zeros_like(got))

    for b in range(n_bands):
        top = b == 0
        r = b * band + v + 1
        pmm_u, pgapm_u, pmx_u, pzz_u = (at(k, r + 1) for k in (0, 1, 2, 4))
        pmy, pzz, dm, dmm = (at(k, r) for k in (3, 4, 5, 6))
        rch = at(None, r)

        def stage(chunk):
            """(U, W, hap base) of slot 32*chunk + 1 + lane, a lane each"""
            s = LANES * chunk + 1 + slot_of_lane
            inside = s[None, :] < hl[:, None]
            if top:
                uw = torch.stack([u0[:, None].expand(B, LANES),
                                  torch.zeros((B, LANES))], dim=2)
            else:
                got = row[:, torch.clamp(s, max=H - 1)]
                uw = torch.where(inside[:, :, None], got, torch.zeros_like(got))
            h = torch.where(inside, hp[:, torch.clamp(s, max=H - 1)], 0)
            return uw, h

        cur, nxt = stage(0), stage(1)
        m_un, y_un, w_p, u_p, u_pp = (zero.clone() for _ in range(5))
        hd = torch.zeros((B, LANES, R), dtype=torch.int32)
        first = stage(-1)[0][:, LANES - 1]         # slot 0
        u_p[:, 0, 0], w_p[:, 0, 0] = first[:, 0], first[:, 1]
        u_pp[:, 0, 0] = u0 if top else 0.0
        hd[:, 0, 0] = hp[:, 0]
        for t in range(n_steps):
            distm = torch.where((rch & hd) != 0, dm, dmm)
            m = distm * u_pp
            x = w_p
            y = m_un * pmy + y_un * pzz
            c = t + 1 - v
            last = (r == rl) & (c >= 1) & (c <= hl3)
            acc = acc + torch.where(last, m + x, zero).sum(dim=(1, 2))
            u = m * pmm_u + (x + y) * pgapm_u
            w = m * pmx_u + x * pzz_u
            m_un, y_un = m, y
            slot = t - (band - 1)
            if slot >= 0:                          # lane 31, sub-row R-1
                live = slot < hl
                row[pair[live], slot, 0] = u[live, -1, -1]
                row[pair[live], slot, 1] = w[live, -1, -1]
            # every (lane, sub-row) takes the one before it; lane 0's first
            # sub-row takes the staged slot t + 1 from lane t & 31
            uw_in, h_in = cur[0][:, t & 31], cur[1][:, t & 31]
            u_pp = u_p
            u_p = torch.cat([uw_in[:, 0:1], u.reshape(B, -1)[:, :-1]],
                            dim=1).view(B, LANES, R)
            w_p = torch.cat([uw_in[:, 1:2], w.reshape(B, -1)[:, :-1]],
                            dim=1).view(B, LANES, R)
            hd = torch.cat([h_in[:, None], hd.reshape(B, -1)[:, :-1]],
                           dim=1).view(B, LANES, R)
            if (t + 1) % LANES == 0:               # a chunk's end
                cur = nxt
                if t + 1 + LANES < n_steps:
                    nxt = stage((t + 1) // LANES + 1)
    return acc


def _staged(read_lens, hap_lens, seed=3):
    reads, haps, pairs = pair_edge_set(seed, read_lens, hap_lens)
    return ph.stage_pairs(*normalize(reads, haps), pairs, CTX_F32, "cpu")


@pytest.mark.parametrize("R", ph.PLANE_ROWS_PER_LANE)
def test_schedule_equals_plain_at_band_edges(R):
    """Reads of 1 to 151 bases (the edges of 64- and 128-row bands)
    against haps of 1, 2, 33 and 420 bases: the schedule's scores equal
    the plain forward's bit for bit.  The planes have 162 rows, so at
    R = 4 the second band's rows from 162 on read 0.  (Long reads
    underflow f32 against a hap of 1, 2 or 33 and score 0 in both; more
    than half of the pairs score above 0.)"""
    args = _staged((1, 63, 64, 65, 127, 128, 129, 151), (1, 2, 33, 420))
    assert args[0].shape[-1] == 162
    got = emulate_plane_kernel(*args, R)
    want = forward_plain(*args)
    assert (want > 0).sum() > len(want) // 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", ph.PLANE_ROWS_PER_LANE)
def test_schedule_equals_plain_across_many_bands(R):
    """A read of 300 bases (five bands at R = 2, three at R = 4, so the
    carry row crosses four or two band boundaries) against a 33-base hap,
    shorter than a band's ramp of 32R - 1 steps (no steady step), and
    against a 420-base one: bit-equal to the plain forward."""
    args = _staged((300, 299), (33, 420), seed=5)
    assert ph.plane_bands(args[0].shape[-1], R) == {2: 5, 4: 3}[R]
    assert torch.equal(emulate_plane_kernel(*args, R), forward_plain(*args))


@pytest.mark.parametrize("n_pairs, read_len, sm_count, want", [
    (6144, 151, H100_SMS, (2, 1)),    # the plane path's region product
    (384, 151, H100_SMS, (2, 3)),     # a 32 x 12 region: 3 bands of 64
    (24, 250, H100_SMS, (2, 4)),      # 250 bp against a long hap
    (6144, 256, H100_SMS, (2, 1)),    # the longest read at R = 2
    (6144, 257, H100_SMS, (4, 1)),    # 3 bands of 128 rows
    (512, 60, H100_SMS, (2, 1)),      # one band at either R
    (512, 1000, H100_SMS, (4, 4)),    # 8 bands of 128 rows
    (4, 8000, H100_SMS, (4, 13)),     # 63 bands: 5 rounds of 13 warps
    (4, 1100, 8, (4, 9)),             # 9 bands on a small card
])
def test_plane_layout_rule(n_pairs, read_len, sm_count, want):
    """R is 2 for reads of up to PLANE_R2_ROWS rows and 4 beyond; W is the
    pipelined kernels' rule over that R's bands: at most the bands and
    BANDED_WARPS_MAX, the fewest warps for its rounds.  A forced R keeps
    the rule's W for that R."""
    rows = -(-read_len // 32) * 32 + 2
    R, W = ph.plane_layout(n_pairs, rows, sm_count)
    assert (R, W) == want
    assert R == (2 if rows - 2 <= ph.PLANE_R2_ROWS else 4)
    n_bands = ph.plane_bands(rows, R)
    assert 1 <= W <= min(n_bands, ph.BANDED_WARPS_MAX)
    rounds = -(-n_bands // W)
    assert -(-n_bands // rounds) == W
    for r in ph.PLANE_ROWS_PER_LANE:
        assert ph.plane_layout(n_pairs, rows, sm_count, r) == (
            r, ph._pipeline_warps(n_pairs, ph.plane_bands(rows, r), sm_count,
                                  ph.BANDED_WARPS_MAX))


@pytest.mark.parametrize("kw", [
    dict(rows_per_lane=1), dict(rows_per_lane=3), dict(rows_per_lane=8),
    dict(warps_per_pair=0), dict(warps_per_pair=ph.BANDED_WARPS_MAX + 1),
    dict(warps_per_pair=2.0),
])
def test_forced_r_or_w_out_of_range_is_refused(kw):
    """Forcing an R the kernel has no instance of, or a W it does not
    take, raises before anything runs, on CPU tensors too; a good forced
    R and W run the plain version there."""
    args = _staged((10, 40), (30,))
    with pytest.raises(ValueError, match=next(iter(kw))):
        ph.pairhmm_plane_f32(*args, **kw)
    before = ph.pairhmm_plane_f32.launches
    got = ph.pairhmm_plane_f32(*args, warps_per_pair=3, rows_per_lane=4)
    assert torch.equal(got, forward_plain(*args))
    assert ph.pairhmm_plane_f32.launches == before


def _every_layout(args):
    want = forward_plain(*args)
    got = ph.pairhmm_plane_f32(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "the wrapper's layout"
    for R in ph.PLANE_ROWS_PER_LANE:
        for w in range(1, ph.BANDED_WARPS_MAX + 1):
            got = ph.pairhmm_plane_f32(*args, warps_per_pair=w,
                                       rows_per_lane=R)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (R, w)


@pytest.mark.cuda
def test_every_r_and_w_matches_plain(cuda):
    """Every R and every W from 1 to BANDED_WARPS_MAX (and the wrapper's
    choice) give the plain version's bits on reads of 1 to 1,100 bases
    (up to 9 bands of 128 rows, so reads wrap over the warps) against
    haps of 1 to 2,000, with the carry row in shared memory."""
    reads, haps, pairs = pair_edge_set(
        3, (1, 63, 64, 65, 127, 128, 129, 151, 300, 1100), (1, 33, 420, 2000))
    args = ph.stage_pairs(*normalize(reads, haps), pairs, CTX_F32, cuda)
    for R in ph.PLANE_ROWS_PER_LANE:
        for w in range(1, ph.BANDED_WARPS_MAX + 1):
            assert ph.plane_carry_in_shared(len(pairs), args[3].shape[1], w,
                                            R, cuda)
    _every_layout(args)


@pytest.mark.cuda
def test_global_carry_row_matches_plain(cuda):
    """A 30 kb hap has a carry row (240 KB) too large for a block's shared
    memory: the launcher puts it in global memory, and every R and W
    still gives the plain version's bits."""
    reads, haps, pairs = pair_edge_set(4, (1, 65, 151, 700), (30_000,))
    args = ph.stage_pairs(*normalize(reads, haps), pairs, CTX_F32, cuda)
    for R in ph.PLANE_ROWS_PER_LANE:
        assert ph.plane_carry_in_shared(384, 420, 3, R, cuda)
        for w in range(1, ph.BANDED_WARPS_MAX + 1):
            assert not ph.plane_carry_in_shared(len(pairs), args[3].shape[1],
                                                w, R, cuda)
    _every_layout(args)


@pytest.mark.cuda
def test_reads_past_the_old_limit_match_plain(cuda):
    """Reads of 8,000 and 7,990 bases against haps of 9,000 (planes of
    8,002 rows, past the 6,434 the kernel's first design held in shared
    memory), at Q45 so that their f32 scores stay far above 0: the
    wrapper's layout and both R at 16 warps equal the plain version."""
    reads, haps, pairs = long_read_pairs(6, (8000, 7990), 9000)
    args = ph.stage_pairs(*normalize(reads, haps), pairs, CTX_F32, cuda)
    assert args[0].shape[-1] == 8002
    want = forward_plain(*args)
    assert (want > 0).all()
    for kw in ({}, *(dict(rows_per_lane=R, warps_per_pair=16)
                     for R in ph.PLANE_ROWS_PER_LANE)):
        got = ph.pairhmm_plane_f32(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kw
