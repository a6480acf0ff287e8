"""The port's kernel wrappers."""

# The warps a block-a-pair kernel aims to put on each SM that holds a
# block (three a scheduler), when it splits a pair's or a read's bands
# across the warps of its block: fewer leave the dependent step's latency
# open, more add ramp time but no instruction slots (the W sweeps of
# chip_smoke.py phase 8, mgl_tpu_torch.time_pairhmm_shared and
# time_pairhmm_banded, PERF.md section 6).  sw_cuda.banded_warps,
# pairhmm_cuda.shared_warps and pairhmm_cuda.pair_warps use it.
WARPS_PER_SM = 12
