"""Share (%) of the f32 PairHMM pass's least time in its kernels' device
time: the larger of the needed flops over the f32 peak and the needed
bytes over HBM bandwidth (``counts.work.pairhmm_f32``, every region of
the window), over the device time of every f32 PairHMM kernel (the
shared-hap-set kernel and the per-pair kernel's float instance)."""

from gpubench.counts import peaks
from gpubench.trace import kernel_seconds


def read(ctx):
    red, w = ctx["trace"], ctx["work"]
    t = [kernel_seconds(red, "pairhmm_shared_kernel"),
         kernel_seconds(red, "pairhmm_banded_kernel<float")]
    t = sum(v for v in t if v is not None)
    if not t or not w.get("f32_flops"):
        return None
    need = max(w["f32_flops"] / peaks.F32_FLOPS,
               w["f32_bytes"] / peaks.HBM_BYTES)
    return 100.0 * need / t
