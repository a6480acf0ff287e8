"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), with where each comes from.

The published rates assume the card's full power limit of 700 W; each
result line records the card's name and power limit beside them."""

# rate a second, and its provenance
F32_FLOPS = 67e12       # published: NVIDIA H100 data sheet, SXM, FP32 (no tensor core)
F64_FLOPS = 34e12       # published: NVIDIA H100 data sheet, SXM, FP64 (no tensor core)
HBM_BYTES = 3.35e12     # published: NVIDIA H100 data sheet, SXM, HBM3 bandwidth
# NOT published: worked out as 64 INT32 lanes an SM x 132 SMs x 1.98 GHz
# (the SXM part's boost clock); NVIDIA gives no INT32 peak.
INT32_OPS = 64 * 132 * 1.98e9

PROVENANCE = {
    "F32_FLOPS": "published (NVIDIA H100 data sheet, SXM)",
    "F64_FLOPS": "published (NVIDIA H100 data sheet, SXM)",
    "HBM_BYTES": "published (NVIDIA H100 data sheet, SXM)",
    "INT32_OPS": "worked out: 64 INT32 lanes x 132 SMs x 1.98 GHz, "
                 "not published",
}
