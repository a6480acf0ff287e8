"""Smith-Waterman parameter types and constants.

The port's copy of ``mgl_tpu/core/params.py``, after the reference's
shared SW definitions (``sw_common.h``):

* overhang-strategy flags (sw_common.h:22-25)
* CIGAR state characters (sw_common.h:27-30) and ``SW_NEG_INF``
  (sw_common.h:33), which the scalar SW oracle (``ref_impl/sw_scalar``)
  uses
* ``DP_NEG_INF``, the int-matrix DP "minus infinity" (sw.cpp:8)
* ``swParameters`` (sw_common.h:42-47) and the JNI sign normalization
  (com_microsoft_mgl_smithwaterman_MicrosoftSmithWaterman.cpp:52-55)
"""

from __future__ import annotations

import dataclasses
import enum


class OverhangStrategy(enum.IntEnum):
    """How overhanging (unaligned) sequence ends are treated.

    Values match the reference bitflags (sw_common.h:22-25) and the GATK
    SWOverhangStrategy enum translation
    (MicrosoftSmithWaterman.java:39-56).
    """

    SOFTCLIP = 0x01
    INDEL = 0x02
    LEADING_INDEL = 0x04
    IGNORE = 0x08


# CIGAR states (sw_common.h:27-30)
STATE_MATCH = "M"
STATE_INS = "I"
STATE_DEL = "D"
STATE_CLIP = "S"

SW_NEG_INF = -0x40000000  # sw_common.h:33

# int-matrix DP "minus infinity": INT_MIN / 2, as used for E/F initial
# state in the scalar kernel (sw.cpp:8).  Safe against int32 underflow.
DP_NEG_INF = -(2**30)


@dataclasses.dataclass(frozen=True)
class SWParameters:
    """Affine-gap scoring parameters.

    Stored *normalized* the way the reference's JNI layer does
    (com_…SmithWaterman.cpp:52-55): match positive; mismatch negative;
    gap open/extend positive magnitudes (the DP subtracts them).
    """

    match: int
    mismatch: int
    gap_open: int
    gap_extend: int

    @staticmethod
    def normalized(match: int, mismatch: int, gap_open: int, gap_extend: int
                   ) -> "SWParameters":
        """Apply the reference's sign normalization to raw (GATK-style)
        parameters, which may arrive with either sign convention."""
        return SWParameters(
            match=match if match > 0 else -match,
            mismatch=mismatch if mismatch < 0 else -mismatch,
            gap_open=gap_open if gap_open > 0 else -gap_open,
            gap_extend=gap_extend if gap_extend > 0 else -gap_extend,
        )


# GATK's standard SW parameter sets (mgl_tpu/core/params.py:73-76)
STANDARD_NGS = SWParameters(25, -50, 110, 6)
NEW_SW_PARAMETERS = SWParameters(200, -150, 260, 11)
ORIGINAL_DEFAULT = SWParameters(3, -1, 4, 3)
