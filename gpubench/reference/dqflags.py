"""Data-quality bit flags, self-contained.

The reference package imports ``roman_datamodels.dqflags.pixel`` /
``.group`` (used throughout, e.g. ``utils/fitting.py:17``,
``gen_cal_image.py:33``).  This framework owns the table so it has no
runtime dependency on the Roman schema stack.  Bit values follow the
Roman/JWST convention (consistent with the reference's own uses:
``SATURATED=2``, ``JUMP_DET=4``, ``HOT=2**11``, ``WARM=2**12`` in
``runs/summer2025run/makemask.py:30-32``, ``REFERENCE_PIXEL=2**31`` in
``makemask.py:14-18``).

All flags are plain Python ints; DQ arrays are uint32 end to end (never
float).  torch has no full uint32 arithmetic on every device, so the
device code holds DQ planes as int32 bit patterns: :func:`i32` gives
a flag's int32 value (``REFERENCE_PIXEL`` reads as negative), and DQ is
only ever combined with ``|``, ``&`` and ``==``.
"""


class pixel:
    """2-D per-pixel data quality flags (uint32 bit values)."""

    GOOD = 0
    DO_NOT_USE = 2**0  # bad pixel; do not use
    SATURATED = 2**1  # saturated pixel
    JUMP_DET = 2**2  # jump (cosmic ray) detected
    DROPOUT = 2**3  # data lost in transmission
    GW_AFFECTED_DATA = 2**4  # data affected by guide-window read
    PERSISTENCE = 2**5  # high persistence
    AD_FLOOR = 2**6  # below A/D floor
    CHARGELOSS = 2**7  # charge migration
    UNRELIABLE_ERROR = 2**8  # uncertainty exceeds quoted error
    NON_SCIENCE = 2**9  # not science data
    DEAD = 2**10  # dead pixel
    HOT = 2**11  # hot pixel
    WARM = 2**12  # warm pixel
    LOW_QE = 2**13  # low quantum efficiency
    RC = 2**14  # RC pixel
    TELEGRAPH = 2**15  # telegraph pixel
    NONLINEAR = 2**16  # pixel highly nonlinear
    BAD_REF_PIXEL = 2**17  # reference pixel cannot be used
    NO_FLAT_FIELD = 2**18  # flat field cannot be measured
    NO_GAIN_VALUE = 2**19  # gain cannot be measured
    NO_LIN_CORR = 2**20  # linearity correction not available
    NO_SAT_CHECK = 2**21  # saturation check not available
    UNRELIABLE_BIAS = 2**22  # bias variance large
    UNRELIABLE_DARK = 2**23  # dark variance large
    UNRELIABLE_SLOPE = 2**24  # slope variance large (i.e., noisy pixel)
    UNRELIABLE_FLAT = 2**25  # flat variance large
    OPEN = 2**26  # open pixel
    ADJ_OPEN = 2**27  # adjacent to open pixel
    UNRELIABLE_RESET = 2**28  # sensitive to reset anomaly
    MSA_FAILED_OPEN = 2**29  # (reserved)
    OTHER_BAD_PIXEL = 2**30  # other bad pixel
    REFERENCE_PIXEL = 2**31  # reference pixel


class group:
    """3-D per-resultant (group) data quality flags (uint32 bit values)."""

    GOOD = 0
    DO_NOT_USE = 2**0
    SATURATED = 2**1
    JUMP_DET = 2**2
    DROPOUT = 2**3
    AD_FLOOR = 2**6


def flag_bit(name):
    """Return the bit *index* (0..31) of a named pixel flag.

    Mirrors the bit-resolution loop of the reference's
    ``CombinedMask.__init__`` (``utils/maskhandling.py:68-80``).
    """
    value = getattr(pixel, name.upper())
    bit = 0
    while value >> bit != 1:
        bit += 1
    return bit


#: Flags whose presence means "this resultant is unusable for fitting".
GROUP_BAD = group.DO_NOT_USE | group.SATURATED


def i32(bits):
    """The int32 bit pattern of a uint32 flag value."""
    bits = int(bits) & 0xFFFFFFFF
    return bits - (1 << 32) if bits >= 1 << 31 else bits
