"""Small utilities (counterpart of ``bigdl_tpu/utils/util.py``)."""

from __future__ import annotations


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= ``n``, clamped into ``[lo, hi]``.

    Pads a traffic-dependent dimension (``LMServer``'s batch) to a power of
    two; ``hi`` need not be a power of two, the top bucket saturates at it."""
    if n < 1:
        raise ValueError(f"pow2_bucket needs n >= 1, got {n}")
    if not 1 <= lo <= hi:
        raise ValueError(f"pow2_bucket needs 1 <= lo <= hi, got "
                         f"lo={lo}, hi={hi}")
    if n > hi:
        raise ValueError(f"pow2_bucket: n={n} exceeds the bucket cap "
                         f"hi={hi}")
    b = 1 << (n - 1).bit_length()       # next power of two >= n
    return min(max(b, lo), hi)
