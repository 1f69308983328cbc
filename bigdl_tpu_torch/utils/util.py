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


def kth_largest(values, k: int) -> float:
    """The k-th largest element, k 1-based (reference ``kth_largest``, the
    straggler-drop threshold): the native quickselect when the host library
    is built, else ``np.partition``. A k out of range raises."""
    import numpy as np
    arr = np.ascontiguousarray(values, dtype=np.float64).ravel()
    if not 1 <= k <= arr.size:
        raise ValueError(f"k={k} out of range for {arr.size} values")
    from bigdl_tpu_torch import native
    if native._call("bt_kth_largest") is not None:
        return native.kth_largest(arr, k)
    return float(np.partition(arr, arr.size - k)[arr.size - k])
