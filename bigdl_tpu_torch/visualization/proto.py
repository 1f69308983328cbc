"""The TF ``Event`` and ``Summary`` messages on the protobuf wire format
(counterpart of ``bigdl_tpu/visualization/proto.py``), written and read by
hand, so TensorBoard files need no TensorFlow and no protobuf package.
Field numbers follow tensorflow's ``event.proto`` / ``summary.proto``:

    Event    { 1: wall_time (double), 2: step (int64),
               3: file_version (string), 5: summary (Summary) }
    Summary  { 1: repeated Value }
    Value    { 1: tag (string), 2: simple_value (float),
               5: histo (HistogramProto) }
    HistogramProto { 1: min, 2: max, 3: num, 4: sum, 5: sum_squares (double),
                     6: repeated bucket_limit (packed double),
                     7: repeated bucket (packed double) }

The bytes equal the reference's for the same values.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.utils.protowire import (WT_I32, WT_I64, WT_LEN,
                                             WT_VARINT, iter_fields)


# ------------------------------------------------------------------ encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, WT_I64) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, WT_I32) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, WT_VARINT) + _varint(value)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, WT_LEN) + _varint(len(payload)) + payload


def _packed_doubles(field: int, values) -> bytes:
    return _len_field(field, np.asarray(values, "<f8").tobytes())


def encode_scalar_value(tag: str, value: float) -> bytes:
    return _len_field(1, tag.encode("utf-8")) + _float_field(2, value)


def encode_histogram(values) -> bytes:
    """A HistogramProto of raw values in TF's exponential buckets. Only
    finite values are bucketed (a diverging run's NaNs still encode); the
    empty buckets past the first and last filled ones are trimmed, one
    boundary bucket kept on each side."""
    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,), dtype=np.float64)
    limits = _bucket_limits()
    counts = np.zeros(len(limits), dtype=np.float64)
    idx = np.minimum(np.searchsorted(limits, v, side="left"), len(limits) - 1)
    np.add.at(counts, idx, 1.0)
    nz = np.nonzero(counts)[0]
    lo, hi = max(0, nz[0] - 1), min(len(limits) - 1, nz[-1] + 1)
    return (_double_field(1, float(v.min())) + _double_field(2, float(v.max()))
            + _double_field(3, float(v.size)) + _double_field(4, float(v.sum()))
            + _double_field(5, float(np.square(v).sum()))
            + _packed_doubles(6, limits[lo:hi + 1])
            + _packed_doubles(7, counts[lo:hi + 1]))


_BUCKET_LIMITS: Optional[np.ndarray] = None


def _bucket_limits() -> np.ndarray:
    """TF's limits: +-1e-12 growing by 1.1 up to 1e20, 0 and +inf."""
    global _BUCKET_LIMITS
    if _BUCKET_LIMITS is None:
        pos = []
        x = 1e-12
        while x < 1e20:
            pos.append(x)
            x *= 1.1
        limits = [-x for x in reversed(pos)] + [0.0] + pos + [float("inf")]
        _BUCKET_LIMITS = np.asarray(limits)
    return _BUCKET_LIMITS


def encode_histo_value(tag: str, values) -> bytes:
    return (_len_field(1, tag.encode("utf-8"))
            + _len_field(5, encode_histogram(values)))


def encode_event(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 summary_values: Optional[List[bytes]] = None) -> bytes:
    msg = _double_field(1, wall_time)
    if step is not None:
        msg += _varint_field(2, step)
    if file_version is not None:
        msg += _len_field(3, file_version.encode("utf-8"))
    if summary_values:
        msg += _len_field(5, b"".join(_len_field(1, v)
                                      for v in summary_values))
    return msg


# ------------------------------------------------------------------ decoding

def decode_event(buf: bytes) -> dict:
    """An Event as ``{wall_time, step, file_version, scalars: [(tag,
    value)]}``."""
    out = {"wall_time": 0.0, "step": 0, "file_version": None, "scalars": []}
    for field, wt, val in iter_fields(buf):
        if field == 1 and wt == WT_I64:
            out["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2 and wt == WT_VARINT:
            out["step"] = val
        elif field == 3 and wt == WT_LEN:
            out["file_version"] = val.decode("utf-8", "replace")
        elif field == 5 and wt == WT_LEN:
            for f2, w2, v2 in iter_fields(val):
                if f2 != 1 or w2 != WT_LEN:
                    continue
                tag, simple = None, None
                for f3, w3, v3 in iter_fields(v2):
                    if f3 == 1 and w3 == WT_LEN:
                        tag = v3.decode("utf-8", "replace")
                    elif f3 == 2 and w3 == WT_I32:
                        simple = struct.unpack("<f", v3)[0]
                if tag is not None and simple is not None:
                    out["scalars"].append((tag, simple))
    return out
