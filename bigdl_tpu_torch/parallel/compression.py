"""Host-side gradient and parameter compression codec (counterpart of
``bigdl_tpu/parallel/compression.py``, reference
``parameters/Parameter.scala:30,53`` and ``FP16CompressedTensor``).

The reference's "fp16" is fp32 truncated to its top 16 bits, i.e.
bfloat16 by truncation. On the card the same rounding of a collective's
payload is ``DistriOptimizer(compress_gradients=True)``; this module is the
host codec for bytes that cross a host boundary (snapshots, a broadcast,
parameter serving), over the host library's ``bt_fp32_to_bf16`` /
``bt_bf16_add`` / ``bt_bf16_accumulate`` (``native``, with its numpy
plain versions when no compiler is present). Its bytes equal the
reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bigdl_tpu_torch import native


def fp32_to_bf16(src: np.ndarray) -> np.ndarray:
    """Truncate fp32 to bf16 (a uint16 view), reference ``truncate()``."""
    return native.fp32_to_bf16(np.ascontiguousarray(src, np.float32))


def bf16_to_fp32(src: np.ndarray) -> np.ndarray:
    return native.bf16_to_fp32(np.ascontiguousarray(src, np.uint16))


class CompressedTensor:
    """Byte-level compressed view of a flat fp32 vector (reference
    ``CompressedTensor``)."""

    def __init__(self, length: int):
        self.length = length
        self._data = np.zeros((length,), dtype=np.uint16)

    def compress(self, src: np.ndarray, offset: int = 0,
                 length: Optional[int] = None) -> "CompressedTensor":
        src = np.ascontiguousarray(src, dtype=np.float32).ravel()
        n = src.size if length is None else length
        self._data[offset:offset + n] = fp32_to_bf16(src[:n])
        return self

    def decompress(self, dst: Optional[np.ndarray] = None) -> np.ndarray:
        out = bf16_to_fp32(self._data)
        if dst is not None:
            np.copyto(dst.ravel(), out)
            return dst
        return out

    def add(self, other: "CompressedTensor", offset: int = 0,
            length: Optional[int] = None) -> "CompressedTensor":
        """``self += other`` in bf16 over ``[offset, offset + length)``
        (reference ``add``/``parAdd``)."""
        n = self.length - offset if length is None else length
        a = self._data[offset:offset + n]
        b = other._data[offset:offset + n]
        if a.flags.c_contiguous and b.flags.c_contiguous:
            native.bf16_add(a, b)
        else:
            native.bf16_add_plain(a, b)
        return self

    def accumulate_into(self, dst: np.ndarray, offset: int = 0) -> None:
        """f32 ``dst += self``, fused slice aggregation."""
        n = self.length
        view = np.ascontiguousarray(dst.ravel()[offset:offset + n],
                                    dtype=np.float32)
        native.bf16_accumulate(view, self._data)
        dst.ravel()[offset:offset + n] = view

    def bytes(self) -> bytes:
        return self._data.tobytes()

    @classmethod
    def from_bytes(cls, payload: bytes) -> "CompressedTensor":
        data = np.frombuffer(payload, dtype=np.uint16).copy()
        out = cls(data.size)
        out._data = data
        return out

    @classmethod
    def from_array(cls, src: np.ndarray) -> "CompressedTensor":
        out = cls(int(np.asarray(src).size))
        return out.compress(np.asarray(src))


class SerializerInstance:
    """Codec registry by name (reference ``Parameter.scala:53``: its one
    codec, "fp16", is bf16 truncation, so both names map to it)."""

    _CODECS = {"fp16": CompressedTensor, "bf16": CompressedTensor}

    @classmethod
    def create(cls, length: int, pm: str = "bf16") -> CompressedTensor:
        try:
            return cls._CODECS[pm](length)
        except KeyError:
            raise ValueError(f"unsupported parameter type {pm}") from None
