"""Protobuf wire-format reader (counterpart of
``bigdl_tpu/utils/protowire.py``): the field walker shared by the
TensorBoard event codec (``visualization/proto.py``) and the SentencePiece
model reader (``interop/sentencepiece.py``)."""

from __future__ import annotations

from typing import Any, Iterator, Tuple, Union

Buf = Union[bytes, memoryview]

WT_VARINT = 0
WT_I64 = 1
WT_LEN = 2
WT_I32 = 5


def read_varint(buf: Buf, pos: int) -> Tuple[int, int]:
    """Decode a varint at ``pos``: ``(value, next_pos)``. Raises
    ``EOFError`` on a varint that runs past the buffer."""
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise EOFError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: Buf) -> Iterator[Tuple[int, int, Any]]:
    """Yield ``(field_number, wire_type, value)``: an int for VARINT, an
    8- or 4-byte slice for I64 / I32, a sub-buffer slice (of ``buf``'s
    type) for LEN."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            val, pos = read_varint(buf, pos)
            yield field, wt, val
        elif wt == WT_I64:
            if pos + 8 > n:
                raise EOFError("truncated fixed64 field")
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == WT_LEN:
            ln, pos = read_varint(buf, pos)
            if pos + ln > n:
                raise EOFError("truncated length-delimited field")
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == WT_I32:
            if pos + 4 > n:
                raise EOFError("truncated fixed32 field")
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
