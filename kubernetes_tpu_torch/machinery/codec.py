"""Binary object codec + content negotiation — the protobuf-serializer seat.

Every internal reference client negotiates
`application/vnd.kubernetes.protobuf` against the apiserver
(`staging/src/k8s.io/apimachinery/pkg/runtime/serializer/protobuf/
protobuf.go`: a 4-byte magic `k8s\\x00` + length-delimited proto `Unknown`
envelope); JSON is the fallback for humans and CRDs. This module fills that
seat for this stack: a self-describing tagged binary encoding of the
JSON object model (protoc codegen for 251k LoC of schemas is exactly what
this rebuild does NOT carry), negotiated the same way — `Accept` /
`Content-Type: application/vnd.kubernetes.ktpu.binary` — with JSON remaining
the default. Watch streams frame events as varint-length-delimited records,
the shape of the reference's streaming protobuf serializer.

Wire format (original; magic `kTPB`):
    value   := tag payload
    tag     0x00 null | 0x01 true | 0x02 false
            0x03 int (zigzag LEB128)
            0x04 float64 (8B big-endian IEEE)
            0x05 str  (LEB128 byte length + UTF-8)
            0x06 list (LEB128 count + values)
            0x07 map  (LEB128 count + (str-payload key, value) pairs)
Dict key order is preserved (insertion order), so encode∘decode is the
identity on the JSON object model — the round-trip contract the fuzz test
enforces.

(A copy of the JAX package's machinery/codec.py.)
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

MAGIC = b"kTPB"
BINARY_MEDIA_TYPE = "application/vnd.kubernetes.ktpu.binary"
JSON_MEDIA_TYPE = "application/json"

_T_NULL, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT, _T_STR, _T_LIST, _T_MAP = \
    range(8)


def _uvarint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_value(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(_T_NULL)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        # generic zigzag without 64-bit assumptions (python ints are wide)
        _uvarint(out, (v << 1) if v >= 0 else ((-v) << 1) - 1)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        out.append(_T_STR)
        b = v.encode()
        _uvarint(out, len(b))
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _uvarint(out, len(v))
        for item in v:
            _encode_value(out, item)
    elif isinstance(v, dict):
        out.append(_T_MAP)
        _uvarint(out, len(v))
        for k, item in v.items():
            kb = str(k).encode()
            _uvarint(out, len(kb))
            out += kb
            _encode_value(out, item)
    else:
        raise TypeError(f"not JSON-model encodable: {type(v).__name__}")


def encode(obj: Any) -> bytes:
    out = bytearray(MAGIC)
    _encode_value(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def uvarint(self) -> int:
        n = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated binary payload")
        self.pos += n
        return b

    def value(self) -> Any:
        tag = self.buf[self.pos]
        self.pos += 1
        if tag == _T_NULL:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            z = self.uvarint()
            return (z >> 1) if not z & 1 else -((z + 1) >> 1)
        if tag == _T_FLOAT:
            return struct.unpack(">d", self.take(8))[0]
        if tag == _T_STR:
            return self.take(self.uvarint()).decode()
        if tag == _T_LIST:
            return [self.value() for _ in range(self.uvarint())]
        if tag == _T_MAP:
            out = {}
            for _ in range(self.uvarint()):
                k = self.take(self.uvarint()).decode()
                out[k] = self.value()
            return out
        raise ValueError(f"bad tag 0x{tag:02x} at {self.pos - 1}")


def decode(data: bytes) -> Any:
    if data[:4] != MAGIC:
        raise ValueError("not a kTPB payload (bad magic)")
    r = _Reader(data, 4)
    v = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return v


# ---------------------------------------------------------------------- #
# watch-stream framing (streaming serializer analog): varint length +
# MAGIC-less encoded value per event, so frames survive concatenation
# ---------------------------------------------------------------------- #

def encode_frame(obj: Any) -> bytes:
    body = bytearray()
    _encode_value(body, obj)
    head = bytearray()
    _uvarint(head, len(body))
    return bytes(head) + bytes(body)


def decode_frames(data: bytes) -> Tuple[List[Any], bytes]:
    """Decode as many complete frames as `data` holds; return (events,
    remainder) — the incremental read loop the watch client runs."""
    out: List[Any] = []
    pos = 0
    while pos < len(data):
        r = _Reader(data, pos)
        try:
            size = r.uvarint()
            body_start = r.pos
            if body_start + size > len(data):
                break
            rv = _Reader(data, body_start)
            out.append(rv.value())
            if rv.pos != body_start + size:
                raise ValueError("frame length mismatch")
            pos = body_start + size
        except IndexError:  # truncated varint header
            break
    return out, data[pos:]


def accepts_binary(accept_header: str) -> bool:
    return BINARY_MEDIA_TYPE in (accept_header or "")
