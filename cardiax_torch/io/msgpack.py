"""A decoder of the msgpack that ``flax.serialization.to_bytes`` writes.

The JAX package saves each trained model as ``model-{name}.msgpack``
(``cardiax/io/export.py``): flax's state dict of the params, packed by the
``msgpack`` package with flax's extension types. The port reads those files
without that package (the card's machine has none) through this decoder of
the subset flax writes:

* maps, arrays, str, bin, nil, bools, ints and floats (every width);
* ext type 1, an ndarray: its payload is itself msgpack, ``(shape, dtype
  name, C-order bytes)``, decoded into a CPU tensor (``bfloat16`` into
  ``torch.bfloat16``);
* ext type 3, a numpy scalar, encoded as an ndarray of shape ``()``:
  decoded into a 0-d tensor.

Anything else raises ``ValueError``: the other ext types (2 is a complex
scalar), flax's chunked arrays (``__msgpack_chunked_array__``, which flax
writes for arrays over 1 GiB) and trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any

import torch

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width formats: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# length-prefixed formats: first byte -> (kind, width of the length)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(need {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_UINT[width], self.take(width))[0]

    def value(self, raw_str: bool) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, raw_str)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, raw_str)
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f, raw_str)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.uint(width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n, raw_str)
            if kind == "array":
                return self.array(n, raw_str)
            if kind == "map":
                return self.map(n, raw_str)
            return self.ext(n)
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts "
                         f"no value of the format")

    def text(self, n: int, raw: bool):
        chunk = self.take(n)
        return bytes(chunk) if raw else str(chunk, "utf-8")

    def array(self, n: int, raw_str: bool) -> list:
        return [self.value(raw_str) for _ in range(n)]

    def map(self, n: int, raw_str: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw_str)
            out[key] = self.value(raw_str)
        if _CHUNKED in out:
            raise ValueError(
                "msgpack: a chunked array (flax writes arrays over 1 GiB in "
                "chunks); the port does not read those")
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"msgpack: ext type {code} (flax: 1 ndarray, 3 "
                             f"numpy scalar; 2, a complex scalar, and any "
                             f"other are not read)")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ndarray encoding, ``(shape, dtype name, C-order bytes)``, as a
    CPU tensor."""
    shape, name, buf = _unpack(payload, raw_str=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f"msgpack: ndarray of dtype {name!r}")
    dtype = _DTYPES[name]
    size = 1
    for s in shape:
        size *= int(s)
    flat = torch.frombuffer(bytearray(buf), dtype=dtype) if buf \
        else torch.empty(0, dtype=dtype)
    if flat.numel() != size:
        raise ValueError(f"msgpack: ndarray of shape {shape} holds "
                         f"{flat.numel()} elements")
    return flat.reshape([int(s) for s in shape])


def _unpack(data: bytes, raw_str: bool) -> Any:
    """Decode one msgpack value; ``raw_str`` keeps strings as bytes."""
    reader = _Reader(data)
    out = reader.value(raw_str)
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         f"after the value")
    return out


def msgpack_restore(encoded: bytes) -> Any:
    """The tree that ``flax.serialization.to_bytes`` encoded, with every
    array as a CPU tensor (flax's function of the same name)."""
    return _unpack(encoded, raw_str=False)

