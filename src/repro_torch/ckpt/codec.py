"""The msgpack subset the checkpoint format uses, encoded and decoded
here so the port needs no ``msgpack`` package.

:func:`packb` writes the bytes ``msgpack.packb`` writes for the same
payload (its defaults: ``use_bin_type=True``, floats as float64, the
smallest format that holds each int, str and container length), and
:func:`unpackb` reads them back as ``msgpack.unpackb`` does (``raw=False``:
str as str, bin as bytes, arrays as lists).  The subset: nil, bool,
int of every width up to 64 bits, float64, str, bin, array and map.
Anything else raises ``TypeError`` on the way in and ``ValueError`` on
the way out, as does a truncated or trailing-garbage buffer.
"""

from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for tag, s, hi in ((0xCC, _U8, 0xFF), (0xCD, _U16, 0xFFFF),
                           (0xCE, _U32, 0xFFFFFFFF),
                           (0xCF, _U64, 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                out.append(tag)
                out += s.pack(v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for tag, s, lo in ((0xD0, _I8, -0x80), (0xD1, _I16, -0x8000),
                           (0xD2, _I32, -0x80000000),
                           (0xD3, _I64, -0x8000000000000000)):
            if v >= lo:
                out.append(tag)
                out += s.pack(v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, tags, out: bytearray,
              what: str) -> None:
    """A length header: the fix form below ``fix_max``, then 8-, 16- and
    32-bit forms (``tags`` lists them, None where the type has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, s, hi in zip(tags, (_U8, _U16, _U32),
                          (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= hi:
            out.append(tag)
            out += s.pack(n)
            return
    raise ValueError(f"{what} of {n} entries is too long for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out, "str")
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out, "bin")
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out, "array")
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out, "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} "
                        f"object")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, byte for byte ``msgpack.packb(obj)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted "
                             f"at offset {self.pos} of {len(self.buf)}")
        v = self.buf[self.pos:end]
        self.pos = end
        return v

    def unpack(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]

    def obj(self):
        t = self.unpack(_U8)
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t < 0x90:
            return self.map(t & 0x0F)
        if t < 0xA0:
            return self.array(t & 0x0F)
        if t < 0xC0:
            return self.str(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        fixed = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16,
                 0xCE: _U32, 0xCF: _U64, 0xD0: _I8, 0xD1: _I16,
                 0xD2: _I32, 0xD3: _I64}
        if t in fixed:
            return self.unpack(fixed[t])
        lengths = {0xC4: _U8, 0xC5: _U16, 0xC6: _U32, 0xD9: _U8,
                   0xDA: _U16, 0xDB: _U32, 0xDC: _U16, 0xDD: _U32,
                   0xDE: _U16, 0xDF: _U32}
        if t not in lengths:
            raise ValueError(f"msgpack type byte 0x{t:02x} at offset "
                             f"{self.pos - 1} is outside the checkpoint "
                             f"format's subset")
        n = self.unpack(lengths[t])
        if t <= 0xC6:
            return bytes(self.take(n))
        if t <= 0xDB:
            return self.str(n)
        if t <= 0xDD:
            return self.array(n)
        return self.map(n)

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str is not UTF-8: {e}") from e

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, (list, dict)):
                raise ValueError("msgpack map key is a container")
            out[k] = self.obj()
        return out


def unpackb(blob: bytes):
    """The object ``blob`` holds, as ``msgpack.unpackb(blob)`` returns
    it; raises ValueError on truncated or trailing data."""
    r = _Reader(blob)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data "
                         f"after the msgpack object")
    return obj
