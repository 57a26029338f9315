"""msgpack, written by hand for exactly what the package reads and writes.

The card's machine has no ``msgpack`` package, and the bytes matter: an
event id hashes its body's encoding, a membership transaction's
signature covers its message's encoding, and a checkpoint's
``meta.msgpack`` must load in the JAX package and back.  So ``packb``
gives the bytes of ``msgpack.packb(obj, use_bin_type=True)`` and
``unpackb`` the value of ``msgpack.unpackb(data, raw=False,
strict_map_key=...)`` for these types:

- ``None``, ``bool``, ``int`` (64 bits, the smallest form, unsigned
  forms for values >= 0 as msgpack-python picks them);
- ``str`` as str, ``bytes``/``bytearray``/``memoryview`` as bin;
- ``list`` and ``tuple`` as arrays (decoded as lists);
- ``dict`` as maps, in insertion order.

``packb`` refuses every other type (floats, numpy scalars, sets) with
``TypeError``.  ``unpackb`` also reads floats (32 and 64 bits), as
msgpack does, so that a hostile input is refused by the same later
type checks; it refuses ext types.  It never allocates from a declared
length: every length is bounded by the bytes that remain before
anything is read, and truncated, overlong, trailing or malformed input
raises ``ValueError``, as does nesting deeper than ``MAX_DEPTH``.

``strict_map_key`` is msgpack's option of that name, with msgpack's
default ``True``: a map key that is not ``str`` or ``bytes`` raises
``ValueError`` as soon as the key is read, before its value.  Each call
site passes what the JAX package's call passes there: only the
checkpoint meta reads decode with ``strict_map_key=False``.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

#: deepest nesting ``unpackb`` reads: far deeper than anything the
#: package writes (a checkpoint's meta nests five levels), and well
#: inside Python's recursion limit
MAX_DEPTH = 128

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _header(out: List[bytes], n: int, fix, tags) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form
    ``(base, limit)`` when it fits, else the 8/16/32-bit length form
    (``tags`` maps a length width to its type byte)."""
    if fix is not None and n < fix[1]:
        out.append(bytes((fix[0] | n,)))
        return
    for width, st in ((8, _U8), (16, _U16), (32, _U32)):
        if width in tags and n < (1 << width):
            out.append(bytes((tags[width],)) + st.pack(n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(_U8.pack(v))         # positive fixint: one byte
    elif -0x20 <= v < 0:
        out.append(_I8.pack(v))
    elif v > 0:
        for tag, st, top in ((0xCC, _U8, 0xFF), (0xCD, _U16, 0xFFFF),
                             (0xCE, _U32, 0xFFFFFFFF),
                             (0xCF, _U64, 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(bytes((tag,)) + st.pack(v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")
    else:
        for tag, st, bits in ((0xD0, _I8, 8), (0xD1, _I16, 16),
                              (0xD2, _I32, 32), (0xD3, _I64, 64)):
            if v >= -(1 << (bits - 1)):
                out.append(bytes((tag,)) + st.pack(v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_into(out: List[bytes], obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(out, obj)
    elif t is str:
        b = obj.encode("utf-8")
        _header(out, len(b), (0xA0, 32), {8: 0xD9, 16: 0xDA, 32: 0xDB})
        out.append(b)
    elif t in (bytes, bytearray, memoryview):
        # a copy of a bytes-like object: its size is the object's own
        # length, never a decoded integer (ints take _pack_int above)
        b = bytes(obj)  # babble-lint: disable=unbounded-hostile-input
        _header(out, len(b), None, {8: 0xC4, 16: 0xC5, 32: 0xC6})
        out.append(b)
    elif t in (list, tuple):
        _header(out, len(obj), (0x90, 16), {16: 0xDC, 32: 0xDD})
        for x in obj:
            _pack_into(out, x)
    elif t is dict:
        _header(out, len(obj), (0x80, 16), {16: 0xDE, 32: 0xDF})
        for k, v in obj.items():
            _pack_into(out, k)
            _pack_into(out, v)
    else:
        raise TypeError(f"cannot encode {t.__name__} in msgpack")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` (module docstring)."""
    out: List[bytes] = []
    _pack_into(out, obj)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.end = len(data)

    def take(self, n: int) -> bytes:
        """The next ``n`` bytes; raises before slicing when fewer remain."""
        if n > self.end - self.pos:
            raise ValueError(
                f"msgpack input truncated: {n} bytes declared, "
                f"{self.end - self.pos} remain")
        lo = self.pos
        self.pos = lo + n
        return self.data[lo:self.pos]

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def count(self, n: int, min_bytes: int) -> int:
        """A declared element count, bounded by the bytes that remain
        (each element takes at least ``min_bytes``)."""
        if n * min_bytes > self.end - self.pos:
            raise ValueError(
                f"msgpack container declares {n} elements, only "
                f"{self.end - self.pos} bytes remain")
        return n


def _read(r: _Reader, depth: int, strict: bool):
    if depth > MAX_DEPTH:
        raise ValueError("msgpack input nests too deep")
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        return _text(r.take(b & 0x1F))
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F, depth, strict)
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, depth, strict)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        return r.take(r.num((_U8, _U16, _U32)[b - 0xC4]))
    if b in (0xD9, 0xDA, 0xDB):
        return _text(r.take(r.num((_U8, _U16, _U32)[b - 0xD9])))
    if 0xCC <= b <= 0xCF:
        return r.num((_U8, _U16, _U32, _U64)[b - 0xCC])
    if 0xD0 <= b <= 0xD3:
        return r.num((_I8, _I16, _I32, _I64)[b - 0xD0])
    if b == 0xCA:
        return r.num(_F32)
    if b == 0xCB:
        return r.num(_F64)
    if b in (0xDC, 0xDD):
        return _array(r, r.num(_U16 if b == 0xDC else _U32), depth, strict)
    if b in (0xDE, 0xDF):
        return _map(r, r.num(_U16 if b == 0xDE else _U32), depth, strict)
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _text(raw: bytes) -> str:
    return raw.decode("utf-8")      # UnicodeDecodeError is a ValueError


def _array(r: _Reader, n: int, depth: int, strict: bool) -> list:
    return [_read(r, depth + 1, strict) for _ in range(r.count(n, 1))]


def _map(r: _Reader, n: int, depth: int, strict: bool) -> dict:
    out = {}
    for _ in range(r.count(n, 2)):
        k = _read(r, depth + 1, strict)
        if strict and type(k) not in (str, bytes):
            raise ValueError(
                f"{type(k).__name__} is not allowed for map key when "
                "strict_map_key=True")
        try:
            hash(k)
        except TypeError:
            raise ValueError(
                f"msgpack map key of type {type(k).__name__} is not "
                "hashable") from None
        out[k] = _read(r, depth + 1, strict)
    return out


def unpackb(data, strict_map_key: bool = True) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=strict_map_key)``
    (module docstring): exactly one object, nothing after it."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError(f"unpackb needs bytes, got {type(data).__name__}")
    r = _Reader(bytes(data))
    obj = _read(r, 0, strict_map_key)
    if r.pos != r.end:
        raise ValueError(
            f"msgpack input has {r.end - r.pos} bytes after its object")
    return obj


def unpack_pair(data) -> Tuple[Any, Any]:
    """A msgpack array of exactly two objects (the snapshot's
    ``[meta, npz]`` pair), refused as ``ValueError`` otherwise.  It
    decodes at msgpack's default ``strict_map_key=True``, as the JAX
    package reads that pair."""
    obj = unpackb(data)
    if not isinstance(obj, list) or len(obj) != 2:
        raise ValueError("expected a msgpack pair")
    return obj[0], obj[1]
