"""The JAX package's checkpoint files: flax's msgpack pytrees, read and
written in pure Python (``struct`` and numpy; no ``msgpack``, no flax).

A file holds ``flax.serialization.to_bytes`` of a state dict: maps with
string keys (in the order they were written), nil, bool, int, float and
str, and two extension types of flax's:

- ext 1, an ndarray: a packed array ``(shape, dtype name, C-order
  bytes)``; ``bfloat16`` (which numpy lacks) is read as a uint16 view into
  a ``torch.bfloat16`` tensor, and written from one;
- ext 3, a numpy scalar: the same payload, read back as a 0-d array's
  item (``arr[()]``).

:func:`pack` picks msgpack's smallest encoding of every value (fixint /
fixstr / fixmap and so on up through the 8-, 16-, 32- and 64-bit forms,
fixext for payloads of 1, 2, 4, 8 or 16 bytes), as the ``msgpack``
package does, so the bytes of a numpy tree equal ``to_bytes`` of the same
tree.  flax splits leaves over 2**30 bytes into chunks
(``__msgpack_chunked_array__``); such leaves are refused both ways, and
no parameter of this system comes near that size.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30       # flax's serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing

def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int %d does not fit msgpack's uint64" % x)
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)),
                              (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if x >= low:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int %d does not fit msgpack's int64" % x)


_LIMIT = {">B": 1 << 8, ">H": 1 << 16, ">I": 1 << 32}


def _pack_len(out: bytearray, n: int, forms: tuple, fix: int | None = None,
              fix_max: int = 0) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    ``forms`` (``(tag, struct format)``, narrowest first) that holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt in forms:
        if n < _LIMIT[fmt]:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError("length %d does not fit msgpack" % n)


_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_BIN = ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))
_STR = ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
_EXT = ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))
_ARRAY = ((0xDC, ">H"), (0xDD, ">I"))
_MAP = ((0xDE, ">H"), (0xDF, ">I"))


def _pack_bytes(out: bytearray, data: bytes) -> None:
    _pack_len(out, len(data), _BIN)
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {n: tag for tag, n in _FIXEXT.items()}.get(len(data))
    if fixext is not None:
        out.append(fixext)
    else:
        _pack_len(out, len(data), _EXT)
    out.append(code)
    out += data


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``
    of a numpy array or a CPU-copyable tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = (tuple(t.shape), "bfloat16",
                                t.view(torch.int16).numpy().tobytes())
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        a = np.asarray(arr)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be "
                             "serialized")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError("a leaf of %d bytes: flax would chunk it "
                         "(over 2**30 bytes), which this codec does not "
                         "write" % len(raw))
    out = bytearray()
    _pack_value(out, [list(shape), name, raw])
    return bytes(out)


def _pack_value(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, int(x))
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), _STR, 0xA0, 32)
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _pack_bytes(out, bytes(x))
    elif isinstance(x, dict):
        _pack_len(out, len(x), _MAP, 0x80, 16)
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError("map keys must be str, got %r" % (k,))
            _pack_value(out, k)
            _pack_value(out, v)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), _ARRAY, 0x90, 16)
        for v in x:
            _pack_value(out, v)
    else:
        raise TypeError("cannot serialize %s" % type(x).__name__)


def pack(tree) -> bytes:
    """The msgpack bytes of a state dict (``flax.serialization.to_bytes``
    of it)."""
    out = bytearray()
    _pack_value(out, tree)
    return bytes(out)


# ------------------------------------------------------------------ reading

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# the headers followed by a length: bin, str, array, map and ext
_SIZED = {tag: fmt for forms in (_BIN, _STR, _ARRAY, _MAP, _EXT)
          for tag, fmt in forms}


class _Reader:
    """Bins are read as memoryviews of the input (no copy)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.num(">B")
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if tag < 0x90:
            return self.map(tag & 0x0F)
        if tag < 0xA0:
            return [self.value() for _ in range(tag & 0x0F)]
        if tag < 0xC0:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag in _SIMPLE:
            return _SIMPLE[tag]
        if tag in _FIXED:
            return self.num(_FIXED[tag])
        if tag in _FIXEXT:
            return self.ext(_FIXEXT[tag])
        if tag not in _SIZED:
            raise ValueError("msgpack type 0x%02x is not used by flax's "
                             "files" % tag)
        n = self.num(_SIZED[tag])
        if tag in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if tag in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if tag in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        if tag in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a chunked leaf (%s, over 2**30 bytes): not "
                             "read by this codec" % _CHUNKED)
        return out

    def ext(self, n: int):
        code = self.num(">B")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError("msgpack ext type %d is not an array" % code)
        shape, name, raw = _Reader(payload).value()
        if isinstance(name, memoryview):
            name = str(name, "utf-8")
        shape = tuple(shape)
        if name == "bfloat16":
            bits = np.frombuffer(raw, np.int16).reshape(shape)
            arr = torch.from_numpy(bits.copy()).view(torch.bfloat16)
            return arr if code == EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(raw, np.dtype(name)).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def unpack(data):
    """The tree of msgpack bytes written by :func:`pack` or by flax (numpy
    leaves, writable where ``data`` is a ``bytearray``)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("%d bytes after the msgpack tree"
                         % (len(reader.buf) - reader.pos))
    return tree


def save(tree, path: str) -> None:
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(pack(tree))


def load(path: str):
    with open(path, "rb") as f:
        return unpack(bytearray(f.read()))
