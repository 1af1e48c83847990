"""A reader and writer for the subset of HDF5 that the corpus files use,
with numpy and the standard library only.

This module has no counterpart in the JAX package, which opens HDF5
through ``h5py``. The port reads and writes the same files here instead,
so that the corpus path needs no ``h5py`` and runs the same code on every
machine. Its scope is what the processed corpus (the JAX builders' LZF
files, the port's own), the MATLAB v7.3 lip files and ``h5py`` 3 with its
default ``libver="earliest"`` write:

- superblock version 0 or 1, searched at offsets 0, 512, 1024, ... (a
  MATLAB v7.3 file carries a 512-byte user block);
- version-1 object headers with their continuation blocks;
- the root group as a symbol table (local heap, version-1 group B-tree,
  symbol nodes), and datasets at the root only;
- IEEE floats of 2, 4 and 8 bytes and integers of 1 to 8 bytes, signed or
  not, in either byte order; simple and scalar dataspaces;
- data layout version 3: contiguous (read through ``np.memmap``, so a
  slice reads only what it selects), compact, and chunked with a
  version-1 chunk B-tree of any depth (a slice reads only the chunks it
  touches);
- the filters deflate, shuffle and LZF (32000; its decoder is the host
  library's ``lzf_decompress``, ``native.py``).

Attributes are skipped. Any other datatype, layout, filter, message or
structure raises a ``ValueError`` that names it.

``File(path, "w")`` writes what ``h5py`` reads: superblock 0, a root
symbol table and contiguous, uncompressed datasets. The API is the part
of ``h5py``'s the call sites use: ``File`` as a context manager, ``f[name]``
(a ``Dataset`` with ``shape``, ``dtype`` and numpy basic slicing),
``keys()`` / ``values()`` and ``create_dataset(name, data=...)``.
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_LZF = 1, 2, 32000
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                32015: "zstd"}
CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
               4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
               8: "enumerated", 9: "variable-length", 10: "array"}
# header messages that do not change how a dataset's array reads: NIL,
# group info, attribute, comment, modification times, attribute info,
# reference count
SKIPPED_MESSAGES = {0x00, 0x0A, 0x0C, 0x0D, 0x0E, 0x12, 0x15, 0x16}
# IEEE layouts by size: (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}
CHUNK_CACHE_BYTES = 32 << 20


def lzf_decompress_py(data: bytes, out_len: int) -> bytes:
    """Plain Python LZF decoder, the twin of the host library's
    ``lzf_decompress`` (``csrc/avvad_io.cpp``), which the reader uses."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            if i + run > n:
                raise ValueError("LZF chunk: corrupt input (literal run past the end)")
            out += data[i:i + run]
            i += run
        else:
            length = ctrl >> 5
            if i >= n:
                raise ValueError("LZF chunk: corrupt input (truncated back reference)")
            if length == 7:
                length += data[i]
                i += 1
                if i >= n:
                    raise ValueError("LZF chunk: corrupt input (truncated back reference)")
            ref = len(out) - ((ctrl & 0x1F) << 8) - 1 - data[i]
            i += 1
            length += 2
            if ref < 0:
                raise ValueError("LZF chunk: corrupt input (reference before the start)")
            for k in range(length):
                out.append(out[ref + k])
        if len(out) > out_len:
            raise ValueError(f"LZF chunk: output longer than {out_len} bytes")
    if len(out) != out_len:
        raise ValueError(f"LZF chunk: decoded {len(out)} bytes, expected {out_len}")
    return bytes(out)


def _lzf_decompress(data: bytes, out_len: int) -> bytes:
    from . import native

    try:
        native.load()
    except (RuntimeError, OSError) as e:
        raise RuntimeError("an LZF-compressed HDF5 chunk needs the host library "
                           f"(native.lzf_decompress), which could not be built: {e}") from e
    return native.lzf_decompress(data, out_len)


def _unshuffle(data: bytes, itemsize: int) -> bytes:
    n = len(data) // itemsize
    body = np.frombuffer(data, np.uint8, n * itemsize).reshape(itemsize, n)
    return body.T.tobytes() + data[n * itemsize:]


def _parse_dtype(body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = body[1] | body[2] << 8 | body[3] << 16
    (size,) = struct.unpack_from("<I", body, 4)
    order = ">" if bits & 1 else "<"
    if version not in (1, 2, 3):
        raise ValueError(f"datatype message version {version} is not supported")
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise ValueError(f"fixed-point datatype of {size} bytes, bit offset {offset}, "
                             f"precision {precision} is not supported")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        if bits & 0x40:
            raise ValueError("floating-point datatype in VAX byte order is not supported")
        offset, precision, *layout = struct.unpack_from("<HHBBBBI", body, 8)
        if size not in IEEE or offset != 0 or precision != 8 * size \
                or tuple(layout) != IEEE[size]:
            raise ValueError(f"floating-point datatype of {size} bytes with layout "
                             f"{(offset, precision, *layout)} is not IEEE 754")
        return np.dtype(f"{order}f{size}")
    raise ValueError(f"datatype class {cls} ({CLASS_NAMES.get(cls, 'unknown')}) "
                     "is not supported")


def _parse_shape(body: bytes) -> tuple:
    version, rank = body[0], body[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise ValueError("null dataspace is not supported")
        pos = 4
    else:
        raise ValueError(f"dataspace message version {version} is not supported")
    return struct.unpack_from(f"<{rank}Q", body, pos)


def _parse_layout(body: bytes) -> tuple:
    version, cls = body[0], body[1]
    if version != 3:
        raise ValueError(f"data layout message version {version} is not supported")
    if cls == 0:
        (size,) = struct.unpack_from("<H", body, 2)
        return ("compact", bytes(body[4:4 + size]))
    if cls == 1:
        return ("contiguous",) + struct.unpack_from("<QQ", body, 2)
    if cls == 2:
        nd = body[2]
        (addr,) = struct.unpack_from("<Q", body, 3)
        dims = struct.unpack_from(f"<{nd}I", body, 11)
        return ("chunked", addr, tuple(dims[:-1]))
    raise ValueError(f"data layout class {cls} is not supported")


def _parse_filters(body: bytes) -> list:
    version, count = body[0], body[1]
    if version not in (1, 2):
        raise ValueError(f"filter pipeline message version {version} is not supported")
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        (fid,) = struct.unpack_from("<H", body, pos)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            (name_len,) = struct.unpack_from("<H", body, pos)
            pos += 2
        flags, nvals = struct.unpack_from("<HH", body, pos)
        pos += 4
        pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
        vals = struct.unpack_from(f"<{nvals}I", body, pos)
        pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_LZF):
            raise ValueError(f"filter {fid} ({FILTER_NAMES.get(fid, 'unknown')}) "
                             "is not supported")
        out.append((fid, vals))
    return out


def _parse_fill(mtype: int, body: bytes):
    """The fill value's bytes, or None where none is defined."""
    if mtype == 0x04:
        (size,) = struct.unpack_from("<I", body, 0)
        return bytes(body[4:4 + size]) if size else None
    version = body[0]
    if version in (1, 2):
        defined, pos = body[3], 4
    elif version == 3:
        defined, pos = body[1] & 0x20, 2
    else:
        raise ValueError(f"fill value message version {version} is not supported")
    if not defined:
        return None
    (size,) = struct.unpack_from("<I", body, pos)
    return bytes(body[pos + 4:pos + 4 + size]) if size else None


class _Reader:
    """The file's bytes: addresses are relative to the superblock's base."""

    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        try:
            self._superblock()
        except BaseException:
            os.close(self.fd)
            raise

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, self.base + addr)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated file (read of {n} bytes at "
                             f"address {addr} got {len(data)})")
        return data

    def _superblock(self):
        size = os.fstat(self.fd).st_size
        at = 0
        while os.pread(self.fd, 8, at) != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > size:
                raise ValueError(f"{self.path}: no HDF5 signature at offset 0, 512, "
                                 "1024, ...")
        head = os.pread(self.fd, 24, at)
        version = head[8]
        if version not in (0, 1):
            raise ValueError(f"{self.path}: superblock version {version} is not "
                             "supported (h5py writes 0 with libver='earliest')")
        if head[13] != 8 or head[14] != 8:
            raise ValueError(f"{self.path}: offsets of {head[13]} and lengths of "
                             f"{head[14]} bytes are not supported (8 and 8)")
        pos = at + 24 + (4 if version == 1 else 0)
        base, _, _, _ = struct.unpack("<4Q", os.pread(self.fd, 32, pos))
        # a user block added after the file was written leaves base 0
        self.base = base if base == at else at
        entry = os.pread(self.fd, 40, pos + 32)
        self.root_header = struct.unpack_from("<Q", entry, 8)[0]

    def messages(self, addr: int) -> list:
        """A version-1 object header's messages -> [(type, flags, body)],
        continuation blocks followed."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{self.path}: version 2 object headers are not supported")
        if head[0] != 1:
            raise ValueError(f"{self.path}: object header version {head[0]} is not "
                             "supported")
        (count,) = struct.unpack_from("<H", head, 2)
        (length,) = struct.unpack_from("<I", head, 8)
        blocks, out = [(addr + 16, length)], []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x10:
                    blocks.append(struct.unpack_from("<QQ", body, 0))
                out.append((mtype, flags, body))
        return out

    def group_entries(self, btree: int, heap: int) -> "OrderedDict[str, int]":
        """A symbol-table group's {name: object header address}, in name
        order."""
        head = self.read(heap, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap signature at {heap}")
        dsize, _, daddr = struct.unpack_from("<QQQ", head, 8)
        names = self.read(daddr, dsize)
        entries, stack = OrderedDict(), [btree]
        while stack:
            addr = stack.pop()
            head = self.read(addr, 24)
            if head[:4] != b"TREE" or head[4] != 0:
                raise ValueError(f"{self.path}: bad group B-tree node at {addr}")
            level, (used,) = head[5], struct.unpack_from("<H", head, 6)
            body = self.read(addr + 24, 16 * used + 8)
            children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
            if level > 0:
                stack.extend(reversed(children))
                continue
            for snod in children:
                head = self.read(snod, 8)
                if head[:4] != b"SNOD":
                    raise ValueError(f"{self.path}: bad symbol table node at {snod}")
                (n,) = struct.unpack_from("<H", head, 6)
                body = self.read(snod + 8, 40 * n)
                for i in range(n):
                    name_off, obj = struct.unpack_from("<QQ", body, 40 * i)
                    name = names[name_off:names.index(b"\0", name_off)].decode()
                    entries[name] = obj
        return entries

    def chunk_index(self, btree: int, rank: int) -> dict:
        """A chunk B-tree -> {chunk offset tuple: (address, size, filter
        mask)}."""
        key = 8 + 8 * (rank + 1)
        out, stack = {}, ([] if btree == UNDEF else [btree])
        while stack:
            addr = stack.pop()
            head = self.read(addr, 24)
            if head[:4] != b"TREE" or head[4] != 1:
                raise ValueError(f"{self.path}: bad chunk B-tree node at {addr}")
            level, (used,) = head[5], struct.unpack_from("<H", head, 6)
            body = self.read(addr + 24, used * (key + 8) + key)
            for i in range(used):
                pos = i * (key + 8)
                size, mask = struct.unpack_from("<II", body, pos)
                offsets = struct.unpack_from(f"<{rank}Q", body, pos + 8)
                (child,) = struct.unpack_from("<Q", body, pos + key)
                if level > 0:
                    stack.append(child)
                else:
                    out[offsets] = (child, size, mask)
        return out

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


def _selection(key, shape: tuple):
    """numpy basic index -> (the bounding box [(start, stop)] a dimension,
    the index that cuts the result out of the box)."""
    if not isinstance(key, tuple):
        key = (key,)
    if sum(k is Ellipsis for k in key) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError(f"too many indices for a dataset of {len(shape)} dimensions")
    key = key + (slice(None),) * (len(shape) - len(key))
    box, cut = [], []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step <= 0:
                raise ValueError("slice steps must be positive")
            box.append((start, max(start, stop)))
            cut.append(slice(None, None, step))
        elif isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(k)} is out of range for a dimension of {n}")
            box.append((i, i + 1))
            cut.append(0)
        else:
            raise TypeError(f"index {k!r}: only integers, slices and ... are supported")
    return box, tuple(cut)


class Dataset:
    """A dataset at the file's root: ``shape``, ``dtype``, and reads by
    numpy basic slicing."""

    def __init__(self, reader: _Reader, name: str, messages: list):
        self.name = "/" + name
        self._reader = reader
        self._filters, layout, fill = [], None, None
        shape = dtype = None
        for mtype, flags, body in messages:
            if mtype == 0x01:
                shape = _parse_shape(body)
            elif mtype == 0x03:
                if flags & 0x02:
                    raise ValueError(f"{self.name}: a shared (committed) datatype is "
                                     "not supported")
                dtype = _parse_dtype(body)
            elif mtype in (0x04, 0x05):
                fill = _parse_fill(mtype, body) if fill is None else fill
            elif mtype == 0x08:
                layout = _parse_layout(body)
            elif mtype == 0x0B:
                self._filters = _parse_filters(body)
            elif mtype not in SKIPPED_MESSAGES and mtype != 0x10:
                raise ValueError(f"{self.name}: object header message type "
                                 f"0x{mtype:04x} is not supported")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.name}: a dataset needs a dataspace, a datatype "
                             "and a layout message")
        self.shape, self.dtype = tuple(int(n) for n in shape), dtype
        self._layout = layout
        self._fill = (np.frombuffer(fill, dtype)[0] if fill and len(fill) == dtype.itemsize
                      else dtype.type(0))
        self.chunks = layout[2] if layout[0] == "chunked" else None
        if self._filters and not self.chunks:
            raise ValueError(f"{self.name}: filters on an unchunked dataset")
        self._index = None
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __array__(self, dtype=None, copy=None):
        out = self[()]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        if isinstance(key, tuple) and key == () and not self.shape:
            return self._read_box([])[()]
        box, cut = _selection(key, self.shape)
        return np.ascontiguousarray(self._read_box(box)[cut])

    def _read_box(self, box: list) -> np.ndarray:
        kind = self._layout[0]
        shape = tuple(b - a for a, b in box)
        if kind == "compact":
            full = np.frombuffer(self._layout[1], self.dtype, self.size).reshape(self.shape)
            return full[tuple(slice(a, b) for a, b in box)].copy()
        if kind == "contiguous":
            addr = self._layout[1]
            if addr == UNDEF or self.size == 0 or 0 in shape:
                return np.full(shape, self._fill, self.dtype)
            mm = np.memmap(self._reader.path, self.dtype, "r",
                           self._reader.base + addr, self.shape)
            return np.array(mm[tuple(slice(a, b) for a, b in box)])
        out = np.full(shape, self._fill, self.dtype)
        if 0 in shape:
            return out
        chunks = self.chunks
        ranges = [range(a // c, (b - 1) // c + 1) for (a, b), c in zip(box, chunks)]
        for idx in itertools.product(*ranges):
            origin = tuple(i * c for i, c in zip(idx, chunks))
            data = self._chunk(origin)
            if data is None:
                continue
            src, dst = [], []
            for (a, b), o, c in zip(box, origin, chunks):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = data[tuple(src)]
        return out

    def _chunk(self, origin: tuple):
        """The decoded chunk at ``origin`` (its full chunk shape), or None
        where none was written."""
        with self._lock:
            if self._index is None:
                self._index = self._reader.chunk_index(self._layout[1], self.ndim)
            if origin in self._cache:
                self._cache.move_to_end(origin)
                return self._cache[origin]
        entry = self._index.get(origin)
        if entry is None:
            return None
        addr, size, mask = entry
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        data = self._reader.read(addr, size)
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, _ = self._filters[i]
            if fid == FILTER_DEFLATE:
                data = zlib.decompress(data)
            elif fid == FILTER_SHUFFLE:
                data = _unshuffle(data, self.dtype.itemsize)
            else:
                data = _lzf_decompress(data, nbytes)
        if len(data) != nbytes:
            raise ValueError(f"{self.name}: chunk at {origin} decoded to {len(data)} "
                             f"bytes, expected {nbytes}")
        arr = np.frombuffer(data, self.dtype).reshape(self.chunks)
        with self._lock:
            self._cache[origin] = arr
            while len(self._cache) > max(1, CHUNK_CACHE_BYTES // max(nbytes, 1)):
                self._cache.popitem(last=False)
        return arr


class File:
    """``File(path, "r")`` reads, ``File(path, "w")`` writes (on close) the
    datasets given to ``create_dataset``."""

    def __init__(self, path, mode: str = "r"):
        self.filename = os.fspath(path)
        self.mode = mode
        if mode == "r":
            self._reader = _Reader(self.filename)
            try:
                self._entries = self._root_entries()
            except BaseException:
                self._reader.close()
                raise
            self._open: dict = {}
        elif mode == "w":
            self._reader = None
            self._pending: dict = {}
        else:
            raise ValueError(f"mode {mode!r} is not supported ('r' or 'w')")

    def _root_entries(self) -> "OrderedDict[str, int]":
        msgs = self._reader.messages(self._reader.root_header)
        table = [body for mtype, _, body in msgs if mtype == 0x11]
        if not table:
            kinds = sorted({f"0x{m:04x}" for m, _, _ in msgs})
            raise ValueError(f"{self.filename}: the root group has no symbol table "
                             f"message (new-style groups are not supported; messages "
                             f"{kinds})")
        return self._reader.group_entries(*struct.unpack_from("<QQ", table[0]))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.mode == "w" and self._pending is not None:
            pending, self._pending = self._pending, None
            _write(self.filename, pending)
        elif self._reader is not None:
            self._reader.close()

    def keys(self):
        return list(self._entries if self.mode == "r" else self._pending)

    def __getitem__(self, name: str) -> Dataset:
        if self.mode != "r":
            raise ValueError(f"{self.filename}: opened for writing")
        name = name.lstrip("/")
        if name not in self._entries:
            raise KeyError(f"{self.filename}: no dataset {name!r} at the root")
        if name not in self._open:
            msgs = self._reader.messages(self._entries[name])
            if any(m == 0x11 for m, _, _ in msgs):
                raise ValueError(f"{self.filename}: {name!r} is a group; nested "
                                 "groups are not supported")
            self._open[name] = Dataset(self._reader, name, msgs)
        return self._open[name]

    def values(self):
        return [self[k] for k in self.keys()]

    def create_dataset(self, name: str, data=None, **options):
        """Store ``data`` as a contiguous, uncompressed dataset at the
        root; written when the file closes."""
        if self.mode != "w":
            raise ValueError(f"{self.filename}: not opened for writing")
        if options:
            raise ValueError(f"create_dataset options {sorted(options)} are not "
                             "supported (contiguous, uncompressed datasets only)")
        if not name or "/" in name or not name.isascii() or "\0" in name:
            raise ValueError(f"dataset name {name!r}: a plain ASCII name at the root")
        if name in self._pending:
            raise ValueError(f"{self.filename}: dataset {name!r} exists")
        arr = np.array(data, order="C")  # a copy; 0-d stays 0-d
        _datatype_message(arr.dtype)  # raises for an unsupported dtype
        self._pending[name] = arr


# --- the writer --------------------------------------------------------------

SNOD_ENTRIES = 8     # 2 x the group leaf node K of 4
BTREE_CHILDREN = 32  # 2 x the group internal node K of 16


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                            not np.little_endian) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in IEEE:
        eloc, esize, mloc, msize, bias = IEEE[size]
        bits = order | 0x20  # mantissa normalisation: the leading 1 implied
        return struct.pack("<BBBBIHHBBBBI", 0x11, bits, 8 * size - 1, 0, size, 0,
                           8 * size, eloc, esize, mloc, msize, bias)
    raise ValueError(f"dtype {dtype} is not supported (IEEE floats and integers)")


def _write(path: str, datasets: dict) -> None:
    names = sorted(datasets)
    if len(names) > SNOD_ENTRIES * BTREE_CHILDREN:
        raise ValueError(f"{path}: at most {SNOD_ENTRIES * BTREE_CHILDREN} datasets")
    heap = bytearray(8)  # offset 0: the empty name
    name_off = {}
    for n in names:
        name_off[n] = len(heap)
        heap += _pad8(n.encode() + b"\0")
    heap_size = max(len(heap), 88)  # the library's default data segment
    heap += bytes(heap_size - len(heap))
    groups = [names[i:i + SNOD_ENTRIES] for i in range(0, len(names), SNOD_ENTRIES)] or [[]]

    root_at = 96
    root_len = 16 + 8 + 16
    heap_at = root_at + root_len
    heap_data_at = heap_at + 32
    btree_at = heap_data_at + heap_size
    btree_len = 24 + 8 * (2 * BTREE_CHILDREN + 1) + 8 * 2 * BTREE_CHILDREN
    snod_at = btree_at + btree_len
    snod_len = 8 + 40 * SNOD_ENTRIES
    pos = snod_at + snod_len * len(groups)

    headers, data_at = {}, {}
    for n in names:
        arr = datasets[n]
        msgs_len = len(_dataset_header(arr, 0))
        headers[n] = pos
        pos += msgs_len
    for n in names:
        pos += -pos % 8
        data_at[n] = pos if datasets[n].nbytes else UNDEF
        pos += datasets[n].nbytes
    eof = pos

    out = bytearray()
    out += SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
    out += struct.pack("<HHI", 4, 16, 0)
    out += struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
    out += struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, heap_at)
    assert len(out) == root_at
    out += _object_header([_message(0x11, struct.pack("<QQ", btree_at, heap_at))])
    out += b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", heap_size, 1, heap_data_at)
    out += heap
    node = bytearray(b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", len(groups), UNDEF, UNDEF))
    node += struct.pack("<Q", 0)
    for i, g in enumerate(groups):
        node += struct.pack("<QQ", snod_at + i * snod_len, name_off[g[-1]] if g else 0)
    out += node + bytes(btree_len - len(node))
    for g in groups:
        snod = bytearray(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(g)))
        for n in g:
            snod += struct.pack("<QQII16x", name_off[n], headers[n], 0, 0)
        out += snod + bytes(snod_len - len(snod))
    for n in names:
        assert len(out) == headers[n]
        out += _dataset_header(datasets[n], data_at[n])
    for n in names:
        out += bytes(-len(out) % 8)
        out += datasets[n].tobytes()
    assert len(out) == eof
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)


def _dataset_header(arr: np.ndarray, data_at: int) -> bytes:
    rank = arr.ndim
    space = struct.pack("<BBB5x", 1, rank, 0) + struct.pack(f"<{rank}Q", *arr.shape)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)  # late allocation, fill if set, undefined
    layout = struct.pack("<BBQQ", 3, 1, data_at, arr.nbytes)
    return _object_header([_message(0x01, space), _message(0x03, _datatype_message(arr.dtype), 1),
                           _message(0x05, fill, 1), _message(0x08, layout)])
