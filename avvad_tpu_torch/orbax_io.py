"""A reader and writer for the Orbax checkpoints of the JAX package, with
numpy, torch and the standard library only.

The JAX package saves with ``orbax.checkpoint.StandardCheckpointer``
(``avvad_tpu/train/checkpoint.py``), which stores through TensorStore.
The card's machine has neither, nor a zstd module, so the port reads and
writes that layout itself; its zstd decoder and CRC-32C are the host
library's (``native.py``). A checkpoint directory holds:

- ``_METADATA``: the tree as JSON (``tree_metadata``: for each leaf its
  keys with their kinds, 1 a sequence index and 2 a dict key, and its
  ``value_type``: ``jax.Array``, ``np.ndarray``, ``scalar`` or ``None``,
  the last for an empty node such as optax's masked moments);
  ``_CHECKPOINT_METADATA``, ``_sharding`` and ``array_metadatas/`` are
  Orbax's own and not needed to read;
- an OCDBT key-value store (TensorStore's "optionally-cooperative
  distributed B+tree"): ``manifest.ocdbt`` at the root, the merge of the
  per-process stores ``ocdbt.process_<i>/``, and ``d/`` data files. Every
  manifest and node is a file (or a slice of a data file) that starts with
  a magic number and its length, states its version and compression (none
  or zstd) and ends in a CRC-32C. The manifest holds the configuration,
  the newest versions inline and references to version-tree nodes for
  older ones; a version names the root of a B+tree whose interior nodes
  hold prefix-coded keys and child references and whose leaves hold
  prefix-coded keys and values, inline or as (data file, offset, length);
- in that store, one zarr v2 array a leaf: ``<name>/.zarray`` (JSON:
  shape, chunks, dtype, compressor none or zstd, C order) and one key a
  chunk, ``<name>/<i>.<j>...`` (``0`` for a 0-d array). A checkpoint saved
  under a mesh holds one chunk a shard.

``read_checkpoint(path)`` gives the tree as nested dicts (lists where the
keys were sequence indices) of numpy arrays (bfloat16 as
``torch.bfloat16`` tensors), Python scalars and ``None``.
``write_checkpoint(path, tree)`` writes a directory that Orbax restores:
one data file, one uncompressed B+tree leaf and an uncompressed manifest,
chunks uncompressed. Anything outside what is described here (numbered
manifests, zarr v3, filters, Fortran order, another compressor or dtype)
raises an ``OrbaxFormatError`` that names what it met; nothing is read
partially.
"""

from __future__ import annotations

import base64
import json
import os
import re
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import native

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
MANIFEST = "manifest.ocdbt"
METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
# zarr v2 dtype strings of the train states (and of Python int scalars,
# "<i8") -> numpy (bfloat16: its bits)
DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
          "|i1": np.int8, "bfloat16": np.uint16}
_ZARR_NAMES = {np.dtype(v).str: k for k, v in DTYPES.items() if k != "bfloat16"}
_SEQUENCE, _DICT = 1, 2
# threads that decode a checkpoint's arrays
DECODE_THREADS = 8


class OrbaxFormatError(ValueError):
    """A checkpoint the reader cannot read as it stands: malformed, or
    outside the subset of Orbax / OCDBT / zarr that it covers."""


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an Orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, CHECKPOINT_METADATA)) or \
        os.path.isfile(os.path.join(path, MANIFEST))


# --- OCDBT ------------------------------------------------------------------


class _Cursor:
    """Bounds-checked reads over one decoded body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise OrbaxFormatError(f"{self.what}: truncated")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise OrbaxFormatError(f"{self.what}: {len(self.buf) - self.pos} bytes "
                                   "left over at the end")


def _decode_file(buf: bytes, magic: int, what: str) -> _Cursor:
    """A manifest or node's encoded bytes -> a cursor on its (decompressed)
    body: magic (big endian), length (uint64), version and compression
    (varints), body, CRC-32C (uint32) of all that precedes it."""
    if len(buf) < 18:
        raise OrbaxFormatError(f"{what}: {len(buf)} bytes, too short")
    got = int.from_bytes(buf[:4], "big")
    if got != magic:
        raise OrbaxFormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(buf[4:12], "little")
    if length != len(buf):
        raise OrbaxFormatError(f"{what}: states {length} bytes, holds {len(buf)}")
    if native.crc32c(buf[:-4]) != int.from_bytes(buf[-4:], "little"):
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    head = _Cursor(buf[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version} is not supported")
    body = buf[head.pos:-4]
    if compression == 1:
        try:
            body = native.zstd_decompress(body).tobytes()
        except native.ZstdError as e:
            raise OrbaxFormatError(f"{what}: {e}") from e
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: compression {compression} is not supported")
    return _Cursor(body, what)


def _data_files(c: _Cursor) -> list:
    """The data file table: the paths, each coded as the length of the prefix
    it shares with the one before and its suffix (plus a base-path length
    that only marks where the base path ends)."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base path lengths
    paths: list = []
    for p, s in zip(prefix, suffix):
        prev = paths[-1] if paths else b""
        if p > len(prev):
            raise OrbaxFormatError(f"{c.what}: data file path prefix past its end")
        paths.append(prev[:p] + c.take(s))
    out = []
    for p in paths:
        name = p.decode()
        if name.startswith("/") or ".." in name.split("/"):
            raise OrbaxFormatError(f"{c.what}: data file path {name!r} leaves the store")
        out.append(name)
    return out


def _refs(c: _Cursor, files: list, n: int) -> list:
    """n references as columns: data file ids, offsets, lengths."""
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    for i in ids:
        if i >= len(files):
            raise OrbaxFormatError(f"{c.what}: data file id {i} of {len(files)}")
    return [(files[i], o, n_) for i, o, n_ in zip(ids, offsets, lengths)]


def _key_lengths(c: _Cursor, n: int) -> tuple:
    """The columns of n prefix-coded keys: the length each shares with the
    key before it, and the length of the rest (whose bytes come later)."""
    prefix = [0] + c.varints(n - 1) if n else []
    return prefix, c.varints(n)


def _join_keys(c: _Cursor, prefix: list, suffix: list) -> list:
    keys: list = []
    for p, s in zip(prefix, suffix):
        prev = keys[-1] if keys else b""
        if p > len(prev):
            raise OrbaxFormatError(f"{c.what}: key prefix past the previous key")
        keys.append(prev[:p] + c.take(s))
    return keys


class OcdbtStore:
    """The newest version of one OCDBT store (a directory with
    ``manifest.ocdbt``): ``items()`` -> {key: value bytes}."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict = {}
        c = self._manifest()
        self.uuid = c.take(16).hex()
        kind = c.varint()
        if kind != 0:
            raise OrbaxFormatError(f"{self._where(MANIFEST)}: numbered manifests "
                                   f"(kind {kind}) are not supported")
        self.max_inline_value_bytes = c.varint()
        self.max_decoded_node_bytes = c.varint()
        self.version_tree_arity_log2 = c.byte()
        method = c.varint()
        if method == 1:
            c.u32()  # zstd level
        elif method != 0:
            raise OrbaxFormatError(f"{self._where(MANIFEST)}: compression method "
                                   f"{method} is not supported")
        files = _data_files(c)
        self.versions = self._version_leaf(c, files)
        self.version_nodes = self._version_refs(c, files, interior=False)
        c.done()
        if not self.versions:
            raise OrbaxFormatError(f"{self._where(MANIFEST)}: no version")

    def _where(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _manifest(self) -> _Cursor:
        path = self._where(MANIFEST)
        with open(path, "rb") as f:
            return _decode_file(f.read(), MANIFEST_MAGIC, path)

    def _read(self, ref: tuple) -> bytes:
        name, offset, length = ref
        f = self._files.get(name)
        if f is None:
            path = self._where(name)
            if not os.path.isfile(path):
                raise OrbaxFormatError(f"{self.root}: data file {name} is missing")
            f = self._files[name] = open(path, "rb")
        f.seek(offset)
        out = f.read(length)
        if len(out) != length:
            raise OrbaxFormatError(f"{self._where(name)}: {length} bytes at {offset} "
                                   f"asked, {len(out)} there")
        return out

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    @staticmethod
    def _version_leaf(c: _Cursor, files: list) -> list:
        """Versions as columns: generation, root height, root reference,
        root statistics (keys, tree bytes, indirect value bytes), commit
        time."""
        n = c.varint()
        generation = c.varints(n)
        height = [c.byte() for _ in range(n)]
        roots = _refs(c, files, n)
        stats = [c.varints(n) for _ in range(3)]
        commit = [c.u64() for _ in range(n)]
        return [{"generation": g, "height": h, "root": r, "num_keys": k,
                 "commit_time": t}
                for g, h, r, k, t in zip(generation, height, roots, stats[0], commit)]

    @staticmethod
    def _version_refs(c: _Cursor, files: list, interior: bool) -> list:
        """References to version-tree nodes as columns: generation, node
        reference, number of generations, commit time (and, in the
        manifest, each node's height)."""
        n = c.varint()
        generation = c.varints(n)
        refs = _refs(c, files, n)
        count = c.varints(n)
        commit = [c.u64() for _ in range(n)]
        height = [None] * n if interior else [c.byte() for _ in range(n)]
        return [{"generation": g, "ref": r, "num_generations": k, "commit_time": t,
                 "height": h}
                for g, r, k, t, h in zip(generation, refs, count, commit, height)]

    def all_versions(self) -> list:
        """Every version, the older ones from the version tree's nodes."""
        out: list = []

        def walk(ref: tuple, height: int) -> None:
            c = _decode_file(self._read(ref), VERSION_MAGIC, f"{self.root}: version node")
            if c.byte() != self.version_tree_arity_log2:
                raise OrbaxFormatError(f"{c.what}: arity differs from the manifest's")
            if c.byte() != height:
                raise OrbaxFormatError(f"{c.what}: height differs from its reference")
            files = _data_files(c)
            if height == 0:
                out.extend(self._version_leaf(c, files))
            else:
                for child in self._version_refs(c, files, interior=True):
                    walk(child["ref"], height - 1)
            c.done()

        for node in self.version_nodes:
            walk(node["ref"], node["height"])
        return out + self.versions

    def items(self) -> dict:
        """The newest version's keys and values (bytes -> bytes)."""
        v = self.versions[-1]
        out: dict = {}
        self._node(v["root"], v["height"], b"", out)
        if len(out) != v["num_keys"]:
            raise OrbaxFormatError(f"{self.root}: read {len(out)} keys, the manifest "
                                   f"states {v['num_keys']}")
        return out

    def _node(self, ref: tuple, height: int, prefix: bytes, out: dict) -> None:
        c = _decode_file(self._read(ref), BTREE_MAGIC,
                         f"{self._where(ref[0])}: B-tree node at {ref[1]}")
        got = c.byte()
        if got != height:
            raise OrbaxFormatError(f"{c.what}: height {got}, expected {height}")
        files = _data_files(c)
        n = c.varint()
        pre, suf = _key_lengths(c, n)
        if height == 0:
            keys = _join_keys(c, pre, suf)
            lengths = c.varints(n)
            kinds = c.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise OrbaxFormatError(f"{c.what}: value kind {max(kinds)}")
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            ids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
            where = dict(zip(indirect, zip(ids, offsets)))
            for i, key in enumerate(keys):
                if kinds[i] == 0:
                    out[prefix + key] = c.take(lengths[i])
                else:
                    fid, off = where[i]
                    if fid >= len(files):
                        raise OrbaxFormatError(f"{c.what}: data file id {fid}")
                    out[prefix + key] = self._read((files[fid], off, lengths[i]))
            c.done()
            return
        common = c.varints(n)
        keys = _join_keys(c, pre, suf)
        children = _refs(c, files, n)
        for _ in range(3):  # the children's statistics
            c.varints(n)
        c.done()
        for key, k, child in zip(keys, common, children):
            if k > len(key):
                raise OrbaxFormatError(f"{c.what}: subtree prefix past its key")
            self._node(child, height - 1, prefix + key[:k], out)


def read_store(path: str) -> dict:
    """A checkpoint directory's key-value store: the root manifest, or where
    there is none the union of the per-process stores."""
    if os.path.isfile(os.path.join(path, MANIFEST)):
        roots = [path]
    else:
        roots = sorted(os.path.join(path, d) for d in os.listdir(path)
                       if re.fullmatch(r"ocdbt\.process_\d+", d)
                       and os.path.isfile(os.path.join(path, d, MANIFEST)))
        if not roots:
            raise OrbaxFormatError(f"{path}: no {MANIFEST} (is it an OCDBT checkpoint? "
                                   "one array a directory, Orbax's use_ocdbt=False, is "
                                   "not supported)")
    out: dict = {}
    for root in roots:
        store = OcdbtStore(root)
        try:
            items = store.items()
        finally:
            store.close()
        clash = set(out) & set(items)
        if clash:
            raise OrbaxFormatError(f"{root}: key {sorted(clash)[0]!r} in two stores")
        out.update(items)
    return out


# --- zarr v2 -----------------------------------------------------------------


def _zarr_array(store: dict, name: str):
    """One zarr v2 array of the store -> numpy (bfloat16: a torch tensor)."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in store:
        if f"{name}/zarr.json".encode() in store:
            raise OrbaxFormatError(f"{name}: zarr v3 arrays (use_zarr3) are not supported")
        raise OrbaxFormatError(f"{name}: no .zarray in the store")
    meta = json.loads(store[meta_key])
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
    dtype_name = meta.get("dtype")
    if not isinstance(dtype_name, str) or dtype_name not in DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {dtype_name!r} is not supported")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']} are not supported")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r} is not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r} is not supported")
    sep = meta.get("dimension_separator", ".")
    dtype = np.dtype(DTYPES[dtype_name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} do not fit shape {shape}")
    out = np.empty(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}".encode()
        raw = store.get(key)
        if raw is None:
            fill = meta.get("fill_value")
            if fill is None:
                raise OrbaxFormatError(f"{key.decode()}: chunk missing and no fill value")
            block = np.full(chunks, fill, dtype)
        else:
            data = native.zstd_decompress(raw) if comp is not None \
                else np.frombuffer(raw, np.uint8)
            if data.size != chunk_bytes:
                raise OrbaxFormatError(f"{key.decode()}: {data.size} bytes, a chunk of "
                                       f"{chunks} {dtype_name} is {chunk_bytes}")
            block = data.view(dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(index, chunks, shape))
        out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    if dtype_name == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# --- the tree ------------------------------------------------------------------


def _param_name(keys: list) -> str:
    return ".".join(str(k) for k in keys)


def read_checkpoint(path: str) -> dict:
    """An Orbax ``StandardCheckpointer`` directory -> its tree: nested dicts
    (lists for sequence keys) of numpy arrays, bfloat16 ``torch`` tensors,
    Python scalars and ``None``."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise OrbaxFormatError(f"{path}: no {METADATA} (not a StandardCheckpointer "
                               "checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise OrbaxFormatError(f"{meta_path}: no tree_metadata (an older Orbax "
                               "layout is not supported)")
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_path}: zarr v3 arrays (use_zarr3) are not supported")
    store = read_store(path)
    leaves = []
    for entry in tree_meta.values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        if vtype not in ("None", "jax.Array", "np.ndarray", "scalar"):
            raise OrbaxFormatError(f"{path}: leaf {keys} of value type {vtype!r} is "
                                   "not supported")
        leaves.append((keys, vtype))

    def read(leaf):
        keys, vtype = leaf
        if vtype == "None":
            return None
        value = _zarr_array(store, _param_name([k for k, _ in keys]))
        return value.item() if vtype == "scalar" else value

    # the decoder releases the GIL (a ctypes call): arrays decode in parallel
    with ThreadPoolExecutor(max_workers=min(DECODE_THREADS, os.cpu_count() or 1)) as pool:
        values = list(pool.map(read, leaves))
    tree: dict = {}
    for (keys, _), value in zip(leaves, values):
        _insert(tree, keys, value)
    return _sequences(tree)


def _insert(tree: dict, keys: list, value) -> None:
    node = tree
    for key, kind in keys[:-1]:
        node = node.setdefault((key, kind), {})
        if not isinstance(node, dict):
            raise OrbaxFormatError(f"key {key!r} is both a leaf and a node")
    node[keys[-1]] = value


def _sequences(node):
    """{(key, kind): ...} -> dicts, and lists where every key is an index."""
    if not isinstance(node, dict):
        return node
    kinds = {kind for _, kind in node}
    items = {key: _sequences(v) for (key, _), v in node.items()}
    if kinds == {_SEQUENCE}:
        idx = sorted(int(k) for k in items)
        if idx != list(range(len(idx))):
            raise OrbaxFormatError(f"sequence indices {idx} are not 0..n-1")
        return [items[str(i)] for i in idx]
    if _SEQUENCE in kinds:
        raise OrbaxFormatError(f"node mixes sequence and dict keys: {sorted(items)}")
    return items


# --- writing ---------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _encode_file(magic: int, body: bytes) -> bytes:
    """Header (uncompressed, version 0), body and CRC-32C."""
    head_tail = _varint(0) + _varint(0)
    total = 12 + len(head_tail) + len(body) + 4
    buf = magic.to_bytes(4, "big") + total.to_bytes(8, "little") + head_tail + body
    return buf + native.crc32c(buf).to_bytes(4, "little")


def _data_file_table(paths: list) -> bytes:
    return (_varint(len(paths)) + _varints([0] * (len(paths) - 1))
            + _varints(len(p) for p in paths) + _varints([0] * len(paths))
            + b"".join(paths))


def _leaf_node(entries: list, data_file: bytes) -> bytes:
    """entries: sorted [(key, inline bytes or (offset, length))] -> a B-tree
    leaf whose keys are coded whole and indirect values point into
    ``data_file``."""
    n = len(entries)
    keys = [k for k, _ in entries]
    lengths = [len(v) if isinstance(v, bytes) else v[1] for _, v in entries]
    kinds = [0 if isinstance(v, bytes) else 1 for _, v in entries]
    indirect = [v for _, v in entries if not isinstance(v, bytes)]
    prefix = [0] * (n - 1)
    for i in range(1, n):
        a, b = keys[i - 1], keys[i]
        m = 0
        while m < min(len(a), len(b)) and a[m] == b[m]:
            m += 1
        prefix[i - 1] = m
    body = (bytes([0]) + _data_file_table([data_file]) + _varint(n) + _varints(prefix)
            + _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
            + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
            + _varints(lengths) + _varints(kinds)
            + _varints([0] * len(indirect)) + _varints(o for o, _ in indirect)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))
    return _encode_file(BTREE_MAGIC, body)


def _manifest(data_file: bytes, node: tuple, num_keys: int, indirect_bytes: int) -> bytes:
    offset, length = node
    body = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES) + bytes([4]) + _varint(0)
            + _data_file_table([data_file])
            + _varint(1) + _varint(1) + bytes([0])  # one version, generation 1, a leaf
            + _varint(0) + _varint(offset) + _varint(length)
            + _varint(num_keys) + _varint(length) + _varint(indirect_bytes)
            + time.time_ns().to_bytes(8, "little")
            + _varint(0))  # no version-tree nodes
    return _encode_file(MANIFEST_MAGIC, body)


def _leaves(tree, keys=()):
    """-> [(keys as (key, kind) pairs, leaf)] in Orbax's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"dict key {k!r} at {keys}: only str keys are written")
            yield from _leaves(tree[k], keys + ((k, _DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + ((str(i), _SEQUENCE),))
    else:
        yield keys, tree


def _as_array(leaf, where: str) -> tuple:
    """-> (numpy array of the stored bits, zarr dtype name, value type)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", "jax.Array"
        arr, vtype = t.numpy(), "jax.Array"
    elif isinstance(leaf, np.ndarray):
        arr, vtype = leaf, "np.ndarray"
    elif isinstance(leaf, (bool, int, float, np.generic)):
        arr, vtype = np.asarray(leaf), "scalar" if not isinstance(leaf, np.generic) \
            else "np.ndarray"
    else:
        raise TypeError(f"{where}: a leaf of type {type(leaf).__name__} cannot be written")
    name = _ZARR_NAMES.get(arr.dtype.newbyteorder("<").str if arr.dtype.itemsize > 1
                           else arr.dtype.str)
    if name is None:
        raise TypeError(f"{where}: dtype {arr.dtype} cannot be written")
    # (np.ascontiguousarray would make a 0-d array 1-d)
    return np.require(arr, arr.dtype.newbyteorder("<"), "C"), name, vtype


def write_checkpoint(path: str, tree: dict) -> str:
    """Write ``tree`` (nested dicts / lists / tuples of torch tensors, which
    Orbax restores as jax.Array, numpy arrays, Python scalars and ``None``)
    as an Orbax ``StandardCheckpointer`` directory at ``path`` (replaced if
    it exists; staged in a sibling and renamed) -> ``path``."""
    path = os.path.abspath(path)
    tmp = path + ".orbax-checkpoint-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "d"))
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    data_name = f"d/{uuid.uuid4().hex}".encode()
    entries: list = []
    tree_meta, array_meta, sharding = {}, [], {}
    offset = 0
    with open(os.path.join(tmp, data_name.decode()), "wb") as data:
        for keys, leaf in _leaves(tree):
            where = str(tuple(k for k, _ in keys))
            key_meta = [{"key": k, "key_type": kind} for k, kind in keys]
            if leaf is None:
                tree_meta[where] = {"key_metadata": key_meta, "value_metadata": {
                    "value_type": "None", "skip_deserialize": True}}
                continue
            arr, dtype_name, vtype = _as_array(leaf, where)
            name = _param_name([k for k, _ in keys])
            shape = list(arr.shape)
            value_meta = {"value_type": vtype, "skip_deserialize": False}
            if vtype == "jax.Array":
                value_meta["write_shape"] = shape
                # JAX's first CPU device: Orbax's target-less restore (JAX's
                # load_pretrained_trunk) places the array there; JAX's
                # restore_checkpoint falls back on the metadata where it
                # is absent, as for its own checkpoints across platforms
                sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                    {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
            tree_meta[where] = {"key_metadata": key_meta, "value_metadata": value_meta}
            array_meta.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                                  "chunk_shape": shape, "ext_metadata": None}})
            zarray = json.dumps({"chunks": shape, "compressor": None,
                                 "dimension_separator": ".", "dtype": dtype_name,
                                 "fill_value": None, "filters": None, "order": "C",
                                 "shape": shape, "zarr_format": 2},
                                separators=(",", ":")).encode()
            entries.append((f"{name}/.zarray".encode(), zarray))
            chunk_key = f"{name}/{'.'.join(['0'] * len(shape)) if shape else '0'}".encode()
            if arr.nbytes <= MAX_INLINE_VALUE_BYTES:
                entries.append((chunk_key, arr.tobytes()))
            else:
                data.write(memoryview(arr.reshape(-1).view(np.uint8)))
                entries.append((chunk_key, (offset, arr.nbytes)))
                offset += arr.nbytes
        entries.sort(key=lambda e: e[0])
        node = _leaf_node(entries, data_name)
        data.write(node)
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(_manifest(data_name, (offset, len(node)), len(entries), offset))
    now = time.time_ns()
    files = {
        METADATA: {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
        "_sharding": sharding,
        "array_metadatas/process_0": {"array_metadatas": array_meta},
        CHECKPOINT_METADATA: {
            "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
            "commit_timestamp_nsecs": now, "custom_metadata": {}},
    }
    for name, obj in files.items():
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path

