"""The port's own HDF5 reader and writer (``avvad_tpu_torch/hdf5.py``)
against h5py: files h5py writes (contiguous, compact, chunked with per-frame
chunks and with enough chunks for a multi-level B-tree, LZF, gzip with
shuffle, 1-4 dimensions, float32 / float64 / int16 / uint8, big-endian, a
512-byte user block, attributes) read bit for bit; files ``hdf5.py`` writes
read by h5py bit for bit; slices equal numpy's; the host library's LZF
decoder equal to its Python twin; each unsupported feature raising its
named error; the JAX builders' tree read as h5py reads it; and the port's
corpus path in an interpreter where h5py cannot be imported.
"""

import os
import struct
import subprocess
import sys

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from avvad_tpu_torch import hdf5, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["<f4", "<f8", "<i2", "|u1", ">f4", ">f8", ">i2", "<i8", "<u2", ">i4"]


def _data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -30000), min(info.max, 30000), size=shape,
                        endpoint=True).astype(dt)


def _assert_same(got, ref):
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


# --- files h5py writes ------------------------------------------------------


@st.composite
def _dataset(draw):
    rank = draw(st.integers(1, 4))
    shape = tuple(draw(st.lists(st.integers(0 if rank > 1 else 1, 7), min_size=rank,
                                max_size=rank)))
    dtype = draw(st.sampled_from(DTYPES))
    storage = draw(st.sampled_from(["contiguous", "compact", "chunked", "lzf", "gzip"]))
    chunks = tuple(draw(st.integers(1, 4)) for _ in range(rank))
    return shape, dtype, storage, chunks


def _write_h5py(path, name, data, storage, chunks, **file_kw):
    with h5py.File(path, "w", **file_kw) as f:
        kw = {}
        if storage != "contiguous" and data.size:
            if storage == "compact":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                space = h5py.h5s.create_simple(data.shape)
                tid = h5py.h5t.py_create(data.dtype)
                dsid = h5py.h5d.create(f.id, name.encode(), tid, space, dcpl=dcpl)
                dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
                return
            kw["chunks"] = tuple(min(c, n) for c, n in zip(chunks, data.shape))
            if storage == "lzf":
                kw["compression"] = "lzf"
            elif storage == "gzip":
                kw.update(compression="gzip", shuffle=True)
        f.create_dataset(name, data=data, **kw)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(spec=_dataset(), seed=st.integers(0, 2**16))
def test_h5py_files_read_bit_for_bit(tmp_path, spec, seed):
    shape, dtype, storage, chunks = spec
    data = _data(shape, dtype, seed)
    path = str(tmp_path / "p.h5")
    _write_h5py(path, "X", data, storage, chunks)
    with hdf5.File(path) as f:
        assert f.keys() == ["X"]
        d = f["X"]
        assert d.shape == data.shape and d.dtype == data.dtype
        _assert_same(d[:], data)
        _assert_same(np.array(d), data)
        # a slice of the last axis, as FrameStore and the loaders cut windows
        lo = shape[-1] // 3
        _assert_same(d[..., lo:lo + 2], data[..., lo:lo + 2])


@pytest.mark.parametrize("compression", [None, "lzf", "gzip"])
def test_per_frame_chunks_in_a_multi_level_btree(tmp_path, compression):
    """(67, 67, 300) with one chunk a frame, as the JAX builders write lip
    video: 300 chunks need a chunk B-tree of two levels (64 a node)."""
    data = _data((67, 67, 300), "<f4", 1)
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=data, chunks=(67, 67, 1), compression=compression,
                         shuffle=compression == "gzip")
    with hdf5.File(path) as f:
        d = f["X"]
        pipeline = {None: [], "lzf": [hdf5.FILTER_LZF],
                    "gzip": [hdf5.FILTER_SHUFFLE, hdf5.FILTER_DEFLATE]}[compression]
        assert d.chunks == (67, 67, 1) and [fid for fid, _ in d._filters] == pipeline
        node = f._reader.read(d._layout[1], 8)
        assert node[:4] == b"TREE" and node[5] >= 1  # the root is an internal node
        _assert_same(d[:], data)
        _assert_same(d[..., 123], data[..., 123])
        _assert_same(d[3:60:7, 1, 290:], data[3:60:7, 1, 290:])


def test_matlab_style_file_with_a_user_block_and_attributes(tmp_path):
    """A MATLAB v7.3-style file: a 512-byte user block, one float64
    dataset with a MATLAB_class attribute; f.values() as read_mat_dct
    iterates it."""
    from avvad_tpu_torch.processing.video import read_mat_dct

    data = _data((40, 4489), "<f8", 2)
    path = str(tmp_path / "s1.mat")
    with h5py.File(path, "w", userblock_size=512) as f:
        d = f.create_dataset("dctFrames", data=data)
        d.attrs["MATLAB_class"] = np.bytes_("double")
        f.attrs["note"] = 3
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file".ljust(128, b" "))
    with hdf5.File(path) as f:
        assert [v.name for v in f.values()] == ["/dctFrames"]
    _assert_same(read_mat_dct(path), data)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_dtypes_and_ranks(tmp_path, dtype, rank):
    data = _data((3, 5, 2, 4)[:rank], dtype, rank)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=data)
        f.create_dataset("b", data=data, chunks=True, compression="lzf")
        f.create_dataset("s", data=data.reshape(-1)[0])
    with hdf5.File(path) as f:
        _assert_same(f["a"][:], data)
        _assert_same(f["b"][:], data)
        assert f["s"].shape == () and f["s"][()] == data.reshape(-1)[0]


def test_fill_value_of_unwritten_chunks(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        d = f.create_dataset("Q", shape=(5, 4), dtype="<f4", chunks=(2, 2), fillvalue=7.5)
        d[0:2, 0:2] = 1.0
        f.create_dataset("E", shape=(3, 0), dtype="<f8")
    with h5py.File(path) as f, hdf5.File(path) as g:
        _assert_same(g["Q"][:], f["Q"][:])
        _assert_same(g["E"][:], f["E"][:])


# --- slices ----------------------------------------------------------------

SLICES = [np.s_[:], np.s_[...], np.s_[2], np.s_[-1], np.s_[1:4], np.s_[..., 3],
          np.s_[..., 2:9], np.s_[:, 1], np.s_[::2, ::3], np.s_[5:1], np.s_[1, 2, 3],
          np.s_[-3:, :, -2], np.s_[..., ::4], np.s_[0:7:3, ..., 1:2]]


@pytest.mark.parametrize("storage", ["contiguous", "chunked", "lzf"])
@pytest.mark.parametrize("key", SLICES, ids=[str(i) for i in range(len(SLICES))])
def test_slices_equal_numpy(tmp_path, storage, key):
    data = _data((6, 7, 10), "<f4", 3)
    path = str(tmp_path / "s.h5")
    _write_h5py(path, "X", data, storage, (4, 3, 3))
    with hdf5.File(path) as f:
        got = f["X"][key]
    want = data[key]
    assert np.asarray(got).dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_bad_indices_raise(tmp_path):
    path = str(tmp_path / "b.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=np.zeros((2, 3), np.float32))
    with hdf5.File(path) as f:
        with pytest.raises(IndexError):
            f["X"][2]
        with pytest.raises(IndexError):
            f["X"][0, 0, 0]
        with pytest.raises(ValueError, match="steps must be positive"):
            f["X"][::-1]
        with pytest.raises(TypeError, match="only integers, slices"):
            f["X"][[0, 1]]
        with pytest.raises(KeyError, match="no dataset 'Y'"):
            f["Y"]


# --- files hdf5.py writes --------------------------------------------------


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shapes=st.lists(st.lists(st.integers(0, 6), min_size=0, max_size=4),
                       min_size=1, max_size=12),
       dtypes=st.lists(st.sampled_from(DTYPES), min_size=12, max_size=12))
def test_written_files_read_by_h5py(tmp_path, shapes, dtypes):
    arrays = {f"d{i:02d}_{dt.strip('<>|')}": _data(tuple(s), dt, i)
              for i, (s, dt) in enumerate(zip(shapes, dtypes))}
    path = str(tmp_path / "w.h5")
    with hdf5.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for k, v in arrays.items():
            # h5py hands a scalar back in native byte order
            assert f[k].dtype == v.dtype and f[k].shape == v.shape
            _assert_same(np.asarray(f[k][()]).astype(f[k].dtype), v)
    with hdf5.File(path) as f:
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype
            _assert_same(np.asarray(f[k][()]).astype(f[k].dtype), v)


def test_written_file_with_many_datasets(tmp_path):
    """More names than one symbol node holds (8): several nodes under the
    group B-tree, in name order."""
    path = str(tmp_path / "m.h5")
    with hdf5.File(path, "w") as f:
        for i in reversed(range(50)):
            f.create_dataset(f"X_{i:02d}_mean", data=np.full((3, 1), i, np.float32))
    with h5py.File(path) as f:
        assert list(f.keys()) == [f"X_{i:02d}_mean" for i in range(50)]
        assert [float(f[f"X_{i:02d}_mean"][1, 0]) for i in range(50)] == list(range(50))


def test_writer_statistics_file_round_trip(tmp_path):
    """save_statistics writes through hdf5.py: h5py and the JAX reader read
    the same mean and std."""
    from avvad_tpu.data.statistics import load_statistics as jload
    from avvad_tpu_torch.data.statistics import load_statistics, save_statistics

    path = str(tmp_path / "stats" / "s.h5")
    mean, std = _data((513,), "<f4", 4), np.abs(_data((513,), "<f4", 5))
    save_statistics(path, mean, std)
    for got in (load_statistics(path), jload(path)):
        _assert_same(got[0], mean[:, None])
        _assert_same(got[1], std[:, None])


# --- LZF ---------------------------------------------------------------------


def _lzf_chunks(tmp_path):
    """Raw LZF chunks as h5py's filter wrote them -> [(bytes, decoded size)]
    (a chunk LZF could not shrink is stored raw, its filter-mask bit set:
    it is no LZF input and is left out)."""
    rng = np.random.default_rng(6)
    smooth = np.floor(np.cumsum(rng.normal(size=(40, 33, 9)), axis=0)).astype(np.float32)
    runs = np.repeat(rng.integers(0, 5, size=(40, 33, 1)), 9, axis=2).astype(np.int16)
    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("a", data=smooth, chunks=(40, 33, 1), compression="lzf")
        f.create_dataset("b", data=runs, chunks=(7, 33, 9), compression="lzf")
        f.create_dataset("c", data=np.zeros((300, 300), np.uint8), chunks=(300, 300),
                         compression="lzf")
    out = []
    with hdf5.File(path) as f:
        for name in ("a", "b", "c"):
            d = f[name]
            index = f._reader.chunk_index(d._layout[1], d.ndim)
            nbytes = int(np.prod(d.chunks)) * d.dtype.itemsize
            for addr, size, mask in index.values():
                if mask == 0:
                    out.append((f._reader.read(addr, size), nbytes))
    return out


@pytest.mark.skipif(not native.available(), reason="the host library needs g++")
def test_lzf_decoder_equals_its_python_twin(tmp_path):
    chunks = _lzf_chunks(tmp_path)
    assert len(chunks) > 10
    for raw, n in chunks:
        assert len(raw) < n  # compressed
        assert native.lzf_decompress(raw, n) == hdf5.lzf_decompress_py(raw, n)
    # corrupt input and a wrong size raise on both routes
    raw, n = chunks[0]
    for bad, size in ((raw[:-3], n), (raw, n - 1), (raw, n + 1), (b"\x40\x00", 8)):
        with pytest.raises(ValueError, match="LZF chunk"):
            native.lzf_decompress(bad, size)
        with pytest.raises(ValueError, match="LZF chunk"):
            hdf5.lzf_decompress_py(bad, size)


def test_lzf_without_the_host_library_raises(tmp_path, monkeypatch):
    """No quiet Python route: an LZF chunk needs the host library."""
    path = str(tmp_path / "l.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=np.zeros((4, 4), np.float32), chunks=(2, 2),
                         compression="lzf")

    def no_library():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load", no_library)
    with hdf5.File(path) as f:
        with pytest.raises(RuntimeError, match="LZF-compressed HDF5 chunk needs the host"):
            f["X"][:]


# --- what is not supported raises, named -----------------------------------


def _unsupported(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    if kind == "superblock":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("X", data=np.zeros(3))
    elif kind == "not_hdf5":
        with open(path, "wb") as fh:
            fh.write(b"\0" * 4096)
    else:
        with h5py.File(path, "w") as f:
            if kind == "string":
                f.create_dataset("X", data=np.array([b"ab", b"cd"]))
            elif kind == "compound":
                f.create_dataset("X", data=np.zeros(3, dtype=[("a", "<f4"), ("b", "<i2")]))
            elif kind == "enum":
                f.create_dataset("X", data=np.array([True, False]))
            elif kind == "fletcher32":
                f.create_dataset("X", data=np.zeros(8, np.float32), chunks=(4,),
                                 fletcher32=True)
            elif kind == "scaleoffset":
                f.create_dataset("X", data=np.zeros(8, np.int32), chunks=(4,), scaleoffset=0)
            elif kind == "group":
                f.create_group("g").create_dataset("X", data=np.zeros(3))
            elif kind == "complex":
                f.create_dataset("X", data=np.zeros(3, np.complex64))
    return path


UNSUPPORTED = {"superblock": "superblock version 3", "not_hdf5": "no HDF5 signature",
               "string": r"datatype class 3 \(string\)",
               "compound": r"datatype class 6 \(compound\)",
               "enum": r"datatype class 8 \(enumerated\)",
               "complex": r"datatype class 6 \(compound\)",
               "fletcher32": r"filter 3 \(fletcher32\)",
               "scaleoffset": r"filter 6 \(scaleoffset\)",
               "group": "'g' is a group; nested groups"}


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
def test_unsupported_features_raise_their_named_error(tmp_path, kind):
    path = _unsupported(tmp_path, kind)
    with pytest.raises(ValueError, match=UNSUPPORTED[kind]):
        with hdf5.File(path) as f:
            for k in f.keys():
                f[k][...]


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with hdf5.File(str(tmp_path / "w.h5"), "w") as f:
        with pytest.raises(ValueError, match=r"options \['compression'\]"):
            f.create_dataset("X", data=np.zeros(3), compression="lzf")
        with pytest.raises(ValueError, match="dtype complex64"):
            f.create_dataset("X", data=np.zeros(3, np.complex64))
        with pytest.raises(ValueError, match="plain ASCII name at the root"):
            f.create_dataset("g/X", data=np.zeros(3))
        f.create_dataset("X", data=np.zeros(3))
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("X", data=np.zeros(3))
    with pytest.raises(ValueError, match="mode 'a'"):
        hdf5.File(str(tmp_path / "w.h5"), "a")


def test_unknown_header_message_raises(tmp_path):
    """A header message type the reader does not know (here a dataset's
    fill value message rewritten as type 0x0019) is named, not skipped."""
    path = str(tmp_path / "u.h5")
    with hdf5.File(path, "w") as f:
        f.create_dataset("X", data=np.zeros(3, np.float32))
    blob = bytearray(open(path, "rb").read())
    fill = struct.pack("<HHB3x", 0x05, 8, 1) + struct.pack("<BBBB", 2, 2, 2, 0)
    at = blob.index(fill)
    blob[at:at + 2] = struct.pack("<H", 0x19)
    open(path, "wb").write(bytes(blob))
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="message type 0x0019"):
            f["X"]


# --- the committed fixtures (read on the card too, by chip_smoke.py) -------

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE_FILES = ["hdf5_jax_video_lzf.h5", "hdf5_matlab_v73.mat"]


@pytest.mark.parametrize("fname", FIXTURE_FILES)
def test_committed_fixtures_read_as_h5py_reads_them(fname):
    """tests/fixtures/make_hdf5_fixtures.py's files: the arrays bit for bit
    and their SHA-256 as the JSON records them (chip_smoke.py holds the
    card's reading to it); the video's 66 LZF chunks in a two-level chunk
    B-tree, each decoded alike by the host library and its Python twin;
    the .mat's superblock after its 512-byte user block, its one chunked
    dataset through shuffle and deflate, as read_mat_dct reads it."""
    import hashlib
    import json

    from avvad_tpu_torch.processing.video import read_mat_dct

    with open(os.path.join(FIXTURES, "hdf5_fixtures.json")) as f:
        meta = json.load(f)[fname]
    path = os.path.join(FIXTURES, fname)
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        assert f.keys() == list(ref.keys()) == list(meta)
        for name, want in meta.items():
            got = f[name][()]
            _assert_same(got, ref[name][()])
            assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
            d = f[name]
            index = f._reader.chunk_index(d._layout[1], d.ndim)
            if fname.endswith(".h5"):
                assert [fid for fid, _ in d._filters] == [hdf5.FILTER_LZF]
                assert f._reader.read(d._layout[1], 8)[5] == 1  # the root's level
                chunks = [f._reader.read(a, n) for a, n, mask in index.values() if mask == 0]
                assert len(chunks) == want["lzf_chunks"] == 66
                nbytes = int(np.prod(d.chunks)) * 4
                for c in chunks:
                    assert native.lzf_decompress(c, nbytes) == hdf5.lzf_decompress_py(c, nbytes)
            else:
                assert f._reader.base == 512 and len(index) == 8
                assert [fid for fid, _ in d._filters] == [hdf5.FILTER_SHUFFLE,
                                                          hdf5.FILTER_DEFLATE]
                _assert_same(read_mat_dct(path), ref[name][()])


# --- the corpus ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The JAX builders' processed tree (LZF, per-frame chunks) of
    tests/test_torch_port_data.py's raw corpus, train split."""
    from avvad_tpu import builders as jbuilders
    from test_torch_port_data import build_tree, write_raw_corpus

    raw = write_raw_corpus(str(tmp_path_factory.mktemp("raw")))
    out = str(tmp_path_factory.mktemp("proc_jax")) + os.sep
    build_tree(jbuilders, raw, out, splits=("train",))
    return out


def test_jax_builders_tree_reads_as_h5py_reads_it(jax_tree):
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(jax_tree) for f in fs
                   if f.endswith(".h5"))
    assert len(files) >= 10
    lzf = 0
    for path in files:
        with h5py.File(path, "r") as f, hdf5.File(path) as g:
            assert g.keys() == list(f.keys())
            for k in f:
                _assert_same(g[k][:], f[k][:])
                lzf += [fid for fid, _ in g[k]._filters] == [hdf5.FILTER_LZF]
    assert lzf >= 10


def test_corpus_path_without_h5py(tmp_path):
    """In a fresh interpreter where ``import h5py`` fails: the raw tree
    (its .mat files by hdf5.py), the port's builders, the sources and one
    DataLoader batch, and the frame-store sources."""
    code = f"""
import sys
sys.modules["h5py"] = None
sys.path.insert(0, {ROOT!r})
import pathlib
import numpy as np
import chip_smoke
from avvad_tpu_torch import builders
from avvad_tpu_torch.data import (AudioVisualSource, DataLoader, SpectrogramFrameSource,
                                  VideoSequenceSource, load_statistics)
root = pathlib.Path({str(tmp_path)!r})
chip_smoke.write_raw_corpus(root / "raw", {{"train": 4}}, seed=0, dur=(1.0, 1.4))
out = str(root / "proc") + "/"
cfg = builders.BuildConfig(raw_dir=str(root / "raw") + "/", processed_dir=out,
                           dataset_size="subset", upsampled_suffix=True, max_workers=0)
assert builders.build_video_split(cfg, "train") == 4
assert builders.build_audio_split(cfg, "train") == 8
assert builders.build_frame_store(cfg, "train", out + "frames.h5") > 0
src = AudioVisualSource(out, "train")
batch = next(iter(DataLoader(src, batch_size=2, bucket=32)))
assert batch.audio.shape[0] == 2 and batch.video.shape[2:] == (67, 67)
assert np.isfinite(batch.audio).all() and np.isfinite(batch.video).all()
assert VideoSequenceSource(out, "train").probe_length(0) > 0
assert SpectrogramFrameSource(out + "frames.h5", "train")[3]["audio"].shape == (513,)
m, s = load_statistics(out + "ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.h5")
assert m.shape == (513, 1) and (s > 0).all()
assert sys.modules["h5py"] is None and "jax" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"
