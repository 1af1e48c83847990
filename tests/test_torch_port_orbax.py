"""The port's reader and writer of the JAX package's Orbax checkpoints, on
the CPU (the four model families through them:
tests/test_torch_port_orbax_models.py; the command-line twins:
tests/test_torch_port_orbax_cli.py).

- zstd: the host library's decoder (``native.zstd_decompress``) against
  libzstd, loaded by ctypes here only, on random, repetitive and long-run
  data over several 128 KiB blocks at several levels, with and without the
  content checksum and size, in several frames, and on the frames
  TensorStore wrote (zarr chunks, OCDBT nodes); corrupted and truncated
  frames raise.
- OCDBT: ``orbax_io.OcdbtStore`` against TensorStore on a store with
  interior B-tree nodes and a version tree.
- Checkpoints: one ``AVVAD`` at full width saved by JAX, read and its
  forward compared through JAX's plain LSTM route; a checkpoint saved
  under a 2-device mesh (several chunks an array); a JAX checkpoint
  restored and exported again by two gloo ranks on a 1 x 2 mesh
  (``restore_checkpoint`` / ``export_jax_checkpoint`` with ``mesh=``); the
  dtypes and leaf kinds the reader takes; ``write_checkpoint`` restored by
  Orbax; the committed fixture of tests/fixtures/make_orbax_fixtures.py.
- Named errors for what the reader does not take, and the prune of both
  kinds of leftovers.
"""

import ctypes
import ctypes.util
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.train import checkpoint as jckpt
from avvad_tpu_torch import native, orbax_io
from avvad_tpu_torch.convert import to_flax_variables
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import AVVAD, AudioVAD
from avvad_tpu_torch.train import checkpoint as ckpt
from avvad_tpu_torch.train import create_train_state, restore_checkpoint, restore_model
from torch_port_orbax_lib import (LR, adam_of, bits, jax_state, leaves_with_paths, np_tree,
                                  ours, params_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# test_torch_port_models.py: whole-model logits, fp32 on both sides
ATOL_LOGITS = 1e-4
# test_torch_port_models.py::test_serving_fn_matches_jax: probabilities
ATOL_PROBS = 1e-4


# --- zstd ---------------------------------------------------------------------


def _libzstd():
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    lib = ctypes.CDLL(name)
    sz = ctypes.c_size_t
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = sz
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, sz, ctypes.c_char_p, sz]
    lib.ZSTD_compress2.restype = sz
    lib.ZSTD_compressBound.argtypes = [sz]
    lib.ZSTD_compressBound.restype = sz
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, sz, ctypes.c_char_p, sz]
    lib.ZSTD_decompress.restype = sz
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, sz]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    return lib


def _compress(data: bytes, level: int, checksum: bool, content_size: bool = True) -> bytes:
    """libzstd's ZSTD_compress2 (ZSTD_c_compressionLevel 100,
    ZSTD_c_contentSizeFlag 200, ZSTD_c_checksumFlag 201)."""
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (200, int(content_size)), (201, int(checksum))):
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param, value))
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def _data(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.bytes(300_000)
    if kind == "repetitive":
        return (b"the quick brown fox jumps over the lazy dog; " * 12_000)[:500_000]
    if kind == "runs":
        vals = rng.integers(0, 6, 3000).astype(np.uint8)
        return np.repeat(vals, rng.integers(1, 400, 3000)).tobytes()
    # weights: fp32 values of a trained layer's scale, rounded so that
    # literals and matches both occur
    return np.round(rng.normal(size=150_000) * 0.05, 3).astype(np.float32).tobytes()


DATA = ["random", "repetitive", "runs", "floats"]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("kind", DATA)
def test_zstd_matches_libzstd(kind, level, checksum):
    """Every frame libzstd writes decodes to the input (which libzstd reads
    back the same): > 128 KiB, so several blocks, at fast, default and
    high levels (RLE and raw blocks, Huffman literals in one and four
    streams, FSE and repeated tables, repeat offsets)."""
    data = _data(kind)
    assert len(data) > 128 * 1024
    frame = _compress(data, level, checksum)
    assert native.zstd_decompress(frame).tobytes() == data


@pytest.mark.parametrize("kind", DATA)
def test_zstd_streamed_and_concatenated_frames(kind):
    """Frames without a content size, and several frames in one buffer (one
    of them a skippable frame)."""
    data = _data(kind)
    streamed = _compress(data, 3, False, content_size=False)
    assert native.zstd_decompress(streamed).tobytes() == data
    skippable = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"12345"
    several = _compress(data[:1000], 1, True) + skippable + streamed + _compress(b"", 3, False)
    assert native.zstd_decompress(several).tobytes() == data[:1000] + data


def test_zstd_matches_libzstd_on_tensorstore_frames():
    """Every zstd frame in the committed fixture as TensorStore wrote it: the
    zarr chunks (level 1) and the bodies of the OCDBT manifests and B-tree
    nodes, decoded by the port and by libzstd alike."""
    lib = _libzstd()
    fix = _fixture()
    root = os.path.join(FIXTURES, fix["model_dir"], fix["checkpoint"])
    frames = [v for v in orbax_io.read_store(root).values() if v[:4] == native.ZSTD_MAGIC]
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                buf = f.read()
            if buf[:2] == b"\x0c\xdb" and buf[12:14] == b"\x00\x01":  # OCDBT, zstd body
                frames.append(buf[14:-4])
    assert len(frames) > 28
    for frame in frames:
        size = lib.ZSTD_getFrameContentSize(frame, len(frame))
        cap = size if size < 2**40 else 1 << 24
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(out, cap, frame, len(frame))
        assert not lib.ZSTD_isError(n)
        assert native.zstd_decompress(frame).tobytes() == out.raw[:n]


def test_zstd_corrupt_frames_raise():
    """Each byte of a checksummed frame flipped, and the frame cut at each
    length, raise ZstdError (a frame without its checksum may decode a
    flipped literal to other bytes; it is still cut short, read only
    within its input, and cut frames raise)."""
    frame = _compress(_data("floats")[:60_000] + _data("repetitive")[:60_000], 3, True)
    for i in range(0, len(frame), max(1, len(frame) // 400)):
        bad = bytearray(frame)
        bad[i] ^= 0xA5
        with pytest.raises(native.ZstdError):
            native.zstd_decompress(bytes(bad))
    for n in range(0, len(frame), max(1, len(frame) // 200)):
        with pytest.raises(native.ZstdError):
            native.zstd_decompress(frame[:n] if n else b"\x28\xb5\x2f")
    with pytest.raises(native.ZstdError, match="magic"):
        native.zstd_decompress(b"not a zstd frame")


def test_crc32c_known_values():
    """CRC-32C against its published check value, continued in two parts
    (XXH64 is held by the checksummed frames above)."""
    assert native.crc32c(b"123456789") == 0xE3069283
    data = _data("random")
    assert native.crc32c(data[5000:], native.crc32c(data[:5000])) == native.crc32c(data)


# --- OCDBT ---------------------------------------------------------------------


def test_ocdbt_interior_nodes_and_version_tree(tmp_path):
    """A store TensorStore wrote with 600-byte nodes (three levels of
    interior nodes) and 40 commits (a version tree below the manifest),
    values inline and indirect: the newest version's keys and values, and
    every version's generation, the older ones from the version tree."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for g in range(40):
        with ts.Transaction() as txn:
            for i in range(10):
                kv.with_transaction(txn)[f"key{g:03d}_{i:02d}".encode()] = \
                    rng.bytes(int(rng.integers(0, 40)))
    store = orbax_io.OcdbtStore(str(tmp_path))
    try:
        items = store.items()
        versions = store.all_versions()
    finally:
        store.close()
    assert store.versions[-1]["height"] >= 2 and store.version_nodes
    keys = kv.list().result()
    assert sorted(items) == sorted(keys)
    assert all(items[k] == kv.read(k).result().value for k in keys)
    # one generation a commit at least (TensorStore may split a commit)
    gens = [v["generation"] for v in versions]
    assert gens == list(range(1, len(gens) + 1)) and len(gens) >= 40
    dump = ts.ocdbt.dump(ts.KvStore.open({"driver": "file",
                                          "path": f"{tmp_path}/"}).result()).result()
    assert gens[-1] == dump["versions"][-1]["generation_number"]


# --- full width, mesh, dtypes, the fixture ------------------------------------------


def test_full_width_avvad_forward_matches_jax(tmp_path):
    """AVVAD at full width (MCB 1024, LSTM 2 x 1024, ResNet-18), Adam
    moments at optax's init, saved by JAX (about 540 MB with the moments):
    the port reads it and its forward at B=1, T=4 agrees with JAX's plain
    (scan) LSTM route at ATOL_LOGITS."""
    torch.manual_seed(11)
    port = AVVAD()
    jm = JAVVAD()
    variables = to_flax_variables(port.state_dict(), params_of(port))
    path = jckpt.save_checkpoint(str(tmp_path), jax_state(jm, variables, True), epoch=0)
    del port
    model = AVVAD()
    restore_model(path, model)
    rng = np.random.default_rng(2)
    audio = rng.normal(size=(1, 4, 513)).astype(np.float32)
    video = rng.normal(size=(1, 4, 67, 67)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(audio), torch.from_numpy(video)).numpy()
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(audio), jnp.asarray(video)))
    np.testing.assert_allclose(got, want, atol=ATOL_LOGITS)


MESH_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from avvad_tpu.models import AudioVAD
from avvad_tpu.train import checkpoint
from avvad_tpu.train.state import TrainState, make_optimizer
out = sys.argv[1]
mesh = Mesh(np.array(jax.devices()), ("model",))
rng = np.random.default_rng(4)
params = {"lstm_audio": {"layer_0": {
              "w_ih": rng.normal(size=(513, 64)).astype(np.float32),
              "w_hh": rng.normal(size=(16, 64)).astype(np.float32),
              "bias": rng.normal(size=(64,)).astype(np.float32)}},
          "vad_audio": {"kernel": rng.normal(size=(16, 1)).astype(np.float32),
                        "bias": np.zeros(1, np.float32)}}
def place(x):
    spec = P(None, "model") if x.ndim == 2 and x.shape[1] % 2 == 0 else P()
    return jax.device_put(x, NamedSharding(mesh, spec))
params = jax.tree_util.tree_map(place, params)
tx = make_optimizer(1e-4)
state = TrainState(step=jnp.int32(0), params=params, batch_stats=None, sketch=None,
                   opt_state=tx.init(params), apply_fn=AudioVAD(lstm_hidden_size=16,
                   lstm_layers=1).apply, tx=tx)
path = checkpoint.save_checkpoint(out, state, epoch=0)
np.savez(os.path.join(out, "want.npz"),
         **{k: np.asarray(v) for k, v in params["lstm_audio"]["layer_0"].items()})
print(path)
"""


def test_meshed_checkpoint_chunks_assemble(tmp_path):
    """A checkpoint saved under a 2-device CPU mesh (a subprocess with two
    host devices), the weights column-sharded: their arrays are stored in
    two chunks each, and the port assembles them bit for bit."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    path = proc.stdout.strip().splitlines()[-1]
    store = orbax_io.read_store(path)
    assert b"params.lstm_audio.layer_0.w_ih/0.1" in store
    tree = orbax_io.read_checkpoint(path)
    want = np.load(os.path.join(str(tmp_path), "want.npz"))
    for k in want.files:
        np.testing.assert_array_equal(tree["params"]["lstm_audio"]["layer_0"][k], want[k])


def test_model_parallel_restore_and_export(tmp_path):
    """A JAX checkpoint of AudioVAD(H=512) with Adam moments (step 1),
    restored by two gloo ranks on a 1 x 2 mesh (tests/test_torch_port_ranks.py): each
    rank holds half of w_ih / w_hh's columns and of their moments, and the
    gathered state equals the unmeshed restore bit for bit; the state
    exported under the mesh (rank 0 writes) is restored by JAX bit-equal."""
    from avvad_tpu_torch.parallel import spawn

    import test_torch_port_ranks as ranks

    port = ranks._tp_audio_model(None, use_kernel=False)
    jm = JAudioVAD(lstm_hidden_size=ranks.TP_H, lstm_layers=2)
    variables = to_flax_variables(port.state_dict(), params_of(port))
    # Adam after a step: count 1, seeded moments (no train step to compile)
    rng = np.random.default_rng(7)
    jstate = jax_state(jm, variables, False)
    adam, empty = jstate.opt_state
    moments = [jax.tree_util.tree_map(
        lambda a: np.abs(rng.normal(size=a.shape)).astype(np.float32) * s, adam.mu)
        for s in (1e-3, 1e-6)]
    jstate = jstate.replace(step=jnp.int32(1), opt_state=(adam._replace(
        count=jnp.int32(1), mu=moments[0], nu=moments[1]), empty))
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, epoch=3, valid_loss=0.2)
    reports = spawn("test_torch_port_ranks:orbax_model_parallel", 2,
                    args=(path, str(tmp_path)), timeout_s=120,
                    paths=[os.path.dirname(os.path.abspath(__file__))])
    h4 = 4 * ranks.TP_H
    for r in reports:
        assert r["epoch"] == 3 and r["step"] == 1
        assert r["shards"]["lstm_audio.layer_0.parametrizations.w_ih.original"] == [513, h4 // 2]
    single = create_train_state(ranks._tp_audio_model(None, use_kernel=False),
                                learning_rate=LR, device="cpu")
    restore_checkpoint(path, single)
    full = torch.load(str(tmp_path / "full.pt"), weights_only=True)
    want = single.model.state_dict()
    assert set(full["model"]) == set(want)
    for k, v in want.items():
        assert torch.equal(full["model"][k], v), k
    opt = single.optimizer.state_dict()["state"]
    assert set(full["optimizer"]["state"]) == set(opt)
    for i, st in opt.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(full["optimizer"]["state"][i][k], st[k]), (i, k)
    exported = ckpt.latest_checkpoint(str(tmp_path / "export"))
    back, _, epoch = jckpt.restore_checkpoint(exported, jax_state(jm, variables, False))
    assert epoch == 3
    for p, v in leaves_with_paths(np_tree(jstate.params)).items():
        np.testing.assert_array_equal(np.asarray(ours(np_tree(back.params), p)), v, err_msg=p)
    want_adam, got_adam = adam_of(jstate.opt_state), adam_of(back.opt_state)
    assert int(got_adam.count) == 1
    for a, b_ in zip(jax.tree_util.tree_leaves((want_adam.mu, want_adam.nu)),
                     jax.tree_util.tree_leaves((got_adam.mu, got_adam.nu)), strict=True):
        np.testing.assert_array_equal(np.asarray(b_), np.asarray(a))


def test_dtypes_and_leaf_kinds_bit_equal(tmp_path):
    """bfloat16 (a torch.bfloat16 tensor), int8, int32, float64 scalars,
    numpy and Python scalars, a list with an empty entry: as Orbax
    restores them."""
    tree = {"bf16": jnp.arange(-6, 6, dtype=jnp.bfloat16) / 3, "i8": jnp.arange(-5, 5,
                                                                                 dtype=jnp.int8),
            "i32": jnp.int32(7), "f64": np.float64(3.25), "np_f32": np.ones((3, 2), np.float32),
            "py_int": 5, "seq": [jnp.ones(3), None, {"x": jnp.zeros((2, 2))}]}
    path = str(tmp_path / "ck")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    got = orbax_io.read_checkpoint(path)
    assert got["bf16"].dtype == torch.bfloat16 and got["py_int"] == 5
    assert got["seq"][1] is None and isinstance(got["seq"], list)
    for p, want in leaves_with_paths(ocp.StandardCheckpointer().restore(path)).items():
        g, w = bits(ours(got, p)), bits(want)
        assert g.dtype == w.dtype and np.array_equal(g, w), p


def test_written_checkpoint_round_trips_through_orbax(tmp_path):
    """write_checkpoint's directory restored by Orbax and read back by the
    port: every leaf bit-equal, bfloat16 and Nones included."""
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor(3, dtype=torch.int32), "d": None,
                  "bf": torch.linspace(-1, 1, 700).to(torch.bfloat16)},
            "big": torch.randn(300, 5), "e": [torch.ones(2, dtype=torch.int8), None],
            "n": np.full((2,), 1.5)}
    path = orbax_io.write_checkpoint(str(tmp_path / "w"), tree)
    ref = ocp.StandardCheckpointer().restore(path)
    back = orbax_io.read_checkpoint(path)
    for p, want in leaves_with_paths(ref).items():
        src = ours(tree, p)
        assert np.array_equal(bits(src), bits(want)), p
        assert np.array_equal(bits(ours(back, p)), bits(want)), p
    assert back["b"]["d"] is None and back["e"][1] is None


def _fixture():
    with open(os.path.join(FIXTURES, "orbax_fixtures.json")) as f:
        return json.load(f)


def test_committed_fixture_reads_and_serves_as_jax():
    """The committed real-Orbax AudioVAD checkpoint: every array's SHA-256
    as Orbax restored it when the fixture was made; restored into the
    port's model (its LSTM kernels' plain versions here) the waveform
    serving step matches JAX's recorded probabilities at ATOL_PROBS, on
    the waveforms whose SHA-256 the fixture records."""
    sys.path.insert(0, FIXTURES)
    from make_orbax_fixtures import waveforms

    meta = _fixture()
    path = os.path.join(FIXTURES, meta["model_dir"], meta["checkpoint"])
    tree = orbax_io.read_checkpoint(path)
    for p, digest in meta["arrays_sha256"].items():
        arr = np.ascontiguousarray(np.asarray(ours(tree, p)))
        assert hashlib.sha256(arr.tobytes()).hexdigest() == digest, p
    wave = waveforms(meta["seed"])
    assert hashlib.sha256(wave.tobytes()).hexdigest() == meta["wave_sha256"]
    model = AudioVAD(lstm_hidden_size=meta["lstm_hidden"], lstm_layers=meta["lstm_layers"],
                     use_kernel_lstm=True)
    norm, epoch = restore_model(path, model)
    fn = make_waveform_serving_fn(model, t_frames=meta["t_frames"], norm_stats=norm,
                                  device="cpu")
    with torch.no_grad():
        probs = fn(torch.from_numpy(wave)).numpy().reshape(meta["batch"], -1)
    np.testing.assert_allclose(probs, np.asarray(meta["probs"]), atol=ATOL_PROBS)
    # JAX's serving step on the same checkpoint still gives the recorded values
    jm = JAudioVAD(lstm_hidden_size=meta["lstm_hidden"], lstm_layers=meta["lstm_layers"],
                   use_pallas_lstm=True)
    jtree = ocp.StandardCheckpointer().restore(path)
    jfn = jmake_serving_fn(jm, {"params": jtree["params"]}, t_frames=meta["t_frames"],
                           norm_stats=jtree["norm_stats"])
    np.testing.assert_allclose(np.asarray(jfn(jnp.asarray(wave))).reshape(meta["batch"], -1),
                               np.asarray(meta["probs"]), atol=1e-6)


def test_per_process_stores_without_the_root_manifest(tmp_path):
    """The fixture with its root manifest and root data file taken away:
    the reader falls back on the union of the ``ocdbt.process_*`` stores
    (each at its newest of several versions) and reads the same tree."""
    import shutil

    meta = _fixture()
    src = os.path.join(FIXTURES, meta["model_dir"], meta["checkpoint"])
    path = str(tmp_path / "ck")
    shutil.copytree(src, path)
    os.remove(os.path.join(path, "manifest.ocdbt"))
    shutil.rmtree(os.path.join(path, "d"))
    store = orbax_io.OcdbtStore(os.path.join(path, "ocdbt.process_0"))
    assert len(store.versions) > 1
    store.close()
    want, got = orbax_io.read_checkpoint(src), orbax_io.read_checkpoint(path)
    for p, v in leaves_with_paths(want).items():
        assert np.array_equal(bits(ours(got, p)), bits(v)), p


# --- named errors, prune ------------------------------------------------------------


def _kv_checkpoint(path, values: dict, tree_meta=None, **meta):
    """A checkpoint directory whose OCDBT store TensorStore writes with
    ``values`` and whose _METADATA names one leaf ``x``."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    for k, v in values.items():
        kv[k] = v
    md = {"tree_metadata": tree_meta or {"('x',)": {
        "key_metadata": [{"key": "x", "key_type": 2}],
        "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False, **meta}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(md, f)


def _zarray(**over) -> bytes:
    meta = {"chunks": [4], "compressor": None, "dimension_separator": ".", "dtype": "<f4",
            "fill_value": None, "filters": None, "order": "C", "shape": [4], "zarr_format": 2}
    meta.update(over)
    return json.dumps(meta).encode()


ERRORS = {
    "order": ({b"x/.zarray": _zarray(order="F"), b"x/0": bytes(16)}, {}, "order"),
    "filters": ({b"x/.zarray": _zarray(filters=[{"id": "delta"}]), b"x/0": bytes(16)}, {},
                "filters"),
    "compressor": ({b"x/.zarray": _zarray(compressor={"id": "blosc"}), b"x/0": bytes(16)},
                   {}, "compressor 'blosc'"),
    "dtype": ({b"x/.zarray": _zarray(dtype="<c8"), b"x/0": bytes(32)}, {}, "dtype"),
    "missing_chunk": ({b"x/.zarray": _zarray()}, {}, "chunk missing"),
    "short_chunk": ({b"x/.zarray": _zarray(), b"x/0": bytes(12)}, {}, "a chunk of"),
    "zarr3": ({b"x/zarr.json": b"{}"}, {}, "zarr v3"),
    "use_zarr3": ({b"x/.zarray": _zarray(), b"x/0": bytes(16)}, {"use_zarr3": True},
                  "use_zarr3"),
    "value_type": ({b"x/.zarray": _zarray(), b"x/0": bytes(16)}, {"tree_metadata": {
        "('x',)": {"key_metadata": [{"key": "x", "key_type": 2}],
                   "value_metadata": {"value_type": "string"}}}}, "value type 'string'"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_unsupported_layouts_raise_named_errors(case, tmp_path):
    values, meta, match = ERRORS[case]
    tree_meta = meta.pop("tree_metadata", None)
    _kv_checkpoint(str(tmp_path), values, tree_meta, **meta)
    with pytest.raises(orbax_io.OrbaxFormatError, match=match):
        orbax_io.read_checkpoint(str(tmp_path))


def test_damaged_files_raise_named_errors(tmp_path):
    """A flipped byte in the manifest (CRC-32C), a data file cut short, no
    _METADATA, and a directory with no OCDBT store."""
    path = orbax_io.write_checkpoint(str(tmp_path / "w"), {"a": torch.randn(400)})
    manifest = os.path.join(path, "manifest.ocdbt")
    with open(manifest, "rb") as f:
        good = f.read()
    bad = bytearray(good)
    bad[20] ^= 1
    with open(manifest, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(orbax_io.OrbaxFormatError, match="CRC-32C"):
        orbax_io.read_checkpoint(path)
    with open(manifest, "wb") as f:
        f.write(good)
    data = [os.path.join(path, "d", n) for n in os.listdir(os.path.join(path, "d"))][0]
    with open(data, "r+b") as f:
        f.truncate(100)
    with pytest.raises(orbax_io.OrbaxFormatError):
        orbax_io.read_checkpoint(path)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(orbax_io.OrbaxFormatError, match="_METADATA"):
        orbax_io.read_checkpoint(str(empty))
    (empty / "_METADATA").write_text(json.dumps({"tree_metadata": {}}))
    with pytest.raises(orbax_io.OrbaxFormatError, match="manifest.ocdbt"):
        orbax_io.read_checkpoint(str(empty))


def test_prune_sweeps_orbax_and_port_leftovers_as_jax(tmp_path):
    """Both leftovers of a crashed save, the port's ``.tmp`` and Orbax's
    ``.orbax-checkpoint-tmp``, are swept, with the checkpoints JAX's prune
    keeps kept."""
    names = ["epoch_001_vloss_0.90", "epoch_002_vloss_0.40", "epoch_003_vloss_0.70",
             "epoch_004_vloss_0.80"]
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        for n in names + ["epoch_005_vloss_0.10.orbax-checkpoint-tmp",
                          "epoch_006_vloss_0.20.tmp"]:
            (d / n).mkdir(parents=True)
        dirs[side] = d
    removed = ckpt.prune_checkpoints(str(dirs["port"]))
    jremoved = jckpt.prune_checkpoints(str(dirs["jax"]))
    assert removed == 4 and jremoved == 3  # JAX leaves the port's .tmp alone
    kept = sorted(os.listdir(dirs["port"]))
    assert kept == ["epoch_002_vloss_0.40", "epoch_004_vloss_0.80"]
    assert sorted(n for n in os.listdir(dirs["jax"]) if not n.endswith(".tmp")) == kept
