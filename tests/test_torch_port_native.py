"""The port's C++ host library (``avvad_tpu_torch.native``, built from
``avvad_tpu_torch/csrc/avvad_io.cpp`` with ``g++``) against its numpy
route and the JAX package's bindings (``avvad_tpu.native``) on both of
theirs: the stream hub's every assemble, bit for bit; WAV reading;
the frame-energy VAD; the build rule and its refusal to fall back.

Every input is a seeded numpy draw or a WAV written to ``tmp_path``."""

import ctypes
import os
import shutil
import threading

import numpy as np
import pytest
from scipy.io import wavfile

from avvad_tpu import native as jnative
from avvad_tpu_torch import native, serve
from avvad_tpu_torch.models import AudioVAD
from avvad_tpu_torch.processing import audio_io

NFFT, HOP, BF, N = 16, 4, 3, 4


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


def _hubs(dtype):
    """The four hubs: the port's C++ and numpy routes, JAX's C++ and numpy."""
    hubs = {"port_native": native.StreamHub(N, NFFT, HOP, BF, dtype=dtype),
            "port_numpy": native.StreamHub(N, NFFT, HOP, BF, force_python=True, dtype=dtype),
            "jax_native": jnative.StreamHub(N, NFFT, HOP, BF, dtype=dtype),
            "jax_numpy": jnative.StreamHub(N, NFFT, HOP, BF, force_python=True,
                                           dtype=dtype)}
    assert [h.is_native for h in hubs.values()] == [True, False, True, False]
    return hubs


def _script(seed, dtype):
    """A seeded session: ragged feeds, gates, resets of one stream and of
    the hub -> list of (op, args)."""
    rng = np.random.default_rng(seed)
    ops = []
    for k in range(14):
        for i in range(N):
            n = int(rng.integers(0, 3 * HOP * BF))
            if dtype == np.int16:
                pcm = rng.integers(-32768, 32768, size=n, dtype=np.int16)
            else:
                pcm = (rng.normal(size=n) * (1 + k)).astype(np.float32)
            ops.append(("feed", (i, pcm)))
        gate = None if k % 3 == 0 else (rng.random(N) > 0.4).astype(np.float32)
        ops.append(("assemble", gate))
        if k == 6:
            ops.append(("reset_stream", 2))
        if k == 10:
            ops.append(("reset", None))
    return ops


def _play(hub, ops, span):
    """Run the script -> every observable, copied."""
    seen = []
    for op, arg in ops:
        if op == "feed":
            seen.append(("feed", hub.feed(*arg)))
        elif op == "assemble":
            blocks, peaks, active, n_active = hub.assemble(gate=arg, span=span)
            seen.append(("assemble", blocks.copy(), peaks.copy(), active.copy(), n_active))
        elif op == "reset_stream":
            hub.reset_stream(arg)
        else:
            hub.reset()
        seen.append(("ready", [hub.frames_ready(i) for i in range(N)]))
    return seen


def _assert_same(a, b, label):
    assert len(a) == len(b), label
    for x, y in zip(a, b):
        assert x[0] == y[0], label
        for u, v in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype, label
                np.testing.assert_array_equal(u, v, err_msg=label)
            else:
                assert u == v, label


@pytest.mark.parametrize("dtype, span", [(np.float32, False), (np.float32, True),
                                         (np.int16, True)])
def test_hub_routes_agree_bit_for_bit(dtype, span):
    """Frames and span assemble, gated assemble, the int16 span,
    reset_stream, reset and frames_ready: the port's C++ hub, its numpy
    route, and JAX's C++ and numpy hubs, at atol 0."""
    ops = _script(3, dtype)
    runs = {name: _play(hub, ops, span) for name, hub in _hubs(dtype).items()}
    assert any(s[0] == "assemble" and s[4] > 0 for s in runs["port_native"])
    assert any(s[0] == "assemble" and 0 < s[4] < N for s in runs["port_native"])
    for name, seen in runs.items():
        _assert_same(seen, runs["port_native"], name)


def test_hub_rejects_what_jax_rejects():
    """int16 feeds only int16; int16 assembles only the span; a bad stream
    index is an error from the library, not a crash."""
    hub = native.StreamHub(2, NFFT, HOP, BF, dtype=np.int16)
    with pytest.raises(TypeError):
        hub.feed(0, np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        hub.assemble()
    with pytest.raises(ValueError):
        hub.reset_stream(5)
    with pytest.raises(ValueError):
        native.StreamHub(2, NFFT, HOP, BF).feed(7, np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        native.StreamHub(2, NFFT, HOP, BF, dtype=np.float64)


def _write(path, kind, rng):
    n = 1000
    if kind == "int16":
        data = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    elif kind == "int32":
        data = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    elif kind == "uint8":
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
    elif kind == "float32":
        data = (rng.normal(size=n) * 0.3).astype(np.float32)
    else:  # stereo int16: channel 0 is read
        data = rng.integers(-32768, 32768, size=(n, 2), dtype=np.int16)
    wavfile.write(str(path), 16000, data)
    return data


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32", "stereo"])
def test_read_wav_matches_scipy_and_jax(tmp_path, monkeypatch, kind):
    path = str(tmp_path / f"{kind}.wav")
    data = _write(path, kind, np.random.default_rng(len(kind)))
    assert native.wav_info(path) == jnative.wav_info(path) == (
        16000, 2 if kind == "stereo" else 1, len(data))
    x, sr = native.read_wav(path)
    ref, ref_sr = audio_io.read_wav(path)  # the scipy route
    jx, jsr = jnative.read_wav(path)
    assert sr == ref_sr == jsr == 16000 and x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-7)
    xn, _ = native.read_wav(path, normalize=True)
    np.testing.assert_array_equal(xn, jnative.read_wav(path, normalize=True)[0])
    # AVVAD_NATIVE=1 routes the port's reader through the library
    monkeypatch.setenv("AVVAD_NATIVE", "1")
    np.testing.assert_array_equal(audio_io.read_wav(path)[0], x)


def test_wav_errors_raise(tmp_path):
    with pytest.raises(IOError):
        native.wav_info(str(tmp_path / "missing.wav"))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"NOT A WAV FILE AT ALL....")
    with pytest.raises(IOError):
        native.read_wav(str(bad))


@pytest.mark.parametrize("pad_end", [0, 256])
def test_frame_energy_vad_matches_jax_binding(pad_end):
    rng = np.random.default_rng(pad_end)
    speech = np.repeat([1.0, 0, 1, 1, 0, 0, 1, 0, 1], 1000)
    x = (rng.normal(size=9000) * speech + 1e-3 * rng.normal(size=9000)).astype(np.float32)
    got = native.frame_energy_vad(x, 1024, 256, pad_end)
    ref = jnative.frame_energy_vad(x, 1024, 256, pad_end)
    assert got.shape == ref.shape and 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        native.frame_energy_vad(x[:10], 1024, 256, 0)


def test_build_rebuilds_when_the_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "avvad_io.cpp"
    shutil.copy(native.SRC, src)
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "libavvad_io.so")
    assert native.build()["seconds"] > 0
    assert native.build()["seconds"] == 0.0
    mtime = native.LIB_PATH.stat().st_mtime
    os.utime(src, (mtime + 10, mtime + 10))
    assert native.build()["seconds"] > 0
    lib = ctypes.CDLL(str(native.LIB_PATH))
    assert lib.hub_assemble_span_gated_i16


def test_concurrent_builds_leave_one_good_library(tmp_path, monkeypatch):
    """Builds racing on one path (the test workers do): each replaces the
    library in one step; no temporary file is left, and it loads."""
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libavvad_io.so")
    errs = []

    def run():
        try:
            native.build(force=True)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libavvad_io.so"]
    assert ctypes.CDLL(str(native.LIB_PATH)).hub_create


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A source that does not compile: load() raises with the compiler's
    output, and so do StreamHub() and the servers with native=True; only an
    explicit numpy route runs."""
    src = tmp_path / "avvad_io.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libavvad_io.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.load()
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.StreamHub(2, NFFT, HOP, BF)
    model = AudioVAD(lstm_hidden_size=8, lstm_layers=1)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        serve.MultiStreamVAD(model, 2, device="cpu")
    ms = serve.MultiStreamVAD(model, 2, native=False, device="cpu")
    assert not ms._hub.is_native
    assert list(tmp_path.iterdir()) == [src]


def test_servers_default_to_the_native_hub():
    from avvad_tpu_torch.models import AVVAD

    audio = AudioVAD(lstm_hidden_size=8, lstm_layers=1)
    av = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=64)
    for ms in (serve.MultiStreamVAD(audio, 2, device="cpu"),
               serve.MultiStreamAVVAD(av, 2, span_wire=True, audio_int16=True,
                                      device="cpu")):
        assert ms._hub.is_native
    assert not serve.MultiStreamAVVAD(av, 2, native=False, device="cpu")._hub.is_native
