"""The port's TCP serving front (``avvad_tpu_torch.server``) on the CPU with
tiny models: round trips against solo streamers, slot recycling, the
half-close tail, the strict framing, a pipelined round trip, and the wire
against the JAX package's server and clients.

Each test drives ``server.poll()`` from its own thread, with a deadline,
while the clients run on threads with socket timeouts; server state is read
only between polls. Inputs are seeded numpy draws.
"""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avvad_tpu import serve as jserve
from avvad_tpu import server as jserver
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu_torch import serve
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.models import AVVAD, AudioVAD, VideoVAD
from avvad_tpu_torch.server import (VADServer, av_frame, av_stream_client,
                                    quantize_pcm_int16, stream_client,
                                    video_stream_client)

BF = 4
NFFT, HOP = 1024, 256
# batched server rows against a solo streamer, fp32: a BLAS may pick another
# kernel for N rows than for one
ATOL = 1e-5
DEADLINE_S = 60.0
TIMEOUT_S = 20.0


def _serve(server, jobs):
    """Run each job on a thread and poll the server here until every job is
    done (or the deadline passes) -> the jobs' results."""
    results, errs = [None] * len(jobs), []

    def run(i, job):
        try:
            results[i] = job()
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, job), daemon=True)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + DEADLINE_S
    while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
        server.poll(0.002)
    for t in threads:
        t.join(timeout=1)
    assert not any(t.is_alive() for t in threads), "clients did not finish"
    assert not errs, errs
    return results


def _poll_until(server, cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        server.poll(0.002)
    return cond()


def _n_out(n_samples):
    return ((1 + (n_samples - NFFT) // HOP) // BF) * BF


def _pcm(n_streams, samples=7000, seed=7):
    """int16 PCM whose first sample is the largest possible |sample|, so the
    causal running peak (32768, 1.0 on the float wire) is fixed from the
    first sample on, whatever the server's tick timing."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-20000, 20000, size=(n_streams, samples), dtype=np.int16)
    pcm[:, 0] = -32768
    return pcm


def _solo_audio(model, x):
    sv = serve.StreamingVAD(model, block_frames=BF, fixed_peak=1.0, device="cpu")
    return np.concatenate([sv.feed(x), sv.flush()])


@pytest.fixture(scope="module")
def audio_model():
    return AudioVAD(lstm_hidden_size=16, lstm_layers=2, seed=1)


@pytest.fixture(scope="module")
def av_model():
    return AVVAD(lstm_hidden_size=16, lstm_layers=1, mcb_output_size=64, seed=2).eval()


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_audio_round_trip_matches_solo(audio_model, wire):
    """Two clients at once on the raw wire: float32 samples on a frames
    server, int16 PCM on an audio_int16 span server."""
    kw = dict(span_wire=True, audio_int16=True) if wire == "i16" else {}
    ms = serve.MultiStreamVAD(audio_model, 3, block_frames=BF, device="cpu", **kw)
    server = VADServer(ms)
    try:
        pcm = _pcm(2)
        x = pcm.astype(np.float32) / 32768.0
        n_out = _n_out(pcm.shape[1])
        send = pcm if wire == "i16" else x
        got = _serve(server, [lambda i=i: stream_client(
            server.address, send[i], n_out, timeout=TIMEOUT_S, audio_wire=wire)
            for i in range(2)])
        for i in range(2):
            assert len(got[i]) == n_out
            np.testing.assert_allclose(got[i], _solo_audio(audio_model, x[i])[:n_out],
                                       atol=ATOL, err_msg=f"stream {i}")
    finally:
        server.close()


def _video(n_streams, n_frames, seed=9):
    return np.random.default_rng(seed).integers(
        0, 256, (n_streams, n_frames, 67, 67)).astype(np.float32)


@pytest.mark.parametrize("video_wire", ["f32", "u8"])
@pytest.mark.parametrize("audio_wire", ["f32", "i16"])
def test_av_round_trip_matches_solo(av_model, audio_wire, video_wire):
    """Two AV clients with A/P audio and V/U lip frames (integer-valued, so
    the uint8 wire carries them exactly) against solo StreamingAVVADs."""
    kw = dict(span_wire=True, audio_int16=True) if audio_wire == "i16" else {}
    ms = serve.MultiStreamAVVAD(av_model, 2, block_frames=BF, device="cpu",
                                video_uint8=video_wire == "u8", **kw)
    server = VADServer(ms)
    try:
        pcm = _pcm(2, samples=5000, seed=11)
        x = pcm.astype(np.float32) / 32768.0
        n_out = _n_out(pcm.shape[1])
        video = _video(2, n_out)
        send = pcm if audio_wire == "i16" else x
        got = _serve(server, [lambda i=i: av_stream_client(
            server.address, send[i], video[i], n_out, chunk=1500, frames_per_msg=5,
            timeout=TIMEOUT_S, video_wire=video_wire, audio_wire=audio_wire)
            for i in range(2)])
        for i in range(2):
            solo = serve.StreamingAVVAD(av_model, block_frames=BF, fixed_peak=1.0,
                                        video_uint8=video_wire == "u8", device="cpu")
            ref = np.concatenate([solo.feed(x[i], video[i]), solo.flush()])[:n_out]
            assert len(got[i]) == n_out
            np.testing.assert_allclose(got[i], ref, atol=ATOL, err_msg=f"stream {i}")
    finally:
        server.close()


def test_video_round_trip_matches_solo():
    model = VideoVAD(lstm_hidden_size=16, lstm_layers=1, seed=3).eval()
    ms = serve.MultiStreamVideoVAD(model, 2, block_frames=BF, device="cpu")
    server = VADServer(ms)
    try:
        video = _video(2, 3 * BF, seed=13)
        got = _serve(server, [lambda i=i: video_stream_client(
            server.address, video[i], 3 * BF, frames_per_msg=3, timeout=TIMEOUT_S)
            for i in range(2)])
        for i in range(2):
            solo = serve.StreamingVideoVAD(model, block_frames=BF, device="cpu")
            np.testing.assert_allclose(got[i], solo.feed(video[i]), atol=ATOL)
    finally:
        server.close()


def test_slot_recycling_and_refusal(audio_model):
    """Two sessions in turn on the only slot give the same results (buffer,
    peak and carries were reset); with the slot held, a further connection
    is closed at once."""
    ms = serve.MultiStreamVAD(audio_model, 1, block_frames=BF, device="cpu")
    server = VADServer(ms)
    try:
        x = _pcm(1, samples=5000)[0].astype(np.float32) / 32768.0
        n_out = _n_out(len(x))
        a, = _serve(server, [lambda: stream_client(server.address, x, n_out,
                                                   timeout=TIMEOUT_S)])
        assert _poll_until(server, lambda: server._free == [0])
        b, = _serve(server, [lambda: stream_client(server.address, x, n_out,
                                                   timeout=TIMEOUT_S)])
        np.testing.assert_array_equal(a, b)
        assert _poll_until(server, lambda: server._free == [0])
        with socket.create_connection(server.address, timeout=TIMEOUT_S) as hold:
            hold.sendall(np.zeros(4, "<f4").tobytes())
            assert _poll_until(server, lambda: server._free == [])
            with socket.create_connection(server.address, timeout=TIMEOUT_S) as extra:
                extra.settimeout(TIMEOUT_S)
                assert _poll_until(server, lambda: len(server._conn_slot) == 1
                                   and not server._sel.select(0))
                assert extra.recv(1) == b""  # refused: closed by the server
        assert _poll_until(server, lambda: server._free == [0])
    finally:
        server.close()


def test_half_close_still_gets_its_tail(audio_model):
    """Everything sent, then shutdown(SHUT_WR) before reading: every block
    buffered at close time is still answered, then the slot is freed."""
    ms = serve.MultiStreamVAD(audio_model, 2, block_frames=BF, device="cpu")
    server = VADServer(ms)
    try:
        x = _pcm(1, samples=9000)[0].astype(np.float32) / 32768.0
        n_out = _n_out(len(x))

        def client():
            with socket.create_connection(server.address, timeout=TIMEOUT_S) as s:
                s.sendall(x.astype("<f4").tobytes())
                s.shutdown(socket.SHUT_WR)
                out = b""
                while True:
                    part = s.recv(1 << 16)
                    if not part:
                        return np.frombuffer(out, "<f4")
                    out += part

        got, = _serve(server, [client])
        assert len(got) == n_out
        np.testing.assert_allclose(got, _solo_audio(audio_model, x)[:n_out], atol=ATOL)
        assert _poll_until(server, lambda: sorted(server._free) == [0, 1])
    finally:
        server.close()


@pytest.mark.parametrize("message", [
    av_frame(b"X", b"\0\0\0\0"),
    b"A" + ((1 << 24) + 4).to_bytes(4, "little"),
    av_frame(b"A", b"\0\0\0"),
    av_frame(b"U", b"\0" * 100),
], ids=["unknown_type", "length_over_cap", "partial_sample", "partial_frame"])
def test_malformed_message_drops_the_connection(av_model, message):
    ms = serve.MultiStreamAVVAD(av_model, 1, block_frames=BF, device="cpu")
    server = VADServer(ms)
    try:
        with socket.create_connection(server.address, timeout=TIMEOUT_S) as s:
            s.settimeout(TIMEOUT_S)
            s.sendall(message)
            assert _poll_until(server, lambda: server._free == [])  # accepted
            assert _poll_until(server, lambda: server._free == [0]
                               and not server._conn_slot)  # dropped
            assert s.recv(1) == b""
    finally:
        server.close()


def test_disconnect_mid_message_frees_the_slot(av_model):
    """A header claiming a whole lip frame, part of its payload, then close:
    the slot is recycled, and the next client is served in full."""
    ms = serve.MultiStreamAVVAD(av_model, 1, block_frames=BF, device="cpu")
    server = VADServer(ms)
    try:
        s = socket.create_connection(server.address, timeout=TIMEOUT_S)
        s.sendall(b"V" + (67 * 67 * 4).to_bytes(4, "little") + b"\0" * 100)
        assert _poll_until(server, lambda: server._free == [])
        s.close()
        assert _poll_until(server, lambda: server._free == [0] and not server._conn_slot)
        x = _pcm(1, samples=2000)[0].astype(np.float32) / 32768.0
        n_out = _n_out(len(x))
        got, = _serve(server, [lambda: av_stream_client(
            server.address, x, _video(1, n_out)[0], n_out, timeout=TIMEOUT_S)])
        assert len(got) == n_out and np.isfinite(got).all()
    finally:
        server.close()


def test_pipelined_round_trip_matches_solo(audio_model):
    """pipelined=True: the same probabilities one block later, the final
    block's included (its result is in flight when the client stops)."""
    ms = serve.MultiStreamVAD(audio_model, 2, block_frames=BF, device="cpu")
    server = VADServer(ms, pipelined=True)
    try:
        x = _pcm(1, samples=8000, seed=17)[0].astype(np.float32) / 32768.0
        n_out = _n_out(len(x))
        got, = _serve(server, [lambda: stream_client(server.address, x, n_out,
                                                     timeout=TIMEOUT_S)])
        assert len(got) == n_out
        np.testing.assert_allclose(got, _solo_audio(audio_model, x)[:n_out], atol=ATOL)
    finally:
        server.close()


def test_quantize_pcm_int16_is_jax_quantizer():
    x = np.random.default_rng(1).normal(size=5000).astype(np.float32)
    x[:3] = (1.5, -1.5, 0.5 / 32768)
    np.testing.assert_array_equal(quantize_pcm_int16(x), jserver.quantize_pcm_int16(x))
    assert av_frame(b"P", b"ab") == jserver.av_frame(b"P", b"ab")


def test_wire_against_the_jax_server():
    """The same AudioVAD weights (fp32) behind the JAX server and the port's:
    each package's client gets the same probabilities from either server,
    within 1e-5."""
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=16, lstm_layers=2)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 513)))
    model = AudioVAD(lstm_hidden_size=16, lstm_layers=2)
    model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)),
                          strict=True)
    port_srv = VADServer(serve.MultiStreamVAD(model, 2, block_frames=BF, device="cpu"))
    jax_srv = jserver.VADServer(jserve.MultiStreamVAD(jm, variables, n_streams=2,
                                                      block_frames=BF))
    try:
        x = _pcm(1, samples=7000, seed=19)[0].astype(np.float32) / 32768.0
        n_out = _n_out(len(x))
        jax_srv.streamer.warmup()
        got = {}
        for srv_name, srv in (("port", port_srv), ("jax", jax_srv)):
            for cli_name, client in (("port", stream_client), ("jax", jserver.stream_client)):
                got[srv_name, cli_name], = _serve(srv, [lambda: client(
                    srv.address, x, n_out, timeout=TIMEOUT_S)])
                assert _poll_until(srv, lambda: srv._free == [1, 0] or srv._free == [0, 1])
        ref = got["jax", "jax"]
        assert len(ref) == n_out
        for key, probs in got.items():
            np.testing.assert_allclose(probs, ref, atol=ATOL, err_msg=str(key))
    finally:
        port_srv.close()
        jax_srv.close()
