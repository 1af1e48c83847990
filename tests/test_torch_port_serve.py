"""CPU parity of the port's streaming servers with the JAX package.

Weights are made by the JAX modules' own init and carried across by
``avvad_tpu_torch.convert.from_flax_variables``; waveforms, lip frames and
feed schedules are seeded numpy draws handed to both sides. The port runs
with ``device="cpu"``; with carries both sides run the LSTM as a plain
scan, so no kernel is on this path on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu import serve as jserve
from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.native import StreamHub as JStreamHub
from avvad_tpu.processing import video as jvideo
from avvad_tpu_torch import serve
from avvad_tpu_torch.config import STFTConfig
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import AVVAD, AudioVAD
from avvad_tpu_torch.native import StreamHub
from avvad_tpu_torch.ops.stft import frame_signal, log_power_frontend
from avvad_tpu_torch.processing import video as pvideo

H, MCB_OUT = 32, 64
# probabilities, port against JAX on the same weights and feeds: fp32 on
# both sides; the DFT matmuls and the scan sum in another order
PROB_ATOL = 1e-5
# rows of one batched step against a batch of one within the port: a BLAS
# may pick another kernel for N rows than for one
SOLO_ATOL = 1e-6
# streaming against the offline forward (tests/test_serve.py:24)
OFFLINE_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(seed=2, video=False):
    rng = np.random.default_rng(seed)
    stats = {"audio_mean": rng.normal(size=513).astype(np.float32),
             "audio_std": (1.0 + rng.random(513)).astype(np.float32)}
    if video:
        stats.update(video_mean=np.float32(120.0), video_std=np.float32(60.0))
    return stats


@pytest.fixture(scope="module")
def audio_models():
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 513))))
    port = AudioVAD(lstm_hidden_size=H, lstm_layers=2)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port


@pytest.fixture(scope="module")
def av_models():
    """MCB fusion with non-trivial BatchNorm running statistics."""
    jm = JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=1, use_mcb=True,
                mcb_output_size=MCB_OUT)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 513)),
                                 jnp.zeros((1, 4, 67, 67))))
    rng = np.random.default_rng(3)
    variables = dict(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.random(a.shape)).astype(np.float32),
        variables["batch_stats"])
    port = AVVAD(lstm_hidden_size=H, lstm_layers=1, use_mcb=True,
                 mcb_output_size=MCB_OUT)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port


def _signals(lengths, seed, int16=False):
    rng = np.random.default_rng(seed)
    if int16:
        return [rng.integers(-20000, 20000, size=n, dtype=np.int16) for n in lengths]
    return [rng.normal(size=n).astype(np.float32) * 0.3 for n in lengths]


def _ragged_schedule(signals, seed, lo=700, hi=3000):
    """Per tick, per stream, the chunk to feed: ragged sizes, one seed."""
    rng = np.random.default_rng(seed)
    pos = [0] * len(signals)
    ticks = []
    while any(p < len(x) for p, x in zip(pos, signals)):
        feeds = {}
        for i, x in enumerate(signals):
            n = int(rng.integers(lo, hi))
            if pos[i] < len(x):
                feeds[i] = x[pos[i]: pos[i] + n]
                pos[i] += n
        ticks.append(feeds)
    return ticks


def _play_audio(ms, schedule, n, tail_ticks=4):
    out = [[] for _ in range(n)]
    for feeds in schedule + [{}] * tail_ticks:
        for i, chunk in feeds.items():
            ms.feed(i, chunk)
        for i, p in ms.tick().items():
            out[i].append(np.asarray(p))
    return [np.concatenate(o) if o else np.zeros(0, np.float32) for o in out]


def _play_av(ms, signals, videos, drip, ticks=24):
    """Stream 0 gets both modalities up front; the others get their audio up
    front and their video ``drip`` frames a tick (exercises the gate)."""
    n = len(signals)
    ms.feed(0, pcm=signals[0], video_frames=videos[0])
    for i in range(1, n):
        ms.feed(i, pcm=signals[i])
    out = [[] for _ in range(n)]
    pos = 0
    for _ in range(ticks):
        for i in range(1, n):
            if pos < len(videos[i]):
                ms.feed(i, video_frames=videos[i][pos:pos + drip])
        pos += drip
        for i, p in ms.tick().items():
            out[i].append(np.asarray(p))
    return [np.concatenate(o) if o else np.zeros(0, np.float32) for o in out]


# -- host-side pieces ---------------------------------------------------------

@pytest.mark.parametrize("dtype, span", [(np.float32, False), (np.float32, True),
                                         (np.int16, True)])
def test_stream_hub_matches_jax(dtype, span):
    """feed / frames_ready / assemble(gate=, span=) / reset_stream / reset
    against the JAX package's numpy hub, exact."""
    nfft, hop, bf = 64, 16, 4
    rng = np.random.default_rng(11)
    hubs = (StreamHub(3, nfft, hop, bf, dtype=dtype),
            JStreamHub(3, nfft, hop, bf, force_python=True, dtype=dtype))
    assert hubs[0].span == hubs[1].span == (bf - 1) * hop + nfft

    def draw(n):
        if dtype == np.int16:
            return rng.integers(-32768, 32768, size=n, dtype=np.int16)
        return rng.normal(size=n).astype(np.float32)

    def same_assemble(gate=None):
        got, want = (h.assemble(gate=gate, span=span) for h in hubs)
        assert got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
        for i in range(3):
            if want[2][i]:
                np.testing.assert_array_equal(got[0][i], want[0][i])
        return got[3]

    for i, n in enumerate((500, 140, 380)):
        x = draw(n)
        assert hubs[0].feed(i, x) == hubs[1].feed(i, x)
    assert [hubs[0].frames_ready(i) for i in range(3)] == \
        [hubs[1].frames_ready(i) for i in range(3)]
    assert same_assemble() == 3
    assert same_assemble(np.array([1.0, 0.0, 1.0], np.float32)) == 2
    same_assemble()
    for h in hubs:
        h.reset_stream(0)
    x = draw(300)
    assert hubs[0].feed(0, x) == hubs[1].feed(0, x)
    assert same_assemble() >= 1
    for h in hubs:
        h.reset()
    assert same_assemble() == 0
    assert not hubs[0].assemble(span=span)[1].any()  # peaks cleared


def test_stream_hub_guards_and_span_framing():
    with pytest.raises(ValueError, match="float32 or int16"):
        StreamHub(1, 64, 16, 4, dtype=np.float64)
    hub = StreamHub(1, 64, 16, 4, dtype=np.int16)
    with pytest.raises(TypeError, match="int16"):
        hub.feed(0, np.zeros(8, np.float32))
    with pytest.raises(ValueError, match="span wire only"):
        hub.assemble()
    # |-32768| does not overflow in the peak
    hub.feed(0, np.full(200, -32768, np.int16))
    assert hub.assemble(span=True)[1][0] == 32768.0
    # the span, framed on the device, is the frames wire's block
    x = np.random.default_rng(0).normal(size=300).astype(np.float32)
    hub_f, hub_s = StreamHub(1, 64, 16, 4), StreamHub(1, 64, 16, 4)
    hub_f.feed(0, x)
    hub_s.feed(0, x)
    framed = frame_signal(torch.from_numpy(hub_s.assemble(span=True)[0]), 64, 16)
    np.testing.assert_array_equal(framed.numpy(), hub_f.assemble()[0])


@pytest.mark.parametrize("rates", [(30.0, 62.5), (25.0, 62.5), (29.97, 62.5),
                                   (62.5, 62.5)])
def test_fps_block_schedules_match_jax(rates):
    rate_in, rate_out = rates
    for n_out in (4, 16):
        assert pvideo.fps_block_src_max(n_out, rate_in, rate_out) == \
            jvideo.fps_block_src_max(n_out, rate_in, rate_out)
        for k0 in (0, n_out, 7 * n_out, 1000 * n_out + 3):
            lo, rel = pvideo.fps_block_schedule(k0, n_out, rate_in, rate_out)
            jlo, jrel = jvideo.fps_block_schedule(k0, n_out, rate_in, rate_out)
            assert lo == jlo and rel.dtype == jrel.dtype
            np.testing.assert_array_equal(rel, jrel)
    # a block's schedule is the whole-sequence schedule, sliced
    whole = pvideo.fps_resample_indices(200, rate_in, rate_out)
    lo, rel = pvideo.fps_block_schedule(32, 16, rate_in, rate_out)
    np.testing.assert_array_equal(lo + rel, whole[32:48])


def test_to_wire_video_and_norm_stat():
    frames = np.array([[-3.0, 0.4, 0.5, 254.6, 300.0]], np.float32)
    np.testing.assert_array_equal(serve._to_wire_video(frames, np.uint8),
                                  jserve._to_wire_video(frames, np.uint8))
    assert serve._to_wire_video(frames, np.float32).dtype == np.float32
    assert serve._norm_stat(None, "audio_mean", "cpu") is None
    got = serve._norm_stat({"audio_mean": np.arange(6.0).reshape(2, 3)},
                           "audio_mean", "cpu")
    assert got.shape == (6,) and got.dtype == torch.float32


# -- audio streaming ----------------------------------------------------------

def test_streaming_vad_matches_jax(audio_models):
    """Ragged chunks, the running peak, dataset normalisation, flush."""
    jm, variables, port = audio_models
    x = _signals([21000], seed=4)[0]
    stats = _stats()
    jsv = jserve.StreamingVAD(jm, variables, norm_stats=stats, block_frames=8)
    sv = serve.StreamingVAD(port, norm_stats=stats, block_frames=8, device="cpu")
    rng = np.random.default_rng(0)
    pos, got, want = 0, [], []
    while pos < len(x):
        n = int(rng.integers(100, 5000))
        got.append(sv.feed(x[pos:pos + n]))
        want.append(jsv.feed(x[pos:pos + n]))
        assert got[-1].shape == want[-1].shape and got[-1].dtype == np.float32
        pos += n
    got.append(sv.flush())
    want.append(jsv.flush())
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape and len(got) == 1 + (21000 - 1024) // 256
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    # reset replays identically
    sv.reset()
    again = np.concatenate([sv.feed(x[:9000]), sv.flush()])
    sv.reset()
    np.testing.assert_array_equal(again, np.concatenate([sv.feed(x[:9000]), sv.flush()]))


def test_streaming_matches_offline(audio_models):
    """Chunked streaming with the known global peak equals the offline
    forward of the whole utterance (the carries cross block boundaries)."""
    _, _, port = audio_models
    x = _signals([30000], seed=5)[0]
    with torch.inference_mode():
        feats = log_power_frontend(torch.from_numpy(x)[None], pad_at_end=False)
        offline = torch.sigmoid(port(feats))[0, :, 0].numpy()
    sv = serve.StreamingVAD(port, block_frames=8, fixed_peak=float(np.abs(x).max()),
                            device="cpu")
    rng = np.random.default_rng(0)
    pos, outs = 0, []
    while pos < len(x):
        n = int(rng.integers(100, 5000))
        outs.append(sv.feed(x[pos:pos + n]))
        pos += n
    outs.append(sv.flush())
    stream = np.concatenate(outs)
    assert len(stream) == len(offline)
    np.testing.assert_allclose(stream, offline, atol=OFFLINE_ATOL)


WIRES = {"frames": {}, "span": {"span_wire": True},
         "span_hop_dft": {"span_wire": True, "hop_dft": True},
         "span_int16": {"span_wire": True, "audio_int16": True},
         "span_int16_hop_dft": {"span_wire": True, "audio_int16": True,
                                "hop_dft": True}}


@pytest.mark.parametrize("wire", WIRES)
def test_multistream_vad_matches_jax(audio_models, wire):
    """Three streams of different lengths fed in ragged chunks, on every
    audio wire, with dataset normalisation."""
    jm, variables, port = audio_models
    kw = WIRES[wire]
    signals = _signals([15000, 9000, 12000], seed=6, int16=kw.get("audio_int16", False))
    schedule = _ragged_schedule(signals, seed=7)
    stats = _stats()
    want = _play_audio(jserve.MultiStreamVAD(jm, variables, 3, norm_stats=stats,
                                             block_frames=8, native=False, **kw),
                       schedule, 3)
    got = _play_audio(serve.MultiStreamVAD(port, 3, norm_stats=stats, block_frames=8,
                                           device="cpu", **kw), schedule, 3)
    for g, w, x in zip(got, want, signals):
        assert len(g) == len(w) == (1 + (len(x) - 1024) // 256) // 8 * 8
        np.testing.assert_allclose(g, w, atol=PROB_ATOL)


def test_wires_agree_within_the_port(audio_models):
    """Span wire against frames wire: exact (the same numbers through the
    same operations); int16 against float span fed the same int16-origin
    samples: exact; hop_dft: fp32 rounding."""
    _, _, port = audio_models
    sig_i = _signals([15000, 9000, 12000], seed=8, int16=True)
    sig_f = [x.astype(np.float32) / 32768.0 for x in sig_i]

    def run(signals, **kw):
        ms = serve.MultiStreamVAD(port, 3, block_frames=8, max_backlog_blocks=256,
                                  device="cpu", **kw)
        return _play_audio(ms, [dict(enumerate(signals))], 3, tail_ticks=8)

    base = run(sig_f)
    span = run(sig_f, span_wire=True)
    i16 = run(sig_i, span_wire=True, audio_int16=True)
    hop = run(sig_f, span_wire=True, hop_dft=True)
    i16_hop = run(sig_i, span_wire=True, audio_int16=True, hop_dft=True)
    for i in range(3):
        assert len(base[i]) >= 24
        np.testing.assert_array_equal(span[i], base[i])
        np.testing.assert_array_equal(i16[i], base[i])
        np.testing.assert_array_equal(i16_hop[i], hop[i])
        np.testing.assert_allclose(hop[i], base[i], atol=PROB_ATOL)
    with pytest.raises(ValueError, match="span_wire"):
        serve.MultiStreamVAD(port, 3, hop_dft=True, device="cpu")
    with pytest.raises(ValueError, match="span_wire"):
        serve.MultiStreamVAD(port, 3, audio_int16=True, device="cpu")
    ms = serve.MultiStreamVAD(port, 3, span_wire=True, audio_int16=True, device="cpu")
    with pytest.raises(TypeError, match="int16"):
        ms.feed(0, sig_f[0])


def test_multistream_matches_solo_streams(audio_models):
    """Each stream of a batched tick against a solo StreamingVAD fed the
    same data, despite streams of different lengths sharing the step."""
    _, _, port = audio_models
    signals = _signals([15000, 5000, 11000], seed=9)
    solo = []
    for x in signals:
        sv = serve.StreamingVAD(port, block_frames=8,
                                fixed_peak=float(np.abs(x).max()), device="cpu")
        solo.append(np.concatenate([sv.feed(x), sv.flush()]))
    ms = serve.MultiStreamVAD(port, 3, block_frames=8, max_backlog_blocks=256,
                              device="cpu")
    got = _play_audio(ms, [dict(enumerate(signals))], 3, tail_ticks=8)
    for g, s in zip(got, solo):
        assert len(s) - 8 < len(g) <= len(s)  # the tail under one block differs
        np.testing.assert_allclose(g, s[:len(g)], atol=SOLO_ATOL)


def test_tick_pipelined_matches_sync_one_tick_late(audio_models):
    """tick_pipelined returns the synchronous tick's probabilities one tick
    late; flush_pipelined drains the tail; trailing empty ticks lose
    nothing (the hub reuses its assemble buffers)."""
    _, _, port = audio_models
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=4 * 256 + 768).astype(np.float32) * 0.1] + \
             [rng.normal(size=4 * 256).astype(np.float32) * 0.1 for _ in range(5)]

    def play(pipelined):
        ms = serve.MultiStreamVAD(port, 2, block_frames=4, device="cpu")
        outs = []
        for c in chunks + [None, None]:
            if c is not None:
                for i in range(2):
                    ms.feed(i, c * (1 + i))
            outs.append(ms.tick_pipelined() if pipelined else ms.tick())
        if pipelined:
            outs.append(ms.flush_pipelined())
        return outs

    sync, piped = play(False), play(True)
    assert piped[0] == {}
    for t, want in enumerate(sync[:len(chunks)]):
        got = piped[t + 1]
        assert set(got) == set(want) == {0, 1}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for i in range(2):
        np.testing.assert_array_equal(
            np.concatenate([o[i] for o in piped if i in o]),
            np.concatenate([o[i] for o in sync if i in o]))
    ms = serve.MultiStreamVAD(port, 1, block_frames=4, device="cpu")
    assert ms.flush_pipelined() == {}


def test_reset_stream_cancels_pending_pipelined_result(audio_models):
    """A recycled slot does not deliver the in-flight result of the stream
    that owned it; the other streams' pending results stay; reset() drops
    the whole pending tick."""
    _, _, port = audio_models
    pcm = np.random.default_rng(1).normal(size=4 * 256 + 768).astype(np.float32) * 0.1
    ms = serve.MultiStreamVAD(port, 2, block_frames=4, device="cpu")
    ms.feed(0, pcm)
    ms.feed(1, pcm)
    assert ms.tick_pipelined() == {}
    assert ms.pending_streams() == {0, 1}
    ms.reset_stream(0)
    assert ms.pending_streams() == {1}
    assert set(ms.flush_pipelined()) == {1}
    ms.feed(0, pcm)
    ms.feed(1, pcm)
    assert ms.tick_pipelined() == {}
    ms.reset()
    assert ms.pending_streams() == set()
    assert ms.flush_pipelined() == {}


def test_unfetched_tick_survives_the_next_assemble(audio_models):
    """tick(fetch=False) keeps device tensors whose inputs were private
    copies: the next tick's assemble does not change them."""
    _, _, port = audio_models
    rng = np.random.default_rng(2)
    chunks = [rng.normal(size=4 * 256 + 768).astype(np.float32),
              rng.normal(size=4 * 256).astype(np.float32)]
    ms = serve.MultiStreamVAD(port, 1, block_frames=4, device="cpu")
    ref = serve.MultiStreamVAD(port, 1, block_frames=4, device="cpu")
    ms.feed(0, chunks[0])
    ref.feed(0, chunks[0])
    lazy = ms.tick(fetch=False)
    want = ref.tick()
    ms.feed(0, chunks[1])
    ms.tick()
    assert isinstance(lazy[0], torch.Tensor)
    np.testing.assert_array_equal(lazy[0].numpy(), want[0])
    # the upload helper never aliases its source
    src = np.ones(4, np.float32)
    up = serve._upload(src, torch.device("cpu"))
    src[:] = 7.0
    assert up.tolist() == [1.0] * 4


def test_reset_stream_clears_one_row_of_carries(audio_models):
    _, _, port = audio_models
    pcm = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    ms = serve.MultiStreamVAD(port, 2, block_frames=4, device="cpu")
    ms.feed(0, pcm)
    ms.feed(1, pcm * 0.5)
    assert sorted(ms.tick()) == [0, 1]
    before = [(h.clone(), c.clone()) for h, c in ms._carries]
    ms.reset_stream(1)
    ptrs = {t.data_ptr() for hc in ms._carries for t in hc}
    assert len(ptrs) == 2 * len(ms._carries)  # no state aliases another
    for (h, c), (hb, cb) in zip(ms._carries, before):
        assert hb[1].abs().max() > 0 and not h[1].any() and not c[1].any()
        assert torch.equal(h[0], hb[0]) and torch.equal(c[0], cb[0])
    assert ms._hub.frames_ready(1) == 0 and not ms.has_full_block(1)
    assert ms.has_full_block(0)


def test_backlog_overflow_raises(audio_models, av_models):
    _, _, port = audio_models
    ms = serve.MultiStreamVAD(port, 1, block_frames=4, max_backlog_blocks=2, device="cpu")
    ms.feed(0, np.zeros(1024 + 7 * 256, np.float32))  # 8 frames: at the cap
    with pytest.raises(ValueError, match="audio backlog"):
        ms.feed(0, np.zeros(256, np.float32))
    av = serve.MultiStreamAVVAD(av_models[2], 1, block_frames=4, max_backlog_blocks=2,
                                device="cpu")
    av.feed(0, video_frames=np.zeros((8, 67, 67), np.float32))
    with pytest.raises(ValueError, match="video backlog"):
        av.feed(0, video_frames=np.zeros((1, 67, 67), np.float32))
    with pytest.raises(ValueError, match="audio backlog"):
        av.feed(0, pcm=np.zeros(1024 + 8 * 256, np.float32))
    with pytest.raises(ValueError, match="exceeds the"):
        serve.MultiStreamAVVAD(av_models[2], 1, video_fps=90.0, device="cpu")


def test_warmup_leaves_state_untouched(audio_models, av_models):
    pcm = np.random.default_rng(4).normal(size=4096).astype(np.float32)
    vid = np.random.default_rng(5).normal(size=(8, 67, 67)).astype(np.float32)
    outs = []
    for warm in (False, True):
        ms = serve.MultiStreamVAD(audio_models[2], 2, block_frames=4, span_wire=True,
                                  audio_int16=True, device="cpu")
        av = serve.MultiStreamAVVAD(av_models[2], 2, block_frames=4, video_fps=30.0,
                                    video_uint8=True, device="cpu")
        ms.feed(0, (pcm * 1000).astype(np.int16))
        av.feed(0, pcm=pcm, video_frames=vid)
        if warm:
            ms.warmup()
            av.warmup()
        outs.append((ms.tick()[0], av.tick()[0]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# -- audio-visual streaming ---------------------------------------------------

def _lip_frames(n, seed, integer=True):
    rng = np.random.default_rng(seed)
    v = rng.random((n, 67, 67)) * 255
    return (np.round(v) if integer else v).astype(np.float32)


def test_streaming_avvad_matches_jax(av_models):
    """Ragged synchronised chunks of both modalities, MCB fusion with the
    per-block L2 norm, both normalisations, flush of a partial block."""
    jm, variables, port = av_models
    x = _signals([12000], seed=10)[0]
    frames = _lip_frames(40, seed=11, integer=False)
    stats = _stats(video=True)
    jsv = jserve.StreamingAVVAD(jm, variables, norm_stats=stats, block_frames=8)
    sv = serve.StreamingAVVAD(port, norm_stats=stats, block_frames=8, device="cpu")
    rng = np.random.default_rng(0)
    pa = pv = 0
    got, want = [], []
    while pa < len(x) or pv < len(frames):
        na, nv = int(rng.integers(500, 4000)), int(rng.integers(2, 16))
        got.append(sv.feed(x[pa:pa + na], frames[pv:pv + nv]))
        want.append(jsv.feed(x[pa:pa + na], frames[pv:pv + nv]))
        pa, pv = pa + na, pv + nv
    got.append(sv.flush())
    want.append(jsv.flush())
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (40,)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)


AV_WIRES = {
    "frames_62.5fps": dict(block_frames=8),
    "camera_30fps_uint8_span_int16_hop_dft": dict(
        block_frames=16, video_fps=30.0, video_uint8=True, span_wire=True,
        audio_int16=True, hop_dft=True)}


@pytest.mark.parametrize("wire", AV_WIRES)
def test_multistream_avvad_matches_jax(av_models, wire):
    """Two streams, one with lagging video (the gated assemble holds its
    samples): 62.5 fps float frames on the frames wire, and 30 fps uint8
    camera frames (8- and 9-source-frame blocks) with the int16 span wire
    and the hop-block DFT."""
    jm, variables, port = av_models
    kw = AV_WIRES[wire]
    camera = "video_fps" in kw
    signals = _signals([40000, 30000] if camera else [9000, 7000], seed=12,
                       int16=camera)
    videos = [_lip_frames(60 if camera else 30, seed=13 + i, integer=camera)
              for i in range(2)]
    stats = _stats(video=True)
    drip = 5 if camera else 8
    want = _play_av(jserve.MultiStreamAVVAD(jm, variables, 2, norm_stats=stats,
                                            native=False, **kw),
                    signals, videos, drip)
    got = _play_av(serve.MultiStreamAVVAD(port, 2, norm_stats=stats, device="cpu", **kw),
                   signals, videos, drip)
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 2 * kw["block_frames"]
        np.testing.assert_allclose(g, w, atol=PROB_ATOL)


def test_multistream_avvad_bf16_matches_jax():
    """The bf16 model, as served at full width: bf16 convs and input
    projections, float32 carries (the recurrent product promotes to float32
    over the bf16-rounded weight on both sides), fp32 MCB and head."""
    jm = JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                mcb_output_size=MCB_OUT, dtype=jnp.bfloat16)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, 513)),
                                 jnp.zeros((1, 4, 67, 67))))
    port = AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                 mcb_output_size=MCB_OUT, dtype=torch.bfloat16)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    signals = _signals([9000, 7000], seed=21)
    videos = [_lip_frames(30, seed=22 + i) for i in range(2)]
    stats = _stats(video=True)
    want = _play_av(jserve.MultiStreamAVVAD(jm, variables, 2, norm_stats=stats,
                                            block_frames=8, native=False),
                    signals, videos, 8)
    got = _play_av(serve.MultiStreamAVVAD(port, 2, norm_stats=stats, block_frames=8,
                                          device="cpu"), signals, videos, 8)
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 16 and g.dtype == np.float32
        # bf16 rounds at other places in the two frameworks (XLA's CPU
        # backend keeps some products at fp32): the bar of the bf16 serving
        # step in tests/test_torch_port_models.py
        np.testing.assert_allclose(g, w, atol=3e-4)


def test_camera_rate_and_uint8_wires_within_the_port(av_models):
    """30 fps source frames against the same frames pre-upsampled to 62.5
    fps: exact (the tower is frame-local and the gather duplicates); uint8
    against float video for integer frames: exact; fractional frames:
    bounded by the quantisation; a recycled slot replays as a fresh one."""
    _, _, port = av_models
    signals = _signals([40000, 40000], seed=14)
    src = [_lip_frames(60, seed=15 + i) for i in range(2)]
    up = [v[pvideo.fps_resample_indices(len(v), 30.0, 62.5)] for v in src]

    def run(videos, drip, **kw):
        ms = serve.MultiStreamAVVAD(port, 2, block_frames=16, device="cpu", **kw)
        return _play_av(ms, signals, videos, drip)

    base = run(up, 11)
    cam = run(src, 5, video_fps=30.0)
    u8 = run(up, 11, video_uint8=True)
    frac = [(v + np.random.default_rng(1).uniform(-0.49, 0.49, v.shape)
             ).astype(np.float32).clip(0, 255) for v in up]
    for i in range(2):
        assert len(base[i]) >= 7 * 16 and len(cam[i]) == len(base[i])
        np.testing.assert_array_equal(cam[i], base[i])
        np.testing.assert_array_equal(u8[i], base[i])
    for a, b in zip(run(frac, 11, video_uint8=True), run(frac, 11)):
        np.testing.assert_allclose(a, b, atol=0.02)
    ms = serve.MultiStreamAVVAD(port, 1, block_frames=16, video_fps=30.0,
                                video_uint8=True, device="cpu")
    assert ms._vout.dtype == np.uint8 and ms._vout.shape[1] == 9
    ms.feed(0, pcm=signals[0], video_frames=src[0])
    first = ms.tick()[0]
    ms.tick()
    ms.reset_stream(0)
    ms.feed(0, pcm=signals[0], video_frames=src[0])
    np.testing.assert_array_equal(ms.tick()[0], first)


def test_multistream_av_matches_solo_streams(av_models):
    """Each stream of the batched AV tick (per-stream L2 norm) against a
    solo StreamingAVVAD fed the same data."""
    _, _, port = av_models
    signals = _signals([9000, 7000], seed=16)
    videos = [_lip_frames(30, seed=17 + i) for i in range(2)]
    solo = []
    for x, v in zip(signals, videos):
        sv = serve.StreamingAVVAD(port, block_frames=8,
                                  fixed_peak=float(np.abs(x).max()), device="cpu")
        solo.append(np.concatenate([sv.feed(x, v), sv.flush()]))
    got = _play_av(serve.MultiStreamAVVAD(port, 2, block_frames=8, device="cpu"),
                   signals, videos, drip=8)
    for g, s in zip(got, solo):
        assert len(s) - 8 < len(g) <= len(s)
        np.testing.assert_allclose(g, s[:len(g)], atol=PROB_ATOL)


def test_av_pipelined_tick_and_slot_recycling(av_models):
    _, _, port = av_models
    pcm = _signals([1024 + 7 * 256], seed=18)[0]
    vid = _lip_frames(8, seed=19)

    def fresh():
        ms = serve.MultiStreamAVVAD(port, 2, block_frames=4, device="cpu")
        for i in range(2):
            ms.feed(i, pcm=pcm, video_frames=vid)
        return ms

    sync = fresh()
    want = [sync.tick(), sync.tick()]
    ms = fresh()
    assert ms.tick_pipelined() == {}
    out = ms.tick_pipelined()
    np.testing.assert_array_equal(out[1], want[0][1])
    assert ms.pending_streams() == {0, 1}
    ms.reset_stream(0)
    tail = ms.flush_pipelined()
    assert set(tail) == {1}
    np.testing.assert_array_equal(tail[1], want[1][1])
    assert len(ms._vbufs[0]) == 0 and not ms._carries[0][0][0].any()


# -- the offline serving step -------------------------------------------------

@pytest.mark.parametrize("hop_dft", [False, True])
def test_audio_serving_fn_matches_jax(hop_dft):
    """``make_waveform_serving_fn`` for AudioVAD (the JAX LSTM through its
    Pallas kernel in interpret mode, the port through the plain version of
    its kernel), on the direct and on the hop-block DFT frontend."""
    t_frames, n = 8, 256 * 7 + 1024
    wave = _signals([n, n], seed=20)
    wave = np.stack(wave)
    stats = _stats()
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True)
    variables = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.zeros((2, t_frames, 513))))
    want = np.asarray(jmake_serving_fn(jm, variables, t_frames=t_frames, hop_dft=hop_dft,
                                       norm_stats=stats)(jnp.asarray(wave)))
    port = AudioVAD(lstm_hidden_size=H, lstm_layers=2, use_kernel_lstm=True)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    fn = make_waveform_serving_fn(port, t_frames=t_frames, hop_dft=hop_dft,
                                  norm_stats=stats, device="cpu")
    got = fn(wave)
    assert got.shape == (2, t_frames, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL)
    if hop_dft:
        direct = make_waveform_serving_fn(port, t_frames=t_frames, norm_stats=stats,
                                          device="cpu")(wave)
        assert not torch.equal(got, direct)  # another route really ran
        np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=PROB_ATOL)


def test_stft_config_matches_jax():
    from avvad_tpu.config import STFTConfig as JSTFTConfig

    for kw in ({}, {"fs": 8000, "wlen_sec": 32e-3, "hop_percent": 0.5}):
        a, b = STFTConfig(**kw), JSTFTConfig(**kw)
        assert (a.nfft, a.hopsamp, a.n_freq, a.frame_rate, a.eps) == \
            (b.nfft, b.hopsamp, b.n_freq, b.frame_rate, b.eps)
    with pytest.raises(ValueError, match="integer"):
        STFTConfig(wlen_sec=0.01001).nfft
