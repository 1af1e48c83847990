"""CPU parity of the port's video-only streaming with the JAX package.

``VideoVAD.streaming_head``, ``StreamingVideoVAD`` and
``MultiStreamVideoVAD`` against the JAX ones on the same weights (the JAX
modules' init through ``convert.from_flax_variables``) and the same seeded
lip frames and feed schedules; the port runs with ``device="cpu"``. With
carries both sides run the LSTM as a plain scan. The static-int8 streamer
runs the JAX package's Pallas trunk in interpret mode and the port's
kernels' plain versions (K3 and K2 on CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu import serve as jserve
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.models.quantize import calibrate as jcalibrate
from avvad_tpu.processing.video import upsample_video as jupsample_video
from avvad_tpu_torch import serve
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.models import VideoVAD
from avvad_tpu_torch.ops import conv_fused, stem_fused
from avvad_tpu_torch.processing import video as pvideo

H = 32
# probabilities, port against JAX on the same weights and frames: fp32 on
# both sides, the trunk's convolutions and the scan summing in another order
# (readings up to 1.8e-7)
PROB_ATOL = 1e-5
# rows of one batched step against a batch of one within the port (reading
# 6.0e-8)
SOLO_ATOL = 1e-6
# streaming against the offline forward (tests/test_serve.py:297-323)
OFFLINE_ATOL = 1e-5
# the static-int8 streamer against JAX's: the int8 trunks flip one LSB on
# rounding ties (XLA's rsqrt in the BatchNorm fold), which moves the tower's
# features by about 1e-4 relative (tests/test_torch_port_int8.py); the
# logits' bar there is 1e-3 (reading here 6.0e-8)
INT8_PROB_ATOL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lip_frames(n, seed, integer=True):
    rng = np.random.default_rng(seed)
    v = rng.random((n, 67, 67)) * 255
    return (np.round(v) if integer else v).astype(np.float32)


STATS = {"video_mean": np.float32(120.0), "video_std": np.float32(60.0)}


@pytest.fixture(scope="module")
def video_models():
    """2 x LSTM 32 with the float ResNet-18 and non-trivial BatchNorm
    running statistics -> (JAX model, its variables, the port's twin)."""
    jm = JVideoVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2)
    variables = dict(_np_tree(jm.init(jax.random.PRNGKey(4),
                                      jnp.zeros((1, 4, 67, 67)))))
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.random(a.shape)).astype(np.float32),
        variables["batch_stats"])
    port = VideoVAD(lstm_hidden_size=H, lstm_layers=2)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port.eval()


def _carries(seed, n, h=H, layers=2):
    rng = np.random.default_rng(seed)
    return [tuple(np.tanh(rng.normal(size=(n, h))).astype(np.float32) for _ in range(2))
            for _ in range(layers)]


@pytest.mark.parametrize("indexed", [False, True], ids=["label_rate", "per_stream_gather"])
def test_streaming_head_matches_jax(video_models, indexed):
    """One block from nonzero carries: logits and the new carries. With
    indices the video holds 5 unique frames a stream and each stream
    gathers them on its own schedule (another resample phase per row)."""
    jm, variables, port = video_models
    n, tc = 2, 8
    video = np.stack([_lip_frames(5 if indexed else tc, seed=30 + i) for i in range(n)]) / 255
    idx = np.stack([pvideo.fps_block_schedule(k0, tc, 30.0, 62.5)[1]
                    for k0 in (0, 3)]) if indexed else None
    assert idx is None or not np.array_equal(idx[0], idx[1])
    carries = _carries(6, n)
    kw = {"video_frame_indices": jnp.asarray(idx)} if indexed else {}
    logits_j, carries_j = jm.apply(variables, jnp.asarray(video),
                                   [tuple(map(jnp.asarray, hc)) for hc in carries],
                                   method=jm.streaming_head, **kw)
    with torch.no_grad():
        logits, new = port.streaming_head(
            torch.from_numpy(video), [tuple(map(torch.from_numpy, hc)) for hc in carries],
            video_frame_indices=None if idx is None else torch.from_numpy(idx))
    assert logits.shape == (n, tc, 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), atol=PROB_ATOL)
    for (h, c), (hj, cj) in zip(new, carries_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=PROB_ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=PROB_ATOL)


@pytest.mark.parametrize("wire", ["float32", "float32_stats", "uint8_stats"])
def test_streaming_video_vad_matches_jax(video_models, wire):
    """Ragged chunks of lip frames, flush of a partial block; the float32
    and the uint8 wire, with and without the dataset's normalisation (eps
    from ``STFTConfig``)."""
    jm, variables, port = video_models
    kw = {"norm_stats": STATS if wire.endswith("stats") else None,
          "video_uint8": wire.startswith("uint8"), "block_frames": 8}
    frames = _lip_frames(37, seed=7, integer=False)
    jsv = jserve.StreamingVideoVAD(jm, variables, **kw)
    sv = serve.StreamingVideoVAD(port, device="cpu", **kw)
    rng = np.random.default_rng(8)
    pos, got, want = 0, [], []
    while pos < len(frames):
        n = int(rng.integers(1, 14))
        got.append(sv.feed(frames[pos:pos + n]))
        want.append(jsv.feed(frames[pos:pos + n]))
        assert got[-1].shape == want[-1].shape and got[-1].dtype == np.float32
        pos += n
    got.append(sv.flush())
    want.append(jsv.flush())
    assert sv.flush().shape == (0,)
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (37,)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    sv.reset()
    np.testing.assert_array_equal(np.concatenate([sv.feed(frames), sv.flush()]), got)


def test_streaming_video_matches_offline(video_models):
    """Streaming equals the offline VideoVAD forward of the same frames:
    the tower is frame-local and the carries cross the blocks; a
    non-aligned tail goes through flush(). The uint8 wire is exact for
    integer frames."""
    _, _, port = video_models
    video = _lip_frames(37, seed=9, integer=False)
    with torch.no_grad():
        offline = torch.sigmoid(port(torch.from_numpy(video)[None]))[0, :, 0].numpy()
    sv = serve.StreamingVideoVAD(port, block_frames=8, device="cpu")
    got = np.concatenate([sv.feed(video[:5]), sv.feed(video[5:20]), sv.feed(video[20:]),
                          sv.flush()])
    assert got.shape == offline.shape
    np.testing.assert_allclose(got, offline, atol=OFFLINE_ATOL)
    vu = np.round(video)
    outs = []
    for uint8 in (True, False):
        s = serve.StreamingVideoVAD(port, block_frames=8, video_uint8=uint8, device="cpu")
        outs.append(np.concatenate([s.feed(vu), s.flush()]))
    np.testing.assert_array_equal(outs[0], outs[1])


def _play_video(ms, videos, drip, ticks=16):
    """Stream 0 gets its frames up front, the others ``drip`` a tick."""
    n = len(videos)
    ms.feed(0, video_frames=videos[0])
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


VIDEO_WIRES = {
    "frames_62.5fps": dict(block_frames=8),
    "camera_30fps_uint8_stats": dict(block_frames=16, video_fps=30.0, video_uint8=True,
                                     norm_stats=STATS)}


@pytest.mark.parametrize("wire", VIDEO_WIRES)
def test_multistream_video_vad_matches_jax(video_models, wire):
    """Three streams, two of them dripping: label-rate float frames, and
    30 fps uint8 camera frames (8- and 9-frame blocks of unique frames, a
    resample phase per stream) with the dataset's normalisation."""
    jm, variables, port = video_models
    kw = VIDEO_WIRES[wire]
    camera = "video_fps" in kw
    videos = [_lip_frames(n, seed=10 + i, integer=camera)
              for i, n in enumerate((40, 30, 26) if camera else (40, 24, 33))]
    drip = 5 if camera else 7
    want = _play_video(jserve.MultiStreamVideoVAD(jm, variables, 3, **kw), videos, drip)
    got = _play_video(serve.MultiStreamVideoVAD(port, 3, device="cpu", **kw), videos, drip)
    for g, w in zip(got, want):
        assert len(g) == len(w) >= kw["block_frames"] and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=PROB_ATOL)


def test_multistream_video_matches_solo_streams(video_models):
    """N batched streams with masked carries equal N solo runs, with ragged
    per-stream progress (tests/test_serve.py:329); audio is refused."""
    _, _, port = video_models
    vids = [_lip_frames(n, seed=20 + i, integer=False) for i, n in enumerate((40, 24, 33))]
    solo = []
    for v in vids:
        sv = serve.StreamingVideoVAD(port, block_frames=8, device="cpu")
        solo.append(np.concatenate([sv.feed(v), sv.flush()]))
    ms = serve.MultiStreamVideoVAD(port, 3, block_frames=8, max_backlog_blocks=256,
                                   device="cpu")
    got = _play_video(ms, vids, drip=7)
    for g, s, v in zip(got, solo, vids):
        n = len(v) // 8 * 8  # the multi-stream server emits full blocks only
        assert len(g) == n
        np.testing.assert_allclose(g, s[:n], atol=SOLO_ATOL)
    with pytest.raises(ValueError, match="audio payload"):
        ms.feed(0, pcm=np.zeros(100, np.float32))


def test_camera_rate_bitexact_within_the_port(video_models):
    """30 fps source frames against the same frames pre-upsampled to 62.5
    fps: bit for bit across ticks (the tower is frame-local and the gather
    duplicates), and a slot recycled mid-stream replays as a fresh one
    (tests/test_serve.py:575)."""
    _, _, port = video_models
    src = [_lip_frames(50, seed=25 + i) for i in range(2)]
    up = [jupsample_video(v) for v in src]
    np.testing.assert_array_equal(
        up[0], src[0][pvideo.fps_resample_indices(len(src[0]), 30.0, 62.5)])

    def run(videos, drip, **kw):
        ms = serve.MultiStreamVideoVAD(port, 2, block_frames=16, video_uint8=True,
                                       device="cpu", **kw)
        return _play_video(ms, videos, drip)

    base = run(up, 15)
    cam = run(src, 7, video_fps=30.0)
    for i in range(2):
        assert len(base[i]) >= 6 * 16 and len(cam[i]) == len(base[i])
        np.testing.assert_array_equal(cam[i], base[i])
    ms = serve.MultiStreamVideoVAD(port, 1, block_frames=16, video_fps=30.0,
                                   video_uint8=True, device="cpu")
    assert ms._vout.dtype == np.uint8 and ms._vout.shape[1] == 9
    ms.feed(0, video_frames=src[0])
    first = ms.tick()[0]
    ms.tick()
    ms.reset_stream(0)
    assert not ms._carries[0][0][0].any() and ms._vpos[0] == 0
    ms.feed(0, video_frames=src[0])
    np.testing.assert_array_equal(ms.tick()[0], first)


def test_video_pipelined_tick_and_slot_recycling(video_models):
    """tick_pipelined returns the synchronous tick's probabilities one tick
    late, flush_pipelined drains the tail, a recycled slot does not deliver
    its pending result, reset() drops the pending tick."""
    _, _, port = video_models
    vids = [_lip_frames(24, seed=27 + i) for i in range(2)]

    def fresh():
        ms = serve.MultiStreamVideoVAD(port, 2, block_frames=4, device="cpu")
        for i in range(2):
            ms.feed(i, video_frames=vids[i])
        return ms

    sync = fresh()
    want = [sync.tick() for _ in range(6)]
    ms = fresh()
    got = [ms.tick_pipelined() for _ in range(6)] + [ms.flush_pipelined()]
    assert got[0] == {}
    for t, w in enumerate(want):
        assert set(got[t + 1]) == set(w) == {0, 1}
        for k in w:
            np.testing.assert_array_equal(got[t + 1][k], w[k])
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
    ms.tick_pipelined()
    ms.reset()
    assert ms.pending_streams() == set() and ms.flush_pipelined() == {}


def test_video_backlog_overflow_raises(video_models):
    _, _, port = video_models
    ms = serve.MultiStreamVideoVAD(port, 1, block_frames=4, max_backlog_blocks=2,
                                   device="cpu")
    ms.feed(0, video_frames=np.zeros((8, 67, 67), np.float32))  # at the cap
    with pytest.raises(ValueError, match="video backlog"):
        ms.feed(0, video_frames=np.zeros((1, 67, 67), np.float32))
    cam = serve.MultiStreamVideoVAD(port, 1, block_frames=16, max_backlog_blocks=1,
                                    video_fps=30.0, device="cpu")
    cam.feed(0, video_frames=np.zeros((8 + 9, 67, 67), np.float32))  # 16 at 30 fps + 9
    with pytest.raises(ValueError, match="video backlog"):
        cam.feed(0, video_frames=np.zeros((1, 67, 67), np.float32))
    with pytest.raises(ValueError, match="exceeds the"):
        serve.MultiStreamVideoVAD(port, 1, video_fps=90.0, device="cpu")


def test_video_warmup_and_unfetched_tick(video_models):
    """warmup() leaves every stream's state as it was; tick(fetch=False)
    keeps its result through the next tick."""
    _, _, port = video_models
    vid = _lip_frames(32, seed=29)
    outs = []
    for warm in (False, True):
        ms = serve.MultiStreamVideoVAD(port, 2, block_frames=8, video_fps=30.0,
                                       video_uint8=True, device="cpu")
        ms.feed(0, video_frames=vid)
        if warm:
            ms.warmup()
        outs.append(ms.tick()[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    ms = serve.MultiStreamVideoVAD(port, 1, block_frames=8, device="cpu")
    ms.feed(0, video_frames=vid)
    lazy = ms.tick(fetch=False)
    ms.tick()
    assert isinstance(lazy[0], torch.Tensor)
    ref = serve.MultiStreamVideoVAD(port, 1, block_frames=8, device="cpu")
    ref.feed(0, video_frames=vid)
    np.testing.assert_array_equal(lazy[0].numpy(), ref.tick()[0])


# -- the static-int8 tower on its fused kernels' plain versions ----------------

H8 = 16


@pytest.fixture(scope="module")
def int8_models():
    """JAX VideoVAD (2 x LSTM 16) with the int8 tower, calibrated on 6
    frames in "calibrate" mode, then static with the Pallas trunk; the
    port's twin with ``tower_pallas`` from the same variables."""
    rng = np.random.default_rng(40)
    frames = jnp.asarray(rng.random((1, 6, 67, 67)).astype(np.float32) * 255)
    cal = JVideoVAD(lstm_hidden_size=H8, lstm_layers=2, tower_int8=True,
                    tower_quant_mode="calibrate")
    init = _np_tree(cal.init(jax.random.PRNGKey(5), frames))
    variables = _np_tree(jcalibrate(cal, init, [(frames,)], train=False))
    jm = JVideoVAD(lstm_hidden_size=H8, lstm_layers=2, tower_int8=True,
                   tower_quant_mode="static", tower_pallas=True)
    port = VideoVAD(lstm_hidden_size=H8, lstm_layers=2, tower_int8=True,
                    tower_quant_mode="static", tower_pallas=True)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port.eval()


def test_static_int8_video_streamer_matches_jax(int8_models):
    """MultiStreamVideoVAD on the static-int8 tower, 30 fps uint8 camera
    frames, two streams (one dripping): the port's channels-last stem,
    K3 and 8 x K2 plain versions against JAX's Pallas trunk in interpret
    mode, at the int8 noise bar; no kernel launches on CPU tensors."""
    jm, variables, port = int8_models
    kw = dict(block_frames=8, video_fps=30.0, video_uint8=True, norm_stats=None)
    videos = [_lip_frames(n, seed=41 + i) for i, n in enumerate((16, 12))]
    want = _play_video(jserve.MultiStreamVideoVAD(jm, variables, 2, **kw), videos, 4, ticks=4)
    for mod in (conv_fused, stem_fused):
        mod.reset_launches()
    got = _play_video(serve.MultiStreamVideoVAD(port, 2, device="cpu", **kw), videos, 4,
                      ticks=4)
    assert not any(conv_fused.launches.values()) and not any(stem_fused.launches.values())
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 16
        np.testing.assert_allclose(g, w, atol=INT8_PROB_ATOL)
    # the int8 tower really ran: the float tower on the same weights differs
    float_port = VideoVAD(lstm_hidden_size=H8, lstm_layers=2)
    float_port.load_state_dict({k: v for k, v in port.state_dict().items()
                                if k.rsplit(".", 1)[-1] not in ("q_stem", "q1", "q_out")})
    ref = _play_video(serve.MultiStreamVideoVAD(float_port, 2, device="cpu", **kw), videos, 4,
                      ticks=4)
    assert not np.array_equal(got[0], ref[0])
