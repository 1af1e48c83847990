"""CPU parity of the port's serving artifacts with the JAX package's
(avvad_tpu/export.py and tests/test_export.py, the tests without a mesh).

Weights are made by the JAX modules' own init and carried across by
``convert.from_flax_variables``; waveforms, lip frames, carries and feeds
are seeded numpy draws handed to both sides. Each port artifact is a
``torch.export`` program saved into a zip and loaded back; its replay is
held against the live port step, and against the JAX package's artifact of
the same weights on the same inputs. On the CPU the custom ops run their
kernels' plain versions.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu import export as jexport
from avvad_tpu import serve as jserve
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import RawAudioVAD as JRawAudioVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu_torch import serve
from avvad_tpu_torch.config import STFTConfig
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import (ServingArtifact, export_multistream_server,
                                    load_multistream_server, make_multistream_tick_fn,
                                    make_streaming_step_fn, make_waveform_serving_fn)
from avvad_tpu_torch.models import AVVAD, AudioVAD, RawAudioVAD, ResNet18, VideoVAD, calibrate
from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused

H, MCB_OUT = 16, 64
HOP, NFFT = 256, 1024
# a replay against the live port step: the same operations on the same
# inputs in the same process (readings 0); held at 1e-6
REPLAY_ATOL = 1e-6
# the port against the JAX package on the same weights and inputs: fp32 on
# both sides, the DFT matmuls, convolutions and scans summing in another
# order (tests/test_torch_port_serve.py, PROB_ATOL)
JAX_ATOL = 1e-5
# the raw-waveform family against JAX (tests/test_torch_port_wavenet.py)
WAVENET = dict(dilations=(1, 2, 4), residual_channels=4, dilation_channels=4,
               bottleneck_width=8)
CUSTOM_OPS = {"avvad_tpu_torch.lstm_infer.default", "avvad_tpu_torch.int8_basic_block.default",
              "avvad_tpu_torch.stem_epilogue_pool_quant.default"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _n_samples(t):
    return HOP * (t - 1) + NFFT


def _port(cls, variables, **kw):
    model = cls(**kw)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model.eval()


def _round_trip(tmp_path, fns, name="a", **meta):
    path = str(tmp_path / f"{name}.avvadx")
    ServingArtifact.build(fns, meta=meta).save(path)
    return ServingArtifact.load(path), path


def _jax_replay(tmp_path, fn, args, name="j"):
    """Build, save, load and call the JAX package's artifact of ``fn``."""
    path = str(tmp_path / f"{name}.avvadx")
    jexport.ServingArtifact.build({"e": (fn, args)}).save(path)
    return jexport.ServingArtifact.load(path).call("e", *args)


@pytest.fixture(scope="module")
def av():
    """JAX AVVAD (MCB, 1 x LSTM 16) with non-trivial BatchNorm statistics,
    its variables and the port's twin."""
    jm = JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=1, use_mcb=True,
                mcb_output_size=MCB_OUT)
    variables = dict(_np_tree(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 513)),
                                      jnp.zeros((1, 4, 67, 67)))))
    rng = np.random.default_rng(3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.random(a.shape)).astype(np.float32),
        variables["batch_stats"])
    port = _port(AVVAD, variables, lstm_hidden_size=H, lstm_layers=1, use_mcb=True,
                 mcb_output_size=MCB_OUT)
    return jm, variables, port


@pytest.fixture(scope="module")
def audio():
    jm = JAudioVAD(lstm_hidden_size=H, lstm_layers=2)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 513))))
    return jm, variables, _port(AudioVAD, variables, lstm_hidden_size=H, lstm_layers=2)


def _av_inputs(b=2, t=8, t_video=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, _n_samples(t))).astype(np.float32),
            rng.normal(size=(b, t_video or t, 67, 67)).astype(np.float32))


def test_av_artifact_round_trip(tmp_path, av):
    jm, variables, port = av
    t = 8
    wave, video = _av_inputs(t=t)
    fn = make_waveform_serving_fn(port, t_frames=t, device="cpu")
    want = fn(wave, video).numpy()
    loaded, _ = _round_trip(tmp_path, {"b2": (fn, (torch.from_numpy(wave),
                                                   torch.from_numpy(video)))},
                            modality="av")
    assert "b2" in loaded and "b1" not in loaded
    assert loaded.meta["modality"] == "av"
    assert loaded.meta["torch_version"] == torch.__version__
    assert loaded.meta["device"] == "cpu" and loaded.meta["format_version"] == 1
    assert loaded.input_shapes("b2") == [wave.shape, video.shape]
    assert loaded.input_dtypes("b2") == [torch.float32, torch.float32]
    got = loaded.call("b2", wave, video).numpy()
    assert got.shape == (2, t, 1) and ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, atol=REPLAY_ATOL)
    jfn = jexport.make_waveform_serving_fn(jm, variables, t_frames=t)
    ref = np.asarray(_jax_replay(tmp_path, jfn, (jnp.asarray(wave), jnp.asarray(video))))
    np.testing.assert_allclose(got, ref, atol=JAX_ATOL)


def test_audio_artifact_with_norm_stats(tmp_path, audio):
    jm, variables, port = audio
    t = 8
    wave = np.random.default_rng(1).normal(size=(2, _n_samples(t))).astype(np.float32)
    # checkpoint-convention keys, reference (dim, 1) stat shapes
    stats = {"audio_mean": np.full((513, 1), 0.25, np.float32),
             "audio_std": np.full((513, 1), 2.0, np.float32)}
    fn = make_waveform_serving_fn(port, t_frames=t, norm_stats=stats, device="cpu")
    loaded, _ = _round_trip(tmp_path, {"b2": (fn, (torch.from_numpy(wave),))})
    got = loaded.call("b2", wave).numpy()
    np.testing.assert_allclose(got, fn(wave).numpy(), atol=REPLAY_ATOL)
    jfn = jexport.make_waveform_serving_fn(jm, variables, t_frames=t, norm_stats=stats)
    ref = np.asarray(_jax_replay(tmp_path, jfn, (jnp.asarray(wave),)))
    np.testing.assert_allclose(got, ref, atol=JAX_ATOL)


def test_av_unique_frame_layout(tmp_path, av):
    """The exported unique-frame serving step (the fps-resample gather in
    the program) against the live step and the JAX artifact."""
    from avvad_tpu_torch.processing.video import fps_resample_indices

    jm, variables, port = av
    t, fps = 8, 30.0
    t_src = int(np.ceil(t * fps / 62.5)) + 2
    idx = fps_resample_indices(t_src, fps, 62.5)[:t]
    assert len(idx) == t
    wave, video = _av_inputs(t=t, t_video=t_src, seed=3)
    fn = make_waveform_serving_fn(port, t_frames=t, video_frame_indices=idx, device="cpu")
    loaded, _ = _round_trip(tmp_path, {"e": (fn, (torch.from_numpy(wave),
                                                  torch.from_numpy(video)))})
    got = loaded.call("e", wave, video).numpy()
    np.testing.assert_allclose(got, fn(wave, video).numpy(), atol=REPLAY_ATOL)
    jfn = jexport.make_waveform_serving_fn(jm, variables, t_frames=t,
                                           video_frame_indices=jnp.asarray(idx))
    ref = np.asarray(_jax_replay(tmp_path, jfn, (jnp.asarray(wave), jnp.asarray(video))))
    np.testing.assert_allclose(got, ref, atol=JAX_ATOL)


def test_raw_audio_artifact(tmp_path):
    t, n = 8, 4096
    jm = JRawAudioVAD(lstm_hidden_size=H, lstm_layers=1, out_frames=t,
                      wavenet_kwargs=WAVENET)
    wave = np.random.default_rng(0).normal(size=(2, n)).astype(np.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(wave)))
    port = _port(RawAudioVAD, variables, lstm_hidden_size=H, lstm_layers=1,
                 out_frames=t, wavenet_kwargs=WAVENET)
    fn = make_waveform_serving_fn(port, device="cpu")
    loaded, _ = _round_trip(tmp_path, {"b2": (fn, (torch.from_numpy(wave),))})
    got = loaded.call("b2", wave).numpy()
    np.testing.assert_allclose(got, fn(wave).numpy(), atol=REPLAY_ATOL)
    jfn = jexport.make_waveform_serving_fn(jm, variables, t_frames=t)
    ref = np.asarray(_jax_replay(tmp_path, jfn, (jnp.asarray(wave),)))
    np.testing.assert_allclose(got, ref, atol=JAX_ATOL)


def _windows(pcm):
    n = 1 + (len(pcm) - NFFT) // HOP
    return pcm[np.arange(n)[:, None] * HOP + np.arange(NFFT)[None, :]]


def test_streaming_step_artifact_matches_live_streamer(tmp_path, audio):
    """The exported streaming step replays block for block against the
    live StreamingVAD, the carries round-tripping through the artifact, and
    against the JAX artifact's replay of the same blocks."""
    jm, variables, port = audio
    bf = 4
    streamer = serve.StreamingVAD(port, block_frames=bf, fixed_peak=1.0, device="cpu")
    pcm = np.random.default_rng(0).standard_normal(NFFT + 4 * HOP * 3).astype(np.float32)
    live = streamer.feed(pcm)
    assert live.size >= 8
    fn, example = make_streaming_step_fn(streamer)
    loaded, _ = _round_trip(tmp_path, {"step": (fn, example)})
    jstreamer = jserve.StreamingVAD(jm, variables, block_frames=bf, fixed_peak=1.0)
    jfn, jexample = jexport.make_streaming_step_fn(jstreamer)
    jpath = str(tmp_path / "j.avvadx")
    jexport.ServingArtifact.build({"step": (jfn, jexample)}).save(jpath)
    jloaded = jexport.ServingArtifact.load(jpath)

    frames = _windows(pcm)
    carries = [(np.zeros((1, H), np.float32),) * 2 for _ in range(2)]
    jcarries = [(jnp.zeros((1, H)), jnp.zeros((1, H))) for _ in range(2)]
    outs, jouts = [], []
    for b in range(len(frames) // bf):
        block = frames[b * bf:(b + 1) * bf]
        probs, carries = loaded.call("step", block, np.float32(1.0), carries)
        outs.append(probs.numpy())
        jprobs, jcarries = jloaded.call("step", jnp.asarray(block), jnp.float32(1.0),
                                        jcarries)
        jouts.append(np.asarray(jprobs))
    replay = np.concatenate(outs)
    np.testing.assert_allclose(replay, live[: len(replay)], atol=REPLAY_ATOL)
    np.testing.assert_allclose(replay, np.concatenate(jouts), atol=JAX_ATOL)


def test_streaming_video_step_fn_replay(tmp_path):
    """The video-only streaming step exports and replays block for block."""
    jm = JVideoVAD(lstm_hidden_size=H, lstm_layers=1)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 67, 67))))
    port = _port(VideoVAD, variables, lstm_hidden_size=H, lstm_layers=1)
    streamer = serve.StreamingVideoVAD(port, block_frames=4, device="cpu")
    frames = np.random.default_rng(0).uniform(0, 255, size=(8, 67, 67)).astype(np.float32)
    live = streamer.feed(frames)
    assert live.shape == (8,)
    fn, example = make_streaming_step_fn(streamer)
    loaded, _ = _round_trip(tmp_path, {"step": (fn, example)})
    carries = [(torch.zeros(1, H), torch.zeros(1, H))]
    outs = []
    for b in range(2):
        probs, carries = loaded.call("step", frames[b * 4:(b + 1) * 4], carries)
        outs.append(probs.numpy())
    np.testing.assert_allclose(np.concatenate(outs), live, atol=REPLAY_ATOL)
    want = jm.apply(variables, jnp.asarray(frames)[None])
    np.testing.assert_allclose(np.concatenate(outs),
                               np.asarray(jax.nn.sigmoid(want))[0, :, 0], atol=JAX_ATOL)


def test_streaming_av_step_fn_shapes(tmp_path, av):
    """The AV streaming step exports with the uint8 wire dtype kept, and
    its replay equals the live streamer."""
    _, _, port = av
    streamer = serve.StreamingAVVAD(port, block_frames=4, fixed_peak=1.0,
                                    video_uint8=True, device="cpu")
    fn, example = make_streaming_step_fn(streamer)
    assert example[1].dtype == torch.uint8
    probs, carries = fn(*example)
    assert probs.shape == (4,)
    assert len(carries) == 1 and carries[0][0].shape == (1, H)
    loaded, _ = _round_trip(tmp_path, {"step": (fn, example)})
    assert loaded.input_dtypes("step")[1] == torch.uint8
    rng = np.random.default_rng(4)
    pcm = rng.standard_normal(NFFT + 3 * HOP).astype(np.float32)
    video = rng.integers(0, 256, size=(4, 67, 67), dtype=np.uint8)
    live = streamer.feed(pcm, video)
    got, _ = loaded.call("step", _windows(pcm), video, np.float32(1.0), example[3])
    np.testing.assert_allclose(got.numpy(), live, atol=REPLAY_ATOL)


def test_multistream_tick_artifact_matches_live_server(tmp_path):
    """The artifact's tick reproduces the live server's step: the same
    probabilities and carries, the inactive streams' carries restored
    exactly; and the JAX artifact's tick on the same inputs."""
    jm1 = JAudioVAD(lstm_hidden_size=H, lstm_layers=1)
    variables = _np_tree(jm1.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 513))))
    port = _port(AudioVAD, variables, lstm_hidden_size=H, lstm_layers=1)
    server = serve.MultiStreamVAD(port, n_streams=4, block_frames=4, device="cpu")
    fn, example = make_multistream_tick_fn(server)
    loaded, _ = _round_trip(tmp_path, {"tick": (fn, example)})

    rng = np.random.default_rng(1)
    frames = rng.standard_normal((4, 4, NFFT)).astype(np.float32)
    peaks = np.ones(4, np.float32)
    active = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    carries = [(rng.standard_normal((4, H)).astype(np.float32),
                rng.standard_normal((4, H)).astype(np.float32))]
    t_carries = [tuple(torch.from_numpy(c) for c in pair) for pair in carries]
    want_p, want_c = server._step(torch.from_numpy(frames), torch.from_numpy(peaks),
                                  torch.from_numpy(active), t_carries)
    got_p, got_c = loaded.call("tick", frames, peaks, active, carries)
    np.testing.assert_allclose(got_p.numpy(), want_p.numpy(), atol=REPLAY_ATOL)
    for (gh, gc), (wh, wc) in zip(got_c, want_c):
        np.testing.assert_allclose(gh.numpy(), wh.numpy(), atol=REPLAY_ATOL)
        np.testing.assert_allclose(gc.numpy(), wc.numpy(), atol=REPLAY_ATOL)
    # the inactive rows keep their old carries exactly
    for g, old in zip(got_c[0], carries[0]):
        np.testing.assert_allclose(g.numpy()[[1, 3]], old[[1, 3]], atol=0)
    jserver = jserve.MultiStreamVAD(jm1, variables, n_streams=4, block_frames=4)
    jfn, jexample = jexport.make_multistream_tick_fn(jserver)
    jpath = str(tmp_path / "j.avvadx")
    jexport.ServingArtifact.build({"tick": (jfn, jexample)}).save(jpath)
    jp, jc = jexport.ServingArtifact.load(jpath).call(
        "tick", jnp.asarray(frames), jnp.asarray(peaks), jnp.asarray(active),
        [tuple(map(jnp.asarray, pair)) for pair in carries])
    np.testing.assert_allclose(got_p.numpy(), np.asarray(jp), atol=JAX_ATOL)
    np.testing.assert_allclose(got_c[0][0].numpy(), np.asarray(jc[0][0]), atol=JAX_ATOL)


def _feed_both(servers, feeds):
    for srv in servers:
        for i, chunk in feeds.items():
            srv.feed(i, *chunk) if isinstance(chunk, tuple) else srv.feed(i, chunk)


def _ticks_agree(live, loaded, n_ticks, streams=None):
    for _ in range(n_ticks):
        want, got = live.tick(), loaded.tick()
        assert set(want) == set(got)
        if streams is not None:
            assert set(got) == streams
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=REPLAY_ATOL)


def test_artifact_server_round_trip(tmp_path, audio):
    """export_multistream_server -> load_multistream_server rebuilds a
    working server (hub buffering and the tick) whose per-stream outputs
    match the live server's."""
    _, _, port = audio
    live = serve.MultiStreamVAD(port, n_streams=2, block_frames=4, device="cpu")
    p = str(tmp_path / "server.avvadx")
    export_multistream_server(live, p, meta={"note": "test"})
    loaded = load_multistream_server(p)
    assert (loaded.n, loaded.block_frames) == (2, 4)
    assert ServingArtifact.load(p).meta["note"] == "test"
    rng = np.random.default_rng(0)
    _feed_both((live, loaded), {0: rng.standard_normal(NFFT + HOP * 3).astype(np.float32),
                                1: rng.standard_normal(NFFT + HOP * 7).astype(np.float32)})
    _ticks_agree(live, loaded, 1, {0, 1})
    _ticks_agree(live, loaded, 1)  # the second drains stream 1's second block
    loaded.reset_stream(0)  # the carry reset works without model code
    assert float(loaded._carries[0][0][0].abs().max()) == 0.0


def test_artifact_server_round_trip_span_hop_dft(tmp_path, audio):
    """A span-wire hop-DFT server exports its tick on the raw (N, span)
    sample span, records the wire, and rebuilds a server that matches."""
    _, _, port = audio
    live = serve.MultiStreamVAD(port, n_streams=2, block_frames=4, span_wire=True,
                                hop_dft=True, device="cpu")
    p = str(tmp_path / "span.avvadx")
    export_multistream_server(live, p)
    loaded = load_multistream_server(p)
    assert loaded.span_wire and loaded.hop_dft
    assert ServingArtifact.load(p).input_shapes("tick")[0] == (2, live._hub.span)
    rng = np.random.default_rng(0)
    _feed_both((live, loaded), {0: rng.standard_normal(NFFT + HOP * 3).astype(np.float32),
                                1: rng.standard_normal(NFFT + HOP * 7).astype(np.float32)})
    _ticks_agree(live, loaded, 2)


def test_artifact_server_preserves_stft_geometry(tmp_path, audio):
    """Non-default STFT windows survive the round trip: the hub cuts the
    windows the tick was traced for."""
    _, _, port = audio
    live = serve.MultiStreamVAD(port, n_streams=2, block_frames=4,
                                stft_cfg=STFTConfig(hop_percent=0.5), device="cpu")
    p = str(tmp_path / "hop50.avvadx")
    export_multistream_server(live, p)
    loaded = load_multistream_server(p)
    assert loaded._hop == live._hop == 512 and loaded._nfft == live._nfft == 1024
    pcm = np.random.default_rng(0).standard_normal(1024 + 512 * 3).astype(np.float32)
    _feed_both((live, loaded), {0: pcm})
    _ticks_agree(live, loaded, 1, {0})


def test_artifact_server_round_trip_audio_int16(tmp_path, audio):
    _, _, port = audio
    live = serve.MultiStreamVAD(port, n_streams=2, block_frames=4, span_wire=True,
                                audio_int16=True, device="cpu")
    p = str(tmp_path / "i16.avvadx")
    export_multistream_server(live, p)
    loaded = load_multistream_server(p)
    assert loaded.audio_int16 and loaded.span_wire
    art = ServingArtifact.load(p)
    assert art.input_shapes("tick")[0] == (2, live._hub.span)
    assert art.input_dtypes("tick")[0] == torch.int16
    assert art.meta["multistream"]["audio_int16"] is True
    rng = np.random.default_rng(0)
    _feed_both((live, loaded), {
        0: rng.integers(-32768, 32768, size=NFFT + HOP * 3, dtype=np.int16),
        1: rng.integers(-32768, 32768, size=NFFT + HOP * 7, dtype=np.int16)})
    _ticks_agree(live, loaded, 1, {0, 1})


def test_artifact_av_server_round_trip_audio_int16(tmp_path, av):
    """The AV tick on the int16 span wire and uint8 video: int16 (N, span)
    audio input, the wire flags through the geometry, and a rebuilt server
    that matches the live one on int16 PCM and uint8 lip frames."""
    _, _, port = av
    live = serve.MultiStreamAVVAD(port, n_streams=2, block_frames=4, span_wire=True,
                                  audio_int16=True, video_uint8=True, device="cpu")
    p = str(tmp_path / "av_i16.avvadx")
    export_multistream_server(live, p)
    loaded = load_multistream_server(p)
    assert loaded.audio_int16 and loaded.span_wire and loaded.video_uint8
    art = ServingArtifact.load(p)
    assert art.input_shapes("tick")[0] == (2, live._hub.span)
    assert art.input_dtypes("tick")[:2] == [torch.int16, torch.uint8]
    rng = np.random.default_rng(7)
    _feed_both((live, loaded), {i: (rng.integers(-32768, 32768, size=NFFT + HOP * (7 + 4 * i),
                                                 dtype=np.int16),
                                    rng.integers(0, 256, size=(12, 67, 67), dtype=np.uint8))
                                for i in range(2)})
    _ticks_agree(live, loaded, 2, {0, 1})


def test_artifact_av_camera_rate_server_round_trip(tmp_path, av):
    """A camera-rate (video_fps=30) AV server exports its unique-frame tick
    (source frames and the per-stream gather schedule as inputs) and
    rebuilds a server that matches the live one over several phases."""
    _, _, port = av
    bf = 16
    live = serve.MultiStreamAVVAD(port, n_streams=2, block_frames=bf, video_uint8=True,
                                  video_fps=30.0, device="cpu")
    p = str(tmp_path / "cam.avvadx")
    export_multistream_server(live, p)
    loaded = load_multistream_server(p)
    assert loaded.video_fps == 30.0
    shapes = ServingArtifact.load(p).input_shapes("tick")
    assert shapes[1] == (2, live._vsrc_max, 67, 67) and shapes[2] == (2, bf)
    rng = np.random.default_rng(3)
    _feed_both((live, loaded), {
        i: (rng.standard_normal(40000).astype(np.float32) * 0.3,
            np.round(rng.random((40, 67, 67)) * 255).astype(np.float32))
        for i in range(2)})
    _ticks_agree(live, loaded, 4, {0, 1})  # 8- and 9-source phases


@pytest.fixture(scope="module")
def int8_video():
    """A VideoVAD on the static-int8 fused tower with the int8 stem,
    calibrated by the port on seeded frames."""
    model = VideoVAD(lstm_hidden_size=H, lstm_layers=1, tower_int8=True,
                     tower_quant_mode="static", tower_pallas=True,
                     tower_stem_int8=True, seed=5)
    frames = np.random.default_rng(8).uniform(0, 255, size=(1, 6, 67, 67))
    calibrate(model, [torch.from_numpy(frames.astype(np.float32))])
    return model.eval()


@pytest.mark.parametrize("video_fps", [None, 30.0], ids=["label_rate", "camera_rate"])
def test_artifact_video_server_round_trip(tmp_path, int8_video, video_fps):
    """MultiStreamVideoVAD with the static-int8 tower: the tick holds the
    stem and trunk ops (K3 once, K2 eight times) and the rebuilt server
    matches the live one."""
    live = serve.MultiStreamVideoVAD(int8_video, n_streams=2, block_frames=4,
                                     video_uint8=True, video_fps=video_fps, device="cpu")
    p = str(tmp_path / "video.avvadx")
    export_multistream_server(live, p)
    art = ServingArtifact.load(p)
    assert set(art.meta["custom_ops"]["tick"]) == CUSTOM_OPS - {
        "avvad_tpu_torch.lstm_infer.default"}
    nodes = [str(n.target) for n in art.entries["tick"].graph.nodes if n.op == "call_function"]
    assert nodes.count("avvad_tpu_torch.int8_basic_block.default") == 8
    assert nodes.count("avvad_tpu_torch.stem_epilogue_pool_quant.default") == 1
    loaded = load_multistream_server(p)
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, size=(2, 12, 67, 67), dtype=np.uint8)
    _feed_both((live, loaded), {i: (None, frames[i]) for i in range(2)})
    _ticks_agree(live, loaded, 2, {0, 1})


@pytest.mark.parametrize("state_quant", ["none", "int8"])
def test_int8_tower_artifact_round_trip(tmp_path, state_quant):
    """The shipped serving configuration: the static-int8 fused tower with
    the int8 stem and the kernel LSTM. The program calls the three custom
    ops, and its replay equals the live step."""
    t = 4
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                  use_kernel_lstm=True, lstm_state_quant=state_quant, tower_int8=True,
                  tower_quant_mode="static", tower_pallas=True, tower_stem_int8=True)
    wave, video = _av_inputs(b=1, t=t, seed=5)
    video = np.abs(video) * 60.0
    calibrate(model, [(torch.zeros(1, t, 513), torch.from_numpy(video))])
    assert float(model.tower.features.q_in) == pytest.approx(float(np.abs(video).max()))
    fn = make_waveform_serving_fn(model, t_frames=t, device="cpu")
    want = fn(wave, video).numpy()
    loaded, _ = _round_trip(tmp_path, {"b1": (fn, (torch.from_numpy(wave),
                                                   torch.from_numpy(video)))},
                            tower_int8=True)
    assert set(loaded.meta["custom_ops"]["b1"]) == CUSTOM_OPS
    np.testing.assert_allclose(loaded.call("b1", wave, video).numpy(), want, atol=REPLAY_ATOL)


def test_traced_forward_reads_the_kept_fold(monkeypatch, int8_video):
    """Neither the eager forward before the trace nor the trace computes the
    int8 tower's fold again (fake tensors have no storage): two exports
    leave the kept fold as it was, and a trunk traced before any eager
    forward says why it cannot be."""
    import avvad_tpu_torch.models.resnet as resnet_mod

    trunk = int8_video.tower.features
    a, b, specs = trunk.folded()
    key = trunk._fold[0]
    server = serve.MultiStreamVideoVAD(int8_video, n_streams=1, block_frames=4,
                                       device="cpu")
    folds = []
    monkeypatch.setattr(resnet_mod, "fold_stem",
                        lambda *args: folds.append(1) or resnet_mod.fold_stem(*args))
    for _ in range(2):
        ServingArtifact.build({"tick": make_multistream_tick_fn(server)})
        assert not folds and trunk._fold[0] == key
        a2, b2, specs2 = trunk._fold[1]
        assert torch.equal(a2, a) and torch.equal(b2, b)
        assert torch.equal(specs2[-1]["tiles"][1], specs[-1]["tiles"][1])
    fresh = ResNet18(quant_int8=True, quant_mode="static", stages_pallas=True).eval()
    with pytest.raises(Exception, match="run the model once"):
        torch.export.export(fresh, (torch.zeros(1, 1, 67, 67),))


def test_loaded_artifact_runs_with_tf32_off(tmp_path, audio):
    """The TF32 switches are process state: an artifact records them and
    load and call set them, so a program built with TF32 off never replays
    with it on."""
    _, _, port = audio
    wave = np.zeros((1, _n_samples(4)), np.float32)
    fn = make_waveform_serving_fn(port, t_frames=4, device="cpu")
    _, path = _round_trip(tmp_path, {"b1": (fn, (torch.from_numpy(wave),))})
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        loaded = ServingArtifact.load(path)
        assert loaded.meta["precision"] == {"cuda_matmul_allow_tf32": False,
                                            "cudnn_allow_tf32": False}
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        loaded.call("b1", wave)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _Facts:
    """What a server with a step_override may read of its model."""
    lstm_hidden_size, lstm_layers = H, 2

    def __getattr__(self, name):
        raise AssertionError(f"the server read model.{name}")


def test_step_override_reads_only_the_lstm_facts():
    """With step_override the server never touches the model but for its
    two LSTM facts (no .to(), no .eval()), and its step gets the server's
    tensors and carries."""
    calls = []

    def step(frames, peaks, active, carries):
        calls.append((tuple(frames.shape), peaks.dtype, active.tolist(), len(carries)))
        return torch.full((2, 4), 0.5), carries

    ms = serve.MultiStreamVAD(_Facts(), n_streams=2, block_frames=4, step_override=step,
                              device="cpu")
    assert ms._carries[0][0].shape == (2, H) and len(ms._carries) == 2
    ms.feed(1, np.zeros(NFFT + 3 * HOP, np.float32))
    out = ms.tick()
    assert list(out) == [1] and np.allclose(out[1], 0.5)
    assert calls == [((2, 4, NFFT), torch.float32, [0.0, 1.0], 2)]
    video = serve.MultiStreamVideoVAD(_Facts(), n_streams=1, block_frames=4,
                                      step_override=lambda *a: None, device="cpu")
    assert video.model.lstm_layers == 2
    with pytest.raises(TypeError, match="step_override"):
        make_multistream_tick_fn(ms)


def test_unsupported_model_rejected():
    with pytest.raises(TypeError, match="unsupported model"):
        make_waveform_serving_fn(ResNet18(), t_frames=4, device="cpu")
    with pytest.raises(TypeError, match="not a single-stream"):
        make_streaming_step_fn(object())


def test_format_version_guard(tmp_path, audio):
    _, _, port = audio
    fn = make_waveform_serving_fn(port, t_frames=4, device="cpu")
    art = ServingArtifact.build({"b1": (fn, (torch.zeros(1, _n_samples(4)),))})
    art.meta["format_version"] = 999
    p = str(tmp_path / "future.avvadx")
    art.save(p)
    with pytest.raises(ValueError, match="newer"):
        ServingArtifact.load(p)


def test_empty_artifact_rejected(tmp_path):
    p = str(tmp_path / "empty.avvadx")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="no serving entries"):
        ServingArtifact.load(p)


def test_not_a_server_artifact_rejected(tmp_path, audio):
    _, _, port = audio
    fn = make_waveform_serving_fn(port, t_frames=4, device="cpu")
    _, p = _round_trip(tmp_path, {"b1": (fn, (torch.zeros(1, _n_samples(4)),))})
    with pytest.raises(ValueError, match="not a multistream"):
        load_multistream_server(p)


@pytest.mark.parametrize("op", ["lstm", "block", "stem"])
def test_custom_ops_fake_and_cpu_implementations(op):
    """Each kernel's custom op: its fake implementation against its CPU
    one (``torch.library.opcheck``: schema, fake tensors, dispatch)."""
    g = torch.Generator().manual_seed(0)
    if op == "lstm":
        args = (torch.randn(2, 3, 32, generator=g), torch.randn(8, 32, generator=g) * 0.1,
                torch.randn(2, 8, generator=g), None, "int8")
        fn = lstm_fused.lstm_infer
    elif op == "block":
        cin = cout = 32
        w1 = torch.randint(-127, 128, (cout, 9 * cin), generator=g, dtype=torch.int8)
        w2 = torch.randint(-127, 128, (cout, 9 * cout), generator=g, dtype=torch.int8)
        vec = lambda: torch.rand(cout, generator=g) * 1e-3  # noqa: E731
        args = (torch.randint(0, 128, (2, 5, 5, cin), generator=g, dtype=torch.int8),
                w1, vec(), vec(), w2, vec(), vec(), None, None, None, torch.tensor(0.5),
                1, None, None, None)
        fn = conv_fused.int8_basic_block_op
    else:
        args = (torch.randn(2, 16, 34, 34, generator=g), torch.rand(16, generator=g) * 20,
                torch.randn(16, generator=g))
        fn = stem_fused.stem_epilogue_op
    torch.library.opcheck(fn, args)
    out = fn(*args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = fn(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    assert fake.shape == out.shape and fake.dtype == out.dtype
