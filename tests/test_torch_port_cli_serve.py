"""``export_serving``, ``serve_server`` and ``stream_demo`` through both
command lines on the CPU, with the reference checkpoint's AudioVAD (H=32)
imported by both ``import_checkpoint`` scripts and given the tree's
audio statistics: the port's artifact
replays within 1e-5 of JAX's; a client of the server that the twin's
``build_server`` makes gets what a solo streamer gives; the demo prints
JAX's speech segments.
"""

import contextlib
import glob
import io
import os
import re

import numpy as np
import pytest
import torch

from test_torch_port_server import TIMEOUT_S, _n_out, _pcm, _serve
from torch_port_cli_lib import build_port_tree, import_both, run_jax_script, write_reference_pt

B, FRAMES = 2, 64
N_SAMPLES = 256 * (FRAMES - 1) + 1024


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The imported checkpoints saved again with the tree's audio
    statistics, as a trained checkpoint carries them (the serving steps
    normalise the log-power by them)."""
    import jax
    import jax.numpy as jnp

    from avvad_tpu.models import AudioVAD as JAudioVAD
    from avvad_tpu.train import create_train_state as jcreate, restore_checkpoint as jrestore
    from avvad_tpu.train import save_checkpoint as jsave
    from avvad_tpu_torch.data import load_statistics
    from avvad_tpu_torch.scripts._common import build_model
    from avvad_tpu_torch.train import create_train_state, restore_checkpoint, save_checkpoint

    data = build_port_tree(tmp_path_factory, seed=4, splits=("train", "test"))
    tmp = tmp_path_factory.mktemp("serve")
    ref = str(tmp / "ref.pt")
    write_reference_pt(ref, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        jdir, tdir = import_both(mp, tmp, ref, "audio")
    mean, std = load_statistics(os.path.join(
        data, "subset", "processed", "ntcd_timit", "Noisy",
        "ntcd_timit_log_power_spec_upsampled_statistics.h5"))
    stats = {"audio_mean": mean, "audio_std": std}
    jstate = jcreate(JAudioVAD(lstm_hidden_size=32, lstm_layers=2), jax.random.PRNGKey(0),
                     (jnp.zeros((1, 4, 513)),))
    jsave(str(tmp / "jax"), jrestore(jdir, jstate)[0], norm_stats=stats, epoch=1)
    state = create_train_state(build_model("audio", lstm_hidden=32), device="cpu")
    save_checkpoint(str(tmp / "port"), restore_checkpoint(tdir, state)[0], norm_stats=stats,
                    epoch=1)
    return {"data": data, "tmp": tmp, "jdir": str(tmp / "jax"), "tdir": str(tmp / "port")}


def test_export_serving_replay_matches_jax(env):
    """Both artifacts at (B=2, 64 frames), replayed on the same waveforms:
    within 1e-5; the port's meta names its custom LSTM op."""
    from avvad_tpu.export import ServingArtifact as JServingArtifact
    from avvad_tpu_torch.export import ServingArtifact
    from avvad_tpu_torch.scripts import export_serving

    tmp = env["tmp"]
    args = ["--modality", "audio", "--lstm-hidden", "32", "--batch", str(B), "--frames",
            str(FRAMES)]
    jpath, tpath = str(tmp / "a_jax.avvadx"), str(tmp / "a_port.avvadx")
    with pytest.MonkeyPatch.context() as mp:
        # the Pallas LSTM (interpret mode here): the port's kernels' arithmetic
        run_jax_script(mp, "export_serving", [*args, "--checkpoint", env["jdir"],
                                              "--out", jpath, "--pallas-lstm"])
    export_serving.main([*args, "--checkpoint", env["tdir"], "--out", tpath,
                         "--device", "cpu"])
    wave = np.random.default_rng(0).normal(size=(B, N_SAMPLES)).astype(np.float32)
    want = np.asarray(JServingArtifact.load(jpath).call(f"b{B}", wave))
    art = ServingArtifact.load(tpath)
    assert art.meta["modality"] == "audio" and art.meta["frames"] == FRAMES
    assert art.meta["custom_ops"][f"b{B}"] == ["avvad_tpu_torch.lstm_infer.default"]
    got = art.call(f"b{B}", torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (B, FRAMES, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("data_parallel", [0, 3])
def test_build_server_round_trip_matches_solo(env, data_parallel):
    """The twin's server (the span wire and the hop-block DFT by default;
    its 3 streams in one step, or sharded over a mesh of 3 CPU positions),
    two clients at once: each stream within 1e-5 of a solo StreamingVAD on
    the same checkpoint (tests/test_torch_port_server.py's bar)."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.scripts import serve_server
    from avvad_tpu_torch.scripts._common import build_model, restore
    from avvad_tpu_torch.server import stream_client

    args = serve_server.parse_args(["--checkpoint", env["tdir"], "--lstm-hidden", "32",
                                    "--port", "0", "--streams", "3", "--block-frames", "4",
                                    "--device", "cpu", "--data-parallel", str(data_parallel)])
    server = serve_server.build_server(args)
    assert server.streamer.span_wire and server.streamer.hop_dft
    assert len(server.streamer._shards or [None]) == max(data_parallel, 1)
    model = build_model("audio", lstm_hidden=32)
    stats, _ = restore(env["tdir"], model, torch.device("cpu"))
    assert stats is not None
    try:
        pcm = _pcm(2)
        x = pcm.astype(np.float32) / 32768.0
        n_out = _n_out(pcm.shape[1])
        got = _serve(server, [lambda i=i: stream_client(server.address, x[i], n_out,
                                                         timeout=TIMEOUT_S)
                              for i in range(2)])
    finally:
        server.close()
    for i in range(2):
        sv = serve.StreamingVAD(model, norm_stats=stats, block_frames=4, fixed_peak=1.0,
                                device="cpu")
        solo = np.concatenate([sv.feed(x[i]), sv.flush()])[:n_out]
        assert len(got[i]) == n_out
        np.testing.assert_allclose(got[i], solo, atol=1e-5, err_msg=f"stream {i}")


def _segments(text):
    return re.findall(r"speech\s+([\d.]+)s -\s+([\d.]+)s", text)


def test_stream_demo_segments_match_jax(env):
    """One test wav in 100 ms chunks: the same frame count, speech share
    and segments as JAX's demo prints."""
    from avvad_tpu_torch.scripts import stream_demo

    wav = sorted(glob.glob(os.path.join(env["data"], "subset", "processed",
                                        "ntcd_timit/Noisy/**/*.wav"), recursive=True))[0]
    args = [wav, "--lstm-hidden", "32"]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        run_jax_script(mp, "stream_demo", [*args, "--checkpoint", env["jdir"]])
    want = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = stream_demo.main([*args, "--checkpoint", env["tdir"], "--device", "cpu"])
    got = out.getvalue()
    assert _segments(want) and _segments(got) == _segments(want)
    assert re.search(r"(\d+) frames, ([\d.]+)% speech", got).groups() == \
        re.search(r"(\d+) frames, ([\d.]+)% speech", want).groups()
    assert len(result["segments"]) == len(_segments(want))
