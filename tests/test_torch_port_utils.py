"""CPU parity of the port's remaining library modules with the JAX
package: ``ops/video.py`` (``idct2_decode``, ``fps_resample``), the
inverse STFT and the energy VAD of ``ops/stft.py``, ``utils/`` (the phase
timer, the profiler trace, the parameter count, the reference's torch
checkpoints in and the trunk out).

The reference-layout state dicts are made from a seed by
``utils.torch_import.random_reference_state``: torchvision's ResNet-18
trunk in its Sequential names, ``nn.LSTM`` and ``nn.Linear`` weights, the
MCB's (h, s) buffers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops import stft as jstft
from avvad_tpu.ops import video as jvideo
from avvad_tpu_torch import native
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.ops import stft, video

H, MCB_OUT = 16, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- ops/video.py -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 4489), (2, 5, 4489), (3, 9)])
@pytest.mark.parametrize("norm", ["frame", "global"])
def test_idct2_decode_matches_jax(shape, norm):
    """fp32 products on both sides in another order: within 1e-5 of each
    frame's range."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 50).astype(np.float32)
    want = np.asarray(jvideo.idct2_decode(jnp.asarray(x), norm=norm))
    got = video.idct2_decode(torch.from_numpy(x), norm=norm).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    span = want.max(axis=(-2, -1)) - want.min(axis=(-2, -1))
    assert (np.abs(got - want).max(axis=(-2, -1)) <= 1e-5 * span).all()


def test_idct2_decode_rejects_an_unknown_norm():
    with pytest.raises(ValueError, match="unknown norm mode: minmax"):
        video.idct2_decode(torch.zeros(2, 9), norm="minmax")


@pytest.mark.parametrize("t", [1, 7, 30, 151])
@pytest.mark.parametrize("rates", [(30.0, 62.5), (25.0, 62.5), (62.5, 30.0)])
def test_fps_resample_matches_jax_exactly(t, rates):
    x = np.random.default_rng(t).normal(size=(2, t, 3, 4)).astype(np.float32)
    want = np.asarray(jvideo.fps_resample(jnp.asarray(x), *rates))
    got = video.fps_resample(torch.from_numpy(x), *rates).numpy()
    np.testing.assert_array_equal(got, want)


# --- ops/stft.py: the inverse STFT and the energy VAD -----------------------


def _speech(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 180 * t) * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (x + 1e-3 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("n", [16000, 16000 + 333])
def test_istft_frames_matches_jax(center, n):
    """JAX's STFT of a signal inverted by both: within 1e-5 of max |x|."""
    x = _speech(n)
    re, im = jstft.stft_frames(jnp.asarray(x), center=center)
    want = np.asarray(jstft.istft_frames(re, im, center=center))
    got = stft.istft_frames(torch.from_numpy(np.array(re)),
                            torch.from_numpy(np.array(im)), center=center).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("center", [False, True])
def test_istft_inverts_the_port_stft(center):
    """The port's STFT then its inverse gives the signal back where the
    windows overlap fully (frames covering each sample with the full
    window sum), within 1e-5 of max |x|."""
    x = _speech(16000 + 333, seed=1)
    re, im = stft.stft_frames(torch.from_numpy(x), center=center, pad_at_end=False)
    y = stft.istft_frames(re, im, center=center).numpy()
    edge = 1024
    n = min(len(y), len(x)) - edge
    assert np.abs(y[edge:n] - x[edge:n]).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("n", [16000, 16000 + 333, 9000])
@pytest.mark.parametrize("pad_at_end", [True, False])
def test_frame_energy_vad_matches_jax_and_native(n, pad_at_end):
    from avvad_tpu_torch.ops.stft import _needs_end_pad

    x = _speech(n, seed=n)
    want = np.asarray(jstft.frame_energy_vad(jnp.asarray(x), pad_at_end=pad_at_end))
    got = stft.frame_energy_vad(torch.from_numpy(x), pad_at_end=pad_at_end).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    if native.available():
        pad = 256 if pad_at_end and _needs_end_pad(n, 16000, 64e-3, 0.25) else 0
        np.testing.assert_array_equal(got, native.frame_energy_vad(x, 1024, 256, pad))


# --- utils: the phase timer, the trace, the parameter count -----------------


def test_phase_timer_report_matches_jax(monkeypatch):
    """The same injected clock through both timers: the same report."""
    import avvad_tpu.utils.profiling as jprof

    import avvad_tpu_torch.utils.profiling as tprof

    reports = []
    for mod in (jprof, tprof):
        ticks = iter([0.0, 0.25, 1.0, 1.004, 2.0, 2.5, 3.0, 3.0001])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        timer = mod.PhaseTimer()
        for name in ("load", "step", "load", "eval"):
            with timer.phase(name):
                pass
        reports.append((timer.report(), dict(timer.counts)))
        timer.reset()
        assert timer.report().count("\n") == 0
    assert reports[0] == reports[1]
    assert "load" in reports[1][0] and reports[1][1]["load"] == 2


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    from avvad_tpu_torch.utils import trace

    with trace(str(tmp_path / "t")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "t" / files[0]).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_count_parameters_matches_jax():
    from avvad_tpu.models import AVVAD as JAVVAD
    from avvad_tpu.utils import count_parameters as jcount
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.utils import count_parameters

    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 513)),
                        jnp.zeros((1, 2, 67, 67)))
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT)
    assert count_parameters(model) == jcount(variables["params"])
    tree = _np_tree(variables["params"])
    assert count_parameters(tree) == jcount(tree)
    # a state dict counts every entry, buffers too
    sd = model.state_dict()
    assert count_parameters(sd) == sum(v.numel() for v in sd.values())


# --- utils: the reference's checkpoints in, the trunk out -------------------


@pytest.fixture(scope="module")
def ref_state():
    from avvad_tpu_torch.utils.torch_import import random_reference_state

    return random_reference_state(7, H, MCB_OUT)


def _jax_import(kind, state):
    from avvad_tpu import models as jm
    from avvad_tpu import utils as ju

    rng = np.random.default_rng(1)
    audio = jnp.asarray(rng.normal(size=(1, 5, 513)).astype(np.float32))
    vid = jnp.asarray(rng.normal(size=(1, 5, 67, 67)).astype(np.float32) * 50 + 100)
    if kind == "audio":
        model = jm.AudioVAD(lstm_hidden_size=H, lstm_layers=2)
        inputs = (audio,)
        variables = ju.import_reference_audio_vad(
            state, model.init(jax.random.PRNGKey(0), *inputs))
    elif kind == "video":
        model = jm.VideoVAD(lstm_hidden_size=H, lstm_layers=2)
        inputs = (vid,)
        variables = ju.import_reference_video_vad(
            state, model.init(jax.random.PRNGKey(0), *inputs))
    else:
        model = jm.AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT)
        inputs = (audio, vid)
        variables = ju.import_reference_avvad(
            state, model, model.init(jax.random.PRNGKey(0), *inputs))
    variables = _np_tree(variables)
    return variables, np.asarray(model.apply(variables, *inputs)), \
        [torch.from_numpy(np.asarray(x)) for x in inputs]


def _port_import(kind, state):
    from avvad_tpu_torch import models
    from avvad_tpu_torch import utils

    if kind == "audio":
        model = models.AudioVAD(lstm_hidden_size=H, lstm_layers=2)
        sd = utils.import_reference_audio_vad(state, model.state_dict())
    elif kind == "video":
        model = models.VideoVAD(lstm_hidden_size=H, lstm_layers=2)
        sd = utils.import_reference_video_vad(state, model.state_dict())
    else:
        model = models.AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT)
        sd = utils.import_reference_avvad(state, model)
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd


@pytest.mark.parametrize("kind", ["audio", "video", "av"])
def test_import_reference_matches_jax(ref_state, kind):
    """The port's import equals convert.from_flax_variables of JAX's import
    bit for bit (every parameter, BatchNorm statistic and sketch; the
    ``num_batches_tracked`` counters keep the model's), and the two models'
    logits agree within 1e-5."""
    variables, want, inputs = _jax_import(kind, ref_state)
    model, sd = _port_import(kind, ref_state)
    ref = from_flax_variables(variables)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    with torch.no_grad():
        got = model(*inputs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_import_rejects_a_mismatched_checkpoint(ref_state):
    from avvad_tpu_torch import models, utils

    model = models.AudioVAD(lstm_hidden_size=2 * H, lstm_layers=2)
    with pytest.raises(ValueError, match="lstm_audio.layer_0.w_ih: the checkpoint's shape"):
        utils.import_reference_audio_vad(ref_state, model.state_dict())


def test_load_torch_state_dict_and_sketch_matrix(ref_state, tmp_path):
    from avvad_tpu.models.mcb import sketch_matrix_from_hs as jsketch
    from avvad_tpu.utils import load_torch_state_dict as jload
    from avvad_tpu_torch.utils import load_torch_state_dict, sketch_matrix_from_hs

    path = str(tmp_path / "ref.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in ref_state.items()}, path)
    got, want = load_torch_state_dict(path), jload(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    h, s = ref_state["mcb.sketch1.h"], ref_state["mcb.sketch1.s"]
    np.testing.assert_array_equal(sketch_matrix_from_hs(h, s, MCB_OUT),
                                  jsketch(h, s, MCB_OUT))


def test_export_trunk_matches_jax_and_inverts_the_import(ref_state, tmp_path):
    """The trunk of the imported VideoVAD out in the reference's names:
    JAX's export of the same trunk key for key, bit for bit; import of the
    export gives the trunk back; export_video_trunk_pt from a port
    checkpoint writes the same tensors."""
    from avvad_tpu.utils.torch_export import export_resnet18_trunk as jexport
    from avvad_tpu_torch.train import create_train_state, save_checkpoint
    from avvad_tpu_torch.utils import (export_resnet18_trunk, export_video_trunk_pt,
                                       import_torch_resnet18)

    variables, _, _ = _jax_import("video", ref_state)
    want = jexport(variables["params"]["tower"]["features"],
                   variables["batch_stats"]["tower"]["features"])
    model, _ = _port_import("video", ref_state)
    trunk = {k[len("tower.features."):]: v for k, v in model.state_dict().items()
             if k.startswith("tower.features.")}
    got = export_resnet18_trunk(trunk)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = import_torch_resnet18(got)
    for k, v in back.items():
        assert torch.equal(v, trunk[k]), k
    assert {k for k in trunk if not k.endswith("num_batches_tracked")} == set(back)

    ckpt = save_checkpoint(str(tmp_path / "video"),
                           create_train_state(model, device="cpu"), epoch=3, valid_loss=0.5)
    n = export_video_trunk_pt(str(tmp_path / "video"), str(tmp_path / "trunk.pt"))
    saved = torch.load(str(tmp_path / "trunk.pt"), weights_only=True)
    assert n == len(saved) == len(want) and os.path.isdir(ckpt)
    for k in want:
        assert np.array_equal(saved[k].numpy(), want[k]), k
    with pytest.raises(ValueError, match="holds no tower.features"):
        audio = _port_import("audio", ref_state)[0]
        save_checkpoint(str(tmp_path / "audio"), create_train_state(audio, device="cpu"))
        export_video_trunk_pt(str(tmp_path / "audio"), str(tmp_path / "x.pt"))
