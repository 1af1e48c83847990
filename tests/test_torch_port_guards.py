"""Rules of the PyTorch port: no JAX in the port, and no silent CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "avvad_tpu")


def _port_files():
    files = sorted((ROOT / "avvad_tpu_torch").rglob("*.py"))
    assert files, "avvad_tpu_torch has no modules"
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_or_jax_package():
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch):
    from avvad_tpu_torch import resolve_device
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    model = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_waveform_serving_fn(model, t_frames=4)
    # an explicit CPU request is honoured
    fn = make_waveform_serving_fn(model, t_frames=2, device="cpu")
    probs = fn(np.random.default_rng(0).normal(size=(1, 1280)).astype(np.float32),
               np.zeros((1, 1, 67, 67), np.float32))
    assert probs.shape == (1, 2, 1) and probs.device.type == "cpu"


def test_video_serving_fn_raises_without_a_card(monkeypatch):
    """The VideoVAD branch of the serving entry point, with the static-int8
    fused tower: no card and no explicit CPU request -> raises."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import VideoVAD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = VideoVAD(lstm_hidden_size=8, lstm_layers=1, tower_int8=True,
                     tower_quant_mode="static", tower_pallas=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_waveform_serving_fn(model)
    probs = make_waveform_serving_fn(model, device="cpu")(
        np.zeros((1, 2, 67, 67), np.float32))
    assert probs.shape == (1, 2, 1) and probs.device.type == "cpu"


@pytest.mark.parametrize("bad", ["state_quant", "w_shape", "h0_shape"])
def test_lstm_wrapper_rejects_bad_arguments(bad):
    from avvad_tpu_torch.ops.lstm_fused import lstm_layer_fused

    kw = dict(x_proj=torch.zeros(2, 3, 32), w_hh=torch.zeros(8, 32))
    if bad == "state_quant":
        kw["state_quant"] = "fp8"
    elif bad == "w_shape":
        kw["w_hh"] = torch.zeros(32, 8)
    else:
        kw["h0"] = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        lstm_layer_fused(**kw)


def test_import_guard_covers_the_training_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"avvad_tpu_torch/train/state.py", "avvad_tpu_torch/train/steps.py",
            "avvad_tpu_torch/train/checkpoint.py", "avvad_tpu_torch/train/trainer.py",
            "avvad_tpu_torch/data/batching.py",
            "avvad_tpu_torch/models/losses.py"} <= names


def test_train_entry_points_raise_without_a_card(monkeypatch):
    """create_train_state (and so every train, eval and predict step, which
    run on the state's device) needs a card unless given device="cpu"."""
    from avvad_tpu_torch.data import Batch
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.train import create_train_state, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(AudioVAD(lstm_hidden_size=8, lstm_layers=1))
    state = create_train_state(AudioVAD(lstm_hidden_size=8, lstm_layers=1),
                               device="cpu")
    mask = np.ones((1, 3), np.float32)
    batch = Batch(audio=np.zeros((1, 3, 513), np.float32), video=None,
                  label=np.ones((1, 3, 1), np.float32), lengths=np.array([3]),
                  mask=mask)
    state, metrics = make_train_step("audio")(state, batch)
    assert state.step == 1 and metrics["loss"].device.type == "cpu"
    with pytest.raises(ValueError, match="not ported"):
        make_train_step("waveform")


@pytest.mark.parametrize("state_quant", ["bf16", "int8"])
def test_quantised_recurrence_refuses_gradients(state_quant):
    """The quantised-state kernels are inference-only, as in JAX: under
    autograd the op raises NotImplementedError; without it they run."""
    from avvad_tpu_torch.ops.lstm_fused import lstm_layer_fused

    xp = torch.zeros(2, 3, 32, requires_grad=True)
    w = torch.zeros(8, 32)
    with pytest.raises(NotImplementedError, match="inference-only"):
        lstm_layer_fused(xp, w, state_quant=state_quant)
    with torch.no_grad():
        assert lstm_layer_fused(xp, w, state_quant=state_quant).shape == (2, 3, 8)


def test_import_guard_covers_the_streaming_and_probe_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"avvad_tpu_torch/serve.py", "avvad_tpu_torch/native.py",
            "avvad_tpu_torch/config.py",
            "avvad_tpu_torch/tools/lstm_probe.py"} <= names


@pytest.mark.parametrize("streamer", ["StreamingVAD", "MultiStreamVAD",
                                      "StreamingAVVAD", "MultiStreamAVVAD"])
def test_streamers_raise_without_a_card(monkeypatch, streamer):
    """Every streaming server needs a card unless given device="cpu"."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AVVAD, AudioVAD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = (AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=64)
             if "AV" in streamer else AudioVAD(lstm_hidden_size=8, lstm_layers=1))
    args = (model, 2) if streamer.startswith("Multi") else (model,)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(serve, streamer)(*args)
    server = getattr(serve, streamer)(*args, block_frames=4, device="cpu")
    pcm = np.random.default_rng(0).normal(size=1024 + 3 * 256).astype(np.float32)
    video = np.zeros((4, 67, 67), np.float32)
    if streamer.startswith("Multi"):
        server.feed(0, pcm, *([video] if "AV" in streamer else []))
        probs = server.tick()[0]
    else:
        probs = server.feed(pcm, *([video] if "AV" in streamer else []))
    assert probs.shape == (4,) and ((probs >= 0) & (probs <= 1)).all()


def test_probe_tool_raises_without_a_card(monkeypatch):
    from avvad_tpu_torch.tools import lstm_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lstm_probe.main(["--b", "2", "--t", "2", "--h", "32", "--iters", "1"])
    res = lstm_probe.main(["--b", "2", "--t", "2", "--h", "32", "--iters", "1",
                           "--modes", "full", "--device", "cpu"])
    assert list(res["probe"]) == ["full"]


@pytest.mark.parametrize("bad", ["mode", "w_shape", "c0_shape"])
def test_probe_wrapper_rejects_bad_arguments(bad):
    from avvad_tpu_torch.ops.lstm_fused import lstm_probe

    kw = dict(x_proj=torch.zeros(2, 3, 32), w_hh=torch.zeros(8, 32), mode="full")
    if bad == "mode":
        kw["mode"] = "half"
    elif bad == "w_shape":
        kw["w_hh"] = torch.zeros(32, 8)
    else:
        kw["c0"] = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        lstm_probe(**kw)
