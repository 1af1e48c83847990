"""Rules of the PyTorch port: no JAX in the port, and no silent CPU."""

import ast
import pathlib
import re

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


def test_raw_audio_serving_fn_raises_without_a_card(monkeypatch):
    """The RawAudioVAD branch of the serving entry point."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import RawAudioVAD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = RawAudioVAD(lstm_hidden_size=8, lstm_layers=1, out_frames=3,
                        wavenet_kwargs=dict(dilations=(1, 2), residual_channels=4,
                                            dilation_channels=4, bottleneck_width=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_waveform_serving_fn(model)
    probs = make_waveform_serving_fn(model, device="cpu")(np.zeros((1, 64), np.float32))
    assert probs.shape == (1, 3, 1) and probs.device.type == "cpu"


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
    with pytest.raises(ValueError, match="unknown modality"):
        make_train_step("spectrogram")


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
            "avvad_tpu_torch/server.py", "avvad_tpu_torch/config.py",
            "avvad_tpu_torch/models/wavenet.py",
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


# --- the card's installations: no h5py, yaml or matplotlib there ---

ABSENT_ON_CARD = ("h5py", "yaml", "matplotlib", "cv2", "librosa", "soundfile",
                  "orbax", "tensorstore", "zstandard")
# imported by no port module, not even inside a function: HDF5 and Orbax
# checkpoints go through the port's own hdf5.py and orbax_io.py
NEVER_IMPORTED = ("h5py", "orbax", "tensorstore", "zstandard")


def _module_level_imports(path):
    """Modules imported where the file runs at import time: everywhere but
    inside a function body."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module or ""
            yield from walk(ast.iter_child_nodes(node))

    yield from walk(ast.parse(path.read_text(), filename=str(path)).body)


def test_port_imports_no_optional_package_at_module_level():
    """yaml only inside the functions that read or write YAML; matplotlib,
    cv2, librosa and soundfile nowhere at module level; h5py, orbax,
    tensorstore and zstandard nowhere at all: HDF5 and Orbax checkpoints go
    through the port's own hdf5.py and orbax_io.py."""
    bad = []
    for path in _port_files():
        for mod in _module_level_imports(path):
            if mod.split(".")[0] in ABSENT_ON_CARD:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
    # no port module imports these, not even inside a function
    assert not [p.relative_to(ROOT) for p in _port_files()
                if set(NEVER_IMPORTED) & {m.split(".")[0] for m in _imported_modules(p)}]


def test_every_port_module_imports_without_h5py_and_yaml():
    """In a fresh interpreter with ``h5py``, ``yaml``, ``orbax``,
    ``tensorstore`` and ``zstandard`` unimportable, every module of the
    package (the command-line twins too) and chip_smoke.py imports."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('h5py', 'yaml', 'orbax', 'tensorstore', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        "import avvad_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(avvad_tpu_torch.__path__,"
        " 'avvad_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "importlib.import_module('chip_smoke')\n"
        "assert 'jax' not in sys.modules\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 62


def test_orbax_checkpoint_reads_without_orbax_tensorstore_zstd_or_jax():
    """In a fresh interpreter with ``orbax``, ``tensorstore``, ``zstandard``
    and ``jax`` unimportable, the committed Orbax fixture reads and restores
    into the port's model; and no port source loads a system zstd library."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('orbax', 'tensorstore', 'zstandard', 'jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "from avvad_tpu_torch.models import AudioVAD\n"
        "from avvad_tpu_torch.train import restore_model\n"
        "model = AudioVAD(lstm_hidden_size=32, lstm_layers=2)\n"
        "norm, epoch = restore_model('tests/fixtures/orbax_audio_h32', model)\n"
        "assert epoch == 1 and set(norm) == {'audio_mean', 'audio_std'}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr
    loads = re.compile(r"find_library|libzstd\.so|CDLL\([^)]*zstd")
    assert not [p.relative_to(ROOT) for p in _port_files() if loads.search(p.read_text())]


def test_import_guard_covers_the_corpus_modules():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f"avvad_tpu_torch/{m}.py" for m in (
        "config", "builders", "processing/audio_io", "processing/stft",
        "processing/targets", "processing/video", "datasets/ntcd_timit",
        "datasets/csr1_wjs0", "data/records", "data/statistics", "data/sources",
        "data/augment", "data/pipeline", "evaluate/stats", "evaluate/predict",
        "evaluate/classify")} <= names


def test_prefetcher_and_trainer_prefetch_raise_without_a_card(monkeypatch, tmp_path):
    """Prefetcher() and the Trainer's prefetch route need a card unless
    given device="cpu"; evaluate_split uploads through the same route."""
    from avvad_tpu_torch.data import Batch, Prefetcher
    from avvad_tpu_torch.evaluate import evaluate_split
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.train import Trainer, create_train_state
    from avvad_tpu_torch.train.state import TrainState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mask = np.ones((1, 3), np.float32)
    batch = Batch(audio=np.zeros((1, 3, 513), np.float32), video=None,
                  label=np.ones((1, 3, 1), np.float32), lengths=np.array([3]),
                  mask=mask)
    with pytest.raises(RuntimeError, match="CUDA"):
        Prefetcher([batch])
    got = list(Prefetcher([batch], device="cpu"))
    assert len(got) == 1 and got[0].audio.device.type == "cpu"
    state = create_train_state(AudioVAD(lstm_hidden_size=8, lstm_layers=1), device="cpu")
    card = TrainState(state.model, state.optimizer, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(card, "audio", str(tmp_path / "card")).fit([batch], [batch], end_epoch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_split(card, [], "audio", str(tmp_path / "eval"), verbose=False)
    last = Trainer(state, "audio", str(tmp_path / "cpu")).fit([batch], [batch], end_epoch=2)
    assert state.step == 1 and np.isfinite(last["train"]["loss"])


def test_import_guard_covers_the_artifact_modules():
    """The serving artifacts: export.py and the modules that
    register the kernels' custom ops."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"avvad_tpu_torch/export.py", "avvad_tpu_torch/ops/lstm_fused.py",
            "avvad_tpu_torch/ops/conv_fused.py", "avvad_tpu_torch/ops/stem_fused.py",
            "avvad_tpu_torch/models/mcb.py"} <= names
    from avvad_tpu_torch import export

    for op in ("lstm_infer", "int8_basic_block", "stem_epilogue_pool_quant"):
        assert hasattr(getattr(torch.ops, export.OP_NAMESPACE), op)


def test_artifact_server_raises_without_a_card(monkeypatch, tmp_path):
    """An artifact exported on the card rebuilds its server on the card:
    without one, load_multistream_server raises; device="cpu" is honoured
    only for a program whose constants lie there."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.export import (ServingArtifact, export_multistream_server,
                                        load_multistream_server)
    from avvad_tpu_torch.models import AudioVAD

    path = str(tmp_path / "s.avvadx")
    export_multistream_server(serve.MultiStreamVAD(
        AudioVAD(lstm_hidden_size=8, lstm_layers=1), 2, block_frames=4, device="cpu"), path)
    assert load_multistream_server(path).tick() == {}
    art = ServingArtifact.load(path)
    art.meta["device"] = "cuda"
    art.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_multistream_server(path)


def test_import_guard_covers_the_parallel_modules():
    """Scale-out: parallel/ (and the modules it changed) are in the guard's
    walk, so neither JAX nor an optional package is imported there."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f"avvad_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "mesh", "distributed", "sync", "dryrun")} <= names
    for m in ("mesh", "distributed", "sync", "dryrun"):
        mods = set(_module_level_imports(ROOT / f"avvad_tpu_torch/parallel/{m}.py"))
        assert not {x.split(".")[0] for x in mods} & {*FORBIDDEN, *ABSENT_ON_CARD}


def test_sharded_server_raises_without_a_card(monkeypatch):
    """A serving mesh over cards needs the cards: no quiet CPU."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_mesh(n_data=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.MultiStreamVAD(AudioVAD(lstm_hidden_size=8, lstm_layers=1), 2,
                             block_frames=4, mesh=mesh)


def test_import_guard_covers_the_cli_modules():
    """hdf5.py, ops/video.py, utils/ and the command-line twins are in the
    guard's walk: neither JAX nor an optional package at module level."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    want = {"avvad_tpu_torch/hdf5.py", "avvad_tpu_torch/ops/video.py",
            *(f"avvad_tpu_torch/utils/{m}.py" for m in (
                "__init__", "misc", "profiling", "torch_import", "torch_export")),
            *(f"avvad_tpu_torch/scripts/{m}.py" for m in (
                "__init__", "_common", *CLI_TWINS))}
    assert want <= names
    for rel in want:
        mods = {x.split(".")[0] for x in _module_level_imports(ROOT / rel)}
        assert not mods & {*FORBIDDEN, *ABSENT_ON_CARD}, rel


CLI_TWINS = {
    "import_checkpoint": ["--modality", "av", "--torch-checkpoint", "x.pt",
                          "--output-dir", "out"],
    "create_train_files": ["--raw-dir", "raw", "--processed-dir", "out"],
    "train": ["--modality", "av", "--model-dir", "out"],
    "evaluate": ["--modality", "av", "--checkpoint", "ck", "--output-dir", "out"],
    "run_metrics": ["--predictions-dir", "out"],
    "reconstruct": ["--checkpoint", "ck", "--output-dir", "out"],
    "export_serving": ["--modality", "av", "--checkpoint", "ck", "--out", "a.avvadx"],
    "serve_server": ["--checkpoint", "ck", "--port", "0"],
    "stream_demo": ["x.wav"],
    "visualization_audio": ["--check-device-stft", "--output-dir", "out"],
    "rehearse_complete": ["--dir", "out"],
}


@pytest.mark.parametrize("name", sorted(CLI_TWINS))
def test_cli_twins_raise_without_a_card(monkeypatch, tmp_path, name):
    """Each twin runs on the card unless given --device cpu: with no card
    it raises before it reads or writes anything."""
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(CLI_TWINS[name])
    assert list(tmp_path.iterdir()) == []


# --- the last slice: figures, QA, comparison and synthesis scripts ---

LAST_SLICE = ("visualization", *(f"scripts/{m}" for m in (
    "visualization_audio", "visualization_video", "visualization_video_upsampling",
    "compare_predictions", "summarize_training", "synth_noisy_testset",
    "synth_complete_corpus", "rehearse_complete")))


def test_import_guard_covers_the_last_slice():
    """visualization.py and the eight new twins are in the guard's walk, and
    none imports JAX, matplotlib, cv2, h5py or yaml at module level."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    want = {f"avvad_tpu_torch/{m}.py" for m in LAST_SLICE}
    assert want <= names
    for rel in want:
        mods = {x.split(".")[0] for x in _module_level_imports(ROOT / rel)}
        assert not mods & {*FORBIDDEN, *ABSENT_ON_CARD}, rel


def test_port_imports_without_figure_packages():
    """In a fresh interpreter with ``h5py``, ``yaml``, ``matplotlib`` and
    ``cv2`` unimportable, visualization, the new twins, every other module
    and chip_smoke.py import, and none of those packages is loaded."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('h5py', 'yaml', 'matplotlib', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import avvad_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(avvad_tpu_torch.__path__,"
        " 'avvad_tpu_torch.')]\n"
        f"want = {['avvad_tpu_torch.' + m.replace('/', '.') for m in LAST_SLICE]!r}\n"
        "assert set(want) <= set(names), set(want) - set(names)\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "importlib.import_module('chip_smoke')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'h5py', 'yaml', 'matplotlib', 'cv2') and sys.modules[m] is not None]\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 71
