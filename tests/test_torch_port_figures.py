"""The figures, the QA scripts and the comparison scripts of the port
against the JAX package's, on the CPU.

``visualization``: each drawing function on the same seeded numpy inputs,
rendered by Agg, pixel for pixel, with the images' arrays, extents and
colour limits and the colorbars' formats; ``amplitude_to_db`` exactly. The
scripts run on one tiny corpus (tests/test_torch_port_data.py's raw tree,
its test split built by the port's create_train_files): ``run_metrics
--figures``, ``visualization_audio`` (with the device STFT check, the
port's on the CPU), ``visualization_video_upsampling`` and
``visualization_video`` write the JAX scripts' figures, pixel for pixel,
and the same video frames; ``compare_predictions`` and
``summarize_training`` print (and write) what the JAX scripts do. With
``matplotlib`` and ``cv2`` unavailable each twin raises an ``ImportError``
that names the package.
"""

import contextlib
import importlib
import io
import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from avvad_tpu import visualization as jvis  # noqa: E402
from avvad_tpu_torch import visualization as tvis  # noqa: E402
from torch_port_cli_lib import run_jax_script  # noqa: E402

FS = 16000
NEW_TWINS = ["visualization_audio", "visualization_video", "visualization_video_upsampling",
             "compare_predictions", "summarize_training", "synth_noisy_testset",
             "synth_complete_corpus", "rehearse_complete"]


# --- visualization ------------------------------------------------------------


def _signals(seed: int = 0):
    """A 1.5 s signal, its (513, T) complex STFT-like matrix, a (1, T) VAD
    row and a power spectrogram."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.normal(size=int(1.5 * FS))).astype(np.float32)
    t = 1 + (len(x) - 1024) // 256
    spec = (rng.normal(size=(513, t)) + 1j * rng.normal(size=(513, t))) * np.exp(
        -np.arange(513)[:, None] / 100.0)
    vad = (rng.uniform(size=(1, t)) > 0.5).astype(np.float32)
    return x, spec, vad, np.abs(spec) ** 2


def _pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _artists(fig) -> list:
    """Each image's array, extent and limits, and each axis formatter's
    format string."""
    out = []
    for ax in fig.axes:
        for im in ax.images:
            out.append((np.asarray(im.get_array()), tuple(im.get_extent()), im.get_clim(),
                        im.get_cmap().name))
        fmt = ax.yaxis.get_major_formatter()
        out.append(getattr(fmt, "fmt", None))
    return out


def _same_figure(fa, fb) -> None:
    np.testing.assert_array_equal(_pixels(fb), _pixels(fa))
    a, b = _artists(fa), _artists(fb)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            np.testing.assert_array_equal(y[0], x[0])
            assert y[1:] == x[1:]
        else:
            assert x == y


@pytest.mark.parametrize("kw", [{}, {"ref": 0.5}, {"top_db": None}, {"amin": 1e-3}])
def test_amplitude_to_db_matches_jax(kw):
    _, spec, _, _ = _signals(1)
    np.testing.assert_array_equal(tvis.amplitude_to_db(spec, **kw),
                                  jvis.amplitude_to_db(spec, **kw))
    row = np.ones((1, 7))
    np.testing.assert_array_equal(tvis._expand_vad_rows(row), jvis._expand_vad_rows(row))


def _draw(vis, name: str, seed: int):
    x, spec, vad, psd = _signals(seed)
    if name in ("display_waveplot", "display_spectrogram", "display_power_spectro"):
        fig, ax = plt.subplots(figsize=(6, 4))
        arg = {"display_waveplot": x, "display_spectrogram": spec,
               "display_power_spectro": psd}[name]
        extra = {"convert_to_db": True} if name == "display_spectrogram" else {}
        getattr(vis, name)(arg, ax=ax, **extra)
        return fig
    if name == "display_wav_spectro_mask":
        return vis.display_wav_spectro_mask(x, spec, vad)
    if name == "display_multiple_signals":
        return vis.display_multiple_signals([[x, spec, vad], [None, vad, None]],
                                            last_only_label=True)
    return vis.display_multiple_spectro([[x, psd], [None, psd]])


DRAWERS = ["display_waveplot", "display_spectrogram", "display_power_spectro",
           "display_wav_spectro_mask", "display_multiple_signals", "display_multiple_spectro"]


@pytest.mark.parametrize("name", DRAWERS)
def test_drawing_functions_render_as_jax(name):
    """The same seeded inputs through JAX's function and the port's: the
    Agg RGBA buffers equal, and each image's array, extent, limits and
    colour map and each axis's format string."""
    fa, fb = _draw(jvis, name, 2), _draw(tvis, name, 2)
    try:
        _same_figure(fa, fb)
    finally:
        plt.close(fa)
        plt.close(fb)


# --- the scripts on a tiny corpus -----------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """-> the data root: ``subset/raw`` (the raw tree) and ``subset/processed``
    (its test split through the port's builders), and seeded predictions
    for the 4 test utterances under ``preds``."""
    from avvad_tpu_torch.data import AudioSequenceSource
    from avvad_tpu_torch.evaluate.predict import write_predictions
    from avvad_tpu_torch.scripts import create_train_files
    from test_torch_port_data import write_raw_corpus

    data = str(tmp_path_factory.mktemp("figures"))
    raw = write_raw_corpus(os.path.join(data, "subset", "raw"))
    processed = os.path.join(data, "subset", "processed")
    create_train_files.main(["--raw-dir", raw, "--processed-dir", processed, "--workers", "0",
                             "--device", "cpu", "--splits", "test"])
    source = AudioSequenceSource(processed + os.sep, "test", "subset", "vad_labels")
    rng = np.random.default_rng(3)
    for i in range(len(source)):
        write_predictions(os.path.join(data, "preds") + os.sep, source.rel_path(i),
                          rng.uniform(size=(source.probe_length(i), 1)).astype(np.float32))
    return data


def _pngs(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = plt.imread(path)
    return out


def _same_pngs(a: str, b: str, n: int) -> None:
    pa, pb = _pngs(a), _pngs(b)
    assert sorted(pa) == sorted(pb) and len(pa) == n
    for rel, img in pa.items():
        np.testing.assert_array_equal(pb[rel], img, err_msg=rel)


def _copy_preds(corpus: str, name: str) -> str:
    import shutil

    out = os.path.join(corpus, name)
    if os.path.exists(out):
        shutil.rmtree(out)
    shutil.copytree(os.path.join(corpus, "preds"), out)
    return out


def test_run_metrics_figures_match_jax(corpus, monkeypatch):
    """``run_metrics --figures``: one ``*_hard_mask.png`` an utterance, pixel
    for pixel JAX's, and the same stats.json."""
    import json

    from avvad_tpu_torch.scripts import run_metrics

    jdir, tdir = _copy_preds(corpus, "jax_metrics"), _copy_preds(corpus, "port_metrics")
    with contextlib.redirect_stdout(io.StringIO()):
        run_jax_script(monkeypatch, "run_metrics", ["--data-root", corpus,
                                                    "--predictions-dir", jdir, "--figures"])
        run_metrics.main(["--data-root", corpus, "--predictions-dir", tdir, "--figures",
                          "--device", "cpu"])
    _same_pngs(jdir, tdir, 4)
    with open(os.path.join(jdir, "stats.json")) as fa, open(os.path.join(tdir, "stats.json")) as fb:
        assert json.load(fa) == json.load(fb)


def test_visualization_audio_matches_jax(corpus, tmp_path, monkeypatch):
    """Oracle-label figures and histograms of the test split, pixel for
    pixel; the device STFT check (the port's ``stft_frames`` on the CPU)
    passes at the JAX script's 5e-3, and reads far inside it."""
    from avvad_tpu_torch.scripts import visualization_audio

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--data-root", corpus, "--check-device-stft"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_jax_script(monkeypatch, "visualization_audio", [*args, "--output-dir", jout])
        checked = visualization_audio.main([*args, "--output-dir", tout, "--device", "cpu"])
    assert out.getvalue().count("device STFT parity ok") == 8
    assert len(checked) == 4 and all(0 <= v < 1e-4 for v in checked.values())
    _same_pngs(jout, tout, 8)


def test_device_stft_check_raises_on_a_wrong_stft():
    from avvad_tpu_torch.processing import stft
    from avvad_tpu_torch.scripts.visualization_audio import device_stft_check

    x, _, _, _ = _signals(4)
    x = x / np.abs(x).max()
    sxx = stft(x, fs=FS)
    assert device_stft_check(x, FS, sxx, "cpu") < 1e-4
    with pytest.raises(AssertionError):
        device_stft_check(x, FS, sxx * 1.01, "cpu")


def _qa(monkeypatch, data: str, out: str, figures: bool):
    """The upsampling QA of JAX and of the port -> their (stdout, exit)."""
    from avvad_tpu_torch.scripts import visualization_video_upsampling

    runs = []
    for name, run in (("jax", lambda a: run_jax_script(
            monkeypatch, "visualization_video_upsampling", a)),
                      ("port", visualization_video_upsampling.main)):
        text, code = io.StringIO(), None
        with contextlib.redirect_stdout(text):
            try:
                run(["--data-root", data, "--output-dir", os.path.join(out, name),
                     *(["--figures"] if figures else [])])
            except SystemExit as e:
                code = e.code
        runs.append((text.getvalue().replace(os.path.join(out, name), out), code))
    return runs


@pytest.mark.parametrize("figures", [False, True])
def test_visualization_video_upsampling_matches_jax(corpus, tmp_path, monkeypatch, figures):
    """The alignment report line for line and the exit, with ``--figures``
    the strips pixel for pixel. This corpus's lip videos hold ceil(30 d)
    frames of a d-second utterance, 3-5 more upsampled frames than its
    STFT's: MISALIGNED by the JAX script's rule (|diff| <= 2) but one."""
    (jtext, jcode), (ttext, tcode) = _qa(monkeypatch, corpus, str(tmp_path), figures)
    assert (ttext, tcode) == (jtext, jcode)
    assert jcode == "3 misaligned utterances" and ttext.count("MISALIGNED") == 3
    if figures:
        _same_pngs(str(tmp_path / "jax"), str(tmp_path / "port"), 4)
    else:
        assert not os.path.exists(tmp_path / "port")


def test_visualization_video_upsampling_all_aligned(corpus, tmp_path, monkeypatch):
    """The same corpus with each clean wav padded (zeros) to the STFT
    frames of its upsampled video: "all aligned" from both, the port's
    diffs within the rule."""
    import shutil

    from avvad_tpu_torch.datasets import speech_list, video_list
    from avvad_tpu_torch.processing import read_wav, write_wav
    from avvad_tpu_torch.processing.stft import n_stft_frames
    from avvad_tpu_torch.processing.video import read_mat_dct
    from avvad_tpu_torch.scripts import visualization_video_upsampling

    data = str(tmp_path / "data")
    raw = os.path.join(data, "subset", "raw") + os.sep
    shutil.copytree(os.path.join(corpus, "subset", "raw"), raw)
    for mat, wav in zip(video_list(raw, "test"), speech_list(raw, "test")[0]):
        n_up = int(np.ceil(len(read_mat_dct(raw + mat)) * 62.5 / 30))
        x, fs = read_wav(raw + wav)
        while n_stft_frames(len(x)) < n_up:
            x = np.concatenate([x, np.zeros(256, np.float32)])
        write_wav(raw + wav, x, fs)
    (jtext, jcode), (ttext, tcode) = _qa(monkeypatch, data, str(tmp_path / "out"), False)
    assert (ttext, tcode) == (jtext, jcode) and jcode is None
    assert ttext.endswith("all aligned\n") and ttext.count(" OK\n") == 4
    with contextlib.redirect_stdout(io.StringIO()):
        diffs = visualization_video_upsampling.main(["--data-root", data])
    assert len(diffs) == 4 and all(abs(d) <= 2 for d in diffs.values())


@pytest.mark.parametrize("predictions", [False, True])
def test_visualization_video_matches_jax(corpus, tmp_path, monkeypatch, predictions):
    """The overlay videos: the same decoded frames (cv2), the audio wavs
    byte-equal; oracle labels, or saved hard predictions."""
    import cv2

    from avvad_tpu_torch.scripts import visualization_video

    from avvad_tpu_torch.datasets import video_list

    extra = []
    if predictions:
        preds = tmp_path / "preds"
        for mat in video_list(os.path.join(corpus, "subset", "raw") + os.sep, "test"):
            path = preds / (os.path.splitext(mat)[0] + "_y_hat_hard.npy")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, (np.arange(200) % 3 == 0).astype(np.int32))
        extra = ["--predictions-dir", str(preds)]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--data-root", corpus, *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        run_jax_script(monkeypatch, "visualization_video", [*args, "--output-dir", jout])
        written = visualization_video.main([*args, "--output-dir", tout])
    assert len(written) == 4
    for path in written:
        rel = os.path.relpath(path, tout)
        frames = []
        for root in (jout, tout):
            cap = cv2.VideoCapture(os.path.join(root, rel))
            got = []
            ok, f = cap.read()
            while ok:
                got.append(f)
                ok, f = cap.read()
            cap.release()
            frames.append(np.stack(got))
        np.testing.assert_array_equal(frames[1], frames[0])
        wav = rel[:-4] + "_audio.wav"
        assert (open(os.path.join(jout, wav), "rb").read()
                == open(os.path.join(tout, wav), "rb").read())


def test_visualization_video_raises_on_a_bad_codec(corpus, tmp_path, monkeypatch):
    import cv2

    from avvad_tpu_torch.scripts import visualization_video

    class Closed:
        def __init__(self, *a, **k):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    with pytest.raises(RuntimeError, match="mp4v"):
        visualization_video.main(["--data-root", corpus, "--output-dir", str(tmp_path)])


# --- the comparison scripts -----------------------------------------------------


def _run_both(monkeypatch, name: str, argv: list):
    """-> ((stdout, stderr, exit code) of JAX's script, the same of the
    port's twin)."""
    twin = importlib.import_module(f"avvad_tpu_torch.scripts.{name}")
    out = []
    for run in (lambda: run_jax_script(monkeypatch, name, argv), lambda: twin.main(argv)):
        o, e = io.StringIO(), io.StringIO()
        code = 0
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            try:
                run()
            except SystemExit as exit_:
                code = exit_.code
        out.append((o.getvalue(), e.getvalue(), code))
    return out


def test_compare_predictions_matches_jax(tmp_path, monkeypatch):
    """Two prediction trees (one utterance missing from the second): the
    same report, byte for byte, and the same warning; the numbers
    returned are the printed ones."""
    from avvad_tpu_torch.scripts import compare_predictions

    rng = np.random.default_rng(5)
    for i in range(5):
        a = rng.uniform(size=(40 + i, 1)).astype(np.float32)
        for root, soft in (("ref", a), ("test", a + rng.normal(0, 0.02, a.shape))):
            if root == "test" and i == 4:
                continue
            d = tmp_path / root / "Noisy" / f"spk{i % 2}"
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / f"u{i}_y_hat_soft.npy", soft.astype(np.float32))
    argv = [str(tmp_path / "ref"), str(tmp_path / "test")]
    jax_run, port_run = _run_both(monkeypatch, "compare_predictions", argv)
    assert port_run == jax_run and jax_run[2] == 0
    assert "warning: 1/5 utterances missing" in port_run[1]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        got = compare_predictions.main(argv)
    assert got["utterances"] == 4 and f"mean |dp|:           {got['mean']:.6f}" in port_run[0]
    assert f"hard flips:          {got['flips']} " in port_run[0]


@pytest.mark.parametrize("case", ["empty", "shape"])
def test_compare_predictions_errors_match_jax(tmp_path, monkeypatch, case):
    (tmp_path / "ref").mkdir()
    (tmp_path / "test").mkdir()
    if case == "shape":
        np.save(tmp_path / "ref" / "u_y_hat_soft.npy", np.zeros(5, np.float32))
        np.save(tmp_path / "test" / "u_y_hat_soft.npy", np.zeros(6, np.float32))
    j, t = _run_both(monkeypatch, "compare_predictions",
                     [str(tmp_path / "ref"), str(tmp_path / "test")])
    assert t == j and j[2] == 2 and t[1]


def _epoch_log(path, n: int, seed: int = 6) -> None:
    rng = np.random.default_rng(seed)
    lines = []
    for e in range(1, n + 1):
        lines.append(f"Epoch: {e}")
        for tag in ("Train", "Validation"):
            loss = "nan" if (tag == "Validation" and e == 3) else f"{rng.uniform(5, 12):.2f}"
            m = rng.uniform(0, 1, 4)
            lines.append(f"[{tag}]  Loss: {loss}    Accuracy: {m[0]:.2f}    Precision: "
                         f"{m[1]:.2f}    Recall: {m[2]:.2f}    F1_score: {m[3]:.2f}")
        lines.append(f"[Time]  {rng.uniform(1, 3):.2f}s")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("stride", [10, 3])
def test_summarize_training_matches_jax(tmp_path, monkeypatch, stride):
    """A 23-epoch log (one validation loss nan): the same table, byte for
    byte, and the same curve.json."""
    import json

    runs = {}
    for k in ("jax", "port"):
        runs[k] = tmp_path / k
        runs[k].mkdir()
        _epoch_log(runs[k] / "output_epoch.log", 23)
    twin = importlib.import_module("avvad_tpu_torch.scripts.summarize_training")
    jtext, ttext = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jtext):
        run_jax_script(monkeypatch, "summarize_training", [str(runs["jax"]), "--stride",
                                                           str(stride)])
    with contextlib.redirect_stdout(ttext):
        summary = twin.main([str(runs["port"]), "--stride", str(stride)])
    assert ttext.getvalue().replace(str(runs["port"]), str(runs["jax"])) == jtext.getvalue()
    want = json.loads((runs["jax"] / "curve.json").read_text())
    got = json.loads((runs["port"] / "curve.json").read_text())
    want["model_dir"] = got["model_dir"]
    assert json.dumps(got) == json.dumps(want)
    assert summary["n_epochs"] == 23


@pytest.mark.parametrize("case", ["no_log", "empty_log"])
def test_summarize_training_errors_match_jax(tmp_path, monkeypatch, case):
    if case == "empty_log":
        (tmp_path / "output_epoch.log").write_text("nothing\n")
    j, t = _run_both(monkeypatch, "summarize_training", [str(tmp_path)])
    assert t == j and isinstance(t[2], str)


# --- where matplotlib or cv2 is missing -------------------------------------------


@pytest.fixture
def no_figure_packages(monkeypatch):
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.gridspec", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("name", DRAWERS)
def test_drawing_functions_name_matplotlib_when_missing(no_figure_packages, name):
    x, spec, vad, psd = _signals(0)
    args = {"display_waveplot": (x,), "display_spectrogram": (spec,),
            "display_power_spectro": (psd,), "display_wav_spectro_mask": (x, spec, vad),
            "display_multiple_signals": ([[x, spec, vad]],),
            "display_multiple_spectro": ([[x, psd]],)}[name]
    with pytest.raises(ImportError, match=f"visualization.{name} needs matplotlib"):
        getattr(tvis, name)(*args)


@pytest.mark.parametrize("twin", ["run_metrics", "visualization_audio",
                                  "visualization_video_upsampling", "visualization_video"])
def test_twins_name_the_missing_package(corpus, tmp_path, no_figure_packages, twin):
    """Each twin that draws raises an ImportError naming matplotlib (or
    cv2) before it writes anything; the upsampling QA without
    ``--figures`` needs neither."""
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{twin}")
    out = str(tmp_path / "out")
    argv, package = {
        "run_metrics": (["--predictions-dir", out, "--figures", "--device", "cpu"],
                        "matplotlib"),
        "visualization_audio": (["--output-dir", out, "--check-device-stft",
                                 "--device", "cpu"], "matplotlib"),
        "visualization_video_upsampling": (["--output-dir", out, "--figures"], "matplotlib"),
        "visualization_video": (["--output-dir", out], "cv2"),
    }[twin]
    with pytest.raises(ImportError, match=f"{twin}.* needs {package}"):
        mod.main(["--data-root", corpus, *argv])
    assert not os.path.exists(out)
    if twin == "visualization_video_upsampling":
        with contextlib.redirect_stdout(io.StringIO()) as text, \
                pytest.raises(SystemExit, match="3 misaligned"):
            mod.main(["--data-root", corpus, "--output-dir", out])
        assert text.getvalue().count("MISALIGNED") == 3


@pytest.mark.parametrize("name", NEW_TWINS)
def test_new_twins_answer_help(name):
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and out.getvalue().startswith("usage")
