"""``evaluate``, ``run_metrics`` and ``reconstruct`` through both command
lines, JAX's scripts against the port's twins on the CPU: the reference
checkpoint (H=32, MCB 1024) imported by both ``import_checkpoint``
scripts, the same processed tree. The static-int8 tower's evaluation is
in tests/test_torch_port_cli_int8.py.
"""

import os
import shutil

import numpy as np
import pytest

from torch_port_cli_lib import (build_port_tree, import_both, run_jax_script,
                                write_reference_pt)


def make_env(tmp_path_factory, modalities):
    """The tree and the reference checkpoint imported by both scripts for
    each of ``modalities`` -> {"data", "tmp", modality: (JAX dir, port
    dir)}."""
    data = build_port_tree(tmp_path_factory, seed=2, splits=("train", "test"))
    tmp = tmp_path_factory.mktemp("eval")
    ref = str(tmp / "ref.pt")
    write_reference_pt(ref, seed=3)
    env = {"data": data, "tmp": tmp}
    with pytest.MonkeyPatch.context() as mp:
        for modality in modalities:
            env[modality] = import_both(mp, tmp, ref, modality)
    return env


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory, ("av", "video"))


def soft_predictions(root):
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs if f.endswith("_soft.npy"))
    return files, [np.load(os.path.join(root, f)) for f in files]


def evaluate_both(env, name, extra):
    """The JAX script and the port's twin over the test split with the
    imported AV checkpoints -> (JAX's prediction dir, the port's, the
    twin's report)."""
    from avvad_tpu_torch.scripts import evaluate

    tmp = env["tmp"]
    args = ["--modality", "av", "--data-root", env["data"], "--lstm-hidden", "32",
            "--batch-size", "4", "--bucket", "128", *extra]
    jout, tout = str(tmp / f"{name}_jax"), str(tmp / f"{name}_port")
    with pytest.MonkeyPatch.context() as mp:
        # the Pallas LSTM (interpret mode here): the port's kernels' arithmetic
        run_jax_script(mp, "evaluate", [*args, "--checkpoint", env["av"][0],
                                        "--output-dir", jout, "--pallas-lstm"])
    report = evaluate.main([*args, "--checkpoint", env["av"][1], "--output-dir", tout,
                            "--device", "cpu"])
    return jout, tout, report


def test_evaluate_float_tower_matches_jax(env):
    """The float tower: the same prediction files, soft predictions within
    1e-4, hard ones equal where the soft one is away from 0.5."""
    jout, tout, report = evaluate_both(env, "float", [])
    files, want = soft_predictions(jout)
    got_files, got = soft_predictions(tout)
    assert files == got_files and len(files) == report["n_utterances"] == 4
    for f, g, w in zip(files, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=f)
        hard_g = np.load(os.path.join(tout, f.replace("_soft", "_hard")))
        hard_w = np.load(os.path.join(jout, f.replace("_soft", "_hard")))
        away = np.abs(w - 0.5) > 1e-4
        np.testing.assert_array_equal(hard_g[away], hard_w[away])
    spread = np.concatenate(want)
    assert (spread > 0.5).any() and (spread < 0.5).any()
    env["float_predictions"] = jout


def test_run_metrics_matches_jax(env, tmp_path):
    """Both scripts score the same prediction files: every number of
    stats.json within 1e-6."""
    import json

    from avvad_tpu_torch.scripts import run_metrics

    src = env.get("float_predictions")
    if src is None:
        src = evaluate_both(env, "float_for_metrics", [])[0]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    args = ["--data-root", env["data"]]
    with pytest.MonkeyPatch.context() as mp:
        run_jax_script(mp, "run_metrics", [*args, "--predictions-dir", jdir])
    stats = run_metrics.main([*args, "--predictions-dir", tdir, "--device", "cpu"])
    want = json.load(open(os.path.join(jdir, "stats.json")))
    got = json.load(open(os.path.join(tdir, "stats.json")))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (int, float)):
            assert abs(a - b) <= 1e-6, (path, a, b)
        else:
            assert a == b, path

    walk(got, want)
    assert stats["overall"].keys() == want["overall"].keys()
    with pytest.raises(SystemExit, match="--figures"):
        run_metrics.main([*args, "--predictions-dir", tdir, "--device", "cpu", "--figures"])


def test_reconstruct_matches_jax(env):
    """VideoVAD one utterance at a time: the same hard-label files, equal
    where the soft prediction is away from 0.5."""
    from avvad_tpu_torch.scripts import reconstruct

    tmp = env["tmp"]
    args = ["--data-root", env["data"], "--lstm-hidden", "32"]
    jout, tout = str(tmp / "rec_jax"), str(tmp / "rec_port")
    with pytest.MonkeyPatch.context() as mp:
        run_jax_script(mp, "reconstruct", [*args, "--checkpoint", env["video"][0],
                                           "--output-dir", jout])
    rows = reconstruct.main([*args, "--checkpoint", env["video"][1], "--output-dir", tout,
                             "--device", "cpu"])
    assert len(rows) == 4
    for row in rows:
        rel = os.path.splitext(row["rel_path"])[0] + "_y_hat_hard.npy"
        got, want = np.load(os.path.join(tout, rel)), np.load(os.path.join(jout, rel))
        assert got.shape == want.shape == (len(row["soft"]),)
        away = np.abs(row["soft"][:, 0] - 0.5) > 1e-4
        np.testing.assert_array_equal(got[away], want[away])
        assert away.mean() > 0.9

