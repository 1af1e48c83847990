"""The port's command-line twins (``avvad_tpu_torch/scripts/``): every one
answers ``--help``; ``create_train_files`` writes the tree the JAX script
writes; one reference (PyTorch) checkpoint goes through both
``import_checkpoint`` scripts into the same weights.

Training, evaluation and serving through the twins are in
tests/test_torch_port_cli_{train,eval,serve}.py.
"""

import contextlib
import importlib
import io
import os

import h5py
import numpy as np
import pytest
import torch

from torch_port_cli_lib import (import_both, jax_state_dict, port_state_dict,
                                run_jax_script, write_reference_pt)

TWINS = ["import_checkpoint", "create_train_files", "train", "evaluate", "run_metrics",
         "reconstruct", "export_serving", "serve_server", "stream_demo"]


@pytest.mark.parametrize("name", TWINS)
def test_help(name):
    """``--help`` of each twin, in process: exit 0, the usage and the
    ``--device`` flag; none of the XLA-only flags."""
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    text = out.getvalue()
    assert text.startswith("usage") and "--device" in text
    for flag in ("--prewarm", "--platforms", "--pallas-lstm"):
        assert flag not in text


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_create_train_files_tree_matches_jax(tmp_path, monkeypatch):
    """The same raw tree through both scripts: the same files; every HDF5
    dataset equal (the JAX builders compress with LZF, the port writes
    contiguous datasets) and every wav byte-equal."""
    from avvad_tpu_torch.scripts import create_train_files
    from test_torch_port_data import write_raw_corpus

    raw = write_raw_corpus(str(tmp_path / "raw"))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--raw-dir", raw, "--workers", "0", "--splits", "train", "test"]
    run_jax_script(monkeypatch, "create_train_files", [*args, "--processed-dir", jout])
    counts = create_train_files.main([*args, "--processed-dir", tout, "--device", "cpu"])
    assert counts == {"train/video": 4, "train/audio": 8, "test/video": 4, "test/audio": 8}
    files = _files(jout)
    assert files == _files(tout) and len(files) == 42
    for rel in files:
        a, b = os.path.join(jout, rel), os.path.join(tout, rel)
        if rel.endswith(".h5"):
            with h5py.File(a) as fa, h5py.File(b) as fb:
                assert list(fa) == list(fb)
                for k in fa:
                    assert fa[k].dtype == fb[k].dtype
                    np.testing.assert_array_equal(fa[k][:], fb[k][:])
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_create_train_files_one_worker_pool(tmp_path, monkeypatch):
    """``--workers 2`` spawns one pool for the whole build (every split's
    three maps) and writes the serial build's files byte for byte."""
    from avvad_tpu_torch import builders
    from avvad_tpu_torch.scripts import create_train_files
    from test_torch_port_data import write_raw_corpus

    spawned = []
    spawn = builders._spawn_pool
    monkeypatch.setattr(builders, "_spawn_pool", lambda n: spawned.append(n) or spawn(n))
    raw = write_raw_corpus(str(tmp_path / "raw"))
    serial, pooled = str(tmp_path / "serial"), str(tmp_path / "pooled")
    args = ["--raw-dir", raw, "--splits", "train", "test", "--device", "cpu"]
    create_train_files.main([*args, "--processed-dir", serial, "--workers", "0"])
    assert spawned == []
    create_train_files.main([*args, "--processed-dir", pooled, "--workers", "2"])
    assert spawned == [2] and builders._POOL is None
    files = _files(serial)
    assert files == _files(pooled) and len(files) == 42
    for rel in files:
        with open(os.path.join(serial, rel), "rb") as a, \
                open(os.path.join(pooled, rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("modality", ["av", "video", "audio"])
def test_import_checkpoint_matches_jax(tmp_path, monkeypatch, modality):
    """One reference .pt through both import scripts: the port checkpoint
    holds what the JAX one holds, bit for bit (epoch 0, vloss 0)."""
    ref = str(tmp_path / "ref.pt")
    write_reference_pt(ref)
    jdir, tdir = import_both(monkeypatch, tmp_path, ref, modality)
    assert os.listdir(jdir) == os.listdir(tdir) == ["epoch_000_vloss_0.00"]
    want, got = jax_state_dict(jdir, modality), port_state_dict(tdir)
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
