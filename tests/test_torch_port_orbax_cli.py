"""The port's command-line twins on the JAX package's model directories:
``train --resume``, ``train --pretrained-video`` and ``evaluate`` given a
directory that JAX's ``save_checkpoint`` wrote (Orbax) run as they do on
the port's own directory of the same weights (``state.pt``): the same log
lines, the same parameters and predictions, bit for bit. No new flag: the
readers tell the two apart. The tree is tests/torch_port_cli_lib.py's;
the weights the port's seeded init at H=32 (MCB 1024), the Adam moments at
init on both sides (optax's zeros and count 0, torch's empty state).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.train import checkpoint as jckpt
from avvad_tpu_torch.convert import to_flax_variables
from avvad_tpu_torch.scripts._common import build_model
from avvad_tpu_torch.train import create_train_state
from avvad_tpu_torch.train import checkpoint as ckpt
from torch_port_cli_lib import H, build_port_tree, port_state_dict
from torch_port_orbax_lib import jax_state, params_of

JAX_MODELS = {"audio": JAudioVAD, "video": JVideoVAD}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return build_port_tree(tmp_path_factory, seed=4)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """For "audio" and "video": (a JAX model dir, the port's) holding the
    same seeded weights as epoch 0."""
    tmp = tmp_path_factory.mktemp("orbax_cli")
    out = {}
    for modality, jmodel in JAX_MODELS.items():
        model = build_model(modality, lstm_hidden=H, seed=0)
        torch.manual_seed(1)
        for p in model.parameters():  # away from init's zeros, as a trained model
            p.data.add_(0.01 * torch.randn_like(p))
        variables = to_flax_variables(model.state_dict(), params_of(model))
        jdir, tdir = str(tmp / f"jax_{modality}"), str(tmp / f"port_{modality}")
        jckpt.save_checkpoint(jdir, jax_state(jmodel(lstm_hidden_size=H), variables, False),
                              epoch=0, valid_loss=1.0)
        ckpt.save_checkpoint(tdir, create_train_state(model, device="cpu"), epoch=0,
                             valid_loss=1.0)
        out[modality] = (jdir, tdir)
    return out


def _lines(d, name):
    with open(os.path.join(d, name)) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("[Time]")]


def _same_state(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_resume_from_jax_model_dir(data, dirs, tmp_path):
    """``train --resume`` on a copy of the JAX model dir and of the port's:
    both resume epoch 0 (Adam from optax's state, step 0), train epoch 1 on
    the same tree; logs, checkpoint names and parameters equal."""
    from avvad_tpu_torch.scripts import train

    args = ["--modality", "audio", "--data-root", data, "--resume", "--epochs", "1",
            "--batch-size", "2", "--bucket", "128", "--lstm-hidden", str(H),
            "--device", "cpu"]
    runs = {}
    for side, src in zip(("jax", "port"), dirs["audio"]):
        model_dir = str(tmp_path / side)
        shutil.copytree(src, model_dir)
        runs[side] = (model_dir, train.main([*args, "--model-dir", model_dir]))
    (jdir, jres), (tdir, tres) = runs["jax"], runs["port"]
    assert jres["epoch"] == tres["epoch"] == 1
    for name in ("output_batch.log", "output_epoch.log"):
        assert _lines(jdir, name) == _lines(tdir, name)
    assert _lines(jdir, "output_epoch.log")[0] == "Epoch: 1"
    _same_state(port_state_dict(ckpt.latest_checkpoint(jdir)),
                port_state_dict(ckpt.latest_checkpoint(tdir)))


def test_train_pretrained_video_from_jax_model_dir(data, dirs, tmp_path):
    """``train --modality av --pretrained-video`` given the JAX VideoVAD
    model dir and the port's: the trunk grafted and frozen, one epoch; logs
    and parameters equal, the trunk's parameters the VideoVAD's."""
    from avvad_tpu_torch.scripts import train

    args = ["--modality", "av", "--data-root", data, "--epochs", "1", "--batch-size", "4",
            "--bucket", "128", "--lstm-hidden", str(H), "--device", "cpu"]
    out = {}
    for side, src in zip(("jax", "port"), dirs["video"]):
        model_dir = str(tmp_path / side)
        train.main([*args, "--model-dir", model_dir, "--pretrained-video", src])
        out[side] = model_dir
    for name in ("output_batch.log", "output_epoch.log"):
        assert _lines(out["jax"], name) == _lines(out["port"], name)
    got = port_state_dict(ckpt.latest_checkpoint(out["jax"]))
    _same_state(got, port_state_dict(ckpt.latest_checkpoint(out["port"])))
    video = port_state_dict(dirs["video"][1])
    trunk = [k for k in video if k.startswith("tower.features.")
             and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert trunk
    for k in trunk:
        assert torch.equal(got[k], video[k]), k


def test_evaluate_jax_model_dir(data, dirs, tmp_path):
    """``evaluate --checkpoint`` given the JAX audio model dir and the
    port's: the same report (but its timings) and predictions, bit for
    bit."""
    from avvad_tpu_torch.scripts import evaluate

    args = ["--modality", "audio", "--data-root", data, "--lstm-hidden", str(H),
            "--batch-size", "4", "--bucket", "128", "--device", "cpu"]
    reports, outs = {}, {}
    for side, src in zip(("jax", "port"), dirs["audio"]):
        outs[side] = str(tmp_path / side)
        reports[side] = evaluate.main([*args, "--checkpoint", src, "--output-dir", outs[side]])
    timings = ("elapsed_s", "rt_factor")
    assert {k: v for k, v in reports["jax"].items() if k not in timings} == \
        {k: v for k, v in reports["port"].items() if k not in timings}
    files = sorted(os.path.relpath(os.path.join(d, f), outs["port"])
                   for d, _, fs in os.walk(outs["port"]) for f in fs if f.endswith(".npy"))
    assert files
    for f in files:
        np.testing.assert_array_equal(np.load(os.path.join(outs["jax"], f)),
                                      np.load(os.path.join(outs["port"], f)))
