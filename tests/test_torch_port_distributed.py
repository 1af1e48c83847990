"""The port's process groups on the CPU: initialisation, the multihost
mesh and rank slices, the launcher, the synchronised BatchNorm, the AV
train step on data 2 (with and without dropout), and the multi-process
run of ``tests/test_distributed.py`` / ``tests/distributed_worker.py``
(2 and 4 ranks: a meshed step, the checkpoint written by rank 0 and
restored bit for bit everywhere, ``Trainer(mesh=)``, a sharded
``evaluate_split``) against single-process oracles.

Every launch is a set of gloo ranks on the CPU with its own time limit;
a failing rank kills the others and raises with its output. The rank
functions are in ``tests/test_torch_port_ranks.py``.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from avvad_tpu_torch.models.resnet import batch_norm
from avvad_tpu_torch.parallel import (initialize_multihost, local_batch_slice,
                                      make_multihost_mesh, spawn)
from avvad_tpu_torch.train import create_train_state, make_train_step

import test_torch_port_ranks as worker

HERE = os.path.dirname(os.path.abspath(__file__))
SPAWN_S = 120


def _spawn(fn, n, *args):
    return spawn(f"test_torch_port_ranks:{fn}", n, args=args, timeout_s=SPAWN_S,
                 paths=[HERE])


def test_initialize_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost(backend="gloo") is False


def test_initialize_multihost_names_its_backend(monkeypatch):
    """The backend is named, never guessed; NCCL without a card raises."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="name the backend"):
        initialize_multihost()
    with pytest.raises(ValueError, match="name the backend"):
        initialize_multihost(backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
            initialize_multihost(backend="nccl")


def test_backends_are_checked_against_the_mesh_devices():
    """No quiet fallback: NCCL cannot carry CPU tensors, other backends are
    refused; gloo carries both."""
    from avvad_tpu_torch.parallel.mesh import check_backend

    check_backend("gloo", torch.device("cpu"))
    check_backend("gloo", torch.device("cuda:0"))
    check_backend("nccl", torch.device("cuda:1"))
    with pytest.raises(ValueError, match="'nccl' cannot carry .* on cpu"):
        check_backend("nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="'mpi' cannot carry"):
        check_backend("mpi", torch.device("cpu"))


def test_single_process_mesh_and_slices():
    mesh = make_multihost_mesh(n_model=1, device="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert local_batch_slice(32) == slice(0, 32)
    with pytest.raises(ValueError, match="not divisible by model axis"):
        make_multihost_mesh(n_model=2, device="cpu")
    if not torch.cuda.is_available():  # the rank's card by default, never the CPU
        with pytest.raises(RuntimeError, match="runs on a CUDA device by default"):
            make_multihost_mesh(n_model=1)


def test_spawn_raises_with_the_failing_rank_output():
    """A mesh of 4 positions on a world of 2 raises on every rank (no quiet
    fallback), and the launcher kills the ranks and raises with the
    output of the first to fail."""
    with pytest.raises(RuntimeError, match="process group has 2 rank"):
        _spawn("mesh_larger_than_world", 2)


# --- synchronised BatchNorm -------------------------------------------------------


@pytest.fixture(scope="module")
def synced_bn():
    return _spawn("synced_batch_norm", 2)


@pytest.mark.parametrize("variance", ["fast", "two_pass"])
def test_synced_batch_norm_matches_the_concatenated_batch(synced_bn, variance):
    """``batch_norm`` on two ranks' halves under the data group equals
    one process on the whole batch: output and input gradient rows, the
    affine gradients and the running statistics on both ranks."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(8, 4, 3, 3)) * 2 + 1).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    bn = nn.BatchNorm2d(4, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
    x.requires_grad_(True)
    y = batch_norm(bn.train(), x, fast_variance=variance == "fast")
    (y * r).sum().backward()
    daffine = torch.cat([bn.weight.grad, bn.bias.grad])
    for rank, got in enumerate(synced_bn):
        g = got[variance]
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(g["y"], y[rows].detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["dx"], x.grad[rows].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["daffine"], daffine.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["running_mean"], bn.running_mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(g["running_var"], bn.running_var.numpy(), rtol=1e-6)


# --- the AV step on data 2 ----------------------------------------------------------

AV_STEPS = 2


@pytest.fixture(scope="module")
def av_meshed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("av")
    reports = _spawn("av_meshed_step", 2, AV_STEPS, str(tmp))
    return reports, tmp


@pytest.mark.parametrize("rate", worker.AV_DROPOUT)
def test_av_meshed_step_matches_unmeshed(av_meshed, rate):
    """AVVAD(MCB 64, 2 x LSTM 32, the ResNet-18 frozen in train mode: its
    BatchNorms on global statistics) on data 2 against the unmeshed port
    step (held to JAX by tests/test_torch_port_train.py), two steps; with
    dropout 0.3 the masks are the global batch's, so the steps still
    agree: loss rtol 1e-5, metrics, parameters and running statistics
    rtol 1e-4 / atol 1e-5."""
    reports, tmp = av_meshed
    model = worker.av_model(rate)
    state = create_train_state(model, learning_rate=1e-4, freeze_video_trunk=True,
                               device="cpu")
    step = make_train_step("av", dropout=rate > 0, dropout_seed=5)
    single = []
    with worker.one_thread():
        for _ in range(AV_STEPS):
            state, m = step(state, worker.av_batch())
            single.append({k: float(v) for k, v in m.items()})
    for r in reports:
        for got, want in zip(r[str(rate)], single):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            for k in ("accuracy", "precision", "recall", "f1"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    meshed = torch.load(str(tmp / f"av_{rate}.pt"), weights_only=True)
    ref = model.state_dict()
    assert set(meshed) == set(ref)
    for k in ref:
        np.testing.assert_allclose(meshed[k].double().numpy(), ref[k].double().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_dropout_changes_the_av_step(av_meshed):
    reports, _ = av_meshed
    assert reports[0]["0.3"][0]["loss"] != reports[0]["0.0"][0]["loss"]


# --- multi-process runs --------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4])
def multi(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"multi{request.param}")
    return request.param, _spawn("multi_process", request.param, str(tmp)), tmp


def test_multi_process_rank_slices_and_mesh(multi):
    n, results, _ = multi
    per = 8 // n
    for rank, r in enumerate(results):
        assert r["rank"] == rank and r["world"] == n and r["mesh"] == [n, 1]
        assert r["device_mesh"] == [["data", "model"], [n, 1]]
        assert r["slice"] == [rank * per, rank * per + per]


def test_multi_process_step_matches_single_process(multi):
    """Loss and parameter norm after one meshed Adam step against the
    single-process step on the global batch, rtol 1e-5 (as
    tests/test_distributed.py); every rank reports the same values."""
    _, results, _ = multi
    model = worker.tiny_audio_model()
    state = create_train_state(model, learning_rate=1e-3, device="cpu")
    _, m = make_train_step("audio")(state, worker.audio_batch(seed=4))
    pnorm = float(torch.sqrt(sum((p.detach().double() ** 2).sum() for p in model.parameters())))
    assert len({r["loss"] for r in results}) == 1
    assert len({r["pnorm"] for r in results}) == 1
    np.testing.assert_allclose(results[0]["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(results[0]["f1"], float(m["f1"]), rtol=1e-5)
    np.testing.assert_allclose(results[0]["pnorm"], pnorm, rtol=1e-5)


def test_multi_process_checkpoint_restores_bit_equal(multi):
    """Rank 0 wrote the gathered state; every rank restored it bit for
    bit (parameters, Adam moments, step)."""
    _, results, tmp = multi
    assert all(r["ckpt_equal"] for r in results)
    assert len(os.listdir(tmp / "ckpt")) == 1


def test_multi_process_trainer_logs_on_rank_zero(multi):
    """``Trainer(mesh=)``: one epoch of two batches; the batch log holds
    rank 0's two lines only, the epoch's checkpoint is written once, and
    every rank reports the same global loss."""
    n, results, tmp = multi
    assert len({r["fit"] for r in results}) == 1 and np.isfinite(results[0]["fit"])
    lines = (tmp / "trainer" / "output_batch.log").read_text().splitlines()
    assert len(lines) == 2 and "[   8/  16 (50%)]" in lines[0]
    assert len((tmp / "trainer" / "output_epoch.log").read_text().splitlines()) == 4
    assert [p for p in os.listdir(tmp / "trainer") if p.startswith("epoch_")]


def test_multi_process_evaluation_shards_partition_the_utterances(multi):
    """The sharded ``evaluate_split`` writes every utterance's pair of
    files exactly once, and every rank reports the global counts."""
    n, results, tmp = multi
    src = worker.TinySource(6)
    for r in results:
        assert r["eval"] == {"n_utterances": 6, "n_frames": int(src.lengths.sum())}
    files = sorted(p.name for p in (tmp / "classif").rglob("*.npy"))
    assert files == sorted(f"utt{i}_y_hat_{k}.npy" for i in range(6) for k in ("hard", "soft"))
