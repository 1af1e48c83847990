"""Runs of the harness with the timed path broken underneath come out not
``correct``: the look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault a cell can have (a train step that
leaves its state unchanged; half of the batch left out; an answer altered
where it is produced; one card, so no exchange between cards to leave out).
A train step that goes wrong only after the checked steps is caught by the
step after the window. The lower-precision controls: the serving cells'
bf16-state LSTM (the program's own path) here; the training cells' TF32
reference on the card."""

import pytest
import torch

from benchmark.drivers import serve, train
from benchmark.harness import weights as wts
from benchmark.harness.readings import run_seed
from benchmark.reference import compare
from benchmark.tests.tiny import run_tiny, tiny_cell

SERVE = ["avvad.serve_b64", "audiovad.serve_b64"]
TRAIN = ["avvad.train_b16", "audiovad.train_b16"]


def _wrap_serve(monkeypatch, fault):
    real = serve.build_step

    def build_step(*a, **k):
        model, step = real(*a, **k)
        return model, lambda i: fault(step, i)

    monkeypatch.setattr(serve, "build_step", build_step)


def answer_altered(step, i):
    out = step(i).clone()
    out[0, 3, 0] += 0.01
    return out


def half_batch(step, i):
    out = step(i).clone()
    b = out.shape[0] // 2
    out[b:] = out[:b].mean(dim=0, keepdim=True)
    return out


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [answer_altered, half_batch])
def test_serve_fault_not_correct(monkeypatch, cell, fault):
    _wrap_serve(monkeypatch, fault)
    res = run_tiny(cell)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_not_correct(cell):
    """The program with its bf16-state LSTM path on fails the comparison."""
    res = run_tiny(cell, lstm_state_quant="bf16")
    assert not res["correct"], res["checks"]


def _wrap_train(monkeypatch, fault):
    real = train.build_step

    def build_step(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: fault(step, state, batch)

    monkeypatch.setattr(train, "build_step", build_step)


def state_unchanged(step, state, batch):
    kept = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, metrics = step(state, batch)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(kept[n])
    return state, metrics


def half_batch_train(step, state, batch):
    b = batch.mask.shape[0] // 2
    return step(state, batch._replace(
        audio=batch.audio[:b], video=None if batch.video is None else batch.video[:b],
        label=batch.label[:b], mask=batch.mask[:b], lengths=batch.lengths[:b]))


def loss_altered(step, state, batch):
    state, metrics = step(state, batch)
    return state, {**metrics, "loss": metrics["loss"] * 1.001}


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch_train, loss_altered])
def test_train_fault_not_correct(monkeypatch, cell, fault):
    _wrap_train(monkeypatch, fault)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_after_warm_up_not_correct(monkeypatch, cell):
    """Sound through the checked steps, then steps that leave the state as it
    was (a fast path that starts late): the step after the window fails."""
    calls = [0]

    def fault(step, state, batch):
        calls[0] += 1
        if calls[0] <= train.CHECKED_STEPS:
            return step(state, batch)
        return state_unchanged(step, state, batch)

    _wrap_train(monkeypatch, fault)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]
    assert res["numbers"]["late_update_norm_gap"] > 0.5, res["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_not_correct(cell):
    """The reference in the program's place with TF32 on fails the cell's
    limits (TF32 exists on the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA card")
    c = tiny_cell(cell, batch=8, frames=128)
    c.config["lstm_hidden_size"] = 256
    numbers = run_seed(c, 5, "control", torch.device("cuda"), seconds=0.5)["numbers"]
    assert not compare.judge(numbers, c.limits)[0], numbers


def test_generator_takes_large_seeds():
    g = wts.generator(2 ** 33 + 7, torch.device("cpu"))
    assert torch.randn(2, generator=g).shape == (2,)
