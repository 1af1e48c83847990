"""Rank functions of the port's multi-process tests (no JAX here: each rank
imports torch and the port only). The module holds no test of its own.

``tests/test_torch_port_parallel.py`` and
``tests/test_torch_port_distributed.py`` launch these through
``avvad_tpu_torch.parallel.spawn``: every rank forms a gloo process group
on the CPU from the launcher's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK``, runs its part, and returns a JSON-able result;
tensors too large for that go to files that rank 0 writes. The batches and
sources are made from numpy seeds by the functions below, which the tests
import too, so that the single-process oracles see the same data.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from avvad_tpu_torch.data import Batch
from avvad_tpu_torch.parallel import (initialize_multihost, local_batch_slice,
                                      make_mesh, make_multihost_mesh, shard_batch,
                                      shard_opt_state, shard_params)
from avvad_tpu_torch.parallel.mesh import full_state_dict

TP_H = 512  # 4H = 2048 = _TP_MIN_COLS: w_ih / w_hh shard on `model`


@contextlib.contextmanager
def one_thread():
    """Within: torch on one CPU thread. The tests' own steps are small, and
    beside other test workers and spawned ranks a pool of intra-op threads
    spends most of a small step handing work over (the ranks get one
    thread from ``spawn`` too)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def audio_batch(b: int = 8, t: int = 12, seed: int = 0) -> Batch:
    """A ragged audio batch: lengths t, t-3, 1, ... (a row of length 0)."""
    rng = np.random.default_rng(seed)
    audio = rng.normal(size=(b, t, 513)).astype(np.float32)
    label = (rng.uniform(size=(b, t, 1)) > 0.5).astype(np.float32)
    lengths = np.array([t, t - 3, t, 5, 0, t, 1, t] * (b // 8 + 1))[:b].astype(np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return Batch(audio=audio, video=None, label=label, lengths=lengths, mask=mask)


def av_batch(b: int = 4, t: int = 8, seed: int = 1) -> Batch:
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 3, t, 2] * (b // 4 + 1))[:b].astype(np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return Batch(audio=rng.normal(size=(b, t, 513)).astype(np.float32),
                 video=(rng.random((b, t, 67, 67)) * 255).astype(np.float32),
                 label=(rng.uniform(size=(b, t, 1)) > 0.5).astype(np.float32),
                 lengths=lengths, mask=mask)


def av_model(dropout_rate: float = 0.0):
    from avvad_tpu_torch.models import AVVAD

    return AVVAD(lstm_hidden_size=32, lstm_layers=2, mcb_output_size=64,
                 use_kernel_lstm=True, dropout_rate=dropout_rate, seed=0)


class TinySource:
    """``n`` AV utterances from a seed, in memory, in the port's source
    protocol (what ``DataLoader`` and ``evaluate_split`` read)."""

    def __init__(self, n: int = 6, seed: int = 7):
        self.n = n
        self.lengths = np.random.default_rng(seed).integers(6, 20, size=n)
        self.seed = seed

    def __len__(self):
        return self.n

    def rel_path(self, i: int) -> str:
        return f"tiny/spk{i % 2}/utt{i}.wav"

    def probe_length(self, i: int) -> int:
        return int(self.lengths[i])

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, i))
        t = int(self.lengths[i])
        return {"audio": rng.normal(size=(t, 513)).astype(np.float32),
                "video": (rng.random((t, 67, 67)) * 255).astype(np.float32),
                "label": (rng.uniform(size=(t, 1)) > 0.5).astype(np.float32),
                "length": t}


def _join() -> int:
    initialize_multihost(backend="gloo")
    return dist.get_rank()


def _tp_audio_model(weights: str | None, use_kernel: bool):
    from avvad_tpu_torch.models import AudioVAD

    model = AudioVAD(lstm_hidden_size=TP_H, lstm_layers=2, use_kernel_lstm=use_kernel, seed=0)
    if weights:
        model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def dp_tp_audio_step(n_data: int, n_model: int, weights: str | None, out_dir: str) -> dict:
    """AudioVAD(H=512) on a data x model mesh: one Adam step on the
    global ``audio_batch()`` for the plain recurrence and for the kernel
    route (``use_kernel_lstm``); rank 0 writes each final full state to
    ``out_dir/{plain,kernel}.pt``. Also reports the placements: shard and
    moment shapes, and the rows each rank held."""
    from avvad_tpu_torch.train import create_train_state, make_train_step

    rank = _join()
    mesh = make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))
    report = {"rank": rank, "coords": [mesh.data_index, mesh.model_index]}
    batch = audio_batch()
    local = shard_batch(mesh, batch)
    report["rows"] = [int(r) for r in np.flatnonzero(
        np.isin(batch.audio[:, 0, 0], local.audio[:, 0, 0]))]
    report["slice"] = [local_batch_slice(8, n_model).start, local_batch_slice(8, n_model).stop]
    for route, use_kernel in (("plain", False), ("kernel", True)):
        model = _tp_audio_model(weights, use_kernel)
        state = create_train_state(model, learning_rate=1e-4, device="cpu")
        shard_params(mesh, model)
        shard_opt_state(mesh, state.optimizer)
        step = make_train_step("audio", mesh=mesh)
        state, metrics = step(state, local)
        report[route] = {k: float(v) for k, v in metrics.items()}
        shards = {n: list(p.shape) for n, p in model.named_parameters() if "original" in n}
        moments = {n: [list(state.optimizer.state[p][k].shape) for k in ("exp_avg", "exp_avg_sq")]
                   for n, p in model.named_parameters() if "original" in n}
        report[route]["shards"] = shards
        report[route]["moments"] = moments
        full = full_state_dict(model)
        if rank == 0:
            torch.save(full, os.path.join(out_dir, f"{route}.pt"))
    return report


def synced_batch_norm(seed: int = 3) -> dict:
    """``resnet.batch_norm`` in train mode under a 2-rank data group, on
    this rank's half of a (8, 4, 3, 3) input: the output rows, the input
    gradient rows, the affine gradients (summed over ranks) and the
    running statistics, for fast and two-pass variance."""
    from torch import nn

    from avvad_tpu_torch.models.resnet import batch_norm
    from avvad_tpu_torch.parallel.sync import data_parallel

    rank = _join()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(8, 4, 3, 3)) * 2 + 1).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    rows = slice(4 * rank, 4 * rank + 4)
    out = {}
    for fast in (True, False):
        bn = nn.BatchNorm2d(4, eps=1e-5)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
        bn.train()
        xl = x[rows].clone().requires_grad_(True)
        with data_parallel(dist.group.WORLD):
            y = batch_norm(bn, xl, fast_variance=fast)
            (y * r[rows]).sum().backward()
        g = torch.cat([bn.weight.grad, bn.bias.grad])
        dist.all_reduce(g)
        out["fast" if fast else "two_pass"] = {
            "y": y.detach().tolist(), "dx": xl.grad.tolist(), "daffine": g.tolist(),
            "running_mean": bn.running_mean.tolist(), "running_var": bn.running_var.tolist()}
    return out


def av_meshed_step(steps: int, out_dir: str) -> dict:
    """AVVAD(2 x LSTM 32, MCB 64, the full ResNet-18 frozen in train mode)
    on data 2: ``steps`` Adam steps on the global ``av_batch()``, without
    dropout and with dropout 0.3 (its masks drawn for the global batch);
    rank 0 writes each final full state to ``out_dir/av_<rate>.pt``."""
    from avvad_tpu_torch.train import create_train_state, make_train_step

    rank = _join()
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    local = shard_batch(mesh, av_batch())
    out = {}
    for rate in AV_DROPOUT:
        model = av_model(rate)
        state = create_train_state(model, learning_rate=1e-4, freeze_video_trunk=True,
                                   device="cpu")
        shard_params(mesh, model)
        shard_opt_state(mesh, state.optimizer)
        step = make_train_step("av", dropout=rate > 0, dropout_seed=5, mesh=mesh)
        metrics = []
        for _ in range(steps):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        out[str(rate)] = metrics
        if rank == 0:
            torch.save(full_state_dict(model), os.path.join(out_dir, f"av_{rate}.pt"))
    return out


AV_DROPOUT = (0.0, 0.3)


def mesh_larger_than_world() -> None:
    """Build a 4-position mesh on a world of 2 and ask for its group:
    raises on every rank."""
    _join()
    make_mesh(4, 1, devices=["cpu"] * 4).group("data")


def tiny_audio_model():
    from avvad_tpu_torch.models import AudioVAD

    return AudioVAD(lstm_hidden_size=8, lstm_layers=1, seed=0)


def multi_process(out_dir: str) -> dict:
    """The multi-process run of ``tests/distributed_worker.py``, ported:
    a multihost mesh (data = world size), one meshed Adam step on this
    rank's rows (``local_batch_slice``) of a global batch of 8, a
    checkpoint written by rank 0 and restored bit for bit on every rank, a
    ``Trainer(mesh=)`` epoch (logs by rank 0 only) and the utterances of an
    ``evaluate_split`` sharded over the ranks."""
    from avvad_tpu_torch.evaluate import evaluate_split
    from avvad_tpu_torch.train import (Trainer, create_train_state, make_train_step,
                                       restore_checkpoint, save_checkpoint)

    rank = _join()
    n = dist.get_world_size()
    mesh = make_multihost_mesh(n_model=1, device="cpu")
    device_mesh = mesh.device_mesh()
    sl = local_batch_slice(8)
    batch = audio_batch(seed=4)
    local = Batch(*[None if a is None else a[sl] for a in batch])
    model = tiny_audio_model()
    state = create_train_state(model, learning_rate=1e-3, device="cpu")
    step = make_train_step("audio", mesh=mesh)
    state, metrics = step(state, local)
    pnorm = float(torch.sqrt(sum((p.detach().double() ** 2).sum() for p in model.parameters())))

    ckpt_dir = os.path.join(out_dir, "ckpt")
    path = save_checkpoint(ckpt_dir, state, epoch=1, valid_loss=0.0, mesh=mesh)
    fresh = create_train_state(tiny_audio_model(), learning_rate=1e-3, device="cpu")
    restore_checkpoint(path, fresh, mesh=mesh)
    sd, fsd = state.model.state_dict(), fresh.model.state_dict()
    opt, fopt = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    ckpt_equal = (set(sd) == set(fsd) and all(torch.equal(sd[k], fsd[k]) for k in sd)
                  and all(torch.equal(opt[i][k], fopt[i][k]) for i in opt for k in opt[i])
                  and fresh.step == state.step)

    trainer = Trainer(fresh, "audio", os.path.join(out_dir, "trainer"), mesh=mesh)
    fit = trainer.fit([audio_batch(seed=5), audio_batch(seed=6)], [audio_batch(seed=7)],
                      start_epoch=1, end_epoch=2)
    classified = evaluate_split(
        create_train_state(tiny_audio_model(), device="cpu"), _AudioOnly(TinySource(6)),
        "audio", os.path.join(out_dir, "classif"), batch_size=2 * n, bucket=8,
        verbose=False, mesh=mesh)
    return {"rank": rank, "world": n, "slice": [sl.start, sl.stop],
            "mesh": [mesh.shape["data"], mesh.shape["model"]],
            "device_mesh": [list(device_mesh.mesh_dim_names), list(device_mesh.shape)],
            "loss": float(metrics["loss"]), "f1": float(metrics["f1"]), "pnorm": pnorm,
            "ckpt_equal": bool(ckpt_equal), "fit": fit["train"]["loss"],
            "eval": {k: classified[k] for k in ("n_utterances", "n_frames")}}


class _AudioOnly:
    """``TinySource`` without its video, for an AudioVAD."""

    def __init__(self, src):
        self.src = src

    def __len__(self):
        return len(self.src)

    def __getattr__(self, name):
        return getattr(self.src, name)

    def __getitem__(self, i):
        item = dict(self.src[i])
        del item["video"]
        return item


def meshed_evaluate(out_dir: str) -> dict:
    """``evaluate_split(mesh=)`` of the AV model on data 2 over
    ``TinySource(6)``, with the float tower and with the static-int8 tower
    (its scales set from the seed), into ``out_dir/{float,int8}``."""
    from avvad_tpu_torch.evaluate import evaluate_split
    from avvad_tpu_torch.train import create_train_state

    _join()
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    out = {}
    for tower in ("float", "int8"):
        state = create_train_state(eval_model(tower == "int8"), device="cpu")
        report = evaluate_split(state, TinySource(6), "av", os.path.join(out_dir, tower),
                                batch_size=4, bucket=8, verbose=False, mesh=mesh)
        out[tower] = {k: report[k] for k in ("n_utterances", "n_frames", "audio_seconds")}
    return out


def eval_model(int8: bool):
    """The AV model of ``meshed_evaluate`` (and of its unmeshed oracle)."""
    from avvad_tpu_torch.models import AVVAD

    if not int8:
        return av_model()
    model = AVVAD(lstm_hidden_size=32, lstm_layers=2, mcb_output_size=64,
                  use_kernel_lstm=True, tower_int8=True, tower_quant_mode="static",
                  tower_pallas=True, seed=0)
    scales = np.random.default_rng(9).uniform(2.0, 6.0, size=64)
    bufs = [b for n, b in model.named_buffers() if n.rsplit(".", 1)[-1] in
            ("q_stem", "q1", "q_out")]
    with torch.no_grad():
        for b, v in zip(bufs, scales):
            b.fill_(float(v))
    return model


def cli_main(name: str, argv: list) -> dict:
    """A command-line twin's ``main(argv)`` on this rank (it forms the group
    itself under ``--data-parallel``) -> the numbers and dicts of what it
    returns (``train``: the last epoch's metrics; ``evaluate``: the
    report)."""
    import importlib

    out = importlib.import_module(f"avvad_tpu_torch.scripts.{name}").main(argv)
    return {k: v for k, v in out.items() if isinstance(v, (int, float, dict))}
