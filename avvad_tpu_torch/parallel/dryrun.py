"""Multi-device dry run: the full-width AV training step over a data x
model mesh, a checkpoint round trip under the mesh, and a sharded serving
tick (the port's counterpart of the JAX package's ``dryrun_multichip``).

Run it as ``python -m avvad_tpu_torch.parallel.dryrun N`` or call
``dryrun_multichip(N)``. It provisions itself: in a process without a
process group it spawns N ranks (``parallel.spawn``): NCCL ranks, one a
card, where N cards are visible, else gloo ranks on the CPU. A rank's
failure raises with its output.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import Batch
from .distributed import initialize_multihost, spawn
from .mesh import make_mesh, shard_batch, shard_opt_state, shard_params, world

H = 1024  # the reference's LSTM width
MCB = 1024
T = 8


def dryrun_multichip(n_devices: int, timeout_s: float = 900.0) -> None:
    """One meshed AV train step (AVVAD, MCB 1024, 2 x LSTM 1024, the
    ResNet-18 trunk frozen) at B = 2 x n_data, T = 8 over a data x model
    mesh (model 2 where n_devices is even and >= 4, so the (1024, 4096)
    LSTM weights shard), a checkpoint saved by rank 0 and restored bit for
    bit on every rank, a second step from it, and one tick of a
    ``MultiStreamAVVAD`` sharded over the data devices. Prints an ok line
    for each; raises on a failure."""
    if dist.is_initialized() and world()[0] == n_devices:
        _dryrun_rank(n_devices, "cuda" if dist.get_backend() == "nccl" else "cpu")
        return
    cards = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    # by module path: run as ``python -m``, this module is __main__
    spawn("avvad_tpu_torch.parallel.dryrun:_dryrun_rank", n_devices,
          args=[n_devices, "cuda" if cards else "cpu"], timeout_s=timeout_s, echo=True)


def _dryrun_rank(n_devices: int, kind: str) -> None:
    """One rank of the dry run."""
    from ..models import AVVAD
    from ..serve import MultiStreamAVVAD
    from ..train import create_train_state, make_train_step
    from ..train.checkpoint import restore_checkpoint, save_checkpoint
    from .mesh import full_state_dict

    if not dist.is_initialized():
        rank = int(os.environ["RANK"])
        initialize_multihost(backend="nccl" if kind == "cuda" else "gloo",
                             device=f"cuda:{rank}" if kind == "cuda" else None)
    rank = dist.get_rank()
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    devices = [f"cuda:{r}" for r in range(n_devices)] if kind == "cuda" else ["cpu"] * n_devices
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=devices)
    dev = mesh.local_device

    b = max(2 * n_data, 2)
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(b, T, 513)).astype(np.float32)
    video = rng.normal(size=(b, T, 67, 67)).astype(np.float32)
    label = (rng.uniform(size=(b, T, 1)) > 0.5).astype(np.float32)
    batch = Batch(audio=audio, video=video, label=label,
                  lengths=np.full((b,), T, np.int32), mask=np.ones((b, T), np.float32))
    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=MCB, use_kernel_lstm=True, seed=0)
    state = create_train_state(model, freeze_video_trunk=True, device=dev)
    shard_params(mesh, state.model)
    shard_opt_state(mesh, state.optimizer)
    local = shard_batch(mesh, batch)
    step = make_train_step("av", mesh=mesh)
    state, metrics = step(state, local)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} in the multichip dry run")
    if rank == 0:
        print(f"dryrun_multichip(n={n_devices}, mesh=data{n_data}xmodel{n_model}): "
              f"loss={loss:.4f} ok", flush=True)

    # checkpoint round trip under the mesh: rank 0 writes the gathered
    # state, every rank restores it, re-shards, and steps again
    saved = {k: v.clone() for k, v in full_state_dict(state.model).items()}
    with tempfile.TemporaryDirectory() as td:
        # every rank must name one directory: rank 0's
        name = [td]
        dist.broadcast_object_list(name, src=0)
        path = save_checkpoint(name[0], state, epoch=1, valid_loss=loss, mesh=mesh)
        restore_checkpoint(path, state, mesh=mesh)
        dist.barrier()
    restored = full_state_dict(state.model)
    if set(restored) != set(saved) or not all(torch.equal(saved[k], restored[k])
                                              for k in saved):
        raise RuntimeError("restored state differs from the saved sharded state")
    state, metrics2 = step(state, local)
    loss2 = float(metrics2["loss"])
    if not np.isfinite(loss2):
        raise RuntimeError(f"non-finite post-restore loss {loss2}")
    if rank == 0:
        print(f"checkpoint round-trip + post-restore step: loss={loss2:.4f} ok", flush=True)

    # serving over the data devices: one process, streams sharded on
    # `data`, no collective; the model unsharded from the trained state
    weights = full_state_dict(state.model)
    if rank == 0:
        served = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                       mcb_output_size=MCB, use_kernel_lstm=True)
        served.load_state_dict(weights)
        serve_mesh = make_mesh(n_data=n_data, n_model=1, devices=list(mesh.devices[:, 0]))
        ms = MultiStreamAVVAD(served, n_streams=n_data, block_frames=4, mesh=serve_mesh,
                              native=False)
        srng = np.random.default_rng(0)
        for i in range(n_data):
            ms.feed(i, pcm=srng.normal(size=4096).astype(np.float32),
                    video_frames=srng.random((8, 67, 67)).astype(np.float32))
        out = ms.tick()
        if not out or not all(np.isfinite(p).all() for p in out.values()):
            raise RuntimeError("serving mesh tick produced no or invalid output")
        print(f"serving mesh tick over {n_data} devices: {len(out)} streams ok", flush=True)
    dist.barrier()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
