"""Process groups: initialisation, the multi-process mesh, rank-local
batch slices, and a launcher of local ranks (port of
avvad_tpu/parallel/distributed.py).

``initialize_multihost`` forms the ``torch.distributed`` process group
from its arguments or torch's standard variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is named by the
caller, never guessed: ``nccl`` for one rank a card, ``gloo`` on the CPU
and for several ranks on one card (NCCL refuses two ranks on one device;
gloo carries CUDA tensors for ``all_reduce``, ``broadcast`` and
``all_gather``, the three collectives the port uses).

``spawn`` runs a function on n local ranks, each a Python process of its
own with those variables set, and raises with a failing rank's stderr.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .._device import resolve_device
from .mesh import Mesh, data_rows, make_mesh, world

BACKENDS = ("nccl", "gloo")
_TIMEOUT = datetime.timedelta(minutes=10)  # of a collective whose peers do not come


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: Optional[str | torch.device] = None) -> bool:
    """Form the process group from the arguments or ``MASTER_ADDR`` (with
    ``MASTER_PORT``, or ``host:port`` in the address), ``WORLD_SIZE`` and
    ``RANK``. -> True once formed; False for a single-process run (no
    address given or set). ``backend``: "nccl" or "gloo", required.
    ``device``: this rank's card, made current before an NCCL group forms.
    Raises where the group cannot be formed."""
    coordinator_address = coordinator_address or os.environ.get("MASTER_ADDR")
    if coordinator_address is None:
        return False
    # `is None` checks, not `or`: rank 0 is falsy
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}: nccl for one rank a "
                         f"card, gloo on the CPU or for ranks sharing a card (got "
                         f"{backend!r})")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend nccl needs a CUDA device and none is available")
        if device is not None:
            torch.cuda.set_device(torch.device(device))
    host, _, port = coordinator_address.rpartition(":")
    if not host:
        host, port = coordinator_address, os.environ["MASTER_PORT"]
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)
    return True


def make_multihost_mesh(n_model: int = 1,
                        device: Optional[str | torch.device] = None) -> Mesh:
    """The global (data, model) mesh over every rank's device, rank r at
    (r // n_model, r % n_model): ranks along ``model`` are consecutive, so
    on a multi-host job a data row's model shards stay on one host.
    ``device``: this rank's device (default: its current card, under any
    backend; raises when no card is visible, so a mesh on the CPU is asked
    for with ``device="cpu"``). Collective."""
    if device is None:
        resolve_device(None)
        device = f"cuda:{torch.cuda.current_device()}"
    size, _ = world()
    if size % n_model:
        raise ValueError(f"{size} ranks not divisible by model axis {n_model}")
    devices = [str(torch.device(device))]
    if size > 1:
        devices = [None] * size
        dist.all_gather_object(devices, str(torch.device(device)))
    return make_mesh(n_data=size // n_model, n_model=n_model, devices=devices)


def local_batch_slice(global_batch: int, n_model: int = 1) -> slice:
    """This rank's rows of a global batch: the share of its DATA
    coordinate (rank // n_model), so ranks along ``model`` get the same
    rows."""
    size, rank = world()
    if size % n_model:
        raise ValueError(f"{size} ranks not divisible by model axis {n_model}")
    return data_rows(global_batch, size // n_model, rank // n_model)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CHILD = ("import sys; sys.path[:0] = {paths!r}\n"
          "from avvad_tpu_torch.parallel.distributed import _run_rank\n"
          "_run_rank({target!r}, {args!r}, {out!r})\n")


def _run_rank(target: str, args: list, out: str) -> None:
    """A spawned rank: call ``module:function(*args)`` and write its
    JSON-able result to ``out``."""
    import importlib

    module, _, fn = target.partition(":")
    result = getattr(importlib.import_module(module), fn)(*args)
    with open(out, "w") as f:
        json.dump(result, f)


def spawn(target: str, n: int, args: Sequence = (), timeout_s: float = 120.0,
          paths: Sequence[str] = (), threads: int = 1, echo: bool = False) -> list:
    """Run ``target`` ("module:function", importable with ``paths`` in front
    of ``sys.path``) on ``n`` local ranks -> each rank's return value (JSON),
    in rank order. Each rank is a process with ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set (the function forms its
    group with ``initialize_multihost``) and ``threads`` CPU threads. The
    first rank to fail, or the time limit, kills every rank and raises
    with the stderr of the failing rank (or of every rank at the limit).
    ``echo``: write rank 0's output to this process's stdout."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="avvad_spawn_") as tmp:
        procs, outs, errs = [], [], []
        for rank in range(n):
            out = os.path.join(tmp, f"rank{rank}.json")
            child_env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
                         "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
                         "RANK": str(rank), "OMP_NUM_THREADS": str(threads)}
            err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
            code = _CHILD.format(paths=[repo, *paths], target=target,
                                 args=list(args), out=out)
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=child_env,
                                          stdout=err, stderr=subprocess.STDOUT))
            outs.append(out)
            errs.append(err)
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} of {n} ({target}) failed "
                                       f"(rc={codes[failed[0]]}):\n"
                                       + _tail(errs[failed[0]]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{target} on {n} ranks passed its {timeout_s} s "
                                       "limit:\n" + "\n".join(
                                           f"--- rank {r}:\n{_tail(e)}"
                                           for r, e in enumerate(errs)))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if echo:
                sys.stdout.write(_tail(errs[0], None))
            for e in errs:
                e.close()
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
        return results


def _tail(f, n: Optional[int] = 6000) -> str:
    f.flush()
    f.seek(0)
    text = f.read()
    return text if n is None else text[-n:]
