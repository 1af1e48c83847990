"""Helpers of the command-line parity tests (tests/test_torch_port_cli*.py):
a tiny processed tree, a reference-layout checkpoint, and the JAX scripts
run in this process.

The tree is tests/test_torch_port_data.py's raw corpus (4 utterances a
split, 1-1.6 s) through the port's builders, which that file holds to
JAX's. The reference checkpoint is a DeepVAD_{AV,video,audio} state dict
at H=32 with MCB 1024 (the JAX scripts have no flag for another MCB
width), made from a seed; its heads are scaled so that the probabilities
spread over both sides of 0.5.
"""

import os
import runpy
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, MCB_OUT = 32, 1024
SPLITS = ("train", "validation", "test")


def build_port_tree(tmp_path_factory, seed: int = 0, splits=SPLITS) -> str:
    """-> the data root (``<root>/subset/processed/`` holds the tree)."""
    from avvad_tpu_torch.scripts import create_train_files
    from test_torch_port_data import write_raw_corpus

    raw = write_raw_corpus(str(tmp_path_factory.mktemp("raw")), seed=seed)
    data = str(tmp_path_factory.mktemp("data"))
    create_train_files.main(["--raw-dir", raw, "--processed-dir",
                             os.path.join(data, "subset", "processed"),
                             "--workers", "0", "--device", "cpu", "--splits", *splits])
    return data


def write_reference_pt(path: str, seed: int = 0) -> dict:
    """A reference-layout torch checkpoint at H=32, MCB 1024 -> its state
    (``utils.torch_import.random_reference_state``: at the scales of a
    trained model, so that the trunk's fp32 gradients are not dominated by
    rounding, and the AV logits centred near 0 on this tree)."""
    from avvad_tpu_torch.utils.torch_import import random_reference_state

    state = random_reference_state(seed, H, MCB_OUT)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    return state


def run_jax_script(monkeypatch, name: str, argv: list):
    """``scripts/<name>.py`` as ``__main__`` with ``argv``, in this process
    (its persistent XLA cache left off) -> its globals."""
    import avvad_tpu.utils

    monkeypatch.setattr(avvad_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *map(str, argv)])
    return runpy.run_path(path, run_name="__main__")


def import_both(monkeypatch, tmp_path, ref: str, modality: str, lstm_hidden: int = H):
    """The reference checkpoint through both import_checkpoint scripts ->
    (the JAX model dir, the port's)."""
    from avvad_tpu_torch.scripts import import_checkpoint

    jdir, tdir = str(tmp_path / f"jax_{modality}"), str(tmp_path / f"port_{modality}")
    args = ["--modality", modality, "--torch-checkpoint", ref, "--lstm-hidden",
            str(lstm_hidden)]
    run_jax_script(monkeypatch, "import_checkpoint", [*args, "--output-dir", jdir])
    import_checkpoint.main([*args, "--output-dir", tdir, "--device", "cpu"])
    return jdir, tdir


def jax_state_dict(path: str, modality: str, lstm_hidden: int = H) -> dict:
    """A JAX checkpoint (a checkpoint, or a model dir: its best) as the
    port's state dict."""
    import jax
    import jax.numpy as jnp

    from avvad_tpu.models import AVVAD, AudioVAD, VideoVAD
    from avvad_tpu.train import create_train_state, restore_checkpoint
    from avvad_tpu_torch.convert import from_flax_variables

    kw = dict(lstm_hidden_size=lstm_hidden, lstm_layers=2)
    model, example = {
        "audio": (AudioVAD(**kw), (jnp.zeros((1, 4, 513)),)),
        "video": (VideoVAD(**kw), (jnp.zeros((1, 2, 67, 67)),)),
        "av": (AVVAD(**kw), (jnp.zeros((1, 2, 513)), jnp.zeros((1, 2, 67, 67)))),
    }[modality]
    state = create_train_state(model, jax.random.PRNGKey(0), example)
    state, _, _ = restore_checkpoint(path, state, with_opt=False)
    return from_flax_variables(jax.tree_util.tree_map(np.asarray, state.variables()))


def port_state_dict(path: str) -> dict:
    """A port checkpoint (a checkpoint, or a model dir: its best) -> its
    model's state dict."""
    from avvad_tpu_torch.train import resolve_checkpoint

    path = os.path.join(resolve_checkpoint(path), "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
