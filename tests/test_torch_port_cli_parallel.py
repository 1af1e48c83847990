"""``--data-parallel`` of the ``train`` and ``evaluate`` twins on two gloo
ranks on the CPU, spawned as a launcher would spawn them
(``parallel.spawn``: ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``; the rank
function is ``tests/test_torch_port_ranks.py::cli_main``), against the
same twin in one process, from checkpoints that ``import_checkpoint``
made of one reference checkpoint (tests/torch_port_cli_lib.py).
"""

import os

import numpy as np
import pytest

from test_torch_port_cli_eval import soft_predictions
from torch_port_cli_lib import build_port_tree, port_state_dict, write_reference_pt

HERE = os.path.dirname(os.path.abspath(__file__))
LR = 1e-4
SPAWN_S = 180


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from avvad_tpu_torch.scripts import import_checkpoint

    data = build_port_tree(tmp_path_factory, seed=6)
    tmp = tmp_path_factory.mktemp("dp")
    ref = str(tmp / "ref.pt")
    write_reference_pt(ref)
    dirs = {}
    for name, modality in (("one", "audio"), ("meshed", "audio"), ("av", "av")):
        dirs[name] = str(tmp / name)
        import_checkpoint.main(["--modality", modality, "--torch-checkpoint", ref,
                                "--output-dir", dirs[name], "--lstm-hidden", "32",
                                "--device", "cpu"])
    return {"data": data, "tmp": tmp, **dirs}


def _spawn(name, argv):
    from avvad_tpu_torch.parallel import spawn

    return spawn("test_torch_port_ranks:cli_main", 2, args=[name, argv],
                 timeout_s=SPAWN_S, paths=[HERE])


def test_train_data_parallel_matches_one_process(env):
    """One epoch of AudioVAD, 4 utterances in one step: the same logs and
    epoch metrics, written by rank 0 alone; the parameters within 1e-6 on
    99.9 % of each tensor (the gradient summed over the ranks in another
    order) and 4 lr everywhere."""
    from avvad_tpu_torch.scripts import train
    from avvad_tpu_torch.train import latest_checkpoint

    args = ["--modality", "audio", "--data-root", env["data"], "--resume", "--epochs", "1",
            "--batch-size", "4", "--bucket", "128", "--lstm-hidden", "32", "--lr", str(LR),
            "--device", "cpu"]
    one = train.main([*args, "--model-dir", env["one"]])
    ranks = _spawn("train", [*args, "--model-dir", env["meshed"], "--data-parallel", "2"])
    for r in ranks:
        assert r["epoch"] == 1
        for split in ("train", "valid"):
            for k, v in one[split].items():
                np.testing.assert_allclose(r[split][k], v, rtol=1e-5, atol=1e-7)
    for name in ("output_batch.log", "output_epoch.log"):
        def lines(d):
            with open(os.path.join(d, name)) as f:
                return [ln for ln in f.read().splitlines() if not ln.startswith("[Time]")]
        assert lines(env["meshed"]) == lines(env["one"])
    got = port_state_dict(latest_checkpoint(env["meshed"]))
    want = port_state_dict(latest_checkpoint(env["one"]))
    assert set(got) == set(want)
    for n, ref in want.items():
        diff = np.abs(got[n].numpy() - ref.numpy())
        assert diff.max() < 4 * LR, n
        assert np.mean(diff < 1e-6) > 0.999, (n, np.mean(diff < 1e-6))


def test_evaluate_data_parallel_matches_one_process(env):
    """The AV model over the test split: the same prediction files, soft
    predictions within 1e-6 (the MCB's L2 norm summed over the ranks in
    another order)."""
    from avvad_tpu_torch.scripts import evaluate

    tmp = env["tmp"]
    args = ["--modality", "av", "--data-root", env["data"], "--lstm-hidden", "32",
            "--batch-size", "4", "--bucket", "128", "--checkpoint", env["av"],
            "--device", "cpu"]
    one = evaluate.main([*args, "--output-dir", str(tmp / "eval_one")])
    ranks = _spawn("evaluate", [*args, "--output-dir", str(tmp / "eval_meshed"),
                                "--data-parallel", "2"])
    assert [r["n_utterances"] for r in ranks] == [one["n_utterances"]] * 2
    files, want = soft_predictions(str(tmp / "eval_one"))
    got_files, got = soft_predictions(str(tmp / "eval_meshed"))
    assert got_files == files and len(files) == 4
    for f, g, w in zip(files, got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=f)


def test_data_parallel_needs_a_launcher(env, monkeypatch):
    """Without the launcher's variables ``--data-parallel`` stops and says
    how to launch it."""
    from avvad_tpu_torch.scripts import train

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(SystemExit, match="launch with torchrun or parallel.spawn"):
        train.main(["--modality", "audio", "--data-root", env["data"], "--model-dir",
                    str(env["tmp"] / "x"), "--data-parallel", "2", "--device", "cpu"])
