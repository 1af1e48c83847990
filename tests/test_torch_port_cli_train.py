"""``train --resume`` through both command lines: one reference checkpoint
(H=32, MCB 1024) imported by both ``import_checkpoint`` scripts, then one
epoch on the same processed tree (bucket 128, Adam 1e-4, the scripts'
default), JAX's script with ``--pallas-lstm`` (the Pallas LSTM, in
interpret mode here: the arithmetic of the port's kernels, W_hh rounded
to bf16) against the port's twin on the CPU. The logs agree line for line
and the parameters within the bars of
tests/test_torch_port_data.py::test_trainer_fit_on_corpus_params_match_jax.

AudioVAD takes two steps (batch 2). AVVAD, its ResNet-18 trunk trained,
takes one (batch 4): with train-mode BatchNorm the fp32 gradient of some
trunk entries is resolved by neither framework
(tests/test_torch_port_train_video.py, TRUNK_L2_TOL: JAX's reads up to
1.3e-2 off float64 in L2), so those entries move by lr in either
direction, and from the second step on the models have moved apart (that
file holds the later steps' losses at 2e-2). The trunk is held at 4 lr
an entry, by the share of each tensor within 1e-6 of JAX's (TRUNK_SHARE)
and by the L2 of the port's move against JAX's (TRUNK_L2): a frozen trunk
reads share 0 and L2 1, a trunk stepped by gradients of random sign share
about 0.5 and L2 about 1.4.
"""

import os

import numpy as np
import pytest

from torch_port_cli_lib import (build_port_tree, import_both, jax_state_dict,
                                port_state_dict, run_jax_script, write_reference_pt)

LR = 1e-4
# the 4 train utterances in two steps (AudioVAD) or one (AVVAD)
BATCH = {"audio": 2, "av": 4}
# the share of each tensor within 1e-6 of JAX's (the trunk's aside)
SHARE = {"audio": 0.999, "av": 0.995}
# each trunk tensor of the AV run: the share of its entries within 1e-6 of
# JAX's (readings 0.859-0.984), and |port's move - JAX's move| / |JAX's
# move| in L2 (readings 0.00024-0.75)
TRUNK_SHARE, TRUNK_L2 = 0.8, 0.85


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return build_port_tree(tmp_path_factory)


@pytest.fixture(scope="module", params=["audio", "av"])
def runs(request, data, tmp_path_factory):
    from avvad_tpu.train.checkpoint import latest_checkpoint as jlatest
    from avvad_tpu_torch.scripts import train
    from avvad_tpu_torch.train import latest_checkpoint

    modality = request.param
    tmp = tmp_path_factory.mktemp(f"train_{modality}")
    ref = str(tmp / "ref.pt")
    write_reference_pt(ref)
    args = ["--modality", modality, "--data-root", data, "--resume", "--epochs", "1",
            "--batch-size", str(BATCH[modality]), "--bucket", "128", "--lstm-hidden", "32",
            "--lr", str(LR)]
    with pytest.MonkeyPatch.context() as mp:
        jdir, tdir = import_both(mp, tmp, ref, modality)
        init = port_state_dict(tdir)
        # the Pallas LSTM (interpret mode here): the port's kernels' arithmetic
        run_jax_script(mp, "train", [*args, "--model-dir", jdir, "--pallas-lstm"])
    result = train.main([*args, "--model-dir", tdir, "--device", "cpu"])
    return {"modality": modality, "jdir": jdir, "tdir": tdir, "init": init,
            "result": result, "jfinal": jax_state_dict(jlatest(jdir), modality),
            "final": port_state_dict(latest_checkpoint(tdir))}


def test_train_resume_logs_as_jax(runs):
    """output_batch.log and output_epoch.log equal line for line (but the
    [Time] lines), epoch 1 after the imported epoch 0; the same
    checkpoints."""
    def lines(d, name):
        with open(os.path.join(d, name)) as f:
            return [ln for ln in f.read().splitlines() if not ln.startswith("[Time]")]

    assert len(lines(runs["tdir"], "output_batch.log")) == 4 // BATCH[runs["modality"]]
    assert lines(runs["tdir"], "output_epoch.log")[0] == "Epoch: 1"
    for name in ("output_batch.log", "output_epoch.log"):
        assert lines(runs["tdir"], name) == lines(runs["jdir"], name)
    assert sorted(p for p in os.listdir(runs["tdir"]) if p.startswith("epoch_")) == \
        sorted(p for p in os.listdir(runs["jdir"]) if p.startswith("epoch_"))
    assert runs["result"]["epoch"] == 1


def test_train_resume_params_match_jax(runs):
    """Parameters after the epoch against JAX's. Every entry within 4 lr:
    an entry whose fp32 gradient is near 0 with another sign in the two
    frameworks moves 2 lr apart (test_trainer_fit_on_corpus_params_match_jax's
    reason). AudioVAD: 99.9 % of each tensor within 1e-6, that test's bar
    (reading: every entry within 3.5e-7). AVVAD: 99.5 % of each tensor but
    the trunk's, whose features carry the trunk's fp32 noise into the LSTM
    (readings: 99.85 % for the second layer's W_hh, 6 of its 4,096 entries
    2 lr apart; 99.98 % or more elsewhere). BatchNorm statistics within
    1e-3 relative (the trunk's train-mode batch statistics in fp32); the
    sketches unchanged; each trained tensor moved, in both. Each trunk
    tensor at TRUNK_SHARE and TRUNK_L2."""
    got, want, init = runs["final"], runs["jfinal"], runs["init"]
    assert set(got) == set(want)
    trained = trunk = 0
    for n, ref in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        g, r = got[n].numpy(), ref.numpy()
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=n)
            continue
        if n.startswith("mcb.sketch"):
            assert np.array_equal(g, r) and np.array_equal(g, init[n].numpy()), n
            continue
        diff = np.abs(g - r)
        assert diff.max() < 4 * LR, (n, diff.max())
        share = np.mean(diff < 1e-6)
        if n.startswith("tower."):
            moved, jmoved = g - init[n].numpy(), r - init[n].numpy()
            l2 = np.linalg.norm(moved - jmoved) / np.linalg.norm(jmoved)
            assert share > TRUNK_SHARE and l2 < TRUNK_L2, (n, share, l2)
            trunk += 1
        else:
            assert share > SHARE[runs["modality"]], (n, share)
        for t in (g, r):  # each side trained it
            assert np.abs(t - init[n].numpy()).max() > 0.5 * LR, n
        trained += 1
    assert trained >= (4 if runs["modality"] == "audio" else 60)
    assert trunk == (0 if runs["modality"] == "audio" else 60)

