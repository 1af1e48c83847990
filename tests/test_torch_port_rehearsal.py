"""The complete-corpus rehearsal and the two synthesizers, the port's
twins against the JAX scripts on the CPU.

The rehearsal runs at 2 / 1 / 1 speakers x 2 utterances (8 utterances, the
whole 6-noise x 3-SNR grid: 72 / 36 / 36 noisy items a split) with
reference_av.yaml cut to H=32, and both AVVAD classes cut to an MCB of 64
for the module (the JAX scripts have no flag for its width). JAX runs
``scripts/rehearse_complete.sh``'s six steps in process, its LSTM as
``--pallas-lstm`` (interpret mode: the arithmetic of the port's kernels,
W_hh rounded to bf16); the port runs ``rehearse_complete.main`` with
``--device cpu``, its train twin starting from JAX's initial weights
(``create_train_state`` at ``PRNGKey(0)``, through the converter), since
the two frameworks draw other initial weights from one seed.
"""

import contextlib
import io
import json
import os
import shutil

import h5py
import numpy as np
import pytest

from torch_port_cli_lib import ROOT, run_jax_script

H, MCB_OUT = 32, 64
SPEAKERS = {"train": 2, "dev": 1, "test": 1}
UTTS = 2
CONDITIONS = 18
# 0.3-0.5 s utterances (19-31 frames) in buckets of 32 frames; the whole
# train split (72 items) in one batch, so that each epoch is one step
# (from the second step on, the AV models move apart: the trunk's fp32
# gradient noise under Adam, tests/test_torch_port_cli_train.py)
DUR = ("0.3", "0.5")
BUCKET, BATCH = 32, 72
# losses (a sum of per-frame BCE over a batch, then a mean over batches:
# about 10), every figure of stats.json (rounded to 3 decimals by
# compute_stats) and every soft prediction, port against JAX (readings:
# audio 6.0e-8, AV 2.9e-6 in the predictions, no hard decision flipped)
LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
PRED_ATOL = 1e-5


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _files_matching(root, suffix):
    return [os.path.join(root, f) for f in _files(root) if f.endswith(suffix)]


def _tiny_config(path: str) -> str:
    with open(os.path.join(ROOT, "configs", "reference_av.yaml")) as f:
        text = f.read()
    for a, b in (("lstm_hidden_size: 1024", f"lstm_hidden_size: {H}"),
                 ("mcb_output_size: 1024", f"mcb_output_size: {MCB_OUT}"),
                 ("batch_size: 16", f"batch_size: {BATCH}"), ("bucket_t: 128",
                                                              f"bucket_t: {BUCKET}")):
        assert a in text
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)
    return path


def _narrow_mcb(mp):
    """Both packages' AVVAD with an MCB of MCB_OUT unless told otherwise."""
    import avvad_tpu.models as jmodels
    import avvad_tpu_torch.models as tmodels

    class JaxAVVAD(jmodels.AVVAD):
        mcb_output_size: int = MCB_OUT

    class PortAVVAD(tmodels.AVVAD):
        def __init__(self, *args, mcb_output_size: int = MCB_OUT, **kw):
            super().__init__(*args, mcb_output_size=mcb_output_size, **kw)

    mp.setattr(jmodels, "AVVAD", JaxAVVAD)
    mp.setattr(tmodels, "AVVAD", PortAVVAD)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    import avvad_tpu.train as jtrain
    from avvad_tpu_torch.convert import from_flax_variables
    from avvad_tpu_torch.scripts import rehearse_complete, synth_complete_corpus
    from avvad_tpu_torch.scripts import train as ttrain

    tmp = tmp_path_factory.mktemp("rehearsal")
    cfg = _tiny_config(str(tmp / "tiny.yaml"))
    jroot, troot = str(tmp / "jax"), str(tmp / "port")
    jraw, jproc, jdata = (os.path.join(jroot, "data", d) for d in ("raw", "processed", ""))
    init, fits = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _narrow_mcb(mp)
        real_create, real_fit = jtrain.create_train_state, jtrain.Trainer.fit

        def create_and_keep(*args, **kw):
            # a copy: the train step donates the state's buffers
            state = real_create(*args, **kw)
            init["last"] = jax.tree_util.tree_map(np.array, state.variables())
            return state

        mp.setattr(jtrain, "create_train_state", create_and_keep)
        mp.setattr(jtrain.Trainer, "fit", lambda self, *a, **k: fits.setdefault(
            self.modality, real_fit(self, *a, **k)))

        # scripts/rehearse_complete.sh's six steps
        synth_args = ["--train-speakers", SPEAKERS["train"], "--dev-speakers",
                      SPEAKERS["dev"], "--test-speakers", SPEAKERS["test"], "--utts",
                      UTTS, "--min-dur", DUR[0], "--max-dur", DUR[1]]
        run_jax_script(mp, "synth_complete_corpus", ["--out", jraw, *synth_args])
        run_jax_script(mp, "create_train_files", [
            "--raw-dir", jraw, "--processed-dir", jproc, "--dataset-size", "complete",
            "--splits", "train", "validation", "test", "--workers", "0"])
        os.makedirs(os.path.join(jdata, "complete"))
        os.symlink(os.path.join("..", "processed"), os.path.join(jdata, "complete",
                                                                 "processed"))
        for modality in ("audio", "av"):
            init.pop("last", None)
            run_jax_script(mp, "train", [
                "--config", cfg, "--modality", modality, "--data-root", jdata,
                "--dataset-size", "complete", "--epochs", "1", "--model-dir",
                os.path.join(jroot, modality), "--pallas-lstm"])
            init[modality] = from_flax_variables(init.pop("last"))
        for modality in ("audio", "av"):
            preds = os.path.join(jroot, f"{modality}_preds")
            run_jax_script(mp, "evaluate", [
                "--modality", modality, "--data-root", jdata, "--dataset-size",
                "complete", "--split", "test", "--checkpoint",
                os.path.join(jroot, modality), "--output-dir", preds,
                "--lstm-hidden", H, "--pallas-lstm"])
            with contextlib.redirect_stdout(io.StringIO()):
                run_jax_script(mp, "run_metrics", [
                    "--data-root", jdata, "--dataset-size", "complete", "--split",
                    "test", "--predictions-dir", preds])

        # the port's twin, from JAX's initial weights
        real_build = ttrain.build_model

        def build_from_jax(modality, *args, **kw):
            model = real_build(modality, *args, **kw)
            model.load_state_dict(init[modality])
            return model

        mp.setattr(ttrain, "build_model", build_from_jax)
        # the short utterances: the raw tree first, which the rehearsal keeps
        synth_complete_corpus.main(["--out", os.path.join(troot, "data", "raw"),
                                    *map(str, synth_args)])
        port = rehearse_complete.main([
            "--dir", troot, "--config", cfg, "--train-speakers", str(SPEAKERS["train"]),
            "--dev-speakers", str(SPEAKERS["dev"]), "--test-speakers",
            str(SPEAKERS["test"]), "--utts", str(UTTS), "--device", "cpu"])
    return {"jax": jroot, "port": troot, "port_results": port, "jax_fits": fits}


def test_raw_trees_equal(runs):
    """synth_complete_corpus at the same seed: every wav byte-equal, every
    ``.mat`` the same array through h5py and the port's ``hdf5``."""
    from avvad_tpu_torch import hdf5

    jraw, traw = (os.path.join(runs[k], "data", "raw") for k in ("jax", "port"))
    files = _files(jraw)
    n_utts = UTTS * sum(SPEAKERS.values())
    assert files == _files(traw) and len(files) == n_utts * (2 + CONDITIONS)
    assert runs["port_results"]["synthesize"]["raw_files"] == len(files)
    for rel in files:
        a, b = os.path.join(jraw, rel), os.path.join(traw, rel)
        if rel.endswith(".mat"):
            with h5py.File(a) as fa, h5py.File(b) as fb, hdf5.File(b) as fp:
                assert list(fb) == list(fa) == ["data"]
                want = fa["data"][()]
                np.testing.assert_array_equal(fb["data"][()], want)
                np.testing.assert_array_equal(fp["data"][()], want)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_rehearsal_synthesizes_from_its_flags(tmp_path):
    """The rehearsal's first step writes synth_complete_corpus's tree for
    its speaker and utterance counts (the synthesizer's default lengths),
    byte for byte, and keeps a tree that is there, as the shell script
    does."""
    from avvad_tpu_torch.scripts import rehearse_complete, synth_complete_corpus

    counts = ["--train-speakers", "1", "--dev-speakers", "1", "--test-speakers", "1",
              "--utts", "1"]
    want = str(tmp_path / "want")
    synth_complete_corpus.main(["--out", want, *counts])
    args = rehearse_complete.build_parser().parse_args(
        ["--dir", str(tmp_path / "r"), *counts, "--device", "cpu"])
    key, _, synthesize = rehearse_complete.stages(args)[0]
    raw = str(tmp_path / "r" / "data" / "raw")
    out = synthesize()
    files = _files(want)
    assert key == "synthesize" and _files(raw) == files
    assert out["raw_files"] == len(files) == 3 * (2 + CONDITIONS)
    for rel in files:
        assert (open(os.path.join(want, rel), "rb").read()
                == open(os.path.join(raw, rel), "rb").read()), rel
    kept = os.path.join(raw, files[0])
    open(kept, "wb").write(b"kept")
    assert synthesize() == {"raw_files": len(files), "synth": None}
    assert open(kept, "rb").read() == b"kept"


def test_processed_trees_equal(runs):
    """create_train_files at --dataset-size complete: the same files, all
    18 conditions in each split, every HDF5 dataset equal, every wav
    byte-equal."""
    jproc, tproc = (os.path.join(runs[k], "data", "processed") for k in ("jax", "port"))
    files = _files(jproc)
    assert files == _files(tproc)
    for split in ("train", "dev", "test"):
        conds = {tuple(f.split(os.sep)[2:4]) for f in files
                 if f.startswith(os.path.join("ntcd_timit", "Noisy", ""))
                 and f.split(os.sep)[4:5] == [split]}
        assert len(conds) == CONDITIONS, (split, conds)
    for rel in files:
        a, b = os.path.join(jproc, rel), os.path.join(tproc, rel)
        if rel.endswith(".h5"):
            with h5py.File(a) as fa, h5py.File(b) as fb:
                assert list(fa) == list(fb)
                for k in fa:
                    assert fa[k].dtype == fb[k].dtype
                    np.testing.assert_array_equal(fa[k][:], fb[k][:], err_msg=rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel
    built = runs["port_results"]["build"]["counts"]
    assert built["test/audio"] == UTTS * SPEAKERS["test"] * (1 + CONDITIONS)


@pytest.mark.parametrize("modality", ["audio", "av"])
def test_epoch_losses_match_jax(runs, modality):
    """The train and validation losses of the one epoch, each side from
    the same initial weights, within LOSS_RTOL."""
    got = runs["port_results"][f"train_{modality}"]
    want = runs["jax_fits"][modality]
    assert got["epoch"] == want["epoch"] == 1
    for split in ("train", "valid"):
        np.testing.assert_allclose(float(got[split]["loss"]), float(want[split]["loss"]),
                                   rtol=LOSS_RTOL, err_msg=split)


def _leaves(d, path=()):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, d


def _stats(preds_dir):
    with open(os.path.join(preds_dir, "stats.json")) as f:
        return dict(_leaves(json.load(f)))


@pytest.mark.parametrize("modality", ["audio", "av"])
def test_grouped_stats_match_jax(runs, modality, tmp_path):
    """evaluate + run_metrics over the complete test grid. Every soft
    prediction within PRED_ATOL of JAX's, no hard decision flipped;
    stats.json with the same groups (3 SNRs, 6 noises, the test speakers),
    each figure within STATS_ATOL of JAX's, but the AV model's AUC figures:
    AUC is a rank statistic, and after one step the AV model's scores are
    near-tied (a std of 1.2e-3 an utterance), so the trunk's fp32 noise
    (2.9e-6) reorders frames (readings: one utterance's AUC 1.2e-2 apart, a
    group's mean 3e-3). Those are held through the scorer instead: the
    port's run_metrics over JAX's predictions writes JAX's stats.json,
    every figure within STATS_ATOL. The metrics file's head as the shell
    script prints it."""
    from avvad_tpu_torch.scripts import run_metrics

    preds = {k: os.path.join(runs[k], f"{modality}_preds") for k in ("jax", "port")}
    soft = [os.path.relpath(p, preds["jax"]) for p in _files_matching(preds["jax"], "_soft.npy")]
    assert len(soft) == UTTS * SPEAKERS["test"] * CONDITIONS
    assert _files(preds["jax"]) == _files(preds["port"])
    for rel in soft:
        a, b = (np.load(os.path.join(preds[k], rel)) for k in ("jax", "port"))
        np.testing.assert_allclose(b, a, atol=PRED_ATOL, rtol=0, err_msg=rel)
        assert np.array_equal(a > 0.5, b > 0.5), rel
    want, got = _stats(preds["jax"]), _stats(preds["port"])
    assert got.keys() == want.keys()
    assert {k[1] for k in got if k[0] == "by_snr_db"} == {"-5.0", "0.0", "5.0"}
    assert len({k[1] for k in got if k[0] == "by_noise_type"}) == 6
    for key, w in want.items():
        if not (modality == "av" and "auc" in key):
            np.testing.assert_allclose(got[key], w, atol=STATS_ATOL, rtol=0, err_msg=str(key))
    rescored = str(tmp_path / "jax_preds")
    shutil.copytree(preds["jax"], rescored)
    os.remove(os.path.join(rescored, "stats.json"))
    with contextlib.redirect_stdout(io.StringIO()):
        run_metrics.main(["--data-root", os.path.join(runs["port"], "data"),
                          "--dataset-size", "complete", "--predictions-dir", rescored,
                          "--device", "cpu"])
    for key, w in want.items():
        np.testing.assert_allclose(_stats(rescored)[key], w, atol=STATS_ATOL, rtol=0,
                                   err_msg=str(key))
    report = runs["port_results"][modality]["evaluate"]
    assert report["n_utterances"] == len(soft)
    head = open(os.path.join(runs["port"], f"{modality}_metrics.txt")).read()
    assert head.startswith(f"test utterances: {len(soft)}\nMETRIC")


def test_synth_noisy_testset_matches_jax(runs, tmp_path, monkeypatch):
    """synth_noisy_testset over the rehearsal's clean test and validation
    wavs: the same 18 conditions' wavs, byte-equal; a condition already
    there is kept."""
    from avvad_tpu_torch.scripts import synth_noisy_testset

    clean = os.path.join(runs["port"], "data", "processed", "ntcd_timit", "Clean")
    roots = {}
    for k in ("jax", "port"):
        roots[k] = str(tmp_path / k)
        shutil.copytree(clean, os.path.join(roots[k], "subset", "processed",
                                            "ntcd_timit", "Clean"))
        kept = os.path.join(roots[k], "subset", "processed", "ntcd_timit", "Noisy",
                            "White", "5", "test", "04F", "s00.wav")
        os.makedirs(os.path.dirname(kept))
        open(kept, "wb").write(b"kept")
    args = ["--splits", "test", "validation", "--seed", "5"]
    run_jax_script(monkeypatch, "synth_noisy_testset", [*args, "--data-root", roots["jax"]])
    n = synth_noisy_testset.main([*args, "--data-root", roots["port"]])
    n_clean = UTTS * (SPEAKERS["test"] + SPEAKERS["dev"])
    assert n == n_clean * CONDITIONS - 1
    files = _files(roots["jax"])
    assert files == _files(roots["port"])
    for rel in files:
        assert (open(os.path.join(roots["jax"], rel), "rb").read()
                == open(os.path.join(roots["port"], rel), "rb").read()), rel
    assert open(os.path.join(roots["port"], "subset", "processed", "ntcd_timit", "Noisy",
                             "White", "5", "test", "04F", "s00.wav"), "rb").read() == b"kept"
