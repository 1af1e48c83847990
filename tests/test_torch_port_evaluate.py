"""CPU parity of the port's evaluation with the JAX package: int8
calibration, ``evaluate_split`` (bucket ladder, length-sorted pools, the
two-deep drain) and the prediction files it writes, ``score_split`` /
``score_video_split`` and the statistics behind them.

The corpus is the tiny raw tree of tests/test_torch_port_data.py (2
speakers x 2 utterances a split, 1-1.6 s), its train and test splits
processed by the port's builders, which that file holds to JAX's. The
model is ``AVVAD`` at 2 x LSTM 32 with a 64-wide MCB, so that the JAX side's
Pallas kernels run cheaply in interpret mode (bench.py:413-414): the LSTM
(K1a, K1c or K1b by ``lstm_state_quant``) and, for the static-int8 tower,
the stem epilogue and BasicBlock kernels. The port runs their plain
versions (CPU tensors never reach a kernel). Weights come from the JAX
init through ``convert.from_flax_variables``; the JAX runs are in module
fixtures.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avvad_tpu import evaluate as jevaluate
from avvad_tpu.data import AudioVisualSource as JAudioVisualSource
from avvad_tpu.data import DataLoader as JDataLoader
from avvad_tpu.data import VideoSequenceSource as JVideoSequenceSource
from avvad_tpu.data.statistics import load_statistics
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu_torch import evaluate
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.data import AudioVisualSource, DataLoader, VideoSequenceSource
from avvad_tpu_torch.models import AVVAD
from avvad_tpu_torch.train import create_train_state
from avvad_tpu_torch.utils import profiling
from test_torch_port_data import build_tree, write_raw_corpus

H, MCB_OUT = 32, 64
# the head's init scaled up and shifted so that the probabilities spread
# over both sides of 0.5 (at init they sit within 0.02 of 0.48)
HEAD_GAIN, HEAD_SHIFT = 40.0, 2.2
EVAL_KW = dict(batch_size=2, bucket=32)  # ladder on: buckets of 64 and 96 frames
QNAMES = ("q_stem", "q1", "q_out")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """-> (processed root, the dataset statistics as the scripts load them)."""
    from avvad_tpu_torch import builders

    raw = write_raw_corpus(str(tmp_path_factory.mktemp("raw")), seed=1)
    root = str(tmp_path_factory.mktemp("proc")) + os.sep
    build_tree(builders, raw, root, splits=("train", "test"))
    stats = {}
    stats["audio_mean"], stats["audio_std"] = load_statistics(
        root + "ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.h5")
    stats["video_mean"], stats["video_std"] = load_statistics(
        root + "ntcd_timit/matlab_raw/ntcd_timit_upsampled_statistics.h5")
    return root, stats


def _models(state_quant="none", **kw):
    """The JAX AVVAD, its train state and the port's AVVAD on the same
    variables (the LSTM on its kernel on both sides)."""
    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                use_pallas_lstm=True, lstm_state_quant=state_quant, **kw)
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(3),
                                 (jnp.zeros((1, 4, 513)), jnp.zeros((1, 4, 67, 67))))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    head = params["vad_merged"]
    params = {**params, "vad_merged": {"kernel": head["kernel"] * HEAD_GAIN,
                                       "bias": head["bias"] + HEAD_SHIFT}}
    jstate = jstate.replace(params=params)
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                  use_kernel_lstm=True, lstm_state_quant=state_quant, **kw)
    model.load_state_dict(from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jstate.variables())), strict=True)
    return jm, jstate, model


def _evaluate_both(tree, tmp, jstate, model, tag):
    root, stats = tree
    out = {"jdir": str(tmp / f"jax_{tag}") + os.sep, "dir": str(tmp / f"port_{tag}") + os.sep}
    out["jreport"] = jevaluate.evaluate_split(jstate, JAudioVisualSource(root, "test"), "av",
                                              out["jdir"], norm_stats=stats, verbose=False,
                                              **EVAL_KW)
    state = create_train_state(model, device="cpu")
    before = profiling.launches()
    out["report"] = evaluate.evaluate_split(state, AudioVisualSource(root, "test"), "av",
                                            out["dir"], norm_stats=stats, verbose=False,
                                            **EVAL_KW)
    # CPU tensors launch nothing
    assert before == profiling.launches()
    return out


@pytest.fixture(scope="module", params=["none", "bf16", "int8"])
def float_run(request, tree, tmp_path_factory):
    """evaluate_split of the float-tower AVVAD over the test split on both
    sides, for each LSTM state_quant."""
    _, jstate, model = _models(request.param)
    return {"state_quant": request.param,
            **_evaluate_both(tree, tmp_path_factory.mktemp("float"), jstate, model,
                             request.param)}


@pytest.fixture(scope="module")
def int8_run(tree, tmp_path_factory):
    """The static-int8 fused tower: calibrate_quant_scales on 2 train
    utterances on each side from the same init, then evaluate_split."""
    root, stats = tree
    kw = dict(tower_int8=True, tower_quant_mode="static", tower_pallas=True)
    jm, jstate, model = _models(**kw)
    cal = dict(norm_stats=stats, n_utts=2, batch_size=2, bucket=32)
    jstate = jevaluate.calibrate_quant_scales(jstate, jm, JAudioVisualSource(root, "train"),
                                              "av", **cal)
    state = create_train_state(model, device="cpu")
    assert evaluate.calibrate_quant_scales(state, model, AudioVisualSource(root, "train"),
                                           "av", **cal) is state
    return {"jquant": from_flax_variables({"quant": jax.tree_util.tree_map(
                np.asarray, jstate.quant)}),
            "model": model,
            **_evaluate_both(tree, tmp_path_factory.mktemp("int8"), jstate, model, "int8")}


def _predictions(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs if f.endswith(".npy"))


def test_evaluate_split_writes_the_same_files(float_run):
    """The same .npy files (hard and soft for each of the 4 utterances, the
    reference's names and (T,) layout) and the same report counts.
    Reading: the same 8 files and counts for each state_quant."""
    files = _predictions(float_run["jdir"])
    assert files == _predictions(float_run["dir"]) and len(files) == 8
    for f in files:
        got, ref = np.load(float_run["dir"] + f), np.load(float_run["jdir"] + f)
        assert got.shape == ref.shape and got.ndim == 1
        assert got.dtype == ref.dtype, f
    for k in ("n_utterances", "n_frames", "audio_seconds"):
        assert float_run["report"][k] == float_run["jreport"][k]
    assert float_run["report"]["n_utterances"] == 4
    assert float_run["report"]["rt_factor"] > 0


def test_evaluate_split_probabilities_match_jax(float_run):
    """fp32 soft predictions within 1e-4 (the bar of the serving step,
    tests/test_torch_port_models.py), hard ones equal but where the soft
    value lies within 1e-4 of 0.5. Readings (probabilities 0.26-0.73):
    3.6e-7 (none), 6.4e-5 (bf16: an h whose fp32 noise crosses a bf16
    rounding boundary moves one gate term), 3.9e-7 (int8); no soft value
    within 0.042 of 0.5, so every hard one is equal."""
    for f in _predictions(float_run["jdir"]):
        got, ref = np.load(float_run["dir"] + f), np.load(float_run["jdir"] + f)
        if f.endswith("_soft.npy"):
            np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f)
            assert ref.min() < 0.5 < ref.max()
        else:
            soft = np.load(float_run["jdir"] + f.replace("_hard", "_soft"))
            near = np.abs(soft - 0.5) < 1e-4
            np.testing.assert_array_equal(got[~near], ref[~near], err_msg=f)


def test_calibrate_quant_scales_matches_jax(int8_run):
    """The 17 scales of the port's calibrate_quant_scales against JAX's
    quant collection, from the same init on the same 2 utterances. JAX's
    own noise against the port (tests/test_torch_port_int8.py): an XLA
    rsqrt one ulp off torch's flips a value on a rounding tie, and the
    flip moves the later blocks' maxima. Held: all at 1e-3 relative, at
    least 15 of 17 at 1e-5. Readings: all 17 within 4.6e-7."""
    sd = int8_run["model"].state_dict()
    assert len(int8_run["jquant"]) == 17
    rel = {}
    for key, want in int8_run["jquant"].items():
        assert key.split(".")[-1] in QNAMES and want.item() > 0
        rel[key] = abs(sd[key].item() / want.item() - 1.0)
    assert max(rel.values()) < 1e-3, rel
    assert sum(r < 1e-5 for r in rel.values()) >= 15, rel


def test_static_int8_evaluation_matches_jax(int8_run):
    """evaluate_split with the calibrated static-int8 tower: the soft
    predictions over all utterances at JAX's int8 bar
    (tests/test_torch_port_int8.py), rel < 0.02 and corr > 0.999. Readings:
    rel 9.4e-5, corr 0.9999999 (max |diff| 1.3e-4)."""
    files = [f for f in _predictions(int8_run["jdir"]) if f.endswith("_soft.npy")]
    assert files == [f for f in _predictions(int8_run["dir"]) if f.endswith("_soft.npy")]
    got = np.concatenate([np.load(int8_run["dir"] + f) for f in files]).astype(np.float64)
    ref = np.concatenate([np.load(int8_run["jdir"] + f) for f in files]).astype(np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    corr = np.corrcoef(got, ref)[0, 1]
    assert rel < 0.02 and corr > 0.999, (rel, corr)
    assert int8_run["report"]["n_utterances"] == 4


def _close(got, ref, rtol=1e-6):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _close(got[k], ref[k], rtol)
    elif isinstance(ref, (float, np.floating)) and np.isnan(ref):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol)


@pytest.mark.parametrize("max_workers", [0, 2])
def test_score_split_matches_jax(int8_run, tree, tmp_path, max_workers):
    """score_split of both packages on the same prediction files (the JAX
    static-int8 run's): the per-utterance metrics and stats.json within
    1e-6 relative. Readings: equal."""
    root = tree[0]
    dirs = {side: str(tmp_path / side) + os.sep for side in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(int8_run["jdir"], d)
    src, jsrc = AudioVisualSource(root, "test"), JAudioVisualSource(root, "test")
    ref = jevaluate.score_split(jsrc, root, dirs["jax"], verbose=False,
                                max_workers=max_workers)
    got = evaluate.score_split(src, root, dirs["port"], verbose=False,
                               max_workers=max_workers)
    _close(got, ref)
    assert set(got) == {"overall", "by_snr_db", "by_noise_type", "by_speaker"}
    assert 0 < got["overall"]["f1"]["avg"] <= 1
    import json
    with open(dirs["port"] + "stats.json") as f, open(dirs["jax"] + "stats.json") as g:
        _close(json.load(f), json.load(g))
    for i in range(len(src)):
        args = (root, dirs["jax"], src.rel_path(i), src.label_rel_path(i))
        m, jm = evaluate.compute_metrics_utt(*args), jevaluate.compute_metrics_utt(*args)
        np.testing.assert_array_equal(m.pop("y_hat_soft"), jm.pop("y_hat_soft"))
        _close({k: v for k, v in m.items() if not isinstance(v, str)},
               {k: v for k, v in jm.items() if not isinstance(v, str)})
        assert {k: v for k, v in m.items() if isinstance(v, str)} == \
            {k: v for k, v in jm.items() if isinstance(v, str)}


def test_score_video_split_matches_jax(tree, tmp_path):
    """score_video_split of both packages on the same seeded soft
    predictions, keyed by the video source's paths (feature-major (1, T)
    on disk, as the video pipeline writes them): speaker-grouped stats
    within 1e-6 relative. Readings: equal."""
    root = tree[0]
    src, jsrc = VideoSequenceSource(root, "test"), JVideoSequenceSource(root, "test")
    d = str(tmp_path / "video") + os.sep
    rng = np.random.default_rng(8)
    for i in range(len(src)):
        t = src.probe_length(i)
        evaluate.write_predictions(d, src.rel_path(i), rng.random((1, t)).astype(np.float32))
    ref = jevaluate.score_video_split(jsrc, root, d, verbose=False, save_stats=False)
    got = evaluate.score_video_split(src, root, d, verbose=False, save_stats=False)
    _close(got, ref)
    assert set(got) == {"overall", "by_speaker"} and len(got["by_speaker"]) == 2


def test_planned_bucket_shapes_match_jax(tree):
    """The padded lengths evaluate_split's loader plans: the ladder's. Reading: equal."""
    root = tree[0]
    kw = dict(batch_size=2, shuffle=False, bucket=32, bucket_ladder=True,
              pad_batch_to_full=True, sort_pool_factor=4)
    got = evaluate.planned_bucket_shapes(DataLoader(AudioVisualSource(root, "test"), **kw))
    ref = jevaluate.planned_bucket_shapes(JDataLoader(JAudioVisualSource(root, "test"), **kw))
    assert got == ref and len(got) >= 1


@pytest.mark.parametrize("shape", [(7,), (3, 7)])
def test_write_predictions_matches_jax(tmp_path, shape):
    """prediction_paths and the .npy files write_predictions writes, (T,) and (y, T).
    Reading: equal paths, byte-equal files."""
    soft = np.random.default_rng(2).random(shape).astype(np.float32)
    rel = "ntcd_timit/Noisy/Babble/-5/test/34M/sa1.wav"
    paths = [evaluate.prediction_paths(str(tmp_path / "t") + os.sep, rel),
             jevaluate.prediction_paths(str(tmp_path / "j") + os.sep, rel)]
    assert [os.path.relpath(p, str(tmp_path / "t")) for p in paths[0]] == \
        [os.path.relpath(p, str(tmp_path / "j")) for p in paths[1]]
    evaluate.write_predictions(str(tmp_path / "t") + os.sep, rel, soft)
    jevaluate.write_predictions(str(tmp_path / "j") + os.sep, rel, soft)
    for a, b in zip(*paths):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


# --- statistics ---------------------------------------------------------------


def test_roc_auc_matches_jax():
    """Ties averaged, one-class input NaN, as in JAX. Reading: equal."""
    rng = np.random.default_rng(6)
    y = (rng.random(500) > 0.4).astype(np.float32)
    s = np.round(rng.random(500) * 0.5 + 0.4 * y, 2)  # many ties
    assert evaluate.roc_auc(y, s) == jevaluate.roc_auc(y, s)
    assert 0.5 < evaluate.roc_auc(y, s) < 1
    assert np.isnan(evaluate.roc_auc(np.ones(4), s[:4]))


def test_confidence_interval_and_energy_ratios_match_jax():
    """mean_confidence_interval, si_sdr_components and energy_ratios on seeded signals.
    Reading: equal."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=30)
    assert evaluate.mean_confidence_interval(data) == jevaluate.mean_confidence_interval(data)
    s, n = rng.normal(size=400), rng.normal(size=400)
    s_hat = 0.8 * s + 0.1 * n + 0.01 * rng.normal(size=400)
    np.testing.assert_array_equal(evaluate.energy_ratios(s_hat, s, n),
                                  jevaluate.energy_ratios(s_hat, s, n))
    for g, r in zip(evaluate.si_sdr_components(s_hat, s, n),
                    jevaluate.si_sdr_components(s_hat, s, n)):
        np.testing.assert_array_equal(g, r)


def test_compute_stats_matches_jax(tmp_path, capsys):
    """Grouped aggregation and its printed tables and stats.json.
    Reading: equal tables, dicts and files."""
    rng = np.random.default_rng(9)
    rows = rng.random((12, 3)).tolist()
    groups = dict(all_snr_db=np.repeat([-5.0, 0.0, 5.0], 4),
                  all_noise_types=["Babble", "Cafe"] * 6,
                  all_speakers=[f"{i % 3:02d}M" for i in range(12)])
    ref = jevaluate.compute_stats(("a", "b", "c"), rows, str(tmp_path / "j"), **groups)
    jtext = capsys.readouterr().out
    got = evaluate.compute_stats(("a", "b", "c"), rows, str(tmp_path / "t"), **groups)
    assert capsys.readouterr().out == jtext and "Input SNR = -5.0" in jtext
    assert got == ref
    assert (tmp_path / "t/stats.json").read_text() == (tmp_path / "j/stats.json").read_text()
