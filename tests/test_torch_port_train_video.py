"""CPU parity of the port's trunk-training path with the JAX package: the
"video" train step (``VideoVAD``, its ResNet-18 trained from scratch) and
the "av" step with the trunk unfrozen, ``remat`` and ``gray_stem=False``.

As in ``tests/test_torch_port_train.py``: the JAX side runs its Pallas LSTM
kernels in interpret mode, the port its kernels' plain versions and
``LSTMRecurrence``; weights come from the JAX modules' init through
``convert.from_flax_variables``, inputs from numpy. Both models carry the
full ResNet-18 at 67x67 (B=2, T=8: 16 frames through the trunk, train-mode
BatchNorm on every layer), so each JAX step compiles once, in a
module-scoped fixture. The AV run is JAX's ``remat=True`` against the
port's ``remat=True``, and the port's step without ``remat`` is held to
both: flax's ``nn.remat`` keeps the primal pass's BatchNorm update only,
while ``torch.utils.checkpoint`` reruns the forward, and a second update of
the running statistics would show here. The trunk's fp32 gradients are held
by their L2 norm and against a float64 evaluation (TRUNK_L2_TOL); later
steps at bars that allow for the trajectories moving apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.models import losses as jlosses
from avvad_tpu.models.vad_nets import _VideoTower as JVideoTower
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu.train import make_eval_step as jmake_eval_step
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu.train.steps import _forward_inputs as jforward_inputs
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.data import Batch, pad_batch
from avvad_tpu_torch.models import AVVAD, VideoVAD
from avvad_tpu_torch.models.resnet import running_stats_frozen
from avvad_tpu_torch.models.vad_nets import _VideoTower
from avvad_tpu_torch.ops import lstm_fused
from avvad_tpu_torch.train import checkpoint as ckpt
from avvad_tpu_torch.train import (Trainer, create_train_state, make_eval_step,
                                   make_predict_step, make_train_step)
from avvad_tpu_torch.train.steps import MODALITIES

LR = 1e-4
N_STEPS = 3
H, MCB_OUT = 32, 64
B, T = 2, 8
LENGTHS = np.array([8, 5], np.int32)
# lip frames are pixel values in [0, 255], normalised by the dataset's
# statistics. (White-noise frames at 16 frames a batch leave a channel of
# layer3_0 nearly constant: its train-mode BatchNorm then makes the trunk's
# fp32 gradients 1e-2 off their fp64 values on either framework.)
VIDEO_STATS = {"video_mean": np.float32(120.0), "video_std": np.float32(60.0)}
# remat against no remat within the port: the same operations recomputed
REMAT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _batch_arrays(seed, audio):
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)
    label = (rng.random((B, T, 1)) > 0.5).astype(np.float32) * mask[..., None]
    return dict(audio=rng.normal(size=(B, T, 513)).astype(np.float32) if audio else None,
                video=(rng.random((B, T, 67, 67)) * 255).astype(np.float32),
                label=label, lengths=LENGTHS, mask=mask)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _run_both(jmodel, jexample, port_models, modality, arrays, norm_stats=None):
    """N_STEPS train steps on the JAX side and on each port model, all from
    the JAX init (Adam, nothing frozen) -> a dict of the JAX and port
    states after each step, the step-1 gradients and per-step metrics."""
    jstate = jcreate_train_state(jmodel, jax.random.PRNGKey(0), jexample, jmake_optimizer(LR))
    init = _np_tree(jstate.variables())
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})

    def loss_fn(params):
        variables = {"params": params, "batch_stats": jstate.batch_stats}
        if jstate.sketch is not None:
            variables["sketch"] = jstate.sketch
        inputs = jforward_inputs(modality, jbatch, norm_stats, 1e-8)
        logits, _ = jstate.apply_fn(variables, *inputs, train=True, mutable=["batch_stats"])
        return jlosses.masked_sequence_bce(logits, jbatch.label, jbatch.mask)

    jgrads = from_flax_variables({"params": _np_tree(jax.jit(jax.grad(loss_fn))(jstate.params))})
    jstep = jmake_train_step(modality, donate=False)
    jstates, jmetrics = [], []
    for _ in range(N_STEPS):
        jstate, m = jstep(jstate, jbatch, norm_stats)
        jmetrics.append({k: float(v) for k, v in m.items()})
        jstates.append(from_flax_variables(_np_tree(jstate.variables())))

    batch = Batch(**arrays)
    ports = []
    for model in port_models:
        model.load_state_dict(from_flax_variables(init), strict=True)
        state = create_train_state(model, learning_rate=LR, device="cpu")
        step = make_train_step(modality)
        states, metrics, grads = [], [], None
        for i in range(N_STEPS):
            state, m = step(state, batch, norm_stats)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(_snapshot(model))
            if i == 0:
                grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        ports.append({"state": state, "states": states, "metrics": metrics, "grads": grads})
    return {"init": from_flax_variables(init), "jstate": jstate, "jstates": jstates,
            "jgrads": jgrads, "jmetrics": jmetrics, "ports": ports, "batch": batch,
            "jbatch": jbatch, "norm_stats": norm_stats, "modality": modality}


@pytest.fixture(scope="module")
def video_run():
    """VideoVAD(2 x LSTM 32), the ResNet-18 trained from scratch, with the
    dataset's video statistics: 3 steps on each side."""
    jm = JVideoVAD(lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True)
    port = VideoVAD(lstm_hidden_size=H, lstm_layers=2, use_kernel_lstm=True)
    return _run_both(jm, (jnp.zeros((1, 4, 67, 67)),), [port], "video",
                     _batch_arrays(50, audio=False), norm_stats=VIDEO_STATS)


@pytest.fixture(scope="module")
def av_run():
    """AVVAD(MCB 64, 2 x LSTM 32), the trunk unfrozen, JAX ``remat=True``:
    3 steps on the JAX side, on the port with ``remat=True`` (ports[0]) and
    without (ports[1])."""
    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                use_pallas_lstm=True, remat=True)
    ports = [AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                   use_kernel_lstm=True, remat=remat) for remat in (True, False)]
    return _run_both(jm, (jnp.zeros((1, 4, 513)), jnp.zeros((1, 4, 67, 67))), ports, "av",
                     _batch_arrays(51, audio=True), norm_stats=VIDEO_STATS)


RUNS = ["video_run", "av_run"]


def _trunk(names):
    return [n for n in names if n.startswith("tower.features.")]


def _l2_rel(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_video_modality_is_ported():
    assert MODALITIES == ("audio", "video", "av", "waveform")
    with pytest.raises(ValueError, match="unknown modality"):
        make_train_step("spectrogram")


@pytest.mark.parametrize("run", RUNS)
def test_train_step_metrics_match_jax(run, request):
    """The 4 metrics of each of the 3 steps and step 1's loss at 1e-5
    (readings: equal, loss 8.6e-8); the loss of steps 2 and 3 at 2e-2
    (readings 8.3e-7 and 1.7e-5 for video, 5.6e-6 and 5.5e-3 for AV): by
    then the trunks have moved apart by the sign-flipped Adam updates of
    TRUNK_L2_TOL, and AV's post-MCB BatchNorm (16 positions, eps 1e-8)
    amplifies what that does to the features."""
    r = request.getfixturevalue(run)
    for port in r["ports"]:
        for i, (got, ref) in enumerate(zip(port["metrics"], r["jmetrics"])):
            assert got.keys() == ref.keys()
            for k in ref:
                rtol = 2e-2 if (k == "loss" and i) else 1e-5
                np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=1e-7)
            assert 0 <= got["f1"] <= 1 and np.isfinite(got["loss"])
        assert port["metrics"][-1]["loss"] < port["metrics"][0]["loss"]


# TRUNK_L2_TOL: why the trunk's gradients are held by the L2 norm. With
# train-mode BatchNorm on 16 frames the fp32 gradient of some trunk entries
# is not resolved by either framework: test_trunk_backward_matches_jax holds
# both to the port's float64 evaluation of the same trunk, where JAX's fp32
# gradients read up to 1.3e-2 off in L2 and the port's 5.4e-3, and single
# entries of a tensor differ by far more than its norm does.
TRUNK_L2_TOL = 5e-2


@pytest.mark.parametrize("run", RUNS)
def test_train_step_grads_match_jax(run, request):
    """Step 1's gradients of every parameter against jax.grad of the same
    loss. Outside the trunk: the largest error over the tensor's max |g|
    at 5e-4, as test_torch_port_train.py holds the frozen AV step
    (readings up to 5.1e-5 video, 1.0e-4 AV). The trunk's 60 tensors (20
    convolutions, 20 BatchNorm scales, 20 biases): L2 error over the
    tensor's L2 norm at 5e-2 (readings up to 1.1e-2 video, 1.6e-2 AV; see
    TRUNK_L2_TOL)."""
    r = request.getfixturevalue(run)
    for port in r["ports"]:
        grads = port["grads"]
        assert set(grads) == set(r["jgrads"])
        trunk = _trunk(grads)
        assert len(trunk) == 60
        for n, g in grads.items():
            got, ref = g.numpy(), r["jgrads"][n].numpy()
            assert np.abs(got).max() > 0, n
            if n in trunk:
                assert _l2_rel(got, ref) < TRUNK_L2_TOL, n
            else:
                assert _rel_err(got, ref) < 5e-4, n


# Adam's bias-corrected update moves an entry by at most 1.004 lr a step in
# the first 3 steps (Cauchy-Schwarz over the moments' weights), so two
# trajectories of 3 steps stay within 6.02 lr of each other
ADAM_3_STEPS = 2 * N_STEPS * 1.004 * LR


@pytest.mark.parametrize("run", RUNS)
def test_train_step_params_match_jax(run, request):
    """After step 1 an Adam update is lr * sign(g): every entry outside the
    trunk whose |g| is above 1e-2 of its tensor's max, and every trunk
    entry above 0.5 of its tensor's max (past either framework's fp32
    error), at 1e-6 (readings 3.7e-9 trunk, 1.5e-8 the rest). After 3
    steps every entry within
    the two trajectories' Adam bound, ADAM_3_STEPS (readings up to 4.2e-4
    video, 5.9e-4 AV), and every tensor moved."""
    r = request.getfixturevalue(run)
    for port in r["ports"]:
        trunk = _trunk(port["grads"])
        for n in port["grads"]:
            g1 = np.abs(r["jgrads"][n].numpy())
            big = g1 > (0.5 if n in trunk else 1e-2) * g1.max()
            first = np.abs(port["states"][0][n].numpy() - r["jstates"][0][n].numpy())
            assert first[big].max(initial=0) < 1e-6, n
            got, ref = port["states"][-1][n].numpy(), r["jstates"][-1][n].numpy()
            assert np.abs(got - ref).max() < ADAM_3_STEPS, n
            assert np.abs(ref - r["init"][n].numpy()).max() > 2 * LR, n  # it trained


@pytest.mark.parametrize("run", RUNS)
def test_batch_stats_match_jax_after_each_step(run, request):
    """The running statistics of the trunk's 20 BatchNorms (and AV's
    post-MCB one) against JAX's batch_stats. After step 1 at 1e-4 as
    test_torch_port_train.py holds them (readings 5.6e-6 video, 6.2e-6
    AV): with ``remat`` too each step updates them once, as flax's
    ``nn.remat`` does (a second update by the recompute would show here).
    After steps 2 and 3, taken on the trunks that moved apart
    (TRUNK_L2_TOL), at 2e-2 (readings up to 4.6e-4 video, 7.8e-3 AV)."""
    r = request.getfixturevalue(run)
    names = [n for n in r["init"] if n.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (20 + (r["modality"] == "av"))
    for port in r["ports"]:
        for i, (sd, ref) in enumerate(zip(port["states"], r["jstates"])):
            for n in names:
                np.testing.assert_allclose(sd[n].numpy(), ref[n].numpy(),
                                           atol=2e-2 if i else 1e-4, rtol=1e-5, err_msg=n)
    for n in names:
        assert np.abs(r["jstates"][0][n].numpy() - r["init"][n].numpy()).max() > 1e-3


def test_remat_step_equals_step_without_remat(av_run):
    """The port's remat step against its step without remat, from the same
    init: gradients of step 1, then parameters and running statistics after
    each step, within 1e-5 (the same operations, recomputed)."""
    remat, plain = av_run["ports"]
    assert remat["state"].model.tower.remat and not plain["state"].model.tower.remat
    for n, g in plain["grads"].items():
        assert _rel_err(remat["grads"][n].numpy(), g.numpy()) < REMAT_TOL, n
    for got, want in zip(remat["states"], plain["states"]):
        for n, v in want.items():
            np.testing.assert_allclose(got[n].double().numpy(), v.double().numpy(),
                                       atol=REMAT_TOL, rtol=0, err_msg=n)


def test_remat_recompute_leaves_running_stats_alone():
    """Inside ``running_stats_frozen`` a train-mode forward normalises with
    the batch statistics (the same output) but updates no running
    statistic; outside it, it does."""
    tower = _VideoTower().train()
    video = torch.from_numpy(np.random.default_rng(52).normal(size=(1, 3, 67, 67))
                             .astype(np.float32))
    before = _snapshot(tower)
    with torch.no_grad(), running_stats_frozen():
        frozen = tower(video)
    for n, v in tower.state_dict().items():
        assert torch.equal(v, before[n]), n
    with torch.no_grad():
        out = tower(video)
    torch.testing.assert_close(out, frozen, rtol=0, atol=0)
    assert not torch.equal(tower.features.bn1.running_var, before["features.bn1.running_var"])


def _tower_grads(port, video, r):
    port.train()
    feats = port(_t(video).to(next(port.parameters()).dtype))
    (feats * _t(r).to(feats.dtype)).sum().backward()
    return feats.detach(), {n: p.grad.double().numpy() for n, p in port.named_parameters()}


@pytest.mark.parametrize("gray_stem", [True, False], ids=["gray", "rgb"])
def test_trunk_backward_matches_jax(gray_stem):
    """JAX's ``_VideoTower`` (``gray_stem=False``: the frame repeated to 3
    channels through the whole (64, 3, 7, 7) kernel) against the port's, 16
    lip frames: features in eval mode (running statistics) and in train
    mode, the running statistics after it, and the gradients of
    sum(features * r) with respect to every trunk parameter, in train mode.
    The port's float64 evaluation of the same trunk is the arbiter of the
    gradients: JAX's fp32 gradients and the port's fp32 ones are each held
    to it at 5e-2 in L2 over the tensor's norm (readings: JAX 1.2e-2 /
    1.3e-2 with the gray / 3-channel stem, the port 5.4e-3 / 3.2e-3; a
    batch of 16 frames leaves some of the trunk's train-mode BatchNorm
    gradients unresolved in fp32, and single entries are further off)."""
    jt = JVideoTower(gray_stem=gray_stem)
    rng = np.random.default_rng(53)
    video = (rng.random((2, 8, 67, 67)) * 255 - 120).astype(np.float32) / 60
    r = rng.normal(size=(2, 8, 512)).astype(np.float32)
    variables = _np_tree(jt.init(jax.random.PRNGKey(6), jnp.zeros((1, 2, 67, 67))))
    assert variables["params"]["features"]["conv1"]["kernel"].shape == (7, 7, 3, 64)
    state = from_flax_variables(variables)
    port = _VideoTower(gray_stem=gray_stem)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port.eval()(_t(video)).numpy()
    np.testing.assert_allclose(got, np.asarray(jt.apply(variables, jnp.asarray(video))),
                               atol=1e-5)

    def jloss(params):
        feats, upd = jt.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(video), train=True, mutable=["batch_stats"])
        return jnp.sum(feats * jnp.asarray(r)), (feats, upd)

    (_, (jfeats, upd)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    feats, grads = _tower_grads(port, video, r)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4)
    sd = port.state_dict()
    for n, v in from_flax_variables(_np_tree({"batch_stats": upd["batch_stats"]})).items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[n].numpy(), v.numpy(), atol=1e-4, rtol=1e-5,
                                       err_msg=n)
    port64 = _VideoTower(gray_stem=gray_stem, dtype=torch.float64).double()
    port64.load_state_dict(state, strict=True)
    _, grads64 = _tower_grads(port64, video, r)
    jgrads = from_flax_variables({"params": _np_tree(jgrads)})
    assert set(grads) == set(jgrads) == set(grads64)
    for n, ref in grads64.items():
        assert _l2_rel(jgrads[n].numpy(), ref) < TRUNK_L2_TOL, n
        assert _l2_rel(grads[n], ref) < TRUNK_L2_TOL, n


def test_gray_stem_on_models():
    """``gray_stem`` and ``remat`` reach the tower of both models; a gray
    frame through the 3-channel stem equals the gray stem on the same
    weights up to fp32 reassociation."""
    video = torch.from_numpy(np.random.default_rng(55).normal(size=(1, 2, 67, 67))
                             .astype(np.float32))
    outs = []
    for gray in (True, False):
        m = VideoVAD(lstm_hidden_size=8, lstm_layers=1, gray_stem=gray, remat=True).eval()
        assert m.tower.gray_stem == gray and m.tower.remat
        assert m.tower.features.conv1.gray == gray
        with torch.no_grad():
            outs.append(m.tower(video))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    av = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=32, gray_stem=False,
               remat=True)
    assert not av.tower.gray_stem and av.tower.remat


@pytest.mark.parametrize("run", RUNS)
def test_eval_and_predict_steps_match_jax(run, request):
    """After 3 train steps: JAX's eval and predict steps against the
    port's (BatchNorm on the trained running statistics, the inference
    LSTM kernel's plain version). The models have moved apart as in
    test_train_step_metrics_match_jax: probabilities and the loss at 5e-4
    (readings 4.6e-5 video, 9.5e-5 AV), the other metrics at 1e-5."""
    r = request.getfixturevalue(run)
    modality = r["modality"]
    jm, jsoft = jmake_eval_step(modality)(r["jstate"], r["jbatch"], r["norm_stats"])
    before = lstm_fused.launch_counts()
    state = r["ports"][0]["state"]
    m, soft = make_eval_step(modality)(state, r["batch"], r["norm_stats"])
    pred = make_predict_step(modality)(state, r["batch"], r["norm_stats"])
    assert lstm_fused.launch_counts() == before  # CPU tensors launch nothing
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=5e-4)
    np.testing.assert_array_equal(pred.numpy(), soft.numpy())
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-7,
                                   rtol=5e-4 if k == "loss" else 1e-5)


# --- Trainer.fit on VideoVAD, checkpoint, graft into AVVAD ---


class _Batches(list):
    """A list of batches with a loader's ``source`` and ``epoch``."""

    epoch = 0

    def __init__(self, batches, n_items):
        super().__init__(batches)
        self.source = list(range(n_items))


def _video_batches(seed, n, lengths=(6, 4)):
    rng = np.random.default_rng(seed)
    return [pad_batch([{"length": n_, "audio": rng.normal(size=(n_, 513)),
                        "video": rng.normal(size=(n_, 67, 67)),
                        "label": (rng.random((n_, 1)) > 0.5).astype(np.float32)}
                       for n_ in lengths]) for _ in range(n)]


def test_video_trainer_checkpoint_and_graft_into_av(tmp_path):
    """Trainer(state, "video") fits 2 epochs of 2 batches with its eval
    pass, logs and checkpoints; its per-batch losses are those of
    make_train_step on a twin state; the trained trunk grafts into an
    AVVAD (load_pretrained_trunk), and a frozen AV step on it
    trains the rest and leaves the grafted trunk's parameters as trained.
    The latest checkpoint is grafted: it holds the trained model's state
    (the best-vloss one, which a model directory resolves to, may be
    epoch 1's)."""
    train_b, valid_b = _video_batches(60, 2), _video_batches(61, 1)
    model = VideoVAD(lstm_hidden_size=8, lstm_layers=1, use_kernel_lstm=True, seed=3)
    twin = VideoVAD(lstm_hidden_size=8, lstm_layers=1, use_kernel_lstm=True, seed=3)
    state = create_train_state(model, learning_rate=1e-3, device="cpu")
    twin_state = create_train_state(twin, learning_rate=1e-3, device="cpu")
    model_dir = tmp_path / "video"
    last = Trainer(state, "video", str(model_dir)).fit(
        _Batches(train_b, 4), _Batches(valid_b, 2), end_epoch=3, keep_checkpoints=1)
    assert last["epoch"] == 2 and state.step == 4
    step = make_train_step("video")
    losses = [float(step(twin_state, b)[1]["loss"]) for _ in range(2) for b in train_b]
    batch_log = (model_dir / "output_batch.log").read_text().splitlines()
    assert [ln.split("Loss: ")[1].split()[0] for ln in batch_log] == \
        [f"{v:.2f}" for v in losses]
    assert batch_log[0].startswith("Train Epoch:  1   [   2/   4 (50%)]")
    epoch_log = (model_dir / "output_epoch.log").read_text().splitlines()
    assert [ln.split()[0] for ln in epoch_log if not ln.startswith("[Time]")] == \
        ["Epoch:", "[Train]", "[Validation]"] * 2
    assert sorted(p.name for p in model_dir.glob("epoch_*"))
    for n, v in twin.state_dict().items():
        torch.testing.assert_close(model.state_dict()[n], v, rtol=0, atol=0, msg=n)

    av = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=32, use_kernel_lstm=True,
               seed=4)
    latest = ckpt.latest_checkpoint(str(model_dir))
    assert latest.endswith("epoch_002_vloss_" + latest.rsplit("_", 1)[1])
    ckpt.load_pretrained_trunk(latest, av)
    trunk = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("tower.features.")}
    for k, v in trunk.items():
        torch.testing.assert_close(av.state_dict()[k], v, rtol=0, atol=0)
    av_state = create_train_state(av, learning_rate=1e-3, freeze_video_trunk=True,
                                  device="cpu")
    head = {n: p.detach().clone() for n, p in av.named_parameters() if p.requires_grad}
    arrays = _batch_arrays(62, audio=True)
    _, metrics = make_train_step("av")(av_state, Batch(**arrays))
    assert np.isfinite(float(metrics["loss"]))
    sd = av.state_dict()
    for k, v in trunk.items():
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    assert all(not torch.equal(p, head[n]) for n, p in av.named_parameters()
               if p.requires_grad)
