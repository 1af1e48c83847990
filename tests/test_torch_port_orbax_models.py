"""The JAX package's Orbax checkpoints of the four model families through
the port, on the CPU: ``AudioVAD``, ``RawAudioVAD``, ``VideoVAD`` and
``AVVAD`` (trunk frozen, so optax's ``multi_transform``, and trunk
trained) at small width, one Adam step taken by JAX and saved by its
``save_checkpoint``. Every array bit-equal to Orbax's restore; the restored
port model's forward against JAX's at the bar of
test_torch_port_models.py; one port train step from the restored state
against JAX's step from the same checkpoint at the bars of
test_torch_port_train.py; ``export_jax_checkpoint`` restored by JAX's
``restore_checkpoint`` bit for bit; a VideoVAD trunk grafted both ways.

The JAX models' weights come from the port's seeded init through
``convert.to_flax_variables`` (no JAX init to compile); JAX writes every
checkpoint read here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import RawAudioVAD as JRawAudioVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.train import checkpoint as jckpt
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu_torch import orbax_io
from avvad_tpu_torch.convert import from_flax_variables, to_flax_variables
from avvad_tpu_torch.data import Batch
from avvad_tpu_torch.models import AVVAD, AudioVAD, RawAudioVAD, VideoVAD
from avvad_tpu_torch.train import (create_train_state, make_train_step, restore_checkpoint,
                                   restore_model)
from avvad_tpu_torch.train import checkpoint as ckpt
from torch_port_orbax_lib import (LR, adam_of, bits, jax_state, leaves_with_paths,
                                  np_tree, ours, params_of)

H, MCB_OUT, B, T = 16, 64, 2, 8
LENGTHS = np.array([8, 5], np.int32)
WAVENET = dict(dilations=(1, 2, 4, 8), residual_channels=8, dilation_channels=8,
               bottleneck_width=8)
N_SAMPLES = 2048
# test_torch_port_models.py: whole-model logits, fp32 on both sides
ATOL_LOGITS = 1e-4


def _arrays(seed):
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)
    label = (rng.random((B, T, 1)) > 0.5).astype(np.float32) * mask[..., None]
    return dict(audio=rng.normal(size=(B, T, 513)).astype(np.float32),
                video=rng.normal(size=(B, T, 67, 67)).astype(np.float32),
                waveform=(rng.normal(size=(B, N_SAMPLES)) * 0.3).astype(np.float32),
                label=label, lengths=LENGTHS, mask=mask)


# family -> (port model, JAX model, train step modality, frozen trunk, inputs)
FAMILIES = {
    "audio": (lambda: AudioVAD(lstm_hidden_size=H, lstm_layers=2),
              lambda: JAudioVAD(lstm_hidden_size=H, lstm_layers=2), "audio", False,
              ("audio",)),
    "raw": (lambda: RawAudioVAD(lstm_hidden_size=H, lstm_layers=1, out_frames=T,
                                wavenet_kwargs=WAVENET),
            lambda: JRawAudioVAD(lstm_hidden_size=H, lstm_layers=1, out_frames=T,
                                 wavenet_kwargs=WAVENET), "waveform", False, ("waveform",)),
    "video": (lambda: VideoVAD(lstm_hidden_size=H, lstm_layers=1),
              lambda: JVideoVAD(lstm_hidden_size=H, lstm_layers=1), "video", False,
              ("video",)),
    "av_frozen": (lambda: AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT),
                  lambda: JAVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT),
                  "av", True, ("audio", "video")),
    "av_trained": (lambda: AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT),
                   lambda: JAVVAD(lstm_hidden_size=H, lstm_layers=1,
                                  mcb_output_size=MCB_OUT), "av", False, ("audio", "video")),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def saved(request, tmp_path_factory):
    """One family: JAX takes an Adam step from the port's seeded init and
    saves (epoch 1); then JAX's next step from that checkpoint."""
    family = request.param
    make_port, make_jax, modality, freeze, inputs = FAMILIES[family]
    torch.manual_seed(3)
    port = make_port()
    jm = make_jax()
    init = to_flax_variables(port.state_dict(), params_of(port))
    jstep = jmake_train_step(modality, donate=False)
    arrays = _arrays(1)
    keep = dict(arrays, **{k: None for k in ("audio", "video", "waveform") if k not in inputs})
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in keep.items()})
    jstate, _ = jstep(jax_state(jm, init, freeze), jbatch, None)
    model_dir = str(tmp_path_factory.mktemp(family))
    path = jckpt.save_checkpoint(model_dir, jstate, epoch=1, valid_loss=0.5)
    restored, _, epoch = jckpt.restore_checkpoint(path, jax_state(jm, init, freeze))
    assert epoch == 1
    jnext, jmetrics = jstep(restored, jbatch, None)
    return {"family": family, "path": path, "model_dir": model_dir, "make_port": make_port,
            "jm": jm, "modality": modality, "freeze": freeze, "inputs": inputs,
            "arrays": keep, "jstate": jstate, "jnext": jnext,
            "jmetrics": {k: float(v) for k, v in jmetrics.items()}}


def test_arrays_bit_equal_to_orbax_restore(saved):
    """Every leaf of the JAX checkpoint (params, batch statistics, sketches,
    optax's Adam state with its masked nodes, step) as Orbax restores it,
    dtype and bits."""
    tree = orbax_io.read_checkpoint(saved["path"])
    ref = leaves_with_paths(ocp.StandardCheckpointer().restore(saved["path"]))
    assert len(ref) > 5
    for path, want in ref.items():
        got, want = bits(ours(tree, path)), bits(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    if saved["freeze"]:
        masked = tree["opt_state"]["inner_states"]["train"]["inner_state"][0]["mu"]
        assert masked["tower"]["features"]["conv1"]["kernel"] is None


def _inputs(saved, torch_side: bool):
    a = saved["arrays"]
    vals = [a[k] for k in saved["inputs"]]
    return [torch.from_numpy(v) if torch_side else jnp.asarray(v) for v in vals]


def test_restored_forward_matches_jax(saved):
    """restore_model of the JAX checkpoint, then the eval forward against
    JAX's apply on the checkpoint's variables (ATOL_LOGITS)."""
    model = saved["make_port"]()
    norm, epoch = restore_model(saved["path"], model)
    assert norm is None and epoch == 1
    with torch.no_grad():
        got = model.eval()(*_inputs(saved, True)).numpy()
    want = np.asarray(saved["jm"].apply(saved["jstate"].variables(), *_inputs(saved, False)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL_LOGITS)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope="module")
def stepped(saved):
    """restore_checkpoint of the family's JAX checkpoint into a fresh port
    state (the trunk frozen where JAX's was), then one port train step ->
    (state, its metrics, the state dict before the step)."""
    model = saved["make_port"]()
    state = create_train_state(model, learning_rate=LR, freeze_video_trunk=saved["freeze"],
                               device="cpu")
    state, _, epoch = restore_checkpoint(saved["path"], state)
    assert epoch == 1 and state.step == 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = make_train_step(saved["modality"])(state, Batch(**saved["arrays"]))
    return state, metrics, before


def test_restored_train_step_matches_jax(saved, stepped):
    """restore_checkpoint into a fresh port state (the trunk frozen where
    JAX's was), then one step against JAX's step from the same checkpoint:
    the metrics at 1e-5 relative, each parameter within 6 lr and the Adam
    moments within 5e-4 of their largest entry (test_torch_port_train.py's
    bars; a trained trunk's by their L2 at 5e-2,
    test_torch_port_train_video.py's), the step count 2, a frozen trunk
    unchanged with no optimizer state."""
    state, metrics, before = stepped
    model = state.model
    assert state.step == 2
    for k, ref in saved["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=1e-5, atol=1e-7, err_msg=k)
    want = from_flax_variables(np_tree(saved["jnext"].variables()))
    sd = model.state_dict()
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    for n in trained:
        assert np.abs(sd[n].numpy() - want[n].numpy()).max() < 6 * LR, n
    for n, _ in model.named_parameters():
        if n.startswith("tower.features.") and saved["freeze"]:
            assert torch.equal(sd[n], before[n]), n
    names = {id(p): n for n, p in model.named_parameters()}
    adam = adam_of(saved["jnext"].opt_state)
    mu = from_flax_variables({"params": np_tree(adam.mu)}) if not saved["freeze"] else None
    for p, st in state.optimizer.state.items():
        assert float(st["step"]) == 2
        if mu is None:
            continue
        got, ref = st["exp_avg"].numpy(), mu[names[id(p)]].numpy()
        if names[id(p)].startswith("tower.features."):
            # the trained trunk's fp32 gradients: held by their L2
            # (test_torch_port_train_video.py's TRUNK_L2_TOL)
            assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-2, names[id(p)]
        else:
            assert _rel_err(got, ref) < 5e-4, names[id(p)]
    assert len(state.optimizer.state) == len(trained)


def test_export_restored_by_jax_bit_equal(saved, stepped, tmp_path):
    """The port state after its step, export_jax_checkpoint, then JAX's
    restore_checkpoint into a template state: params, batch statistics,
    sketches, optax's Adam state and step bit-equal to the port's own
    (through to_flax_variables)."""
    state = stepped[0]
    model = state.model
    norm = {"audio_mean": np.full((513, 1), 0.5, np.float32)}
    path = ckpt.export_jax_checkpoint(str(tmp_path), state, norm, epoch=2, valid_loss=0.25)
    assert os.path.basename(path) == "epoch_002_vloss_0.25"
    template = jax_state(saved["jm"], to_flax_variables(
        saved["make_port"]().state_dict(), params_of(model)), saved["freeze"])
    jstate, jnorm, epoch = jckpt.restore_checkpoint(path, template)
    assert epoch == 2 and int(jstate.step) == 2
    np.testing.assert_array_equal(np.asarray(jnorm["audio_mean"]), norm["audio_mean"])
    want = to_flax_variables(model.state_dict(), params_of(model))
    got = np_tree(jstate.variables())
    assert set(got) == set(want)
    for path_, v in leaves_with_paths(want).items():
        np.testing.assert_array_equal(np.asarray(ours(got, path_)), v, err_msg=path_)
    adam = adam_of(jstate.opt_state)
    assert int(adam.count) == 2
    names = {id(p): n for n, p in model.named_parameters()}
    exp_avg = {names[id(p)]: st["exp_avg"] for p, st in state.optimizer.state.items()}
    mu = from_flax_variables({"params": {k: v for k, v in np_tree(adam.mu).items()}}) \
        if not saved["freeze"] else None
    if mu is not None:
        for n, v in exp_avg.items():
            assert torch.equal(mu[n], v), n
    else:  # masked trunk moments: optax's MaskedNode in the restored tree
        leaves = jax.tree_util.tree_leaves(adam.mu)
        assert len(leaves) == len(exp_avg)


def test_load_pretrained_trunk_from_jax_video_checkpoint(tmp_path):
    """A JAX VideoVAD checkpoint's trunk grafted into a port AVVAD (its own
    trunk frozen), bit for bit; and the port's export of a VideoVAD grafted
    by JAX's load_pretrained_trunk, which restores with Orbax's own
    target-less restore."""
    torch.manual_seed(5)
    video = VideoVAD(lstm_hidden_size=H, lstm_layers=1)
    variables = to_flax_variables(video.state_dict(), params_of(video))
    jvideo = jax_state(JVideoVAD(lstm_hidden_size=H, lstm_layers=1), variables, False)
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), jvideo, epoch=3, valid_loss=0.1)
    av = AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT)
    ckpt.load_pretrained_trunk(str(tmp_path / "jax"), av)
    for k, v in video.state_dict().items():
        if k.startswith("tower.features."):
            assert torch.equal(av.state_dict()[k], v), k
    state = create_train_state(video, learning_rate=LR, device="cpu")
    out = ckpt.export_jax_checkpoint(str(tmp_path / "port"), state, epoch=0)
    jav = to_flax_variables(AVVAD(lstm_hidden_size=H, lstm_layers=1,
                                  mcb_output_size=MCB_OUT).state_dict(), params_of(av))
    params, stats = jckpt.load_pretrained_trunk(out, jav["params"], jav["batch_stats"])
    for tree, ref in ((params, variables["params"]), (stats, variables["batch_stats"])):
        for p, v in leaves_with_paths(ref["tower"]["features"]).items():
            np.testing.assert_array_equal(np.asarray(ours(tree["tower"]["features"], p)), v)
    assert path.endswith("epoch_003_vloss_0.10")

