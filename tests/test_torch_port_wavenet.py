"""CPU parity of the port's raw-waveform family with the JAX package:
``adaptive_avg_pool1d``, ``WaveNetEncoder``, ``RawAudioVAD``, the
``"waveform"`` train step, ``make_waveform_serving_fn(RawAudioVAD)``,
``Trainer.fit`` and ``evaluate_split`` on waveform batches.

Weights come from the JAX modules' init through
``convert.from_flax_variables``; waveforms and labels are seeded numpy
draws handed to both sides. No kernel is on this path: the WaveNet
convolutions are plain convolutions on both sides, and ``RawAudioVAD``'s
LSTM is JAX's ``lax.scan`` and the port's plain loop.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from hypothesis import given, settings
from hypothesis import strategies as st

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.evaluate.predict import evaluate_split as jevaluate_split
from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import RawAudioVAD as JRawAudioVAD
from avvad_tpu.models import losses as jlosses
from avvad_tpu.models.wavenet import WaveNetEncoder as JWaveNetEncoder
from avvad_tpu.models.wavenet import adaptive_avg_pool1d as jadaptive_avg_pool1d
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.data import Batch, pad_batch
from avvad_tpu_torch.evaluate import evaluate_split
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import RawAudioVAD, WaveNetEncoder, adaptive_avg_pool1d
from avvad_tpu_torch.train import Trainer, create_train_state, make_train_step

# a cut-down encoder: 4 dilations, 8 channels (receptive field 33 samples)
WAVENET = dict(dilations=(1, 2, 4, 8), residual_channels=8, dilation_channels=8,
               bottleneck_width=8)
N_SAMPLES, OUT_FRAMES, H = 2048, 8, 16
# fp32 on both sides: convolutions and the recurrence sum in another order
ATOL_F32 = 1e-5
# bf16 on both sides: one bf16 rounding of a unit-scale value is 2**-8; the
# JAX conv rounds its output before adding the bias, the port's adds it in
# the conv; the recurrence carries the differences through T steps
ATOL_BF16 = 2e-2
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wave(b=2, n=N_SAMPLES, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, n)) * 0.3).astype(np.float32)


def _raw_models(layers, dtype=torch.float32, out_frames=OUT_FRAMES, seed=0):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = JRawAudioVAD(lstm_hidden_size=H, lstm_layers=layers, out_frames=out_frames,
                      wavenet_kwargs=WAVENET, dtype=jdt)
    variables = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, N_SAMPLES))))
    port = RawAudioVAD(lstm_hidden_size=H, lstm_layers=layers, out_frames=out_frames,
                       wavenet_kwargs=WAVENET, dtype=dtype)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port


@settings(max_examples=40, deadline=None, database=None)
@given(t=st.integers(1, 90), out=st.integers(1, 120), c=st.integers(1, 3))
def test_adaptive_avg_pool1d_matches_jax(t, out, c):
    """JAX's floor/ceil bins, out > T included (bins then overlap)."""
    x = np.random.default_rng(t * 1000 + out).normal(size=(2, t, c)).astype(np.float32)
    got = adaptive_avg_pool1d(torch.from_numpy(x), out).numpy()
    ref = np.asarray(jadaptive_avg_pool1d(jnp.asarray(x), out))
    assert got.shape == ref.shape == (2, out, c)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dilation", [1, 3])
def test_conv1d_kernel_convert_rule(dilation):
    """A Flax Conv1D kernel (W, I, O) becomes a Conv1d weight (O, I, W), and
    the two convolutions agree (VALID padding, dilation)."""
    conv = fnn.Conv(5, (3,), kernel_dilation=(dilation,), padding="VALID")
    x = np.random.default_rng(1).normal(size=(2, 20, 4)).astype(np.float32)
    variables = _np_tree(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    state = from_flax_variables({"params": {"c": variables["params"]}})
    kernel = variables["params"]["kernel"]
    assert kernel.shape == (3, 4, 5) and state["c.weight"].shape == (5, 4, 3)
    np.testing.assert_array_equal(state["c.weight"].numpy(), kernel.transpose(2, 1, 0))
    layer = torch.nn.Conv1d(4, 5, 3, dilation=dilation)
    layer.load_state_dict({"weight": state["c.weight"], "bias": state["c.bias"]})
    got = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    ref = np.asarray(conv.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_wavenet_encoder_matches_jax():
    """Dilations (1, 2, 4, 8), 8 channels, about 2,000 samples, fp32."""
    kw = dict(quantization_channels=1, pool_kernel_size=32, **WAVENET)
    jenc = JWaveNetEncoder(**kw)
    x = _wave()[..., None]
    variables = _np_tree(jenc.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    enc = WaveNetEncoder(**kw)
    enc.load_state_dict(from_flax_variables(variables), strict=True)
    assert enc.receptive_field == jenc.receptive_field == 33
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    ref = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 32, 8)
    np.testing.assert_allclose(got, ref, atol=ATOL_F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_raw_audio_vad_logits_match_jax(layers, dtype):
    jm, variables, port = _raw_models(layers, getattr(torch, dtype))
    wave = _wave(seed=layers)
    with torch.no_grad():
        got = port(torch.from_numpy(wave)).numpy()
    ref = np.asarray(jm.apply(variables, jnp.asarray(wave)), np.float32)
    assert got.shape == ref.shape == (2, OUT_FRAMES, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL_F32 if dtype == "float32" else ATOL_BF16)


def _waveform_batch(seed=5, lengths=(OUT_FRAMES, 5)):
    rng = np.random.default_rng(seed)
    t = OUT_FRAMES
    lengths = np.asarray(lengths, np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    label = (rng.random((2, t, 1)) > 0.5).astype(np.float32) * mask[..., None]
    return dict(audio=None, video=None, label=label, lengths=lengths, mask=mask,
                waveform=_wave(seed=seed))


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_waveform_train_step_matches_jax():
    """One Adam step of make_train_step("waveform") on each side from the
    same weights: the loss within 1e-5, every gradient within 1e-4 in
    relative L2 (jax.grad of the same loss), the step's parameters."""
    jm, variables, port = _raw_models(2)
    arrays = _waveform_batch()
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, N_SAMPLES)),),
                                 jmake_optimizer(LR))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    def loss_fn(params):
        logits = jstate.apply_fn({"params": params}, jbatch.waveform, train=True)
        return jlosses.masked_sequence_bce(logits, jbatch.label, jbatch.mask)

    jgrads = from_flax_variables({"params": _np_tree(jax.grad(loss_fn)(jstate.params))})
    jstate, jmetrics = jmake_train_step("waveform", donate=False)(jstate, jbatch, None)
    jfinal = from_flax_variables(_np_tree({"params": jstate.params}))

    state = create_train_state(port, learning_rate=LR, device="cpu")
    state, metrics = make_train_step("waveform")(state, Batch(**arrays))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for k in ("accuracy", "precision", "recall", "f1"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), atol=1e-6)
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        assert _rel_l2(g, jgrads[n].numpy()) < 1e-4, n
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[n].numpy(), atol=2e-6,
                                   err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_waveform_serving_fn_matches_jax(dtype):
    """The raw wave straight into the encoder, no STFT."""
    jm, variables, port = _raw_models(1, getattr(torch, dtype))
    wave = _wave(b=3, seed=7)
    got = make_waveform_serving_fn(port, device="cpu")(wave)
    ref = np.asarray(jmake_serving_fn(jm, variables, t_frames=OUT_FRAMES)(jnp.asarray(wave)),
                     np.float32)
    assert got.shape == ref.shape == (3, OUT_FRAMES, 1) and got.device.type == "cpu"
    assert ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=ATOL_F32 if dtype == "float32" else ATOL_BF16)


class _WaveSource:
    """In-memory waveform utterances in the sources' protocol."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            length = OUT_FRAMES - (i % 3)
            self.items.append({
                "waveform": (rng.normal(size=N_SAMPLES) * 0.3).astype(np.float32),
                "label": (rng.random((length, 1)) > 0.5).astype(np.float32),
                "length": length, "time_length": N_SAMPLES})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def rel_path(self, i):
        return f"spk/utt_{i}.wav"


def test_trainer_and_evaluate_split_take_waveform_batches(tmp_path):
    """Trainer.fit, one epoch of waveform batches (padded to out_frames),
    then evaluate_split over a waveform source: every written soft
    prediction against JAX's evaluate_split on the same weights."""
    jm, variables, port = _raw_models(1)
    source = _WaveSource(5, seed=9)
    evaluate_split(create_train_state(port, device="cpu"), source, "waveform",
                   str(tmp_path / "port") + "/", batch_size=2, bucket=OUT_FRAMES,
                   bucket_ladder=False, verbose=False)
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, N_SAMPLES)),),
                                 jmake_optimizer(LR))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    jevaluate_split(jstate, source, "waveform", str(tmp_path / "jax") + "/", batch_size=2,
                    bucket=OUT_FRAMES, bucket_ladder=False, verbose=False)
    soft = sorted(p for p in (tmp_path / "port").rglob("*.npy") if "soft" in p.name)
    assert len(soft) == len(source)
    for p in soft:
        ref = np.load(tmp_path / "jax" / p.relative_to(tmp_path / "port"))
        np.testing.assert_allclose(np.load(p), ref, atol=ATOL_F32)

    batches = [pad_batch([source[i], source[i + 1]], bucket=OUT_FRAMES) for i in (0, 2)]
    state = create_train_state(port, learning_rate=1e-2, device="cpu")
    last = Trainer(state, "waveform", str(tmp_path / "fit")).fit(
        batches, batches[:1], end_epoch=2)
    assert state.step == 2 and np.isfinite(last["train"]["loss"])
    assert os.listdir(tmp_path / "fit")
