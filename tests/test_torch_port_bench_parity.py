"""CPU parity of the programs the port's timers time with the JAX package's.

Each timer twin (``avvad_tpu_torch/scripts/bench*.py``) builds its program
so that it can take weights carried across from JAX
(``convert.from_flax_variables``); the same seeded numpy inputs then go
through the twin's program and through the JAX composition that the JAX
timer builds for the same flags (bench.py:416-475, bench_modalities.py:60-126,
bench_streaming.py:38-120, bench.py:150-200), at B=2, T=8, LSTM 32, MCB 64.
The JAX side runs its Pallas LSTM in interpret mode (the kernels'
arithmetic: W_hh rounded to bf16), its static-int8 tower on XLA's unfused
int8 path (bench.py's default, ``AVVAD_BENCH_PALLAS_TOWER`` unset), and
its MCB matmuls at DEFAULT as the TPU computes them (bf16 operands, fp32
sums; JAX's CPU DEFAULT is plain fp32). The port runs the plain versions
of its kernels, its int8 tower on the fused route (plain K3 + 8 x K2). JAX
runs jitted with the weights as arguments (closed over, XLA folds the
int8 weights as constants: 13 s a call; eagerly, each operation compiles
on its first call: 8 s for the first step).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.export import make_waveform_serving_fn as jserving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import RawAudioVAD as JRawAudioVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.models import mcb as jmcb
from avvad_tpu.models.mcb import fold_sketch_collection
from avvad_tpu.models.quantize import calibrate as jcalibrate
from avvad_tpu.ops.stft import log_power_frontend as jlog_power_frontend
from avvad_tpu.serve import MultiStreamAVVAD as JMultiStreamAVVAD
from avvad_tpu.serve import MultiStreamVAD as JMultiStreamVAD
from avvad_tpu.train.state import TrainState as JTrainState
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu.train.state import trainable_except_video_trunk as jfreeze
from avvad_tpu.train.steps import make_train_step as jmake_train_step
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.models import AudioVAD, RawAudioVAD
from avvad_tpu_torch.scripts import bench, bench_modalities, bench_streaming

B, T, H, MCB_OUT = 2, 8, 32, 64
PREC = jax.lax.Precision
# The bf16 serving step against JAX's (tests/test_torch_port_models.py,
# test_serving_fn_bf16_matches_jax): bf16 rounds at other places in the two
# frameworks (XLA's CPU backend keeps some products at fp32). Readings:
# 6.5e-5, 8.3e-5, 1.5e-4 (the float-tower cases), 1.6e-4 (audio)
BF16_PROB_ATOL = 3e-4
# the same with the static-int8 tower: XLA's rsqrt in the BatchNorm and
# torch's differ by an ulp and flip int8 ties, which move tower features by
# about 1e-4 relative (tests/test_torch_port_int8.py, 1e-4 for the fp32
# composition); MCB's L2 norm and BatchNorm damp them, bf16 adds its noise.
# Reading 5.7e-5
BF16_INT8_PROB_ATOL = 1e-3
# VideoVAD bf16 with the static-int8 tower: the int8 tie flips and bf16's
# roundings reach the LSTM with no MCB normalisation to damp them (ROADMAP
# "Faults": a batched bf16 VideoVAD tick reads 2.4e-3 from a solo one on the
# card). Readings 1.2e-3 on these weights, 2.4e-3 on a JAX init; held at 5e-3
BF16_VIDEO_ATOL = 5e-3
# the raw-waveform family in bf16 (tests/test_torch_port_wavenet.py);
# reading 4.1e-4
WAVENET_ATOL = 2e-2
# fp32 streaming ticks against JAX's (tests/test_torch_port_serve.py);
# reading 6.0e-8
STREAM_ATOL = 1e-5
# fp32 streaming with the static-int8 tower: the int8 tie flips above
# (tests/test_torch_port_int8.py's 1e-4 for the fp32 serving step); reading
# 8.3e-6
STREAM_INT8_ATOL = 1e-4
# a train step's loss, relative (the fp32 recurrence and convs summed in
# another order); readings 0 to 8.7e-8
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these programs are many small operations, which
    a pool of threads slows down badly when the suite's workers share the
    cores (tests/test_torch_port_ranks.py does the same)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16_operand_matmul(a, b, precision=None, preferred_element_type=None):
    """JAX's matmul with the TPU's DEFAULT product made explicit
    (tests/test_torch_port_options.py): operands rounded to bf16 and
    multiplied at HIGHEST; every other call unchanged."""
    if precision == PREC.DEFAULT:
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
        precision = PREC.HIGHEST
    return jnp.matmul(a, b, precision=precision,
                      preferred_element_type=preferred_element_type)


# the inverse of convert's kernel layouts (convert._KERNEL_LAYOUT)
_FLAX_KERNEL = {4: lambda w: w.transpose(2, 3, 1, 0), 3: lambda w: w.transpose(2, 1, 0),
                2: lambda w: w.T}
_FLAX_NAME = {"scale": "weight", "mean": "running_mean", "var": "running_var",
              "kernel": "weight"}


def _jax_vars(jm, port, *args, **kw):
    """JAX variables of ``jm`` holding the port model's own initial weights
    (shapes from ``jax.eval_shape`` of its init: a trace, no compile; the
    inverse of ``convert.from_flax_variables``, which the port then loads,
    so the same weights reach both sides through the converter)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    state = {k: v.numpy() for k, v in port.state_dict().items()}

    def fill(tree, prefix):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict) or hasattr(leaf, "items"):
                out[name] = fill(leaf, prefix + (name,))
                continue
            arr = state[".".join([*prefix, _FLAX_NAME.get(name, name)])]
            if name == "kernel":
                arr = _FLAX_KERNEL[arr.ndim](arr)
            assert arr.shape == leaf.shape, (prefix, name, arr.shape, leaf.shape)
            out[name] = np.ascontiguousarray(arr, dtype=np.float32)
        return out

    return {col: fill(tree, ()) for col, tree in shapes.items()}


@pytest.fixture
def tpu_default(monkeypatch):
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.matmul = _bf16_operand_matmul
    monkeypatch.setattr(jmcb, "jnp", shim)


@pytest.fixture(scope="module")
def inputs():
    """The twin's serving draws at B=2, T=8: wave, 4 unique frames, the
    gather schedule."""
    return bench.serving_inputs(B, T)


def _jav(int8: bool, **kw):
    return JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=MCB_OUT, use_pallas_lstm=True, dtype=jnp.bfloat16,
                  tower_int8=int8, tower_quant_mode="static" if int8 else "dynamic",
                  mcb_precision=PREC.DEFAULT, **kw)


@pytest.fixture(scope="module")
def av_vars(inputs):
    """JAX variables of the AVVAD with the int8 tower (its params are the
    float tower's too), from the port's init -> {"int8": variables,
    "float": without "quant"}."""
    from avvad_tpu_torch.models import AVVAD

    _, video, idx = inputs
    port = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                 tower_int8=True, tower_quant_mode="static", seed=2)
    v = _jax_vars(_jav(True), port, jnp.zeros((B, T, 513)), jnp.asarray(video),
                  video_frame_indices=jnp.asarray(idx))
    return {"int8": v, "float": {k: x for k, x in v.items() if k != "quant"}}


@pytest.fixture(scope="module")
def video_vars():
    """JAX variables of the VideoVAD with the int8 tower, from the port's
    init (its params and statistics serve the fp32 train step too)."""
    from avvad_tpu_torch.models import VideoVAD

    jm = JVideoVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, tower_int8=True,
                   tower_quant_mode="static")
    port = VideoVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, tower_int8=True,
                    tower_quant_mode="static", seed=1)
    return _jax_vars(jm, port, jnp.zeros((1, 4, 67, 67)))


def _jcalibrate(cal_model, variables, batch, **kw):
    """JAX's ``calibrate`` over one batch with the model's apply jitted (the
    weights as arguments): the same program, one compile instead of an
    eager call's per-operation ones."""
    apply = jax.jit(lambda v, *b: cal_model.apply(v, *b, mutable=["quant"], **kw))
    shim = types.SimpleNamespace(apply=lambda v, *b, mutable, **_kw: apply(v, *b))
    return _np_tree(jcalibrate(shim, variables, [batch]))


def _cfg(int8: int, lstm_quant: str) -> dict:
    return bench.serving_config({"AVVAD_BENCH_B": str(B), "AVVAD_BENCH_T": str(T),
                                 "AVVAD_BENCH_LSTM_H": str(H), "AVVAD_BENCH_INT8": str(int8),
                                 "AVVAD_BENCH_LSTM_QUANT": lstm_quant})


def _jax_serving(int8: int, lstm_quant: str, hop_dft: bool, mcb_hoist: bool, variables,
                 inputs):
    """bench.py main()'s program for these flags (bench.py:416-475)."""
    wave, video, idx = inputs
    jm = _jav(int8 == 2, lstm_state_quant=lstm_quant)
    if int8 == 2:
        variables = _jcalibrate(jm.clone(tower_quant_mode="calibrate", tower_pallas=False),
                                variables, (jnp.zeros((2, T, 513)), jnp.asarray(video[:2])),
                                train=False, video_frame_indices=jnp.asarray(idx))
    if mcb_hoist:
        jm = jm.clone(mcb_folded_vars=True)
        variables = fold_sketch_collection(variables)
    fn = jax.jit(lambda v, w, x: jserving_fn(
        jm, v, t_frames=T, hop_dft=hop_dft, fe_precision=PREC.HIGHEST,
        video_frame_indices=jnp.asarray(idx))(w, x))
    return np.asarray(fn(variables, jnp.asarray(wave), jnp.asarray(video)), np.float32)


SERVING_CASES = [  # (AVVAD_BENCH_INT8, LSTM_QUANT, HOP_DFT, MCB_HOIST): each flag on
    (0, "none", False, False), (0, "bf16", True, False), (0, "int8", False, True),
    (2, "none", False, False)]


@pytest.mark.parametrize("int8, lstm_quant, hop_dft, mcb_hoist", SERVING_CASES)
def test_serving_program_matches_jax(tpu_default, av_vars, inputs, int8, lstm_quant,
                                     hop_dft, mcb_hoist):
    """The step the serving twin times (``build_serving`` -> ``make``) for
    each flag against JAX's make_waveform_serving_fn for the same flags, the
    int8 scales calibrated on both sides on the same 2 utterances."""
    variables = av_vars["int8" if int8 else "float"]
    sb = bench.build_serving(_cfg(int8, "none"), torch.device("cpu"),
                             state_dict=from_flax_variables(variables), inputs=inputs,
                             mcb_output_size=MCB_OUT)
    assert sb.model.tower.features.stages_pallas == (int8 == 2)
    got = sb.make(hop_dft, lstm_quant, mcb_hoist)(sb.wave, sb.video).numpy()
    ref = _jax_serving(int8, lstm_quant, hop_dft, mcb_hoist, variables, inputs)
    assert got.shape == ref.shape == (B, T, 1)
    np.testing.assert_allclose(got, ref, atol=BF16_INT8_PROB_ATOL if int8 else BF16_PROB_ATOL)


def test_modality_audio_matches_jax(inputs):
    """bench_modalities' audio configuration: AudioVAD bf16 on the log-power
    frontend (bench_modalities.py:60-78)."""
    wave = inputs[0]
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True,
                   dtype=jnp.bfloat16)
    variables = _jax_vars(jm, AudioVAD(lstm_hidden_size=H, lstm_layers=2),
                          jnp.zeros((B, T, 513)))
    feats = jlog_power_frontend(jnp.asarray(wave), fs=16000, wlen_sec=64e-3,
                                hop_percent=0.25, center=False, pad_at_end=True)[:, :T, :]
    ref = np.asarray(jax.nn.sigmoid(jax.jit(jm.apply)(variables, feats)), np.float32)
    serve, args, secs = bench_modalities.audio_spec_config(
        B, T, torch.device("cpu"), from_flax_variables(variables), H, wave)
    assert secs == B * T / 62.5
    np.testing.assert_allclose(serve(*args).numpy(), ref, atol=BF16_PROB_ATOL)


def test_modality_wavenet_matches_jax(inputs):
    """bench_modalities' wavenet configuration: RawAudioVAD bf16, the
    default encoder pooled to T frames (bench_modalities.py:81-94)."""
    wave = inputs[0]
    jm = JRawAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, out_frames=T,
                      dtype=jnp.bfloat16)
    variables = _jax_vars(jm, RawAudioVAD(lstm_hidden_size=H, lstm_layers=2, out_frames=T),
                          jnp.asarray(wave))
    ref = np.asarray(jax.nn.sigmoid(jax.jit(jm.apply)(variables, jnp.asarray(wave))),
                     np.float32)
    serve, args, _ = bench_modalities.audio_wavenet_config(
        B, T, torch.device("cpu"), from_flax_variables(variables), H, wave)
    got = serve(*args).numpy()
    assert got.shape == ref.shape == (B, T, 1)
    np.testing.assert_allclose(got, ref, atol=WAVENET_ATOL)


def test_modality_video_int8_matches_jax(video_vars, inputs):
    """bench_modalities' video configuration: VideoVAD bf16, the static-int8
    tower calibrated on 2 utterances (bench_modalities.py:97-126)."""
    _, video, idx = inputs
    jm = JVideoVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True,
                   dtype=jnp.bfloat16, tower_int8=True, tower_quant_mode="static")
    variables = _jcalibrate(jm.clone(tower_quant_mode="calibrate"), video_vars,
                            (jnp.asarray(video[:2]),), train=False,
                            video_frame_indices=jnp.asarray(idx))
    apply = jax.jit(lambda v, x: jm.apply(v, x, video_frame_indices=jnp.asarray(idx)))
    ref = np.asarray(jax.nn.sigmoid(apply(variables, jnp.asarray(video))), np.float32)
    serve, args, _ = bench_modalities.video_config(B, T, torch.device("cpu"), True,
                                                   from_flax_variables(video_vars), H, video)
    np.testing.assert_allclose(serve(*args).numpy(), ref, atol=BF16_VIDEO_ATOL)


def _tick(srv, chunk, vchunk=None):
    for i in range(srv.n):
        if vchunk is None:
            srv.feed(i, np.concatenate([chunk, chunk]))
        else:
            srv.feed(i, pcm=np.concatenate([chunk, chunk]), video_frames=vchunk)
    out = srv.tick(fetch=True)
    return np.stack([np.asarray(out[i]) for i in range(srv.n)])


def test_streaming_audio_server_matches_jax():
    """bench_streaming's audio server on the int16 span wire, 2 streams,
    one tick (bench_streaming.py:38-48)."""
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True)
    variables = _jax_vars(jm, AudioVAD(lstm_hidden_size=H, lstm_layers=2),
                          jnp.zeros((2, 16, 513)))
    chunk, chunk_i, _ = bench_streaming.stream_chunks(16)
    want = _tick(JMultiStreamVAD(jm, variables, 2, block_frames=16, native=False,
                                 span_wire=True, audio_int16=True), chunk_i)
    got = _tick(bench_streaming.make_server(2, 16, native=True, span_wire=True,
                                            audio_int16=True, device="cpu",
                                            state_dict=from_flax_variables(variables),
                                            lstm_hidden=H), chunk_i)
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=STREAM_ATOL)


def test_streaming_int8_u8_av_server_matches_jax(av_vars):
    """bench_streaming's AV server with the calibrated static-int8 tower
    and the uint8 video wire (fp32 model; scales from one block of
    default_rng(0) draws on both sides), 2 streams, one tick
    (bench_streaming.py:81-120)."""
    jm = JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                mcb_output_size=MCB_OUT, use_pallas_lstm=True, tower_int8=True,
                tower_quant_mode="static")
    variables = av_vars["int8"]
    rng = np.random.default_rng(0)
    cal_a = jnp.asarray(rng.normal(size=(1, 16, 513)).astype(np.float32))
    cal_v = jnp.asarray(rng.uniform(0, 255, size=(1, 16, 67, 67)).astype(np.float32))
    jvars = _jcalibrate(jm.clone(tower_quant_mode="calibrate", tower_pallas=False),
                        variables, (cal_a, cal_v), train=False)
    chunk, _, vchunk = bench_streaming.stream_chunks(16)
    want = _tick(JMultiStreamAVVAD(jm, jvars, 2, block_frames=16, video_uint8=True,
                                   native=False), chunk, vchunk)
    srv = bench_streaming.make_av_server(2, 16, int8=True, u8_wire=True, device="cpu",
                                         state_dict=from_flax_variables(variables),
                                         lstm_hidden=H, mcb_output_size=MCB_OUT)
    assert srv.model.tower.features.stages_pallas
    got = _tick(srv, chunk, vchunk)
    np.testing.assert_allclose(got, want, atol=STREAM_INT8_ATOL)


@pytest.mark.parametrize("modality, freeze", [("av", True), ("audio", False),
                                              ("video", False)])
def test_train_matrix_step_loss_matches_jax(av_vars, video_vars, modality, freeze):
    """One step of the train matrix (``build_train_bench``) against JAX's
    train step on bench.py's draws (bench.py:150-200; fp32, Adam 1e-4, the
    trunk frozen for AV): the loss within LOSS_RTOL. The JAX models take
    the Pallas LSTM (the port's training kernels round W_hh to bf16 as it
    does; bench.py's models take JAX's scan, about 1e-4 away). The AV and
    video weights are the serving fixtures' (their params are the fp32
    models' too)."""
    audio, video, label = bench.train_inputs(B, T)
    kw = dict(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_pallas_lstm=True)
    if modality == "audio":
        jm = JAudioVAD(**kw)
        variables = _jax_vars(jm, AudioVAD(lstm_hidden_size=H, lstm_layers=2, seed=3),
                              jnp.zeros((1, 4, 513)))
        batch_kw = {"audio": audio, "video": None}
    elif modality == "video":
        jm, variables = JVideoVAD(**kw), video_vars
        batch_kw = {"audio": None, "video": video}
    else:
        jm, variables = JAVVAD(**kw, use_mcb=True, mcb_output_size=MCB_OUT), av_vars["float"]
        batch_kw = {"audio": audio, "video": video}
    variables = {k: v for k, v in variables.items() if k != "quant"}
    tx = jmake_optimizer(1e-4, freeze_filter=jfreeze if freeze else None)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables.get("batch_stats"),
                        sketch=variables.get("sketch"), opt_state=tx.init(variables["params"]),
                        apply_fn=jm.apply, tx=tx)
    batch = JBatch(label=jnp.asarray(label), lengths=jnp.full((B,), T, jnp.int32),
                   mask=jnp.ones((B, T), jnp.float32),
                   **{k: None if v is None else jnp.asarray(v) for k, v in batch_kw.items()})
    _, metrics = jmake_train_step(modality, donate=False)(state, batch, None)
    tb = bench.build_train_bench(modality, freeze, B, T, H, torch.device("cpu"),
                                 state_dict=from_flax_variables(variables),
                                 mcb_output_size=MCB_OUT)
    _, got = tb.step(tb.state, tb.batch)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=LOSS_RTOL)
