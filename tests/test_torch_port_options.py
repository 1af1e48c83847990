"""CPU parity of the port's serving options with the JAX package: the int8
stem (``ResNet18.stem_int8``, ``tower_stem_int8``), ``stem_s2d``, the MCB
precision (``mcb_precision``) and the sketch fold (``fold_sketch_state_dict``).

Weights come from the JAX modules' init through
``convert.from_flax_variables``; frames, waveforms and features are seeded
numpy draws handed to both sides. JAX runs its unfused XLA int8 path (its
Pallas trunk is held against the port in tests/test_torch_port_int8.py);
the port runs both its unfused path and its fused one (the kernels' plain
versions on the CPU).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import ResNet18 as JResNet18
from avvad_tpu.models import mcb as jmcb
from avvad_tpu.models import resnet as jresnet
from avvad_tpu.models.quantize import calibrate as jcalibrate
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import (AVVAD, CompactBilinearPooling, ResNet18, VideoVAD, calibrate,
                                    fold_sketch_state_dict)
from avvad_tpu_torch.models.resnet import act_quant
from avvad_tpu_torch.ops.conv_fused import conv_exact

H, MCB_OUT = 16, 64
B, T = 2, 8
N_SAMPLES = 256 * (T - 1) + 1024
N_FRAMES = 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_corr(got, ref):
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    return rel, np.corrcoef(got.ravel(), ref.ravel())[0, 1]


def _frames(seed=0, n=N_FRAMES):
    """Lip frames as served: pixel values in [0, 255]."""
    return np.random.default_rng(seed).uniform(0, 255, size=(n, 67, 67)).astype(np.float32)


# -- the int8 stem --------------------------------------------------------------


@pytest.fixture(scope="module")
def stem_int8():
    """A JAX gray ResNet18 with the W8A8 stem, calibrated by JAX, and the
    port's twin calibrated by the port on the same frames."""
    x = jnp.asarray(_frames())[..., None]
    cal = JResNet18(gray_input=True, quant_int8=True, quant_mode="calibrate", stem_int8=True)
    init = _np_tree(cal.init(jax.random.PRNGKey(0), x))
    jvars = _np_tree(jcalibrate(cal, init, [(x,)]))
    port = ResNet18(quant_int8=True, quant_mode="calibrate", stem_int8=True)
    port.load_state_dict(from_flax_variables(init), strict=True)
    calibrate(port, [_t(_frames())[:, None]])
    return jvars, port


def test_stem_int8_calibrates_q_in_as_jax(stem_int8):
    """The same calibration fills ``q_in`` (the raw input's max |x|, exact)
    and ``q_stem``; the stem's int32 sums are exact on both sides, so
    q_stem agrees to the fp32 BatchNorm's rounding (measured 6.2e-8
    relative, held at 1e-5)."""
    jvars, port = stem_int8
    jq = jvars["quant"]
    assert float(port.q_in) == float(jq["q_in"]) == float(np.abs(_frames()).max())
    np.testing.assert_allclose(float(port.q_stem), float(jq["q_stem"]), rtol=1e-5)


@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_stem_int8_conv_bit_exact_against_jax(stem_int8, gray):
    """The W8A8 stem alone (quantised input, int8 kernel summed over its
    input channels when gray, dequantised output) against JAX's
    ``_StemInt8`` on the same kernel and input: the int32 sums are exact and
    the dequantisation is the same two float32 products, so the outputs
    are equal."""
    jvars, port = stem_int8
    kernel = jvars["params"]["conv1"]["kernel"]
    cin = 1 if gray else 3
    x = np.random.default_rng(1).uniform(0, 255, size=(N_FRAMES, 67, 67, cin))
    scale = np.float32(255.0 / 127.0)
    x_q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    ref = np.asarray(jresnet._StemInt8(gray=gray).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x_q), jnp.float32(scale)))
    stem = ResNet18(gray_input=gray, quant_int8=True, stem_int8=True).conv1
    stem.weight.data.copy_(port.conv1.weight.data)
    with torch.no_grad():
        got = stem.forward_int8(_t(x_q.transpose(0, 3, 1, 2)), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), ref)


def test_fp32_route_of_the_int8_stem_is_exact():
    """The card's route for the int8 stem: an fp32 convolution rounded to the
    nearest integer. At the largest magnitudes an int8 input and kernel can
    take (every product 127 * 127, 49 or 147 taps) every sum stays below
    2^24, so it equals the float64 convolution, RGB and gray."""
    g = torch.Generator().manual_seed(0)
    for cin in (1, 3):
        x = torch.randint(-127, 128, (3, cin, 67, 67), generator=g, dtype=torch.int8)
        x[0] = 127
        w = torch.randint(-127, 128, (64, cin, 7, 7), generator=g, dtype=torch.int8)
        w[0] = 127
        ref = conv_exact(x, w, 2, 3)
        assert ref.abs().max().item() == 127 * 127 * 49 * cin
        got = torch.round(F.conv2d(x.float(), w.float(), stride=2, padding=3))
        assert torch.equal(got, ref)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_stem_int8_trunk_matches_jax(stem_int8, fused):
    """The static-int8 trunk with the int8 stem against JAX's (XLA) from the
    same calibrated scales: unfused, and fused (K3 then 8 x K2, plain). JAX's
    bar for its int8 trunks (tests/test_conv_pallas.py:152-155): rel < 0.02,
    corr > 0.999; the stem agrees exactly, one-LSB flips on rounding ties
    start in the blocks (tests/test_torch_port_int8.py). Measured rel 0.0058,
    corr 0.99996 on both routes."""
    jvars, _ = stem_int8
    port = ResNet18(quant_int8=True, quant_mode="static", stem_int8=True,
                    stages_pallas=fused).eval()
    port.load_state_dict(from_flax_variables(jvars), strict=True)
    x = _frames(seed=2)
    ref = np.asarray(JResNet18(gray_input=True, quant_int8=True, quant_mode="static",
                               stem_int8=True).apply(jvars, jnp.asarray(x)[..., None]))
    with torch.no_grad():
        got = port(_t(x)[:, None]).numpy()
    rel, corr = _rel_corr(got, ref)
    assert rel < 0.02 and corr > 0.999, (rel, corr)


def test_tower_stem_int8_option():
    """``tower_stem_int8`` reaches the trunk of a VideoVAD and an AVVAD."""
    for cls, kw in ((VideoVAD, {}), (AVVAD, {"mcb_output_size": MCB_OUT})):
        model = cls(lstm_hidden_size=H, lstm_layers=1, tower_int8=True,
                    tower_stem_int8=True, **kw)
        assert model.tower.features.stem_int8
        assert "tower.features.q_in" in model.state_dict()
        assert not cls(lstm_hidden_size=H, lstm_layers=1, tower_int8=True,
                       **kw).tower.features.stem_int8


def test_stem_options_are_exclusive():
    with pytest.raises(ValueError, match="exclusive"):
        ResNet18(quant_int8=True, stem_int8=True, stem_s2d=True)
    with pytest.raises(ValueError, match="requires quant_int8"):
        ResNet18(stem_int8=True)


def test_converter_carries_q_in(stem_int8):
    jvars, _ = stem_int8
    state = from_flax_variables(jvars)
    assert float(state["q_in"]) == float(jvars["quant"]["q_in"])
    port = ResNet18(quant_int8=True, stem_int8=True)
    port.load_state_dict(state, strict=True)
    assert float(port.q_in) == float(jvars["quant"]["q_in"])


@pytest.fixture(scope="module")
def av_stem_int8():
    """The JAX fp32 AVVAD with the int8 stem, initialised in calibrate mode
    and calibrated by JAX, and the port's AVVAD calibrated by the port's
    ``calibrate`` on the same frames."""
    rng = np.random.default_rng(4)
    video = rng.uniform(0, 255, size=(B, T, 67, 67)).astype(np.float32)
    audio = jnp.zeros((B, T, 513))
    kw = dict(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT, tower_int8=True,
              tower_stem_int8=True)
    cal = JAVVAD(**kw, tower_quant_mode="calibrate")
    init = _np_tree(cal.init(jax.random.PRNGKey(1), audio, jnp.asarray(video)))
    jvars = _np_tree(jcalibrate(cal, init, [(audio, jnp.asarray(video))], train=False))
    port = AVVAD(**kw, tower_quant_mode="static", tower_pallas=True, use_kernel_lstm=True)
    port.load_state_dict(from_flax_variables(init), strict=True)
    calibrate(port, [(torch.zeros(B, T, 513), _t(video))])
    return kw, jvars, port, video


def test_av_calibrate_fills_q_in_as_jax(av_stem_int8):
    _, jvars, port, video = av_stem_int8
    q_in = float(jvars["quant"]["tower"]["features"]["q_in"])
    assert float(port.tower.features.q_in) == q_in == float(np.abs(video).max())


def test_int8_stem_serving_step_matches_jax(av_stem_int8):
    """The fp32 serving step with the int8 stem on the static-int8 fused
    tower and the kernel LSTM (the port's plain versions) against JAX's
    XLA int8 tower from the same calibrated scales; probabilities within
    1e-4 (tests/test_torch_port_int8.py's bar for the same step; measured
    1.4e-5)."""
    kw, jvars, port, video = av_stem_int8
    wave = np.random.default_rng(5).normal(size=(B, N_SAMPLES)).astype(np.float32)
    jm = JAVVAD(**kw, tower_quant_mode="static")
    p_j = np.asarray(jmake_serving_fn(jm, jvars, t_frames=T)(jnp.asarray(wave),
                                                              jnp.asarray(video)))
    fn = make_waveform_serving_fn(port, t_frames=T, device="cpu")
    p_t = fn(wave, video).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)


# -- stem_s2d -------------------------------------------------------------------


def test_stem_s2d_matches_jax():
    """``stem_s2d`` keeps the JAX option's (7, 7, 3, 64) kernel and runs the
    plain 7x7/2 convolution, which the space-to-depth rewrite equals: RGB
    trunk features against JAX's s2d trunk at fp32 summation order
    (measured 5.6e-7 relative L2, JAX's s2d against its plain conv 2.2e-7;
    held at 1e-5)."""
    x = (_frames(seed=6)[..., None] / 255.0).repeat(3, axis=-1)
    jm = JResNet18(gray_input=False, stem_s2d=True)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    assert jvars["params"]["conv1"]["kernel"].shape == (7, 7, 3, 64)
    ref = np.asarray(jm.apply(jvars, jnp.asarray(x)))
    plain = np.asarray(JResNet18(gray_input=False).apply(jvars, jnp.asarray(x)))
    port = ResNet18(gray_input=False, stem_s2d=True).eval()
    port.load_state_dict(from_flax_variables(jvars), strict=True)
    with torch.no_grad():
        got = port(_t(x.transpose(0, 3, 1, 2))).numpy()
    assert np.linalg.norm(plain - ref) / np.linalg.norm(ref) < 1e-5
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


# -- MCB precision --------------------------------------------------------------


def _bf16_operand_matmul(a, b, precision=None, preferred_element_type=None):
    """JAX's matmul with the TPU's DEFAULT product made explicit: at
    DEFAULT the operands are rounded to bf16 and multiplied at HIGHEST
    (exact products, fp32 sums); every other call is unchanged."""
    if precision == jax.lax.Precision.DEFAULT:
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
        precision = jax.lax.Precision.HIGHEST
    return jnp.matmul(a, b, precision=precision,
                      preferred_element_type=preferred_element_type)


@pytest.fixture
def tpu_default(monkeypatch):
    """The JAX MCB module with its DEFAULT matmuls as the TPU computes them
    (JAX's CPU DEFAULT is plain fp32)."""
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.matmul = _bf16_operand_matmul
    monkeypatch.setattr(jmcb, "jnp", shim)


@pytest.mark.parametrize("folded_vars", [False, True], ids=["plain", "folded"])
def test_mcb_default_precision_matches_jax(tpu_default, folded_vars):
    """``precision="default"`` against JAX at DEFAULT with the operands of
    each MCB matmul rounded to bf16 (the sketch fold stays full precision
    on both sides). Both sum exact products in fp32, possibly in other
    orders, and an fp32 difference could move the bf16 rounding of an
    intermediate by one bf16 ulp: measured 0, held at 1e-4 of the output's
    largest value; "highest" is 4.3e-3 away."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, T, 513)).astype(np.float32)
    y = np.abs(rng.normal(size=(B, T, 512))).astype(np.float32)
    jm = jmcb.CompactBilinearPooling(513, 512, MCB_OUT, precision=jax.lax.Precision.DEFAULT,
                                     folded_vars=folded_vars)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y)))
    ref = np.asarray(jm.apply(jvars, jnp.asarray(x), jnp.asarray(y)))
    out = {}
    for prec in ("default", "highest"):
        port = CompactBilinearPooling(513, 512, MCB_OUT, precision=prec,
                                      folded_vars=folded_vars)
        port.load_state_dict({k: _t(v) for k, v in jvars["sketch"].items()}, strict=False)
        port.refold()
        out[prec] = port(_t(x), _t(y)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out["default"] - ref).max() / scale < 1e-4
    assert np.abs(out["highest"] - ref).max() / scale > 4 * np.abs(out["default"] - ref).max() / scale


def test_avvad_mcb_precision_default_serving_matches_jax(tpu_default):
    """The AV serving step with ``mcb_precision="default"`` against JAX's
    with ``Precision.DEFAULT`` as the TPU computes it: probabilities within
    1e-4 (measured 2.3e-6; the JAX bench moved its probabilities by 2.3e-6
    between DEFAULT and HIGHEST, bench.py:383-384)."""
    rng = np.random.default_rng(8)
    wave = rng.normal(size=(B, N_SAMPLES)).astype(np.float32)
    video = rng.normal(size=(B, T, 67, 67)).astype(np.float32)
    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT,
                mcb_precision=jax.lax.Precision.DEFAULT)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, 513)),
                             jnp.zeros((1, 4, 67, 67))))
    p_j = np.asarray(jmake_serving_fn(jm, jvars, t_frames=T)(jnp.asarray(wave),
                                                             jnp.asarray(video)))
    port = AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT,
                 mcb_precision="default")
    port.load_state_dict(from_flax_variables(jvars), strict=True)
    p_t = make_waveform_serving_fn(port, t_frames=T, device="cpu")(wave, video).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)
    with pytest.raises(ValueError, match="mcb precision"):
        AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT,
              mcb_precision="high")


# -- the sketch fold ------------------------------------------------------------


def test_fold_sketch_state_dict_matches_jax():
    """``fold_sketch_state_dict`` of a plain AVVAD state dict equals the
    converted ``fold_sketch_collection`` of the JAX variables (both fold in
    float64 on the host), loads strictly into ``mcb_folded_vars=True``, and
    the folded model serves what the plain one does and what JAX's folded
    model serves (the plain one folds in fp32: measured 0 and 0, held at
    1e-5)."""
    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT)
    jvars = _np_tree(jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 4, 513)),
                             jnp.zeros((1, 4, 67, 67))))
    plain_state = from_flax_variables(jvars)
    folded = fold_sketch_state_dict(plain_state)
    jfolded = from_flax_variables(_np_tree(jmcb.fold_sketch_collection(jvars)))
    assert folded.keys() == jfolded.keys()
    for key in ("mcb.sketch1", "mcb.sketch2"):
        assert folded[key].shape == (2, plain_state[key].shape[0], MCB_OUT // 2 + 1)
        torch.testing.assert_close(folded[key], jfolded[key], rtol=0, atol=0)
    assert fold_sketch_state_dict(folded)["mcb.sketch1"] is folded["mcb.sketch1"]
    assert plain_state["mcb.sketch1"].ndim == 2  # the input is left as it was
    rng = np.random.default_rng(9)
    wave = rng.normal(size=(B, N_SAMPLES)).astype(np.float32)
    video = rng.normal(size=(B, T, 67, 67)).astype(np.float32)
    probs = {}
    for folded_vars, state in ((False, plain_state), (True, folded)):
        model = AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT,
                      mcb_folded_vars=folded_vars)
        model.load_state_dict(state, strict=True)
        probs[folded_vars] = make_waveform_serving_fn(model, t_frames=T, device="cpu")(
            wave, video).numpy()
    np.testing.assert_allclose(probs[True], probs[False], atol=1e-5)
    jfm = JAVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT,
                 mcb_folded_vars=True)
    p_j = np.asarray(jmake_serving_fn(jfm, jmcb.fold_sketch_collection(jvars), t_frames=T)(
        jnp.asarray(wave), jnp.asarray(video)))
    np.testing.assert_allclose(probs[True], p_j, atol=1e-5)


def test_act_quant_of_the_raw_input_keeps_zero_padding_exact():
    """The int8 stem quantises the raw fp32 input symmetrically, so the
    conv's zero padding is the quantised zero."""
    q, s = act_quant(torch.zeros(1, 1, 4, 4), torch.tensor(255.0), "static")
    assert torch.equal(q, torch.zeros_like(q)) and float(s) == pytest.approx(255.0 / 127)


def test_calibrate_quant_scales_fills_q_in():
    """evaluate.calibrate_quant_scales goes through the same calibration as
    models.quantize.calibrate: on the same normalised utterances it fills
    q_in (the largest |normalised pixel|) and every other scale alike."""
    import copy

    from avvad_tpu_torch.evaluate import calibrate_quant_scales
    from avvad_tpu_torch.train import create_train_state

    rng = np.random.default_rng(10)
    source = [{"audio": rng.normal(size=(6, 513)).astype(np.float32),
               "video": rng.uniform(0, 255, size=(6, 67, 67)).astype(np.float32),
               "label": np.zeros((6, 1), np.float32), "length": 6} for _ in range(2)]
    stats = {"video_mean": np.float32(100.0), "video_std": np.float32(50.0)}
    model = AVVAD(lstm_hidden_size=H, lstm_layers=1, mcb_output_size=MCB_OUT, tower_int8=True,
                  tower_quant_mode="static", tower_pallas=True, tower_stem_int8=True)
    twin = copy.deepcopy(model)
    state = create_train_state(model, device="cpu")
    calibrate_quant_scales(state, model, source, "av", norm_stats=stats, n_utts=2,
                           batch_size=2, bucket=8)
    video = (np.stack([u["video"] for u in source]) - 100.0) / (50.0 + 1e-8)
    assert float(model.tower.features.q_in) == pytest.approx(float(np.abs(video).max()),
                                                             rel=1e-6)
    calibrate(twin, [(_t(np.stack([u["audio"] for u in source])),
                      _t(video.astype(np.float32)))])
    for (name, got), want in zip(model.named_buffers(), twin.buffers()):
        if name.split(".")[-1] in ("q_in", "q_stem", "q1", "q_out"):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)
