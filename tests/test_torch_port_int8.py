"""CPU parity of the port's static-int8 video tower with the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU; the port runs its kernels' plain versions (``basic_block_int8``
and ``stem_epilogue_pool_quant`` on CPU tensors). Weights come from the JAX
modules' init through ``convert.from_flax_variables``; inputs from numpy.
The JAX calibration and the JAX Pallas trunk are the slow parts, so they
live in module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import ResNet18 as JResNet18
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.models.quantize import calibrate as jcalibrate
from avvad_tpu.ops import conv_pallas as jcp
from avvad_tpu.ops.qparams import weight_qparams as jweight_qparams
from avvad_tpu.ops.stem_pallas import stem_epilogue_pool_quant as jstem
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import AVVAD, VideoVAD, calibrate
from avvad_tpu_torch.models.resnet import act_quant, max_pool_i8, static_scale
from avvad_tpu_torch.ops import conv_fused, stem_fused

H, MCB_OUT = 16, 256          # small LSTM and MCB widths
B, T, T_SRC = 2, 8, 4
FRAME_IDX = np.array([0, 0, 1, 1, 2, 2, 3, 3])
N_SAMPLES = 256 * (T - 1) + 1024
QNAMES = ("q_stem", "q1", "q_out")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_corr(got, ref):
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    return rel, np.corrcoef(got.ravel(), ref.ravel())[0, 1]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"wave": rng.normal(size=(B, N_SAMPLES)).astype(np.float32),
            "video": rng.normal(size=(B, T_SRC, 67, 67)).astype(np.float32),
            "frames": rng.normal(size=(4, 67, 67)).astype(np.float32)}


@pytest.fixture(scope="module")
def calibrated(inputs):
    """The JAX fp32 AVVAD (int8 tower) initialised in calibrate mode, then
    calibrated by the JAX and by the port's ``calibrate`` on the same
    frames -> (JAX variables after calibration, the port model, the JAX
    variables before calibration)."""
    audio = jnp.zeros((B, T, 513))
    video = jnp.asarray(inputs["video"])
    cal = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                 tower_int8=True, tower_quant_mode="calibrate")
    init = _np_tree(cal.init(jax.random.PRNGKey(0), audio, video,
                             video_frame_indices=jnp.asarray(FRAME_IDX)))
    jvars = _np_tree(jcalibrate(cal, init, [(audio, video)], train=False,
                                video_frame_indices=jnp.asarray(FRAME_IDX)))
    port = _port_avvad(init, tower_quant_mode="calibrate")
    calibrate(port, [(torch.zeros(B, T, 513), _t(inputs["video"]))],
              video_frame_indices=_t(FRAME_IDX))
    return jvars, port, init


def _port_avvad(variables, **kw):
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                  tower_int8=True, **kw)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model.eval()


def _trunk_vars(jvars):
    return {col: jvars[col]["tower"]["features"]
            for col in ("params", "batch_stats", "quant")}


@pytest.fixture(scope="module")
def jax_trunk(calibrated, inputs):
    """JAX static-int8 trunk features of the 4 test frames from the
    calibrated variables: the fused Pallas stages (interpret) and XLA's
    unfused int8 path."""
    jvars = _trunk_vars(calibrated[0])
    x = jnp.asarray(inputs["frames"])[..., None]
    return {pallas: np.asarray(JResNet18(gray_input=True, quant_int8=True,
                                         quant_mode="static",
                                         stages_pallas=pallas).apply(jvars, x))
            for pallas in (True, False)}


def _port_trunk(jvars, pallas):
    model = _port_avvad(jvars, tower_quant_mode="static", tower_pallas=pallas)
    return model.tower.features


# -- module 1: per-output-channel weight quantisation of OIHW conv weights --


def test_conv_weight_qparams_match_jax_on_hwio_view():
    """The port quantises its OIHW weights through the HWIO view, which
    gives JAX's ints and per-Cout scales exactly; quantising OIHW directly
    would give per-W-column scales (the pitfall the view avoids)."""
    w = np.random.default_rng(5).normal(size=(3, 3, 32, 48)).astype(np.float32)
    wq_j, ws_j = map(np.asarray, jweight_qparams(jnp.asarray(w)))
    wq_t, ws_t = conv_fused.quant_hwio(_t(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(wq_t.numpy(), wq_j)
    np.testing.assert_array_equal(ws_t.numpy(), ws_j)
    from avvad_tpu_torch.ops.qparams import weight_qparams
    assert weight_qparams(_t(w.transpose(3, 2, 0, 1)))[1].shape == (3,)


# -- module 2: int8 helpers ---------------------------------------------------


def test_act_quant_modes_and_int8_max_pool():
    """dynamic == calibrate on the same tensor, calibrate records the
    running max, static uses the record; the -128-padded int8 max pool
    equals the float pool of the dequantised values."""
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(2, 8, 9, 9)).astype(np.float32))
    buf = torch.zeros(())
    q_dyn, s_dyn = act_quant(x, buf.clone(), "dynamic")
    q_cal, s_cal = act_quant(x, buf, "calibrate")
    assert torch.equal(q_dyn, q_cal) and torch.equal(s_dyn, s_cal)
    assert buf.item() == x.abs().max().item()
    act_quant(x * 0.5, buf, "calibrate")
    assert buf.item() == x.abs().max().item()  # a running max
    q_st, s_st = act_quant(x * 0.5, buf, "static")
    assert torch.equal(s_st, static_scale(buf))
    assert torch.equal(q_st, torch.clamp(torch.round(x * 0.5 / s_st), -127, 127).to(torch.int8))
    assert q_dyn.abs().max().item() == 127
    pooled = max_pool_i8(q_dyn)
    ref = torch.nn.functional.max_pool2d(q_dyn.float(), 3, 2, padding=1)
    assert pooled.dtype == torch.int8 and torch.equal(pooled.float(), ref)


# -- K2: the fused block, plain version vs the JAX Pallas kernel ---------------


def _rand_bn(rng, c):
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.normal(size=c) * 0.5).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return params, stats


@pytest.mark.parametrize("stride, cin, cout, seed", [
    (1, 32, 32, 0),   # identity residual
    (2, 32, 64, 1),   # stride-2 downsample
    (1, 32, 64, 2),   # stride-1 channel change
])
def test_basic_block_plain_matches_pallas(stride, cin, cout, seed):
    """tests/test_conv_pallas.py:72-121 on the port: the same folded block
    through the JAX Pallas kernel (interpret; planes converted to NHWC here)
    and the port's ``basic_block_int8`` (plain on the CPU), h = 5, n = 16.
    Bar: <= 1 LSB, < 1 % flipped: the folded vectors differ by an ulp
    (XLA's rsqrt against torch's). Measured: exact for the identity and
    stride-2 cases, one LSB on 3.9e-5 of the outputs for the channel
    change. The port's channels must be multiples of 32, the kernel's K
    step."""
    h, n = 5, 16
    rng = np.random.default_rng(seed)
    conv = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    params = {"conv1": {"kernel": conv(3, 3, cin, cout)},
              "conv2": {"kernel": conv(3, 3, cout, cout)}}
    stats = {}
    params["bn1"], stats["bn1"] = _rand_bn(rng, cout)
    params["bn2"], stats["bn2"] = _rand_bn(rng, cout)
    if stride != 1 or cin != cout:
        params["downsample_conv"] = {"kernel": conv(1, 1, cin, cout)}
        params["downsample_bn"], stats["downsample_bn"] = _rand_bn(rng, cout)
    x_q = rng.integers(-127, 128, size=(n, h, h, cin)).astype(np.int8)
    x_scale, q1_s = np.float32(0.05), np.float32(0.04)
    qo_s = np.float32(2.5 * q1_s)

    spec_j = jcp.fold_block(x_scale, params, stats, q1_s, qo_s)
    got_planes = np.asarray(jcp.basic_block_int8(
        jcp.nhwc_to_planes(jnp.asarray(x_q)), spec_j["w1"], spec_j["a1"],
        spec_j["b1"], spec_j["w2"], spec_j["a2"], spec_j["b2"],
        wd=spec_j.get("wd"), ad=spec_j.get("ad"), bd=spec_j.get("bd"),
        res_scale=spec_j.get("res_scale"), H=h, W=h, stride=stride, tn=8))
    ho = (h - 1) // stride + 1
    ref = got_planes.reshape(ho + 2, ho + 2, cout, n)[1:-1, 1:-1].transpose(3, 0, 1, 2)

    tparams = {k: _t(v["kernel"].transpose(3, 2, 0, 1))
               for k, v in params.items() if "conv" in k}
    for bn in ("bn1", "bn2", "downsample_bn"):
        if bn in params:
            tparams[bn] = tuple(_t(a) for a in (params[bn]["scale"], params[bn]["bias"],
                                                stats[bn]["mean"], stats[bn]["var"]))
    spec = conv_fused.fold_block(torch.tensor(x_scale), tparams, torch.tensor(q1_s),
                                 torch.tensor(qo_s))
    # the folded vectors: jax.lax.rsqrt and torch.rsqrt may differ by an
    # ulp, carried through three float32 products (measured 7e-6 relative)
    for k in ("a1", "b1", "a2", "b2", "ad", "bd", "res_scale"):
        if k in spec:
            np.testing.assert_allclose(spec[k].numpy(), np.asarray(spec_j[k]).reshape(
                spec[k].shape), rtol=1e-5)
    for k in ("w1", "w2", "wd"):
        if k in spec:  # same ints; JAX packs (3, Cout, 3Cin) / (Cout, Cin)
            wj = np.asarray(spec_j[k])
            if k != "wd":
                wj = wj.reshape(3, cout, 3, -1).transpose(1, 0, 2, 3).reshape(cout, -1)
            np.testing.assert_array_equal(spec[k].numpy(), wj)
    got = conv_fused.basic_block_int8(_t(x_q), *conv_fused._block_args(spec),
                                      stride=stride).numpy()
    assert got.shape == ref.shape == (n, ho, ho, cout) and got.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 1).mean() < 0.01


# -- K3: the stem epilogue, plain version vs the JAX Pallas kernel -------------


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_stem_epilogue_plain_matches_pallas_exactly(layout):
    """tests/test_models.py:585-599 on the port, N = 37, C = 64: bit-identical,
    for an NHWC (channels-last) and an NCHW input."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 34, 34, 64)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    ref = np.asarray(jstem(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    xt = _t(x).permute(0, 3, 1, 2)
    if layout == "nchw":
        xt = xt.contiguous()
    got = stem_fused.stem_epilogue_pool_quant(xt, _t(a), _t(b)).numpy()
    assert got.shape == (37, 17, 17, 64)
    np.testing.assert_array_equal(got, ref)


def test_fold_stem_matches_unfused_stem(calibrated, inputs):
    """fold_stem + the stem epilogue against the unfused stem (BatchNorm,
    ReLU, static act_quant, int8 max pool) on the same stem conv output:
    the folded affine reassociates float32, so within one LSB."""
    from avvad_tpu_torch.models.resnet import _bn_int8

    trunk = _port_trunk(calibrated[0], pallas=True)
    with torch.no_grad():
        stem = trunk.conv1(_t(inputs["frames"])[:, None])
        a, b = stem_fused.fold_stem(trunk.bn1, trunk.q_stem)
        fused = stem_fused.stem_epilogue_pool_quant(stem, a, b)
        q, _ = act_quant(torch.relu(_bn_int8(trunk.bn1, stem)), trunk.q_stem, "static")
        unfused = max_pool_i8(q).permute(0, 2, 3, 1)
    diff = (fused.int() - unfused.int()).abs()
    assert diff.max().item() <= 1 and diff.float().mean().item() < 0.01


# -- calibration, trunk and tower -----------------------------------------------


def test_calibrate_matches_jax(calibrated):
    """Every scale of the port's ``calibrate`` against JAX ``calibrate`` on
    the same fp32 weights and frames. Measured: 15 of the 17 within 4e-7
    relative; layer4_1's q1 and q_out 9.0e-4 and 8.3e-5. XLA's CPU rsqrt in
    the BatchNorm differs from torch's by an ulp, which flips a value that
    sits on a rounding tie (54.5 against 54.50001) by one LSB in layer1_0;
    the flip spreads through the later blocks and moves layer4's maxima
    over these 8 frames x 9 pixels. Held: all 17 at 1e-3, at least 15 at
    1e-5."""
    jvars, port, _ = calibrated
    state = port.state_dict()
    jq = from_flax_variables({"quant": jvars["quant"]})
    assert len(jq) == 17
    rel = {}
    for key, want in jq.items():
        assert key.split(".")[-1] in QNAMES and want.item() > 0
        rel[key] = abs(state[key].item() / want.item() - 1.0)
    assert max(rel.values()) < 1e-3, rel
    assert sum(r < 1e-5 for r in rel.values()) >= 15, rel


def test_calibrate_restores_mode_and_static_stays_put(calibrated, inputs):
    """calibrate runs the unfused path and puts the mode back; a static
    forward does not move the scales."""
    _, port, _ = calibrated
    trunk = port.tower.features
    assert trunk.quant_mode == "calibrate" and not trunk.stages_pallas
    before = {k: v.clone() for k, v in port.state_dict().items() if "q" in k}
    trunk.quant_mode = "static"
    try:
        with torch.no_grad():
            trunk(_t(inputs["frames"])[:, None] * 3.0)
    finally:
        trunk.quant_mode = "calibrate"
    after = port.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "unfused"])
def test_int8_trunk_matches_jax(calibrated, jax_trunk, inputs, pallas):
    """The port's static-int8 trunk against JAX ``ResNet18`` from the same
    calibrated variables, N = 4 frames at 67x67: fused (port K3 + 8 x K2,
    plain) vs JAX ``stages_pallas=True`` (interpret), and unfused vs JAX's
    XLA int8 path. JAX's bar (tests/test_conv_pallas.py:152-155): rel <
    0.02, corr > 0.999. Measured: rel 0.0063 / corr 0.99996 (fused) and
    rel 0.0067 / corr 0.99995 (unfused): the stem conv and the int32 sums
    agree exactly; one-LSB flips on rounding ties (XLA's rsqrt in the
    BatchNorm, see test_calibrate_matches_jax) start in layer1_0 and
    spread through the later blocks by one to three LSB."""
    trunk = _port_trunk(calibrated[0], pallas)
    with torch.no_grad():
        got = trunk(_t(inputs["frames"])[:, None]).numpy()
    ref = jax_trunk[pallas]
    assert got.shape == ref.shape == (4, 512)
    rel, corr = _rel_corr(got, ref)
    assert rel < 0.02 and corr > 0.999, (rel, corr)


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "unfused"])
def test_int8_tower_close_to_float_tower(calibrated, inputs, pallas):
    """The port's static-int8 trunk against its float trunk on the same
    weights and frames: JAX's bar (tests/test_models.py:419-422), rel <
    0.05, corr > 0.995. Measured: rel 0.0149 / corr 0.99976 (fused) and
    0.0148 / 0.99976 (unfused)."""
    from avvad_tpu_torch.models import ResNet18

    jvars = calibrated[0]
    float_trunk = ResNet18()
    float_trunk.load_state_dict({
        k[len("tower.features."):]: v for k, v in from_flax_variables(jvars).items()
        if k.startswith("tower.features.") and k.split(".")[-1] not in QNAMES})
    frames = _t(inputs["frames"])[:, None]
    with torch.no_grad():
        ref = float_trunk.eval()(frames).numpy()
        got = _port_trunk(jvars, pallas)(frames).numpy()
    rel, corr = _rel_corr(got, ref)
    assert rel < 0.05 and corr > 0.995, (rel, corr)


def test_static_int8_chunks_match_single_pass(calibrated, inputs):
    """``chunk`` stays valid for the static int8 tower: frames are
    independent and the scales fixed, so the chunked features are equal."""
    port = _port_avvad(calibrated[0], tower_quant_mode="static", tower_pallas=True)
    video = _t(inputs["video"])
    with torch.no_grad():
        whole = port.tower(video)
        port.tower.chunk = 3
        chunked = port.tower(video)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


# -- serving, VideoVAD, converter -----------------------------------------------


def test_int8_serving_step_matches_jax(calibrated, inputs):
    """The fp32 waveform serving step with the static-int8 fused tower and
    the kernel LSTM on both sides (JAX: Pallas trunk and LSTM, interpret;
    the port: the kernels' plain versions), from the same calibrated
    variables. Probabilities within 1e-4 (measured 1.2e-7: the tower's
    one-LSB tie flips move its features by about 1e-4 relative, and MCB's
    global L2 norm and BatchNorm damp them)."""
    jvars = calibrated[0]
    kw = dict(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
              tower_int8=True, tower_quant_mode="static")
    jm = JAVVAD(**kw, tower_pallas=True, use_pallas_lstm=True)
    p_j = np.asarray(jmake_serving_fn(
        jm, jvars, t_frames=T, video_frame_indices=jnp.asarray(FRAME_IDX))(
            jnp.asarray(inputs["wave"]), jnp.asarray(inputs["video"])))
    port = _port_avvad(jvars, tower_quant_mode="static", tower_pallas=True,
                       use_kernel_lstm=True)
    fn = make_waveform_serving_fn(port, t_frames=T, video_frame_indices=FRAME_IDX,
                                  device="cpu")
    p_t = fn(inputs["wave"], inputs["video"]).numpy()
    assert p_t.shape == (B, T, 1)
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)


@pytest.fixture(scope="module")
def video_vad(calibrated):
    """JAX VideoVAD (static-int8 fused tower, Pallas LSTM) whose tower
    variables are the calibrated AVVAD tower's, and the port's twin."""
    jvars = calibrated[0]
    jm = JVideoVAD(lstm_hidden_size=H, lstm_layers=2, tower_int8=True,
                   tower_quant_mode="static", tower_pallas=True,
                   use_pallas_lstm=True)
    init = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((B, T_SRC, 67, 67)),
                            video_frame_indices=jnp.asarray(FRAME_IDX)))
    variables = {col: {**init.get(col, {}), "tower": jvars[col]["tower"]}
                 for col in ("params", "batch_stats", "quant")}
    port = VideoVAD(lstm_hidden_size=H, lstm_layers=2, tower_int8=True,
                    tower_quant_mode="static", tower_pallas=True,
                    use_kernel_lstm=True)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jm, variables, port.eval()


@pytest.mark.parametrize("return_last", [False, True])
def test_video_vad_matches_jax(video_vad, inputs, return_last):
    """VideoVAD logits over the camera-rate gather, and at each sequence's
    last valid step with ``return_last``. Measured max |diff| 1.9e-4 (all
    steps) and 5.2e-5 (last steps): the int8 tower's features agree to rel
    1.2e-4 (the one-LSB tie flips of test_int8_trunk_matches_jax), and
    here they reach the head without MCB or normalisation. Held at 1e-3."""
    jm, variables, port = video_vad
    lengths = np.array([5, T])
    kw = {"lengths": jnp.asarray(lengths)} if return_last else {}
    out_j = np.asarray(jm.apply(variables, jnp.asarray(inputs["video"]),
                                return_last=return_last,
                                video_frame_indices=jnp.asarray(FRAME_IDX), **kw))
    with torch.no_grad():
        out_t = port(_t(inputs["video"]), lengths=_t(lengths), return_last=return_last,
                     video_frame_indices=_t(FRAME_IDX)).numpy()
    assert out_t.shape == ((B, 1) if return_last else (B, T, 1))
    np.testing.assert_allclose(out_t, out_j, atol=1e-3)


def test_video_vad_serving_fn(video_vad, inputs):
    """The VideoVAD branch of make_waveform_serving_fn: sigmoid of the
    logits, with the video normalisation; held at 1e-3 as the logits."""
    jm, variables, port = video_vad
    stats = {"video_mean": np.float32(0.1), "video_std": np.float32(1.3)}
    p_j = np.asarray(jmake_serving_fn(jm, variables, t_frames=T, norm_stats=stats,
                                      video_frame_indices=jnp.asarray(FRAME_IDX))(
        jnp.asarray(inputs["video"])))
    fn = make_waveform_serving_fn(port, norm_stats=stats, video_frame_indices=FRAME_IDX,
                                  device="cpu")
    p_t = fn(inputs["video"]).numpy()
    assert p_t.shape == (B, T, 1)
    np.testing.assert_allclose(p_t, p_j, atol=1e-3)


def test_converter_round_trip_with_quant(calibrated, video_vad):
    """The quant collection becomes 0-d float32 buffers under the same
    dotted paths; AVVAD and VideoVAD trees load strictly, and a float
    model's tree lacks them (strict load of an int8 model then fails)."""
    jvars, _, _ = calibrated
    state = from_flax_variables(jvars)
    port = _port_avvad(jvars, tower_quant_mode="static")
    loaded = port.state_dict()
    for path in [("tower", "features", "q_stem"),
                 ("tower", "features", "layer3_0", "q1"),
                 ("tower", "features", "layer4_1", "q_out")]:
        key = ".".join(path)
        want = jvars["quant"]
        for p in path:
            want = want[p]
        assert state[key].shape == () and state[key].dtype == torch.float32
        assert loaded[key].item() == np.float32(want)
    _, variables, vport = video_vad
    assert set(from_flax_variables(variables)) == set(vport.state_dict())
    no_quant = {k: v for k, v in jvars.items() if k != "quant"}
    with pytest.raises(RuntimeError, match="q_stem"):
        _port_avvad(no_quant, tower_quant_mode="static")
