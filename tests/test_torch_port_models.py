"""CPU parity of the port's models and serving step with the JAX package.

Weights are made by the JAX modules' own init and carried across by
``avvad_tpu_torch.convert.from_flax_variables``; inputs come from numpy.
The JAX LSTM runs its Pallas kernel in interpret mode where the model asks
for it (use_pallas_lstm=True on the CPU), the port its kernels' plain
versions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.export import make_waveform_serving_fn as jmake_serving_fn
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import ResNet18 as JResNet18
from avvad_tpu.models.mcb import CompactBilinearPooling as JMCB
from avvad_tpu.models.mcb import fold_sketch_collection
from avvad_tpu.models.mcb import global_l2_normalize as jl2
from avvad_tpu.models.mcb import signed_sqrt as jsigned_sqrt
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import AVVAD, CompactBilinearPooling, ResNet18
from avvad_tpu_torch.models import global_l2_normalize, signed_sqrt
from golden_fixture_lib import load_fixture

H = 16          # LSTM width of the small models
MCB_OUT = 256   # MCB output of the small models
B, T, T_SRC = 2, 6, 3
FRAME_IDX = np.array([0, 0, 1, 1, 2, 2])
# whole-model logits: fp32 on both sides through a ResNet-18, MCB and two
# LSTM layers; measured ~1e-7, held at 1e-4
ATOL_LOGITS = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def av_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, T, 513)).astype(np.float32),
            rng.normal(size=(B, T_SRC, 67, 67)).astype(np.float32))


@pytest.fixture(scope="module", params=["mcb", "concat"])
def jax_avvad(request, av_inputs):
    audio, video = av_inputs
    model = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                   use_mcb=request.param == "mcb")
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(audio),
                           jnp.asarray(video),
                           video_frame_indices=jnp.asarray(FRAME_IDX))
    return request.param, model, _np_tree(variables)


def _port_avvad(variables, **kw):
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                  **kw)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model.eval()


def test_resnet18_float_matches_jax():
    """Float ResNet-18 with the gray stem: 67 -> 34 -> 17 -> 9 -> 5 -> 3,
    the 1x1/2 downsample (flax SAME) lining up with torch's padding 0."""
    x = np.random.default_rng(1).normal(size=(3, 67, 67)).astype(np.float32)
    jm = JResNet18(gray_input=True)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)[..., None]))
    f_j = np.asarray(jm.apply(variables, jnp.asarray(x)[..., None]))
    port = ResNet18()
    port.load_state_dict(from_flax_variables(variables), strict=True)
    with torch.no_grad():
        f_t = port.eval()(_t(x)[:, None])
    assert f_t.shape == (3, 512)
    # fp32 through 17 convs, features of O(1-10): reassociation ~1e-6
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=5e-5, rtol=1e-5)


def test_video_tower_chunks_match_single_pass():
    """``chunk`` runs the trunk over frame slices (here 3 + 3 + 1 of the 7
    frames): frames are independent in eval mode, so the features equal
    the single pass up to the conv's blocking for another batch size."""
    from avvad_tpu_torch.models.vad_nets import _VideoTower

    video = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 7, 67, 67)).astype(np.float32))
    whole, chunked = _VideoTower().eval(), _VideoTower(chunk=3).eval()
    with torch.no_grad():
        torch.testing.assert_close(chunked(video), whole(video), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("form", ["plain", "fold_sketch", "folded_vars"])
def test_mcb_forms_match_jax(form):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    y = rng.normal(size=(2, 5, 24)).astype(np.float32)
    kw = dict(fold_sketch=form != "plain", folded_vars=form == "folded_vars")
    jm = JMCB(40, 24, 128, seed=7, **kw)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(y)))
    out_j = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(y)))
    port = CompactBilinearPooling(40, 24, 128, seed=7, **kw)
    # same numpy draw: the seeded sketches are equal before any load
    np.testing.assert_array_equal(port.sketch1.numpy(),
                                  variables["sketch"]["sketch1"])
    np.testing.assert_array_equal(port.sketch2.numpy(),
                                  variables["sketch"]["sketch2"])
    with torch.no_grad():
        out_t = port(_t(x), _t(y))
    # fp32 DFT matmuls over 128 bins, outputs of O(10)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("axes", [None, (1, 2), (2,)])
def test_signed_sqrt_and_l2_match_jax(axes):
    x = np.random.default_rng(3).normal(size=(2, 4, 6)).astype(np.float32)
    x[0, 0, 0] = 0.0
    s_j = np.asarray(jsigned_sqrt(jnp.asarray(x)))
    s_t = signed_sqrt(_t(x)).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(global_l2_normalize(_t(s_t), axes=axes).numpy(),
                               np.asarray(jl2(jnp.asarray(s_j), axes=axes)),
                               rtol=1e-6, atol=1e-7)


def test_avvad_matches_jax(jax_avvad, av_inputs):
    """AVVAD in MCB / concat mode with the camera-rate gather."""
    mode, jm, variables = jax_avvad
    audio, video = av_inputs
    out_j = np.asarray(jm.apply(variables, jnp.asarray(audio),
                                jnp.asarray(video),
                                video_frame_indices=jnp.asarray(FRAME_IDX)))
    port = _port_avvad(variables, use_mcb=mode == "mcb")
    with torch.no_grad():
        out_t = port(_t(audio), _t(video), _t(FRAME_IDX))
    assert out_t.shape == (B, T, 1)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL_LOGITS)


@pytest.mark.parametrize("jax_avvad", ["mcb"], indirect=True)
def test_avvad_folded_sketch_vars_match_jax(jax_avvad, av_inputs):
    """The serving form with pre-folded sketches (fold_sketch_collection)."""
    _, jm, variables = jax_avvad
    audio, video = av_inputs
    folded = _np_tree(fold_sketch_collection(variables))
    out_j = np.asarray(jm.clone(mcb_folded_vars=True).apply(
        folded, jnp.asarray(audio), jnp.asarray(video),
        video_frame_indices=jnp.asarray(FRAME_IDX)))
    port = _port_avvad(folded, mcb_folded_vars=True)
    with torch.no_grad():
        out_t = port(_t(audio), _t(video), _t(FRAME_IDX))
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=ATOL_LOGITS)


def test_avvad_whole_tensor_norm_couples_rows(jax_avvad, av_inputs):
    """MCB mode's L2 norm spans the whole batch: changing row 1 moves row 0
    (the reference's semantics); concat mode keeps rows independent."""
    mode, _, variables = jax_avvad
    audio, video = av_inputs
    port = _port_avvad(variables, use_mcb=mode == "mcb")
    audio2 = audio.copy()
    audio2[1] *= 3.0
    with torch.no_grad():
        a = port(_t(audio), _t(video), _t(FRAME_IDX))[0]
        b = port(_t(audio2), _t(video), _t(FRAME_IDX))[0]
    assert (not torch.equal(a, b)) == (mode == "mcb")


def _serving_probs(state_quant, jdtype, tdtype):
    """The waveform serving step of both packages on the same weights and
    inputs (the JAX LSTM through its Pallas kernel, interpret) ->
    (port probs, JAX probs)."""
    t_frames, n = 8, 256 * 7 + 1024
    rng = np.random.default_rng(4)
    wave = rng.normal(size=(B, n)).astype(np.float32)
    video = rng.normal(size=(B, 4, 67, 67)).astype(np.float32)
    idx = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    stats = {"audio_mean": rng.normal(size=513).astype(np.float32),
             "audio_std": (1.0 + rng.random(513)).astype(np.float32),
             "video_mean": np.float32(0.1), "video_std": np.float32(1.3)}
    jm = JAVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                dtype=jdtype, use_pallas_lstm=True,
                lstm_state_quant=state_quant)
    variables = _np_tree(jm.init(jax.random.PRNGKey(5),
                                 jnp.zeros((B, t_frames, 513)),
                                 jnp.asarray(video),
                                 video_frame_indices=jnp.asarray(idx)))
    p_j = np.asarray(jmake_serving_fn(
        jm, variables, t_frames=t_frames, norm_stats=stats,
        video_frame_indices=jnp.asarray(idx))(jnp.asarray(wave),
                                              jnp.asarray(video)))
    port = _port_avvad(variables, dtype=tdtype, use_kernel_lstm=True,
                       lstm_state_quant=state_quant)
    fn = make_waveform_serving_fn(port, t_frames=t_frames, norm_stats=stats,
                                  video_frame_indices=idx, device="cpu")
    p_t = fn(wave, video)
    assert p_t.shape == (B, t_frames, 1) and p_t.dtype == torch.float32
    return p_t.numpy(), p_j


@pytest.mark.parametrize("state_quant", ["none", "int8"])
def test_serving_fn_matches_jax(state_quant):
    """The whole fp32 waveform serving step against the JAX one, with
    dataset normalisation."""
    p_t, p_j = _serving_probs(state_quant, jnp.float32, torch.float32)
    # probabilities: the frontend's fp32 reassociation (~1e-5 log-power on
    # normal bins) passes through MCB, the LSTM and a sigmoid
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)


@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_serving_fn_bf16_matches_jax(state_quant):
    """The bf16 model, as served at full width: bf16 convs with fp32
    BatchNorm outputs, bf16 input projections cast to fp32 for the
    recurrence and its output cast back, fp32 MCB and Dense head."""
    p_t, p_j = _serving_probs(state_quant, jnp.bfloat16, torch.bfloat16)
    # The port rounds every bf16 matmul and conv result to bf16, as the
    # dtype asks; XLA's CPU backend keeps some of them at fp32 (excess
    # precision across the bf16 casts), so the sides agree to bf16
    # rounding noise, not bit for bit. Measured max |diff| on these inputs:
    # 8.2e-5 (none), 6.3e-5 (bf16), 1.8e-5 (int8); over three more input
    # and weight seeds (no norm_stats) at most 1.1e-4. Held at 3e-4.
    np.testing.assert_allclose(p_t, p_j, atol=3e-4)


def test_av_mcb_golden_fixture():
    """The committed reference AV-MCB fixture (H=128): torch reference
    weights -> JAX variables (avvad_tpu.utils.import_reference_avvad) ->
    the port's converter; the port's logits match the recorded reference
    logits at the JAX package's own golden tolerance
    (tests/test_torch_golden_fixture.py)."""
    from avvad_tpu.utils import import_reference_avvad

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_golden_av_mcb.npz")
    state, arr = load_fixture(path)
    jm = JAVVAD(y_dim=1, lstm_hidden_size=128, lstm_layers=2, use_mcb=True)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 513)),
                        jnp.zeros((1, 2, 67, 67)))
    variables = _np_tree(import_reference_avvad(state, jm, variables))
    port = AVVAD(y_dim=1, lstm_hidden_size=128, lstm_layers=2, use_mcb=True)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    with torch.no_grad():
        ours = port.eval()(_t(arr["audio"]), _t(arr["video"])).numpy()
    assert ours.shape == arr["logits"].shape
    for b, n in enumerate(arr["lengths"]):
        np.testing.assert_allclose(ours[b, :n], arr["logits"][b, :n],
                                   atol=1e-3)
