"""CPU parity of the port's training path with the JAX package.

The JAX side runs its Pallas LSTM kernels in interpret mode (K1d
``_fwd_train_call``, K1e ``_bwd_call`` and the custom VJP that joins
them), at H <= 128; the port runs its kernels' plain versions (CPU
tensors never reach a kernel) and ``LSTMRecurrence``, its form of that
custom VJP. Weights come from the JAX modules' init through
``convert.from_flax_variables``; inputs, labels and masks from numpy. The
JAX train steps are the slow part (about 50 s for the AV model with the
full ResNet-18), so each model's run lives in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import LSTMStack as JLSTMStack
from avvad_tpu.models import losses as jlosses
from avvad_tpu.ops.lstm_pallas import _bwd_call, _fwd_train_call
from avvad_tpu.ops.lstm_pallas import lstm_layer_fused as jlstm_layer_fused
from avvad_tpu.train import checkpoint as jckpt
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu.train import make_eval_step as jmake_eval_step
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu.train.state import trainable_except_video_trunk as jfreeze
from avvad_tpu.train.steps import _forward_inputs as jforward_inputs
from avvad_tpu.train.steps import make_predict_step as jmake_predict_step
from avvad_tpu.train.steps import normalize as jnormalize
from avvad_tpu.train.trainer import Trainer as JTrainer
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.data import Batch, bucket_length, pad_batch
from avvad_tpu_torch.models import AVVAD, AudioVAD, LSTMStack, VideoVAD, losses
from avvad_tpu_torch.ops import lstm_fused
from avvad_tpu_torch.train import checkpoint as ckpt
from avvad_tpu_torch.train import (Trainer, create_train_state, make_eval_step,
                                   make_predict_step, make_train_step, normalize)

LR = 1e-4
N_STEPS = 3
# fp32 recurrences in another summation order: a few ulp of unit-scale values
ATOL_F32 = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tm(a):
    """batch-major (B, T, ...) <-> time-major (T, B, ...)"""
    return np.swapaxes(np.asarray(a), 0, 1)


def _lstm_inputs(seed, b=3, t=7, h=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, 4 * h)).astype(np.float32),
            (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32),
            np.tanh(rng.normal(size=(b, h))).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32))


# --- K1d and K1e: plain versions against the Pallas kernels (interpret) ---


def test_fwd_train_plain_matches_pallas():
    """K1d: y, c_seq and the activated gates, from a nonzero state.
    Readings: 1.2e-7, 2.4e-7, 1.9e-7; held at 1e-5."""
    xp, w, h0, c0 = _lstm_inputs(0)
    y_j, c_j, g_j = _fwd_train_call(jnp.asarray(_tm(xp)), jnp.asarray(w),
                                    jnp.asarray(h0), jnp.asarray(c0),
                                    interpret=True, w_dtype=jnp.bfloat16)
    y, c_seq, gates = lstm_fused.lstm_fwd_train_plain(_t(xp), _t(w), _t(h0), _t(c0))
    assert gates.shape == (3, 7, 128)
    for got, ref in ((y, y_j), (c_seq, c_j), (gates, g_j)):
        np.testing.assert_allclose(got.numpy(), _tm(ref), atol=ATOL_F32)
    # the same y as the inference recurrence
    np.testing.assert_array_equal(
        y.numpy(), lstm_fused.lstm_layer_plain(_t(xp), _t(w), _t(h0), _t(c0)).numpy())


def test_bwd_plain_matches_pallas():
    """K1e at B=3, T=7, H=32 from a nonzero h0 / c0: the pre-activation
    gate gradients and dh0, dc0. Readings: 1.5e-7 (d_gates, of max 1.07),
    3.6e-7 (dh0), 1.8e-7 (dc0); held at 1e-5."""
    xp, w, h0, c0 = _lstm_inputs(1)
    dy = np.random.default_rng(2).normal(size=(3, 7, 32)).astype(np.float32)
    _, c_j, g_j = _fwd_train_call(jnp.asarray(_tm(xp)), jnp.asarray(w),
                                  jnp.asarray(h0), jnp.asarray(c0),
                                  interpret=True, w_dtype=jnp.bfloat16)
    c_seq, gates = _tm(c_j), _tm(g_j)
    c_prev = np.concatenate([c0[:, None], c_seq[:, :-1]], axis=1)
    dg_j, dh0_j, dc0_j = _bwd_call(jnp.asarray(_tm(dy)), g_j, c_j,
                                   jnp.asarray(_tm(c_prev)), jnp.asarray(w),
                                   interpret=True, w_dtype=jnp.bfloat16)
    dg, dh0, dc0 = lstm_fused.lstm_bwd_plain(_t(dy), _t(gates), _t(c_seq),
                                             _t(c_prev), _t(w))
    np.testing.assert_allclose(dg.numpy(), _tm(dg_j), atol=ATOL_F32)
    np.testing.assert_allclose(dh0.numpy(), np.asarray(dh0_j), atol=ATOL_F32)
    np.testing.assert_allclose(dc0.numpy(), np.asarray(dc0_j), atol=ATOL_F32)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_recurrence_function_grads_match_custom_vjp():
    """``LSTMRecurrence`` (the plain K1d / K1e on the CPU) against jax.grad
    of the Pallas ``lstm_layer_fused``: dx_proj, dW_hh, dh0 and dc0 of
    sum(y * r). Readings (max error over the tensor's max): 1.3e-7 to
    3.0e-7; held at 1e-5."""
    xp, w, h0, c0 = _lstm_inputs(3)
    r = np.random.default_rng(4).normal(size=(3, 7, 32)).astype(np.float32)

    def jloss(xp_, w_, h0_, c0_):
        y = jlstm_layer_fused(xp_, w_, h0_, c0_, interpret=True)
        return jnp.sum(y * jnp.asarray(r))

    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (xp, w, h0, c0)))
    args = [_t(a).requires_grad_() for a in (xp, w, h0, c0)]
    y = lstm_fused.LSTMRecurrence.apply(*args)
    (y * _t(r)).sum().backward()
    for a, ref in zip(args, g_j):
        assert a.grad.dtype == torch.float32
        assert _rel_err(a.grad.numpy(), np.asarray(ref)) < 1e-5


def _jax_stack_to_port(variables, d, h, layers):
    stack = LSTMStack(d, h, layers, use_kernel=True)
    with torch.no_grad():
        for i, cell in enumerate(stack.layers()):
            p = variables["params"][f"layer_{i}"]
            for name in ("w_ih", "w_hh", "bias"):
                getattr(cell, name).copy_(_t(p[name]))
    return stack


def test_lstm_cell_grads_match_jax_custom_vjp():
    """Gradients of ``LSTMCellFused(use_kernel=True)`` (two layers) against
    jax.grad of the JAX ``LSTMStack(use_pallas=True)`` at its default bf16
    w_dtype: dx, dW_ih, dW_hh and dbias. JAX's custom VJP forms an fp32
    dW_hh; autograd through the plain forward, which rounds W_hh to bf16
    for the product, rounded dW_hh to bf16 too: this test then read 1.9e-3
    on layer 0's dW_hh. Readings (max error over the tensor's max): 1.1e-7
    to 3.2e-7; held at 1e-5."""
    b, t, d, h = 3, 7, 12, 32
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    r = rng.normal(size=(b, t, h)).astype(np.float32)
    jm = JLSTMStack(hidden_size=h, num_layers=2, use_pallas=True)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))

    def jloss(params, x_):
        return jnp.sum(jm.apply({"params": params}, x_) * jnp.asarray(r))

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    port = _jax_stack_to_port(variables, d, h, 2)
    xt = _t(x).requires_grad_()
    (port(xt) * _t(r)).sum().backward()
    assert _rel_err(xt.grad.numpy(), np.asarray(gx_j)) < 1e-5
    for i, cell in enumerate(port.layers()):
        for name in ("w_ih", "w_hh", "bias"):
            ref = np.asarray(gp_j[f"layer_{i}"][name])
            err = _rel_err(getattr(cell, name).grad.numpy(), ref)
            assert err < 1e-5, (i, name, err)


# --- losses, metrics, normalisation ---


@pytest.fixture(scope="module")
def ragged():
    """(B=4, T=6, 1) logits and labels; lengths 6, 3, 1 and 0 (all padding)."""
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(4, 6, 1)) * 4).astype(np.float32)
    logits[0, 0, 0] = 40.0  # saturated: sigmoid(-r) keeps the eps inside the log
    lengths = np.array([6, 3, 1, 0])
    mask = (np.arange(6)[None] < lengths[:, None]).astype(np.float32)
    label = (rng.random((4, 6, 1)) > 0.5).astype(np.float32)
    label[0, 0, 0] = 0.0
    return logits, label, mask


def test_masked_sequence_bce_matches_jax(ragged):
    logits, label, mask = ragged
    got = losses.masked_sequence_bce(_t(logits), _t(label), _t(mask))
    ref = jlosses.masked_sequence_bce(*map(jnp.asarray, ragged))
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(losses.binary_cross_entropy(_t(logits), _t(label)).item(),
                               float(jlosses.binary_cross_entropy(
                                   jnp.asarray(logits), jnp.asarray(label))), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_f1_metrics_match_jax(ragged, masked):
    logits, label, mask = ragged
    hard = (logits > 0).astype(np.float32)
    m_t, m_j = (_t(mask), jnp.asarray(mask)) if masked else (None, None)
    got = losses.f1_metrics(_t(hard), _t(label), m_t)
    ref = jlosses.f1_metrics(jnp.asarray(hard), jnp.asarray(label), m_j)
    np.testing.assert_allclose([g.item() for g in got], [float(v) for v in ref],
                               rtol=1e-6)


def test_batch_mean_f1_metrics_match_jax(ragged):
    """The all-padding row counts in neither the sum nor the divisor."""
    logits, label, mask = ragged
    hard = (logits > 0).astype(np.float32)
    got = losses.batch_mean_f1_metrics(_t(hard), _t(label), _t(mask))
    ref = jlosses.batch_mean_f1_metrics(jnp.asarray(hard), jnp.asarray(label),
                                        jnp.asarray(mask))
    np.testing.assert_allclose([g.item() for g in got], [float(v) for v in ref],
                               rtol=1e-6)


@pytest.mark.parametrize("stat_shape", [(513, 1), (513,)])
def test_normalize_matches_jax(stat_shape):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 513)).astype(np.float32)
    mean = rng.normal(size=stat_shape).astype(np.float32)
    std = rng.random(stat_shape).astype(np.float32)
    np.testing.assert_allclose(normalize(_t(x), mean, std).numpy(),
                               np.asarray(jnormalize(jnp.asarray(x), mean, std)),
                               rtol=1e-6)


def test_pad_batch_matches_jax():
    from avvad_tpu.data.batching import bucket_length as jbucket_length
    from avvad_tpu.data.batching import pad_batch as jpad_batch

    rng = np.random.default_rng(8)
    items = [{"length": n, "audio": rng.normal(size=(n, 5)),
              "label": rng.random((n, 1))} for n in (5, 2, 7)]
    got = pad_batch(items, bucket=4, pad_batch_to=4, source_indices=[9, 3, 1])
    ref = jpad_batch(items, bucket=4, pad_batch_to=4, source_indices=[9, 3, 1])
    assert isinstance(got, Batch) and got.max_frames == 8 and got.batch_size == 4
    for a, b in zip(got, ref):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    assert [bucket_length(t, 16, ladder=True) for t in range(1, 400, 7)] == \
        [jbucket_length(t, 16, ladder=True) for t in range(1, 400, 7)]


# --- whole train steps against JAX's make_train_step ---

B, T = 2, 8
LENGTHS = np.array([8, 5], np.int32)


def _batch_arrays(seed, audio=True, video=True):
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)
    label = (rng.random((B, T, 1)) > 0.5).astype(np.float32) * mask[..., None]
    return dict(audio=rng.normal(size=(B, T, 513)).astype(np.float32) if audio else None,
                video=(rng.normal(size=(B, T, 67, 67)).astype(np.float32)
                       if video else None),
                label=label, lengths=LENGTHS, mask=mask)


def _run_both(jmodel, jexample, tx, port_model, modality, arrays, freeze,
              norm_stats=None):
    """N_STEPS train steps on each side from the same variables -> a dict of
    the JAX and port states, step-1 grads and per-step metrics."""
    jstate = jcreate_train_state(jmodel, jax.random.PRNGKey(0), jexample, tx)
    init = _np_tree(jstate.variables())
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})

    def loss_fn(params):
        variables = {"params": params}
        for name in ("batch_stats", "sketch"):
            if getattr(jstate, name) is not None:
                variables[name] = getattr(jstate, name)
        inputs = jforward_inputs(modality, jbatch, norm_stats, 1e-8)
        if jstate.batch_stats is not None:
            logits, _ = jstate.apply_fn(variables, *inputs, train=True,
                                        mutable=["batch_stats"])
        else:
            logits = jstate.apply_fn(variables, *inputs, train=True)
        return jlosses.masked_sequence_bce(logits, jbatch.label, jbatch.mask)

    jgrads = from_flax_variables({"params": _np_tree(jax.grad(loss_fn)(jstate.params))})
    jstep = jmake_train_step(modality, donate=False)
    jmetrics = []
    for _ in range(N_STEPS):
        jstate, m = jstep(jstate, jbatch, norm_stats)
        jmetrics.append({k: float(v) for k, v in m.items()})

    port_model.load_state_dict(from_flax_variables(init), strict=True)
    state = create_train_state(port_model, learning_rate=LR,
                               freeze_video_trunk=freeze, device="cpu")
    step = make_train_step(modality)
    batch = Batch(**arrays)
    metrics, grads = [], None
    for i in range(N_STEPS):
        state, m = step(state, batch, norm_stats)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in port_model.named_parameters()
                     if p.grad is not None}
    return {"init": from_flax_variables(init), "jstate": jstate,
            "jfinal": from_flax_variables(_np_tree(jstate.variables())),
            "jgrads": jgrads, "jmetrics": jmetrics, "state": state,
            "grads": grads, "metrics": metrics, "batch": batch, "jbatch": jbatch,
            "norm_stats": norm_stats}


@pytest.fixture(scope="module")
def av_run():
    """AVVAD(MCB 64, 2 x LSTM 32) with the full ResNet-18 at 67x67, B=2,
    T=8, lengths (8, 5), the trunk frozen: 3 steps on each side."""
    jm = JAVVAD(lstm_hidden_size=32, lstm_layers=2, mcb_output_size=64,
                use_pallas_lstm=True, use_mcb=True)
    arrays = _batch_arrays(10)
    example = (jnp.zeros((1, 4, 513)), jnp.zeros((1, 4, 67, 67)))
    port = AVVAD(lstm_hidden_size=32, lstm_layers=2, mcb_output_size=64,
                 use_kernel_lstm=True)
    return _run_both(jm, example, jmake_optimizer(LR, freeze_filter=jfreeze), port,
                     "av", arrays, freeze=True)


@pytest.fixture(scope="module")
def audio_run():
    """AudioVAD(2 x LSTM 32), B=2, T=8, lengths (8, 5), with dataset
    statistics: 3 steps on each side."""
    rng = np.random.default_rng(11)
    stats = {"audio_mean": rng.normal(size=(513, 1)).astype(np.float32),
             "audio_std": (rng.random((513, 1)) + 0.5).astype(np.float32)}
    jm = JAudioVAD(lstm_hidden_size=32, lstm_layers=2, use_pallas_lstm=True)
    port = AudioVAD(lstm_hidden_size=32, lstm_layers=2, use_kernel_lstm=True)
    return _run_both(jm, (jnp.zeros((1, 4, 513)),), jmake_optimizer(LR), port,
                     "audio", _batch_arrays(12, video=False), freeze=False,
                     norm_stats=stats)


RUNS = ["av_run", "audio_run"]


@pytest.mark.parametrize("run", RUNS)
def test_train_step_metrics_match_jax(run, request):
    """Loss and the 4 metrics of each of the 3 steps. Readings: 2.6e-7
    relative (AV), 8.7e-8 (audio); held at 1e-5."""
    r = request.getfixturevalue(run)
    for got, ref in zip(r["metrics"], r["jmetrics"]):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7)
        assert 0 <= got["f1"] <= 1 and np.isfinite(got["loss"])
    assert r["metrics"][-1]["loss"] < r["metrics"][0]["loss"]


@pytest.mark.parametrize("run", RUNS)
def test_train_step_grads_match_jax(run, request):
    """The trainable parameters' gradients of step 1 against jax.grad of the
    same loss; the frozen trunk gets none on the port's side. Readings
    (max error over the tensor's max |g|): audio 2.2e-7 to 6.4e-7; AV
    1.8e-6 to 1.1e-4, the largest on the first layer's W_ih, where the
    signed square root and the post-MCB BatchNorm (16 positions, eps 1e-8)
    amplify the fp32 reassociation of the ResNet trunk; held at 5e-4."""
    r = request.getfixturevalue(run)
    want = {n for n, p in r["state"].model.named_parameters() if p.requires_grad}
    assert set(r["grads"]) == want
    assert not any(n.startswith("tower.") for n in want)
    for n, g in r["grads"].items():
        assert _rel_err(g.numpy(), r["jgrads"][n].numpy()) < 5e-4, n


@pytest.mark.parametrize("run", RUNS)
def test_train_step_params_match_jax(run, request):
    """Parameters after 3 Adam steps. Adam's early updates are about +-lr
    wherever |g| >> eps, so a gradient near 0 whose sign differs between
    the two frameworks moves the parameter up to 2 lr apart per step:
    entries whose step-1 |g| is above 1e-2 of the tensor's max are held at
    1e-6 (readings up to 9.7e-8), the rest at 6 lr = 6e-4 (readings up to
    5.8e-5 for AV, 6.0e-7 for audio)."""
    r = request.getfixturevalue(run)
    sd = r["state"].model.state_dict()
    for n, g in r["grads"].items():
        got, ref = sd[n].numpy(), r["jfinal"][n].numpy()
        g1 = np.abs(r["jgrads"][n].numpy())
        big = g1 > 1e-2 * g1.max()
        assert np.abs(got - ref)[big].max(initial=0) < 1e-6, n
        assert np.abs(got - ref).max() < 6 * LR, n
        assert np.abs(ref - r["init"][n].numpy()).max() > 2 * LR  # it trained


def test_av_batch_stats_match_jax_and_trunk_stays_frozen(av_run):
    """After 3 steps: the trunk's and the post-MCB BatchNorm's running
    statistics (flax's rule: biased variance, momentum 0.9) against JAX's
    batch_stats; the frozen trunk's parameters unchanged on both sides.
    Readings: up to 1.7e-5 on running variances of order 1; held at 1e-4."""
    sd = av_run["state"].model.state_dict()
    stats = [n for n in av_run["jfinal"] if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 21  # 20 trunk BatchNorms and the post-MCB one
    for n in stats:
        ref = av_run["jfinal"][n].numpy()
        assert np.abs(ref - av_run["init"][n].numpy()).max() > 1e-3  # updated
        np.testing.assert_allclose(sd[n].numpy(), ref, atol=1e-4, rtol=1e-5, err_msg=n)
    trunk = [n for n, p in av_run["state"].model.named_parameters()
             if n.startswith("tower.features.")]
    assert trunk and not any(av_run["state"].model.get_parameter(n).requires_grad
                             for n in trunk)
    for n in trunk:
        np.testing.assert_array_equal(sd[n].numpy(), av_run["init"][n].numpy())
        np.testing.assert_array_equal(av_run["jfinal"][n].numpy(),
                                      av_run["init"][n].numpy())


def test_mcb_batch_norm_update_is_flax_rule():
    """The port's running-variance update takes the biased batch variance
    (flax), not torch's unbiased one: at n = 16 positions the two differ by
    n / (n - 1) = 6.7 %."""
    from avvad_tpu_torch.models.resnet import batch_norm

    bn = torch.nn.BatchNorm1d(3, eps=1e-8).train()
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(16, 3)).astype(np.float32))
    batch_norm(bn, x, fast_variance=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * x.var(0, unbiased=False).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.mean(0).numpy(),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("run", RUNS)
def test_eval_and_predict_steps_match_jax(run, request):
    """After 3 train steps: JAX's make_eval_step / make_predict_step against
    the port's (BatchNorm on running statistics, the inference LSTM kernel).
    Readings: probabilities equal (AV) and 6e-8 apart (audio), loss 1.7e-7
    relative; held at 1e-5."""
    r = request.getfixturevalue(run)
    modality = "av" if run == "av_run" else "audio"
    jm, jsoft = jmake_eval_step(modality)(r["jstate"], r["jbatch"], r["norm_stats"])
    jpred = jmake_predict_step(modality)(r["jstate"], r["jbatch"], r["norm_stats"])
    before = lstm_fused.launch_counts()
    m, soft = make_eval_step(modality)(r["state"], r["batch"], r["norm_stats"])
    pred = make_predict_step(modality)(r["state"], r["batch"], r["norm_stats"])
    assert lstm_fused.launch_counts() == before  # CPU tensors launch nothing
    assert not r["state"].model.training
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=1e-5)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7)


# --- Trainer.fit and checkpoints ---


class _Batches(list):
    """A list of batches with a loader's ``source`` and ``epoch``."""

    epoch = 0

    def __init__(self, batches, n_items):
        super().__init__(batches)
        self.source = list(range(n_items))


def _synthetic_batches(seed, n, lengths=(6, 4)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items = [{"length": L, "audio": rng.normal(size=(L, 513)),
                  "label": (rng.random((L, 1)) > 0.5).astype(np.float32)}
                 for L in lengths]
        out.append(pad_batch(items))
    return out


def _jbatches(batches):
    return _Batches([JBatch(*[None if a is None else jnp.asarray(a) for a in b])
                     for b in batches], 2 * len(batches))


def test_trainer_fit_logs_and_checkpoints_as_jax(tmp_path):
    """Trainer.fit over 2 epochs of 3 synthetic batches, with one
    validation batch: the port's output_batch.log and output_epoch.log
    lines equal the JAX trainer's (but for the [Time] lines), and both
    leave the same checkpoint names after pruning."""
    train_b, valid_b = _synthetic_batches(20, 3), _synthetic_batches(21, 1)
    jm = JAudioVAD(lstm_hidden_size=16, lstm_layers=1, use_pallas_lstm=True)
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, 4, 513)),),
                                 jmake_optimizer(1e-2))
    init = _np_tree(jstate.variables())  # the JAX trainer donates its state
    JTrainer(jstate, "audio", str(tmp_path / "jax"), prefetch=False).fit(
        _jbatches(train_b), _jbatches(valid_b), end_epoch=3, keep_checkpoints=1)

    model = AudioVAD(lstm_hidden_size=16, lstm_layers=1, use_kernel_lstm=True)
    model.load_state_dict(from_flax_variables(init))
    state = create_train_state(model, learning_rate=1e-2, device="cpu")
    last = Trainer(state, "audio", str(tmp_path / "port")).fit(
        _Batches(train_b, 6), _Batches(valid_b, 2), end_epoch=3, keep_checkpoints=1)
    assert last["epoch"] == 2 and state.step == 6

    def lines(side, name):
        text = (tmp_path / side / name).read_text().splitlines()
        return [ln for ln in text if not ln.startswith("[Time]")]

    for name in ("output_batch.log", "output_epoch.log"):
        assert lines("port", name) == lines("jax", name)
    assert len(lines("port", "output_batch.log")) == 6
    names = lambda side: sorted(p.name for p in (tmp_path / side).glob("epoch_*"))  # noqa: E731
    assert names("port") == names("jax") and names("port")


@pytest.mark.parametrize("names", [
    ["epoch_001_vloss_0.70", "epoch_002_vloss_0.65", "epoch_003_vloss_0.66",
     "epoch_004_vloss_0.65", "epoch_010_vloss_0.90"],
    ["epoch_001_vloss_1.00", "epoch_002_vloss_1.00", "epoch_003_vloss_1.00"],
    ["epoch_005_vloss_-0.10", "epoch_006_vloss_0.20"],
])
def test_checkpoint_names_resolve_and_prune_as_jax(tmp_path, names):
    """Best (ties: the later epoch), latest, resolution of a model
    directory and pruning pick as JAX's functions do; a crashed save's
    ``.tmp`` directory is swept and never resolved."""
    assert ckpt.checkpoint_name(3, 0.654) == jckpt.checkpoint_name(3, 0.654)
    dirs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        for n in names:
            (d / n).mkdir(parents=True)
        dirs[side] = str(d)
    (tmp_path / "port" / "epoch_011_vloss_0.01.tmp").mkdir()
    rel = lambda p: None if p is None else p.rsplit("/", 1)[-1]  # noqa: E731
    assert rel(ckpt.best_checkpoint(dirs["port"])) == rel(jckpt.best_checkpoint(dirs["jax"]))
    assert rel(ckpt.latest_checkpoint(dirs["port"])) == \
        rel(jckpt.latest_checkpoint(dirs["jax"]))
    for prefer in ("best", "latest"):
        assert rel(ckpt.resolve_checkpoint(dirs["port"], prefer)) == \
            rel(jckpt.resolve_checkpoint(dirs["jax"], prefer))
    assert ckpt.prune_checkpoints(dirs["port"], keep_latest=1) == \
        jckpt.prune_checkpoints(dirs["jax"], keep_latest=1) + 1
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def _params(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_restore_checkpoint_resumes_exactly(tmp_path):
    """2 steps, a checkpoint, a 3rd step; a fresh model restored from the
    checkpoint (optimizer moments, step, norm stats) and given the same
    3rd step ends with the same parameters and BatchNorm statistics."""
    rng = np.random.default_rng(30)
    stats = {"audio_mean": rng.normal(size=(513, 1)).astype(np.float32),
             "audio_std": np.ones((513, 1), np.float32)}
    arrays = _batch_arrays(31)
    batch = Batch(**arrays)

    def fresh():
        model = AVVAD(lstm_hidden_size=16, lstm_layers=1, mcb_output_size=32,
                      use_kernel_lstm=True, seed=4)
        return create_train_state(model, learning_rate=1e-3, freeze_video_trunk=True,
                                  device="cpu")

    step = make_train_step("av")
    state = fresh()
    for _ in range(2):
        step(state, batch, stats)
    path = ckpt.save_checkpoint(str(tmp_path), state, stats, epoch=2, valid_loss=0.5)
    step(state, batch, stats)

    resumed = fresh()
    resumed, norm, epoch = ckpt.restore_checkpoint(str(tmp_path), resumed)
    assert epoch == 2 and resumed.step == 2 and path.endswith("epoch_002_vloss_0.50")
    np.testing.assert_array_equal(norm["audio_mean"], stats["audio_mean"])
    step(resumed, batch, norm)
    want, got = _params(state.model), _params(resumed.model)
    assert want.keys() == got.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_restore_missing_checkpoint_raises(tmp_path):
    state = create_train_state(AudioVAD(lstm_hidden_size=8, lstm_layers=1), device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "nothing"), state)


def test_load_pretrained_trunk_grafts_video_vad_trunk(tmp_path):
    """A VideoVAD checkpoint's trunk (parameters and BatchNorm statistics)
    lands in an AVVAD's tower; nothing else of the AVVAD changes."""
    video = VideoVAD(lstm_hidden_size=8, lstm_layers=1, seed=1)
    vstate = create_train_state(video, device="cpu")
    with torch.no_grad():  # running statistics as a trained trunk has them
        video.tower.features.layer1_0.bn1.running_var.uniform_(0.5, 2.0)
    ckpt.save_checkpoint(str(tmp_path), vstate, epoch=1, valid_loss=0.3)
    av = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=32, seed=2)
    before = _params(av)
    ckpt.load_pretrained_trunk(str(tmp_path), av)
    src = video.state_dict()
    for k, v in av.state_dict().items():
        if k.startswith("tower.features."):
            torch.testing.assert_close(v, src[k], rtol=0, atol=0)
        else:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not torch.equal(before["tower.features.conv1.weight"],
                           src["tower.features.conv1.weight"])
    with pytest.raises(ValueError):
        ckpt.load_pretrained_trunk(str(tmp_path), AudioVAD(lstm_hidden_size=8,
                                                           lstm_layers=1))


def test_load_pretrained_trunk_into_int8_tower_leaves_scales_alone(tmp_path):
    """A float VideoVAD trunk grafts into an AVVAD built with
    ``tower_int8=True``: parameters and BatchNorm statistics land, the
    ``q_stem`` / ``q1`` / ``q_out`` scale buffers, which the checkpoint does
    not hold, stay as they were (JAX grafts ``params`` and ``batch_stats``
    and leaves ``quant`` alone, avvad_tpu/train/checkpoint.py:205-233); a
    trunk whose parameter keys differ still raises."""
    video = VideoVAD(lstm_hidden_size=8, lstm_layers=1, seed=1)
    vstate = create_train_state(video, device="cpu")
    with torch.no_grad():
        video.tower.features.layer2_0.bn2.running_mean.uniform_(-1.0, 1.0)
    ckpt.save_checkpoint(str(tmp_path), vstate, epoch=1, valid_loss=0.3)
    av = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=32, seed=2,
               tower_int8=True)
    scales = [k for k in av.state_dict() if k.split(".")[-1] in ("q_stem", "q1", "q_out")]
    assert len(scales) == 17
    with torch.no_grad():  # as a calibration leaves them
        for i, k in enumerate(scales):
            av.state_dict()[k].fill_(1.0 + i)
    before = _params(av)
    ckpt.load_pretrained_trunk(str(tmp_path), av)
    src = video.state_dict()
    grafted = 0
    for k, v in av.state_dict().items():
        if k.startswith("tower.features.") and k not in scales:
            torch.testing.assert_close(v, src[k], rtol=0, atol=0)
            grafted += 1
        else:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert grafted == len([k for k in src if k.startswith("tower.features.")])
    narrow = AVVAD(lstm_hidden_size=8, lstm_layers=1, mcb_output_size=32, tower_int8=True)
    del narrow.tower.features.layer4_1  # a trunk with other parameter keys
    narrow.tower.features.block_names.remove("layer4_1")
    with pytest.raises(ValueError):
        ckpt.load_pretrained_trunk(str(tmp_path), narrow)
