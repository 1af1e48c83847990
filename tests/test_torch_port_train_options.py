"""The training options of the port against the JAX package on the CPU:
the auxiliary losses and ``init_normal`` (avvad_tpu/models/losses.py:42,
107-174), and dropout (vad_nets.py, train/steps.py).

JAX's threefry stream cannot be reproduced in torch, so dropout is held to
JAX in two ways: by its statistics and rules, and, for the train step's
numbers, with flax's own mask read out of the JAX forward
(``capture_intermediates``) and handed to the port's draw
(``vad_nets.draw_keep``, monkeypatched in the test only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.data.batching import Batch as JBatch
from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import losses as jlosses
from avvad_tpu.train import create_train_state as jcreate_train_state
from avvad_tpu.train import make_train_step as jmake_train_step
from avvad_tpu.train.state import make_optimizer as jmake_optimizer
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.data import Batch
from avvad_tpu_torch.models import AVVAD, AudioVAD, VideoVAD, losses, vad_nets
from avvad_tpu_torch.models.vad_nets import Dropout, DropoutRNG, dropout_generator
from avvad_tpu_torch.train import create_train_state, make_train_step

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- auxiliary losses -----------------------------------------------------------


def _positive(rng, shape):
    return (rng.random(shape) + 0.1).astype(np.float32)


def _loss_cases():
    rng = np.random.default_rng(0)
    shape = (4, 6, 5)
    r, x = _positive(rng, shape), _positive(rng, shape)
    mu = rng.normal(size=(4, 3)).astype(np.float32)
    logvar = (rng.normal(size=(4, 3)) * 0.3).astype(np.float32)
    y, y_hat = rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)
    t = (rng.random(shape) > 0.5).astype(np.float32)
    s = rng.normal(size=shape).astype(np.float32)
    sc = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    xc = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    lse = (rng.normal(size=shape) * 3).astype(np.float32)
    return {
        "binary_cross_entropy_2classes": ((y, 1 - y, t), {}),
        "itakura_saito_divergence": ((r, x), {}),
        "elbo": ((x, r, mu, logvar), {}),
        "mean_square_error_signal": ((x, y, y_hat), {}),
        "mean_square_error_mask": ((y, y_hat), {}),
        "magnitude_spectrum_approximation_loss": ((x, s, y_hat), {}),
        "magnitude_spectrum_approximation_loss/complex": ((xc, sc, y_hat), {}),
        "log_sum_exp": ((lse,), {}),
        "log_sum_exp/axis0": ((lse,), {"axis": 0}),
    }


@pytest.mark.parametrize("case", list(_loss_cases()))
def test_auxiliary_loss_matches_jax(case):
    """Each auxiliary loss on the same numpy inputs, 1e-6 relative (every
    output of ``elbo``; the complex spectrum loss in both parts)."""
    args, kw = _loss_cases()[case]
    name = case.split("/")[0]
    ref = getattr(jlosses, name)(*map(jnp.asarray, args), **kw)
    port_kw = {"dim": kw["axis"]} if "axis" in kw else {}
    got = getattr(losses, name)(*map(_t, args), **port_kw)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and np.iscomplexobj(g) == np.iscomplexobj(r)
        np.testing.assert_allclose(g, r, rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_onehot_and_enumerate_discrete_match_jax_exactly(k):
    enc, jenc = losses.onehot(k), jlosses.onehot(k)
    for label in range(k + 2):  # labels >= k encode to zeros
        np.testing.assert_array_equal(enc(label).numpy(), np.asarray(jenc(label)))
        assert enc(label).dtype == torch.float32
    x = np.zeros((4, 7), np.float32)
    got = losses.enumerate_discrete(_t(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlosses.enumerate_discrete(
        jnp.asarray(x), k)))
    assert got.shape == (4 * k, k)


# --- init_normal ----------------------------------------------------------------


def _kind(before, after):
    if np.array_equal(before, after):
        return "kept"
    if not after.any():
        return "zeroed"
    return "drawn"


@pytest.fixture(scope="module")
def av_pair():
    jm = JAVVAD(y_dim=1, lstm_hidden_size=16, lstm_layers=1, use_mcb=True,
                mcb_output_size=32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 513)),
                                 jnp.zeros((1, 2, 67, 67))))
    port = AVVAD(lstm_hidden_size=16, lstm_layers=1, mcb_output_size=32)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return variables, port


def test_init_normal_follows_the_jax_rules(av_pair):
    """Per parameter, what JAX's ``init_normal`` does (a draw, zeroed, or
    kept: the LSTM) is what the port's does; buffers are left alone."""
    variables, port = av_pair
    rng = np.random.default_rng(4)
    variables = dict(variables)  # every parameter nonzero, so that zeroing shows
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.01 + 0.01 * rng.random(a.shape)).astype(a.dtype),
        variables["params"])
    port.load_state_dict(from_flax_variables(variables), strict=True)
    jnew = dict(variables)
    jnew["params"] = _np_tree(jlosses.init_normal(jax.random.PRNGKey(1),
                                                  variables["params"]))
    before, jafter = from_flax_variables(variables), from_flax_variables(jnew)
    params = {n for n, _ in port.named_parameters()}
    losses.init_normal(port, torch.Generator().manual_seed(0))
    after = port.state_dict()
    kinds = {"kept": 0, "zeroed": 0, "drawn": 0}
    for k in before:
        want = _kind(before[k].numpy(), jafter[k].numpy())
        got = _kind(before[k].numpy(), after[k].numpy())
        assert got == want, k
        if k not in params:
            assert got == "kept", k
        kinds[got] += 1
    assert all(kinds.values())
    assert all(after[k].equal(before[k]) for k in before if "lstm" in k)


def test_init_normal_statistics_and_determinism():
    """Kernels of linear and conv layers ~ N(mean, std), BatchNorm scales
    ~ N(1, 0.02), biases 0 (the ResNet-18's 11M kernel entries pin the
    moments); the same generator seed draws the same weights."""
    def fresh():
        return VideoVAD(lstm_hidden_size=8, lstm_layers=1)

    model = losses.init_normal(fresh(), torch.Generator().manual_seed(3), mean=0.1, std=0.005)
    kernels = torch.cat([m.weight.flatten() for m in model.modules()
                         if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
                        + [model.tower.features.conv1.weight.flatten()])
    assert kernels.numel() > 1e7
    np.testing.assert_allclose(kernels.mean().item(), 0.1, atol=1e-5)
    np.testing.assert_allclose(kernels.std().item(), 0.005, rtol=1e-3)
    scales = torch.cat([m.weight for m in model.modules()
                        if isinstance(m, torch.nn.BatchNorm2d)])
    assert abs(scales.mean().item() - 1.0) < 5 * 0.02 / np.sqrt(scales.numel())
    np.testing.assert_allclose(scales.std().item(), 0.02, rtol=0.1)
    for name, p in model.named_parameters():
        if name.endswith("bias") and "lstm" not in name:
            assert not p.any(), name
    again = losses.init_normal(fresh(), torch.Generator().manual_seed(3), mean=0.1, std=0.005)
    for (n, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), n


# --- dropout ----------------------------------------------------------------------


def test_dropout_rate_zero_and_eval_mode_are_identity():
    """Rate 0 in train mode and any rate in eval mode give the no-dropout
    forward bit for bit; no generator is needed there."""
    x = torch.randn(3, 5, 513, generator=torch.Generator().manual_seed(0))
    base = AudioVAD(lstm_hidden_size=16, lstm_layers=1, seed=1)
    ref = base(x)
    for rate in (0.0, 0.5):
        model = AudioVAD(lstm_hidden_size=16, lstm_layers=1, dropout_rate=rate, seed=1)
        model.train(rate == 0.0)
        assert torch.equal(model(x), ref)
        assert torch.equal(model(x, dropout_rng=DropoutRNG(dropout_generator(0, 0, "cpu"))), ref)
    with pytest.raises(ValueError, match="needs a dropout_rng"):
        AudioVAD(lstm_hidden_size=16, lstm_layers=1, dropout_rate=0.5).train()(x)
    with pytest.raises(ValueError, match="outside"):
        Dropout(1.5)


def test_dropout_statistics_and_scaling():
    """p = 0.5 over 2^17 entries: the kept share within 5 sigma of 1 - p,
    kept entries scaled by exactly 1 / (1 - p), dropped ones 0; rate 1
    drops all."""
    p, n = 0.5, 1 << 17
    x = torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5
    y = Dropout(p).train()(x, DropoutRNG(dropout_generator(7, 0, "cpu")))
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert torch.equal(Dropout(1.0).train()(x, None), torch.zeros_like(x))


def test_dropout_mask_is_a_function_of_seed_and_step():
    def mask(seed, step):
        return DropoutRNG(dropout_generator(seed, step, "cpu")).keep((64, 32), 0.7)

    assert torch.equal(mask(3, 5), mask(3, 5))
    assert not torch.equal(mask(3, 5), mask(3, 6))
    assert not torch.equal(mask(3, 5), mask(4, 5))


def test_dropout_rows_are_the_global_masks_rows():
    """A data rank draws the global batch's mask and keeps its rows, so
    the ranks' masks stacked equal the unmeshed step's."""
    full = DropoutRNG(dropout_generator(2, 9, "cpu")).keep((8, 6, 4), 0.5)
    parts = [DropoutRNG(dropout_generator(2, 9, "cpu"), rows=slice(2 * r, 2 * r + 2),
                        global_batch=8).keep((2, 6, 4), 0.5) for r in range(4)]
    assert torch.equal(torch.cat(parts), full)


def test_dropout_masks_are_drawn_on_the_step_device(monkeypatch):
    """The step's generator lives on the state's device and the mask is
    drawn there: no host draw and no copy a step."""
    seen = []
    draw = vad_nets.draw_keep

    def spy(generator, shape, keep_prob):
        mask = draw(generator, shape, keep_prob)
        seen.append((generator.device, mask.device))
        return mask

    monkeypatch.setattr(vad_nets, "draw_keep", spy)
    model = AudioVAD(lstm_hidden_size=8, lstm_layers=1, dropout_rate=0.5)
    state = create_train_state(model, learning_rate=1e-4, device="cpu")
    make_train_step("audio", dropout=True, dropout_seed=1)(state, _batch())
    assert seen == [(state.device, state.device)]


def _batch(seed=0, b=3, t=9):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, 5, 2])[:b].astype(np.int32)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return Batch(audio=rng.normal(size=(b, t, 513)).astype(np.float32), video=None,
                 label=(rng.random((b, t, 1)) > 0.5).astype(np.float32),
                 lengths=lengths, mask=mask)


@pytest.fixture(scope="module")
def dropout_jax():
    """JAX AudioVAD(2 x LSTM 32, dropout 0.5): its train step with
    dropout (seed 3, step 0) and, with the same rng, flax's mask, loss and
    gradients of the step's forward."""
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=32, lstm_layers=2, dropout_rate=0.5)
    batch = _batch()
    jb = JBatch(audio=jnp.asarray(batch.audio), video=None, label=jnp.asarray(batch.label),
                lengths=jnp.asarray(batch.lengths), mask=jnp.asarray(batch.mask))
    state = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, 4, 513)),),
                                jmake_optimizer(1e-4))
    rngs = {"dropout": jax.random.fold_in(jax.random.PRNGKey(3), 0)}
    _, inter = jm.apply({"params": state.params}, jb.audio, train=True, rngs=rngs,
                        capture_intermediates=True, mutable=["intermediates"])
    dropped = np.asarray(inter["intermediates"]["dropout"]["__call__"][0])
    lstm_out = np.asarray(inter["intermediates"]["lstm_audio"]["__call__"][0])
    assert (lstm_out != 0).all()

    def loss_fn(params):
        logits = jm.apply({"params": params}, jb.audio, train=True, rngs=rngs)
        return jlosses.masked_sequence_bce(logits, jb.label, jb.mask)

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    _, metrics = jmake_train_step("audio", dropout=True, dropout_seed=3, donate=False)(
        state, jb, None)
    return {"params": from_flax_variables({"params": _np_tree(state.params)}),
            "mask": dropped != 0, "loss": float(loss), "step_loss": float(metrics["loss"]),
            "grads": from_flax_variables({"params": _np_tree(grads)})}


def test_dropout_train_step_matches_jax_with_flax_mask(dropout_jax, monkeypatch):
    """The port's train step with dropout, its draw handed flax's mask:
    loss and every gradient equal JAX's within 1e-5."""
    ref = dropout_jax
    assert 0.35 < ref["mask"].mean() < 0.65
    np.testing.assert_allclose(ref["step_loss"], ref["loss"], rtol=1e-6)
    draws = []

    def flax_mask(generator, shape, keep_prob):
        assert shape == ref["mask"].shape and keep_prob == 0.5
        draws.append(shape)
        return torch.from_numpy(ref["mask"])

    monkeypatch.setattr(vad_nets, "draw_keep", flax_mask)
    model = AudioVAD(lstm_hidden_size=32, lstm_layers=2, dropout_rate=0.5)
    model.load_state_dict(ref["params"], strict=True)
    state = create_train_state(model, learning_rate=1e-4, device="cpu")
    state, metrics = make_train_step("audio", dropout=True, dropout_seed=3)(state, _batch())
    assert len(draws) == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=GRAD_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref["grads"])
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][n], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=n)


def test_dropout_step_draws_per_step_and_reproduces(monkeypatch):
    """Two runs of the port's step with the same seed give the same
    parameters; another seed other ones; each step draws a new mask."""
    def run(seed):
        model = AudioVAD(lstm_hidden_size=16, lstm_layers=1, dropout_rate=0.5, seed=0)
        state = create_train_state(model, learning_rate=1e-3, device="cpu")
        step = make_train_step("audio", dropout=True, dropout_seed=seed)
        losses_ = [float(step(state, _batch())[1]["loss"]) for _ in range(2)]
        return losses_, [p.detach().clone() for p in model.parameters()]

    (la, pa), (lb, pb), (lc, _) = run(1), run(1), run(2)
    assert la == lb and all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert la != lc and la[0] != la[1]
