"""CPU parity of the port's LSTM (avvad_tpu_torch) with the JAX package.

The JAX side runs the Pallas recurrence in interpret mode, as
tests/test_lstm_pallas.py does; the port runs the plain PyTorch version
of its CUDA kernels (a CPU tensor never reaches a kernel). Inputs come
from numpy so both frameworks see the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.models import LSTMStack as JLSTMStack
from avvad_tpu.models.lstm import select_last as jselect_last
from avvad_tpu.ops.lstm_pallas import lstm_layer_fused as jlstm_layer_fused
from avvad_tpu.ops.qparams import weight_qparams as jweight_qparams
from avvad_tpu_torch.models.lstm import LSTMStack, select_last
from avvad_tpu_torch.ops.lstm_fused import launch_counts, lstm_layer_fused
from avvad_tpu_torch.ops.qparams import weight_qparams

# fp32 paths: the same arithmetic in another summation order, a few ulp of
# unit-scale hidden states
ATOL_F32 = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(16, 64), (3, 3, 4, 8), (7,)])
def test_weight_qparams_bit_identical(shape):
    """int8 weights and scales equal the JAX package's bit for bit
    (torch.round and jnp.round both round half to even)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=shape).astype(np.float32)
    w.flat[0] = 0.5 * np.abs(w).max()  # lands 63.5 -> a tie on the grid
    q_j, s_j = jweight_qparams(jnp.asarray(w))
    q_t, s_t = weight_qparams(_t(w))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def _layer_inputs(seed, b=3, t=9, h=32, with_state=False):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(b, t, 4 * h)).astype(np.float32)
    w = (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32)
    state = None
    if with_state:
        state = (np.tanh(rng.normal(size=(b, h))).astype(np.float32),
                 rng.normal(size=(b, h)).astype(np.float32))
    return xp, w, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_lstm_layer_matches_pallas(state_quant, with_state):
    """Plain recurrence == the Pallas kernel (interpret) for each variant,
    with and without an initial state; B=3 is not a TPU tile multiple, so
    the JAX side pads and the port must give the same rows unpadded."""
    xp, w, state = _layer_inputs(0, with_state=with_state)
    kw_j, kw_t = {}, {}
    if state is not None:
        kw_j = dict(h0=jnp.asarray(state[0]), c0=jnp.asarray(state[1]))
        kw_t = dict(h0=_t(state[0]), c0=_t(state[1]))
    y_j = jlstm_layer_fused(jnp.asarray(xp), jnp.asarray(w), interpret=True,
                            state_quant=state_quant, **kw_j)
    before = launch_counts()
    y_t = lstm_layer_fused(_t(xp), _t(w), state_quant=state_quant, **kw_t)
    assert launch_counts() == before  # a CPU tensor never counts a kernel launch
    assert y_t.shape == (3, 9, 32) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL_F32)


def test_int8_state_rounds_half_to_even():
    """h0 values whose 127*h is exactly k + 0.5 in fp32: the port's qh
    must round them to even as jnp.round does (CUDA's roundf would not),
    so the first step's int8 product matches the Pallas kernel."""
    k = np.arange(-120, 120, dtype=np.float32) + np.float32(0.5)
    cand = (k / np.float32(127.0)).astype(np.float32)
    ties = cand[cand * np.float32(127.0) == k]
    assert ties.size > 50
    np.testing.assert_array_equal(
        torch.round(_t(ties) * 127.0).numpy(),
        np.asarray(jnp.round(jnp.asarray(ties) * 127.0)))
    h = 64
    b = ties.size // h
    h0 = ties[: b * h].reshape(b, h)
    rng = np.random.default_rng(3)
    xp = rng.normal(size=(b, 2, 4 * h)).astype(np.float32)
    w = (rng.normal(size=(h, 4 * h)) * 0.3).astype(np.float32)
    c0 = np.zeros((b, h), np.float32)
    y_j = jlstm_layer_fused(jnp.asarray(xp), jnp.asarray(w),
                            h0=jnp.asarray(h0), c0=jnp.asarray(c0),
                            interpret=True, state_quant="int8")
    y_t = lstm_layer_fused(_t(xp), _t(w), h0=_t(h0), c0=_t(c0),
                           state_quant="int8")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL_F32)


def _jax_stack_to_port(variables, d, h, layers, **kw):
    stack = LSTMStack(d, h, layers, **kw)
    with torch.no_grad():
        for i, cell in enumerate(stack.layers()):
            p = variables["params"][f"layer_{i}"]
            for name in ("w_ih", "w_hh", "bias"):
                getattr(cell, name).copy_(_t(p[name]))
    return stack


@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_lstm_stack_kernel_path_matches_jax(state_quant):
    """LSTMStack with the kernel recurrence (plain version on the CPU) vs
    the JAX stack with use_pallas=True, weights carried across."""
    b, t, d, h = 2, 7, 12, 16
    x = np.random.default_rng(4).normal(size=(b, t, d)).astype(np.float32)
    jm = JLSTMStack(hidden_size=h, num_layers=2, use_pallas=True,
                    state_quant=state_quant)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    y_j = jm.apply(variables, jnp.asarray(x))
    port = _jax_stack_to_port(variables, d, h, 2, use_kernel=True,
                              state_quant=state_quant)
    with torch.no_grad():
        y_t = port(_t(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL_F32)


def test_lstm_stack_carries_match_jax():
    """The carry path (plain loop, fp32 W) across two chunks == the JAX
    scan with carries, and the carries themselves agree."""
    b, t, d, h = 2, 10, 12, 16
    x = np.random.default_rng(5).normal(size=(b, t, d)).astype(np.float32)
    jm = JLSTMStack(hidden_size=h, num_layers=2)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    port = _jax_stack_to_port(variables, d, h, 2, use_kernel=True)

    y_full_j = jm.apply(variables, jnp.asarray(x))
    y1_j, c1_j = jm.apply(variables, jnp.asarray(x[:, :4]),
                          return_carries=True)
    y2_j, c2_j = jm.apply(variables, jnp.asarray(x[:, 4:]), carries=c1_j,
                          return_carries=True)
    with torch.no_grad():
        y1_t, c1_t = port(_t(x[:, :4]), return_carries=True)
        y2_t, c2_t = port(_t(x[:, 4:]), carries=c1_t, return_carries=True)
    np.testing.assert_allclose(torch.cat([y1_t, y2_t], 1).numpy(),
                               np.asarray(y_full_j), atol=ATOL_F32)
    np.testing.assert_allclose(y2_t.numpy(), np.asarray(y2_j), atol=ATOL_F32)
    for (hj, cj), (ht, ct) in zip(c2_j, c2_t):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL_F32)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL_F32)


def test_select_last_matches_jax():
    out = np.random.default_rng(6).normal(size=(4, 6, 3)).astype(np.float32)
    lengths = np.array([6, 1, 3, 0])  # 0 clamps to the first step
    np.testing.assert_array_equal(
        select_last(_t(out), _t(lengths)).numpy(),
        np.asarray(jselect_last(jnp.asarray(out), jnp.asarray(lengths))))
