"""CPU parity of the port's STFT frontend and frame schedule with the JAX
package (avvad_tpu.ops.stft / avvad_tpu.processing.video)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops.stft import _needs_end_pad as j_needs_end_pad
from avvad_tpu.ops.stft import log_power_frontend as jlog_power_frontend
from avvad_tpu.processing.video import fps_resample_indices as jfps
from avvad_tpu_torch.ops.stft import _needs_end_pad, log_power_frontend
from avvad_tpu_torch.processing.video import (fps_resample_indices,
                                              unique_frame_schedule)

# log-power tolerance: both sides run the same fp32 windowed-DFT matmul in
# another summation order; re/im agree to ~1e-6 of the frame scale, which
# on the quietest (cancelling) bins of white noise moves log(|X|^2) by a
# few 1e-3 at most (the bound tests/test_ops_stft.py:107-117 sets for a
# reordered fp32 DFT is 0.1 max and 1e-3 mean).
LOG_MAX, LOG_MEAN = 0.1, 1e-3


@pytest.mark.parametrize("n, center", [
    (256 * 15 + 1024, False),  # exact frame count: no end pad
    (5000, False),             # ragged: one hop of end pad
    (5000, True),              # reflect-centred frames
])
def test_log_power_frontend_matches_jax(n, center):
    x = np.random.default_rng(0).normal(size=(2, n)).astype(np.float32)
    x[1] *= 1e-3  # peak normalisation must undo the scale
    f_j = np.asarray(jlog_power_frontend(jnp.asarray(x), center=center))
    f_t = log_power_frontend(torch.from_numpy(x), center=center).numpy()
    assert _needs_end_pad(n, 16000, 64e-3, 0.25) == \
        j_needs_end_pad(n, 16000, 64e-3, 0.25)
    assert f_t.shape == f_j.shape and f_t.dtype == np.float32
    err = np.abs(f_t - f_j)
    assert err.max() < LOG_MAX and err.mean() < LOG_MEAN, (err.max(), err.mean())


def test_log_power_frontend_end_pad_adds_a_frame():
    n = 5000
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(n,)).astype(np.float32))
    padded = log_power_frontend(x, pad_at_end=True)
    plain = log_power_frontend(x, pad_at_end=False)
    assert padded.shape == (1 + (n + 256 - 1024) // 256, 513)
    assert plain.shape == (1 + (n - 1024) // 256, 513)
    # the shared frames agree up to the matmul's blocking for another row
    # count (fp32 reassociation, ~1e-5 in the log domain)
    torch.testing.assert_close(padded[: plain.shape[0]], plain, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n_in, rate_in, rate_out", [
    (48, 30.0, 62.5), (100, 25.0, 62.5), (17, 29.97, 62.5), (9, 62.5, 30.0)])
def test_fps_resample_indices_equal(n_in, rate_in, rate_out):
    np.testing.assert_array_equal(fps_resample_indices(n_in, rate_in, rate_out),
                                  jfps(n_in, rate_in, rate_out))


def test_unique_frame_schedule_is_bench_schedule():
    """The bench shape's 30 fps schedule (bench.py:433-438)."""
    t_src, idx = unique_frame_schedule(512)
    ref_src = int(np.ceil(512 * 30.0 / 62.5))
    while len(jfps(ref_src, 30.0, 62.5)) < 512:
        ref_src += 1
    assert t_src == ref_src
    np.testing.assert_array_equal(idx, jfps(ref_src, 30.0, 62.5)[:512])
