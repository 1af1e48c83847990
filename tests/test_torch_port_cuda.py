"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips inside its fixture when no CUDA device is
visible (never at import), so all pytest-xdist workers collect the same
tests. Run on a machine with the card:
``python -m pytest -m cuda tests/test_torch_port_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from avvad_tpu_torch.ops import lstm_fused

pytestmark = pytest.mark.cuda

# kernel vs plain on the same card: identical fp32 formulas in another
# summation order (and expf/tanhf vs PyTorch's), compounded over T steps;
# for bf16 / int8 also the rare h whose fp32 noise crosses a rounding
# boundary of the quantised state (one LSB of one gate term)
ATOL = {"none": 1e-4, "bf16": 2e-3, "int8": 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (64, 16, 1024)])
@pytest.mark.parametrize("state_quant", ["none", "bf16", "int8"])
def test_kernel_matches_plain(cuda, state_quant, b, t, h):
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(b, t, 4 * h, generator=g).to(cuda)
    w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(cuda)
    h0 = torch.tanh(torch.randn(b, h, generator=g)).to(cuda)
    c0 = torch.randn(b, h, generator=g).to(cuda)
    before = lstm_fused.launches[state_quant]
    y = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    torch.cuda.synchronize()
    assert lstm_fused.launches[state_quant] - before == t
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant)
    assert y.shape == (b, t, h) and torch.isfinite(y).all()
    assert (y - ref).abs().max().item() < ATOL[state_quant]


@pytest.mark.parametrize("state_quant", ["none", "int8"])
def test_kernel_on_explicit_device_index(cuda, state_quant):
    """Tensors on the last visible card, with card 0 current: the wrapper
    makes the tensors' card current for the launch (on a one-card machine
    both are card 0)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator().manual_seed(3)
    xp = torch.randn(4, 5, 4 * 64, generator=g).to(dev)
    w = (torch.randn(64, 4 * 64, generator=g) / 8).to(dev)
    with torch.cuda.device(0):
        y = lstm_fused.lstm_layer_fused(xp, w, state_quant=state_quant)
    torch.cuda.synchronize(dev)
    assert y.device == dev
    ref = lstm_fused.lstm_layer_plain(xp, w, state_quant=state_quant)
    assert (y - ref).abs().max().item() < ATOL[state_quant]


def test_kernel_raises_on_wrong_dtype(cuda):
    xp = torch.zeros(2, 3, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        lstm_fused.lstm_layer_fused(xp, torch.zeros(8, 32, device=cuda))


def test_serving_fn_on_card_matches_cpu(cuda):
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD

    rng = np.random.default_rng(0)
    wave = rng.normal(size=(2, 256 * 15 + 1024)).astype(np.float32)
    video = rng.normal(size=(2, 8, 67, 67)).astype(np.float32)
    idx = np.repeat(np.arange(8), 2)
    probs = {}
    for dev in ("cpu", "cuda"):
        model = AVVAD(lstm_hidden_size=64, lstm_layers=2, use_kernel_lstm=True)
        fn = make_waveform_serving_fn(model, t_frames=16,
                                      video_frame_indices=idx, device=dev)
        probs[dev] = fn(wave, video).cpu()
    # fp32 throughout on both; cuDNN and CPU convs and DFTs reassociate
    torch.testing.assert_close(probs["cuda"], probs["cpu"], atol=1e-4, rtol=0)
