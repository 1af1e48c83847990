"""At a tiny size on the CPU the plain reference agrees with the port's
plain path (the program's CUDA kernels run their plain PyTorch versions
there): part by part, and through whole runs of every cell's driver, which
come out ``correct`` under the cell's own limits. The test imports both; the
reference imports nothing of the program."""

import pytest
import torch

from benchmark.harness import weights as wts
from benchmark.reference import model as ref
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = ["avvad.serve_b64", "avvad.train_b16", "audiovad.serve_b64", "audiovad.train_b16"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(v >= 0 for v in res["numbers"].values())


def _weights(cell, seed=3):
    c = tiny_cell(cell)
    g = wts.generator(seed, torch.device("cpu"))
    return c, wts.make_weights(c.config, g, torch.device("cpu")), g


def test_frontend_matches_port():
    from avvad_tpu_torch.ops.stft import log_power_frontend

    cfg = tiny_cell("audiovad.serve_b64").config
    wave = torch.randn(3, 256 * 15 + 1024, generator=torch.Generator().manual_seed(1))
    port = log_power_frontend(wave, fs=16000, center=False, pad_at_end=True)[:, :16]
    torch.testing.assert_close(ref.frontend(wave, cfg, 16), port, rtol=0, atol=1e-4)


def test_mcb_matches_port():
    from avvad_tpu_torch.models.mcb import CompactBilinearPooling

    c, w, g = _weights("avvad.serve_b64")
    mod = CompactBilinearPooling(513, 512, 64)
    mod.load_state_dict({"sketch1": w["mcb.sketch1"], "sketch2": w["mcb.sketch2"]})
    a, v = torch.randn(2, 5, 513, generator=g), torch.randn(2, 5, 512, generator=g)
    torch.testing.assert_close(ref.mcb(a, v, w), mod(a, v), rtol=1e-4, atol=1e-4)


def test_int8_tower_and_scales_match_port():
    """Calibration gives the port's scales, and the static int8 trunk the
    features of the port's fused route (its plain K3 and K2) bit for bit."""
    from avvad_tpu_torch.models import ResNet18, calibrate

    c, w, g = _weights("avvad.serve_b64")
    trunk = ResNet18(quant_int8=True, quant_mode="static", stages_pallas=True,
                     dtype=torch.bfloat16)
    trunk.load_state_dict({k[len("tower.features."):]: v for k, v in w.items()
                           if k.startswith("tower.features.")}, strict=False)
    frames = torch.randn(6, 1, 67, 67, generator=g)
    trunk.eval()
    calibrate(trunk, [frames])
    scales = ref.calibrate(w, c.config, frames.view(2, 3, 67, 67), torch.bfloat16)
    port = {k: v for k, v in trunk.state_dict().items() if k.rsplit(".", 1)[-1] in
            ("q_stem", "q1", "q_out")}
    assert {k: float(v) for k, v in port.items()} == {k: float(v) for k, v in scales.items()}
    with torch.no_grad():
        torch.testing.assert_close(trunk(frames), ref.int8_trunk(frames, w, c.config, scales,
                                                                 torch.bfloat16, chunk=4),
                                   rtol=0, atol=0)


def test_lstm_matches_port_plain():
    from avvad_tpu_torch.models.lstm import LSTMStack

    c, w, g = _weights("audiovad.serve_b64")
    stack = LSTMStack(513, 32, 2, dtype=torch.bfloat16, use_kernel=True)
    stack.load_state_dict({k[len("lstm_audio."):]: v for k, v in w.items()
                           if k.startswith("lstm_audio.")})
    x = torch.randn(2, 9, 513, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(ref.lstm_stack(x, w, "lstm_audio", 2, torch.bfloat16)
                                   .float(), stack(x).float(), rtol=0, atol=1e-2)
