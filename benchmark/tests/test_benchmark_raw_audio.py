"""The raw-waveform cell ``rawaudiovad.serve_b64`` on the CPU at a tiny size:
a run comes out ``correct`` under the cell's own limits, and neither a planted
encoder fault nor the bf16-state LSTM does; the plain reference (``reference/raw_audio.py``) agrees with
the port's ``WaveNetEncoder`` part by part and imports nothing of the
program; the encoder's roofline counts are the ones worked by hand; the
readers of the encoder's spans."""

import subprocess
import sys

import pytest
import torch

from avvad_tpu_torch.utils import profiling
from benchmark.harness import weights as wts
from benchmark.harness.spec import BENCH_DIR, ROOT, Cell, load_module
from benchmark.reference import raw_audio as ref
from benchmark.roofline import model_rawaudiovad_ref, peaks, wavenet
from benchmark.tests.tiny import run_tiny, tiny_cell

CELL = "rawaudiovad.serve_b64"


# The tiny runs serve an fp32 model: on the CPU a bf16 convolution (oneDNN)
# adds the bias before its one rounding, where the card (cuDNN, then a bf16
# add) and the reference round the sums and then add the bf16 bias; that
# difference alone reads 4.3e-5 / 5.8e-5 at the tiny runs' seed, over the
# cell's limits, which hold the card's bf16 arithmetic
FP32 = {"model_dtype": "float32"}


def test_tiny_run_correct():
    res = run_tiny(CELL, **FP32)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def _lstm_checks(res) -> dict:
    return {k: (v, lim) for k, v, lim in res["checks"] if k.startswith("lstm_")}


def test_lstm_numbers_hold_the_recurrence():
    """A bf16 model against the reference's LSTM and head on its own
    encoder features: on the CPU the kernel route's plain implementation
    is the reference's arithmetic, so the ``lstm_`` numbers read 0 whatever
    the CPU's convolutions do; the bf16-state control (K1c's arithmetic)
    breaks one of them."""
    res = run_tiny(CELL, model_dtype="bfloat16")
    checks = _lstm_checks(res)
    assert len(checks) == 2 and all(v == 0.0 for v, _ in checks.values()), checks
    res = run_tiny(CELL, model_dtype="bfloat16", lstm_state_quant="bf16")
    checks = _lstm_checks(res)
    assert not res["correct"] and any(v > lim for v, lim in checks.values()), checks


def _residual_one_sample_early(self, x):
    """``WaveNetEncoder.forward`` with each block's residual tail taken one
    sample early."""
    from avvad_tpu_torch.models.wavenet import adaptive_avg_pool1d

    x = self._conv("causal_entry", x.to(self.dtype).transpose(1, 2))
    for i in range(len(self.dilations)):
        y = self._conv(f"dense_{i}", torch.relu(self._conv(f"dilated_{i}", torch.relu(x))))
        at = x.shape[-1] - y.shape[-1] - 1
        x = y + x[..., at:at + y.shape[-1]]
    x = torch.relu(self._conv("bottleneck", x))
    return adaptive_avg_pool1d(x.transpose(1, 2), self.pool_kernel_size)


def test_encoder_fault_not_correct(monkeypatch):
    from avvad_tpu_torch.models import wavenet as port_wavenet

    monkeypatch.setattr(port_wavenet.WaveNetEncoder, "forward", _residual_one_sample_early)
    res = run_tiny(CELL, **FP32)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def _encoder(cfg, w, frames):
    from avvad_tpu_torch.models import WaveNetEncoder

    enc = WaveNetEncoder(quantization_channels=cfg["quantization_channels"],
                         residual_channels=cfg["residual_channels"],
                         dilation_channels=cfg["dilation_channels"],
                         bottleneck_width=cfg["bottleneck_width"],
                         filter_width=cfg["filter_width"], dilations=cfg["dilations"],
                         pool_kernel_size=frames)
    enc.load_state_dict({k[len(ref.ENCODER) + 1:]: v for k, v in w.items()
                         if k.startswith(ref.ENCODER + ".")}, strict=True)
    return enc


def test_encoder_matches_port_part_by_part():
    """fp32: each convolution, each block's residual stream, the bottleneck
    and the pool (its fp32 sums in another order); the pool of bf16 values
    rounded to bf16 bit for bit."""
    c = tiny_cell(CELL)
    cfg, frames = c.config, c.mix["frames"]
    g = wts.generator(7, torch.device("cpu"))
    w = ref.make_weights(cfg, g, "cpu")
    wave = torch.randn(2, cfg["hop"] * (frames - 1) + cfg["nfft"], generator=g)
    enc, f32 = _encoder(cfg, w, frames), torch.float32
    with torch.no_grad():
        x = ref.conv(wave[:, None, :], w, "causal_entry", 1, f32)
        xp = enc._conv("causal_entry", wave[:, None, :])
        torch.testing.assert_close(x, xp, rtol=0, atol=1e-6)
        for i, d in enumerate(cfg["dilations"]):
            y = ref.conv(torch.relu(x), w, f"dilated_{i}", d, f32)
            torch.testing.assert_close(y, enc._conv(f"dilated_{i}", torch.relu(x)),
                                       rtol=0, atol=1e-5)
            y2 = ref.conv(torch.relu(y), w, f"dense_{i}", 1, f32)
            torch.testing.assert_close(y2, enc._conv(f"dense_{i}", torch.relu(y)),
                                       rtol=0, atol=1e-5)
            x = y2 + x[..., x.shape[-1] - y2.shape[-1]:]
        z = torch.relu(ref.conv(x, w, "bottleneck", 1, f32))
        torch.testing.assert_close(z, torch.relu(enc._conv("bottleneck", x)), rtol=0, atol=1e-5)
        from avvad_tpu_torch.models.wavenet import adaptive_avg_pool1d

        torch.testing.assert_close(ref.pool(z, frames),
                                   adaptive_avg_pool1d(z.transpose(1, 2), frames),
                                   rtol=1e-6, atol=1e-6)
        zb = z.bfloat16()
        assert torch.equal(ref.pool(zb, frames), adaptive_avg_pool1d(zb.transpose(1, 2), frames))
        torch.testing.assert_close(ref.encoder(wave, w, cfg, frames, f32), enc(wave[..., None]),
                                   rtol=0, atol=1e-5)


def test_wavenet_cost_by_hand():
    """B=64, n = 256 x 511 + 1,024 = 131,840: 2 x MACs of the entry, the 10
    dilated and 10 dense convolutions and the bottleneck at their VALID
    lengths; the fp32 waveform read and the bf16 pooled features written."""
    c = Cell(CELL)
    b, n = 64, 131840
    lengths = [n - 2]
    for d in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        lengths.append(lengths[-1] - 2 * d)
    macs = lengths[0] * 32 * 3 + sum(ln * 32 * 32 * 4 for ln in lengths[1:]) + lengths[-1] * 32 * 64
    ops, nbytes = wavenet.cost(c.config, c.mix)
    assert lengths[-1] == 129792 and ops == 2.0 * b * macs
    assert ops / 1e12 == pytest.approx(0.7247, abs=5e-5)
    assert nbytes == b * n * 4 + b * 512 * 64 * 2 and nbytes / 1e6 == pytest.approx(37.9, abs=0.05)
    assert 1e3 * peaks.bound_s(ops, nbytes, wavenet.PRECISION) == pytest.approx(0.733, abs=5e-4)
    parts = model_rawaudiovad_ref.parts(c.config, c.mix)
    assert 1e3 * sum(o / peaks.PEAK[p] for _, o, p in parts) == pytest.approx(9.234, abs=1e-3)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.raw_audio\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'avvad_tpu_torch'))\n"
            ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _span(count, device_ms):
    return {"count": count, "host_ms": 1.0, "device_ms": device_ms, "self_ms": 0.5, "counts": {}}


STUB = {"spans": {"serve.step": _span(24, 83.0), "encoder": _span(24, 61.0),
                  "encoder.block": _span(240, 5.5), "encoder.pool": _span(24, 3.0)},
        "counters": {}, "setup": {}, "dropped": 0}
WANT = {"encoder_span_ms.serve": 61.0, "encoder_blocks_ms.serve": 55.0,
        "encoder_roofline": 100.0 * 0.73278072 / 61.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_encoder_readers(name, monkeypatch):
    read = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}").read
    c = Cell(CELL)
    rec = {"config": c.config, "mix": c.mix}
    monkeypatch.setattr(profiling, "snapshot", lambda: STUB)
    assert read(rec) == pytest.approx(WANT[name], rel=1e-6)
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"spans": {}, "counters": {}, "setup": {}, "dropped": 0})
    assert read(rec) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(rec) is None
