"""``RawAudioVAD`` on the port's normal serving path: the LSTM on the
hand-written kernels (``use_kernel_lstm=True``; on the CPU their plain
versions) behind the published WaveNet encoder, through
``export.make_waveform_serving_fn``, against the benchmark's plain reference
(``benchmark/reference/raw_audio.py``) on seeded weights; the default route
(the plain loop, the JAX package's scan) unchanged; the encoder's spans.

The encoder keeps its published widths (32 channels, bottleneck 64, ten
dilations 1-512: a 2,049-sample receptive field) at H=32, B=2 and 4,864
samples. No JAX here: the card case runs on a machine with the card by
``python -m pytest --noconftest -m cuda tests/test_torch_port_raw_serving.py -q``.
"""

import json
from pathlib import Path

import pytest
import torch

from avvad_tpu_torch.export import make_waveform_serving_fn
from avvad_tpu_torch.models import RawAudioVAD
from avvad_tpu_torch.ops import lstm_fused
from avvad_tpu_torch.utils import profiling
from benchmark.harness import weights as wts
from benchmark.reference import raw_audio as ref

CFG = {**json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "rawaudiovad_ref.json").read_text()), "lstm_hidden_size": 32}
B, FRAMES = 2, 16
N = CFG["hop"] * (FRAMES - 1) + CFG["nfft"]     # 4,864 samples
# fp32: the plain path and the reference sum the same products; what is
# left is the order of fp32 sums in the convolutions and the matmuls
ATOL_F32 = 1e-5
# bf16 on the CPU: its convolution adds the bias before rounding once, the
# reference (as the card and the JAX package) rounds the sum and then adds
# the bf16 bias, so an output may differ by one bf16 step (2**-8 of it) in
# each of the 22 convolutions; pooled, projected and carried through the
# recurrence that read up to 2.9e-4 over seeds 3 and 7 to 11
ATOL_BF16 = 1e-3


def _model(w: dict, dtype=torch.float32, **kw) -> RawAudioVAD:
    wavenet = {k: CFG[k] for k in ("quantization_channels", "residual_channels",
                                   "dilation_channels", "bottleneck_width", "filter_width")}
    model = RawAudioVAD(lstm_hidden_size=CFG["lstm_hidden_size"], lstm_layers=CFG["lstm_layers"],
                        out_frames=FRAMES, dtype=dtype,
                        wavenet_kwargs={**wavenet, "dilations": tuple(CFG["dilations"])}, **kw)
    if w is not None:
        model.load_state_dict(w, strict=True)
    return model


def _seeded(seed: int, device="cpu"):
    g = wts.generator(seed, torch.device(device))
    w = ref.make_weights(CFG, g, device)
    return w, torch.randn(B, N, generator=g, device=device)


def test_published_encoder_widths():
    model = _model(None)
    assert model.wavenet_en.receptive_field == 2049 < N
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref.state_shapes(CFG)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, ATOL_F32), (torch.bfloat16, ATOL_BF16)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_kernel_route_matches_reference(dtype, atol, seed):
    w, wave = _seeded(seed)
    fn = make_waveform_serving_fn(_model(w, dtype, use_kernel_lstm=True), device="cpu")
    got = fn(wave)
    want = ref.serve_probs(w, CFG, wave, FRAMES, dtype)
    assert got.shape == want.shape == (B, FRAMES, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_default_route_is_the_plain_loop():
    """Without ``use_kernel_lstm`` the recurrence is the plain loop over W_hh
    in the model dtype, bit for bit; the new options draw nothing at init."""
    default, kernel = _model(None), _model(None, use_kernel_lstm=True, lstm_state_quant="bf16")
    assert all(not c.use_kernel and c.state_quant == "none" for c in default.lstm_audio.layers())
    for k, v in default.state_dict().items():
        assert torch.equal(v, kernel.state_dict()[k]), k
    wave = _seeded(4)[1]
    with torch.no_grad():
        x = default.wavenet_en(wave[..., None])
        for cell in default.lstm_audio.layers():
            x, _ = cell(x, return_carry=True)      # the carried form: always the loop
        want = default.vad_audio(x.float())
        assert torch.equal(default(wave), want)


def test_encoder_spans_nest():
    model = _model(_seeded(5)[0], use_kernel_lstm=True)
    profiling.enable()
    profiling.reset()
    try:
        with torch.no_grad():
            model(_seeded(5)[1])
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    (enc,) = [r for r in recs if r["name"] == "encoder"]
    inside = [r["name"] for r in recs if r["parent"] == enc["id"]]
    assert inside == ["encoder.block"] * 10 + ["encoder.pool"]
    assert sum(r["name"].startswith("encoder.") for r in recs) == 11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1a_twice_a_serving_call(cuda):
    """On the card: one persistent K1a launch a layer, 2 a call, and the
    answer within the fp32 tolerance of the reference."""
    w, wave = _seeded(6, cuda)
    fn = make_waveform_serving_fn(_model(w, use_kernel_lstm=True), device=cuda)
    fn(wave)
    torch.cuda.synchronize()
    profiling.reset()
    got = fn(wave)
    torch.cuda.synchronize()
    assert lstm_fused.launch_counts()["none_persist"] == 2
    assert sum(profiling.launches().values()) == 2
    torch.testing.assert_close(got, ref.serve_probs(w, CFG, wave, FRAMES, torch.float32),
                               rtol=0, atol=ATOL_F32)
