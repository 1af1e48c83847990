"""Plain PyTorch reference of the raw-waveform configuration's forward pass
(``configs/rawaudiovad_ref.json``).

Written from the published description (Ariav & Cohen, IEEE JSTSP 13(2)
2019: the WaveNet-encoder audio branch, as ``sp-uhh/audio-visual-vad``
wires it in ``Audio_Net.py`` behind ``wavenet_autoencoder.py``) and from the
numeric contract the configuration states, with no code of the program
under test. NCW, VALID padding throughout:

- encoder: ``x0 = entry(w)`` (width 3); for each dilation ``d`` in 1, 2, ...,
  512: ``y = dense(relu(dilated_d(relu(x))))``, ``x = y + x[..., -len(y):]``;
  ``z = relu(bottleneck(x))``; an adaptive average pool onto the label
  frames (bin k averages ``[floor(k L / T), ceil((k + 1) L / T))``). The
  reference's ReLU encoder: no tanh-sigmoid gates, no skip sum.
- precision of a bf16 model: the waveform rounded to bf16; each convolution
  in fp32 (TF32 off) over bf16-rounded operands, its sums rounded to bf16,
  then the bf16 bias added in bf16; the residual adds and ReLUs in bf16; the
  pool's fp32 mean rounded to bf16. In fp32 nothing is rounded.
- LSTM, head: ``reference/model.py``'s (the input projection in the model
  dtype, fp32 h and c against W_hh rounded to bf16; fp32 Dense, sigmoid).

Weights come as a dict of fp32 tensors keyed like a checkpoint of the model
(``state_shapes``), drawn by ``make_weights`` from the seed with the
harness's rules (``harness/weights._scale``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.harness.weights import _scale

from .model import head, lstm_stack, tf32

ENCODER = "wavenet_en"
BLOCK = 16      # utterances a pass through the encoder: 0.27 GB an fp32 activation


def _conv_shapes(name: str, cin: int, cout: int, width: int) -> dict:
    return {f"{ENCODER}.{name}.weight": (cout, cin, width), f"{ENCODER}.{name}.bias": (cout,)}


def state_shapes(cfg: dict) -> dict:
    """name -> shape of every weight of the model, the port's names."""
    fw, res, dil = cfg["filter_width"], cfg["residual_channels"], cfg["dilation_channels"]
    h, layers, bott = cfg["lstm_hidden_size"], cfg["lstm_layers"], cfg["bottleneck_width"]
    out = _conv_shapes("causal_entry", cfg["quantization_channels"], res, fw)
    for i in range(len(cfg["dilations"])):
        out.update(_conv_shapes(f"dilated_{i}", res, dil, fw))
        out.update(_conv_shapes(f"dense_{i}", dil, res, 1))
    out.update(_conv_shapes("bottleneck", res, bott, 1))
    for i in range(layers):
        d = bott if i == 0 else h
        out.update({f"lstm_audio.layer_{i}.w_ih": (d, 4 * h),
                    f"lstm_audio.layer_{i}.w_hh": (h, 4 * h),
                    f"lstm_audio.layer_{i}.bias": (4 * h,)})
    out.update({"vad_audio.weight": (cfg["y_dim"], h), "vad_audio.bias": (cfg["y_dim"],)})
    return out


def make_weights(cfg: dict, g: torch.Generator, device) -> dict:
    """name -> fp32 tensor on ``device``: one normal draw from ``g`` for all
    leaves, cut into views and scaled by kind (``_scale``)."""
    shapes = state_shapes(cfg)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = _scale(name, shape, cfg["lstm_hidden_size"])
        out[name] = flat[at:at + n].view(shape) * std + mean
        at += n
    return out


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def conv(x: torch.Tensor, w: dict, name: str, dilation: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, C, L) in ``dtype`` -> (B, C', L - dilation (width - 1)) in
    ``dtype``: fp32 sums over the rounded operands, rounded, + the rounded
    bias in ``dtype``."""
    p = f"{ENCODER}.{name}"
    y = F.conv1d(x.float(), _round(w[f"{p}.weight"], dtype), dilation=dilation)
    return y.to(dtype) + w[f"{p}.bias"].to(dtype)[:, None]


def pool(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, C, L) -> (B, frames, C): bin k the fp32 mean of
    x[..., floor(k L / frames) : ceil((k + 1) L / frames)], in x's dtype."""
    length = x.shape[-1]
    xf = x.float()
    bins = [xf[..., (k * length) // frames: -((-(k + 1) * length) // frames)].mean(dim=-1)
            for k in range(frames)]
    return torch.stack(bins, dim=1).to(x.dtype)


def encoder(wave: torch.Tensor, w: dict, cfg: dict, frames: int,
            dtype: torch.dtype) -> torch.Tensor:
    """(B, n) -> (B, frames, bottleneck) in ``dtype``."""
    x = conv(wave.to(dtype)[:, None, :], w, "causal_entry", 1, dtype)
    for i, d in enumerate(cfg["dilations"]):
        y = conv(torch.relu(x), w, f"dilated_{i}", d, dtype)
        y = conv(torch.relu(y), w, f"dense_{i}", 1, dtype)
        x = y + x[..., x.shape[-1] - y.shape[-1]:]
    return pool(torch.relu(conv(x, w, "bottleneck", 1, dtype)), frames)


def lstm_probs(w: dict, cfg: dict, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pooled encoder features (B, frames, bottleneck) -> the served
    probabilities (B, frames, y_dim): the LSTM stack, the head and the
    sigmoid, TF32 off."""
    with torch.no_grad(), tf32(False):
        y = lstm_stack(z, w, "lstm_audio", cfg["lstm_layers"], dtype)
        return torch.sigmoid(head(y, w, "vad_audio"))


def serve_probs(w: dict, cfg: dict, wave: torch.Tensor, t_frames: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The served probabilities (B, t_frames, y_dim) of one batch of
    waveforms (B, n), ``BLOCK`` utterances at a time through the encoder,
    TF32 off."""
    with torch.no_grad(), tf32(False):
        z = torch.cat([encoder(wave[i:i + BLOCK], w, cfg, t_frames, dtype)
                       for i in range(0, wave.shape[0], BLOCK)])
    return lstm_probs(w, cfg, z, dtype)
