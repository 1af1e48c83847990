"""Plain PyTorch reference of the two configurations' forward passes.

Written from the models' published description (Ariav & Cohen, IEEE JSTSP
13(2) 2019, as ``sp-uhh/audio-visual-vad`` sets it up) and from the numeric
contract the configuration states, with no code of the program under test:

- frontend: the peak-normalised utterance, a periodic-Hann STFT of ``nfft``
  points and ``hop`` samples (the DFT as a product with its bases, fp32),
  log(|X|^2 + 1e-8);
- video tower: the gray-stem ResNet-18 (the (64, 3, 7, 7) stem kernel summed
  over its input channels), eval-mode BatchNorm, and, for serving, W8A8 int8
  activations with per-output-channel int8 weights and static per-tensor
  activation scales calibrated as the max of |x| over calibration frames.
  Served, each BatchNorm and dequantisation is folded into one fp32 affine
  per channel ahead of the requantisation, round(relu(acc * a + b)), and the
  pooled features are the int sums over 3x3 pixels times scale / 9: the
  static-int8 tower's stated arithmetic. Int8 convolutions are computed
  exactly (float64 over the integer values). The stem convolution runs in
  the serving dtype (bf16 operands, fp32 sums, bf16 result);
- fusion: compact bilinear pooling by its definition (count sketches, then
  the circular convolution through ``torch.fft``), signed square root, an L2
  norm over the whole tensor (detached), BatchNorm over the channels;
- LSTM: gate order [i, f, g, o], weights in (in, 4H) layout, the input
  projection in the model dtype, the recurrence with fp32 h and c against
  W_hh rounded to bf16 (the configuration's stated recurrence precision);
- head: fp32 Dense, sigmoid.

Weights come as a dict of fp32 tensors keyed like a checkpoint of the model
(``state_shapes``); nothing here reads a model object.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

BLOCK_STRIDES = (1, 1, 2, 1, 2, 1, 2, 1)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matmuls and convolutions on or off inside the block, whatever the
    process had set; the reference runs with them off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def block_names(cfg: dict) -> list:
    return [f"layer{s + 1}_{b}" for s, n in enumerate(cfg["trunk_blocks"]) for b in range(n)]


def _lstm_shapes(prefix: str, d_in: int, h: int, layers: int) -> dict:
    out = {}
    for i in range(layers):
        d = d_in if i == 0 else h
        out.update({f"{prefix}.layer_{i}.w_ih": (d, 4 * h),
                    f"{prefix}.layer_{i}.w_hh": (h, 4 * h),
                    f"{prefix}.layer_{i}.bias": (4 * h,)})
    return out


def _bn_shapes(prefix: str, c: int) -> dict:
    return {f"{prefix}.{k}": (c,) for k in ("weight", "bias", "running_mean", "running_var")}


def trunk_shapes(prefix: str, cfg: dict) -> dict:
    out = {f"{prefix}.conv1.weight": (64, 3, 7, 7), **_bn_shapes(f"{prefix}.bn1", 64)}
    cin = 64
    widths = [w for w, n in zip(cfg["trunk_widths"], cfg["trunk_blocks"]) for _ in range(n)]
    for name, width, stride in zip(block_names(cfg), widths, BLOCK_STRIDES):
        p = f"{prefix}.{name}"
        out[f"{p}.conv1.weight"] = (width, cin, 3, 3)
        out.update(_bn_shapes(f"{p}.bn1", width))
        out[f"{p}.conv2.weight"] = (width, width, 3, 3)
        out.update(_bn_shapes(f"{p}.bn2", width))
        if stride != 1 or cin != width:
            out[f"{p}.downsample_conv.weight"] = (width, cin, 1, 1)
            out.update(_bn_shapes(f"{p}.downsample_bn", width))
        cin = width
    return out


def state_shapes(cfg: dict) -> dict:
    """name -> shape of every weight and BatchNorm statistic of the model
    (the count sketches as dense (d_in, out) sign matrices)."""
    h, layers, x_dim = cfg["lstm_hidden_size"], cfg["lstm_layers"], cfg["x_dim"]
    if cfg["model"] == "AudioVAD":
        return {**_lstm_shapes("lstm_audio", x_dim, h, layers),
                "vad_audio.weight": (cfg["y_dim"], h), "vad_audio.bias": (cfg["y_dim"],)}
    m = cfg["mcb_output_size"]
    return {**trunk_shapes("tower.features", cfg),
            "mcb.sketch1": (x_dim, m), "mcb.sketch2": (cfg["num_video_features"], m),
            **_bn_shapes("mcb_bn", m),
            **_lstm_shapes("lstm_merged", m, h, layers),
            "vad_merged.weight": (cfg["y_dim"], h), "vad_merged.bias": (cfg["y_dim"],)}


# ----------------------------------------------------------------- frontend

def frontend(wave: torch.Tensor, cfg: dict, t_frames: int) -> torch.Tensor:
    """(B, n) PCM -> (B, t_frames, nfft // 2 + 1) log power, fp32: the DFT by
    its definition, each frame times the periodic-Hann-windowed cos and sin
    bases (made in float64, rounded once to fp32)."""
    x = wave.float()
    x = x / x.abs().amax(dim=-1, keepdim=True)
    nfft, hop = cfg["nfft"], cfg["hop"]
    n = torch.arange(nfft, dtype=torch.float64, device=x.device)
    ang = 2.0 * math.pi * n[:, None] * torch.arange(nfft // 2 + 1, dtype=torch.float64,
                                                   device=x.device)[None, :] / nfft
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / nfft))[:, None]
    cos_b, sin_b = (win * torch.cos(ang)).float(), (-win * torch.sin(ang)).float()
    frames = x.unfold(-1, nfft, hop)[:, :t_frames]
    re, im = frames @ cos_b, frames @ sin_b
    return torch.log(re * re + im * im + 1e-8)


def frame_schedule(t_frames: int, video_fps: float, frame_rate: float) -> tuple:
    """-> (t_src, (t_frames,) indices): camera-rate frames onto the audio
    timeline by ffmpeg's ``fps`` duplication (start(i) = floor(i * r + 1/2)),
    with the fewest source frames that cover ``t_frames``."""
    def starts(n):
        return np.floor(np.arange(n + 1) * frame_rate / video_fps + 0.5).astype(np.int64)

    t_src = int(math.ceil(t_frames * video_fps / frame_rate))
    while starts(t_src)[-1] < t_frames:
        t_src += 1
    idx = np.searchsorted(starts(t_src), np.arange(t_frames), side="right") - 1
    return t_src, idx


# ------------------------------------------------------------- video tower

def _bn(x, w: dict, p: str, eps: float):
    """Eval BatchNorm over channel axis 1."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    mul = torch.rsqrt(w[f"{p}.running_var"] + eps) * w[f"{p}.weight"]
    return (x.float() - w[f"{p}.running_mean"].view(shape)) * mul.view(shape) + w[f"{p}.bias"].view(shape)


def _bn_train(x, w: dict, p: str, eps: float, fast_variance: bool = True):
    """Train-mode BatchNorm: batch mean and biased variance over every axis
    but 1 (``fast_variance``: E[x^2] - E[x]^2 clamped at 0; else two-pass)."""
    axes = [0, *range(2, x.ndim)]
    shape = [1, -1] + [1] * (x.ndim - 2)
    mean = x.mean(axes)
    if fast_variance:
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
    else:
        var = torch.square(x - mean.view(shape)).mean(axes)
    mul = torch.rsqrt(var + eps) * w[f"{p}.weight"]
    return (x - mean.view(shape)) * mul.view(shape) + w[f"{p}.bias"].view(shape)


def gray_stem_kernel(w: dict, prefix: str) -> torch.Tensor:
    return w[f"{prefix}.conv1.weight"].sum(dim=1, keepdim=True)


def quant_weight(wt: torch.Tensor) -> tuple:
    """OIHW float -> (integer-valued float64 OIHW, (O,) fp32 scale):
    symmetric per output channel, amax / 127, round half to even."""
    amax = wt.float().abs().amax(dim=(1, 2, 3))
    s = torch.clamp(amax, min=1e-8) / 127.0
    return torch.round(wt.float() / s.view(-1, 1, 1, 1)).double(), s


def static_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-8) / 127.0


def quant_act(x: torch.Tensor, amax: torch.Tensor) -> tuple:
    s = static_scale(amax)
    return torch.clamp(torch.round(x / s), -127, 127), s


def _exact(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The int32 sums of an int8 convolution (exact in float64) as fp32."""
    return F.conv2d(xq.double(), wq, stride=stride, padding=pad).float()


def _qconv(xq: torch.Tensor, x_s, wt: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """Exact int8 x int8 convolution, dequantised."""
    wq, w_s = quant_weight(wt)
    return _exact(xq, wq, stride, pad) * (x_s * w_s).view(1, -1, 1, 1)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) in channels-last strides; one channel keeps its bytes."""
    t = t.contiguous()
    n, c, h, w = t.shape
    if c != 1:
        return t.contiguous(memory_format=torch.channels_last)
    return t.as_strided(t.shape, (h * w, 1, w, 1))


def stem_conv(frames: torch.Tensor, w: dict, prefix: str, dtype: torch.dtype,
              channels_last: bool = False) -> torch.Tensor:
    """(N, 1, 67, 67) -> (N, 64, 34, 34) in ``dtype``: 7x7/2, pad 3 (for
    bf16: bf16 operands and result, fp32 sums). ``channels_last``: input,
    kernel and result in that layout, whose sums cuDNN orders as it does
    for the served stem."""
    k = gray_stem_kernel(w, prefix).to(dtype)
    x = frames.to(dtype)
    if channels_last:
        x, k = _nhwc(x), _nhwc(k)
    return F.conv2d(x, k, stride=2, padding=3)


def calibrate_trunk(frames: torch.Tensor, w: dict, cfg: dict, dtype: torch.dtype) -> dict:
    """The calibration pass over (N, 1, 67, 67): the unfused W8A8 trunk, each
    activation quantised at its own max |x| -> {scale name: that max}."""
    prefix, eps = "tower.features", cfg["bn_eps"]
    amax = {}

    def quant(x, key):
        amax[key] = x.abs().amax()
        return quant_act(x, amax[key])

    y = F.relu(_bn(stem_conv(frames, w, prefix, dtype).float(), w, f"{prefix}.bn1", eps))
    xq, xs = quant(y, "q_stem")
    xq = F.max_pool2d(F.pad(xq, (1, 1, 1, 1), value=-128.0), 3, stride=2)
    for name, stride in zip(block_names(cfg), BLOCK_STRIDES):
        p = f"{prefix}.{name}"
        y = F.relu(_bn(_qconv(xq, xs, w[f"{p}.conv1.weight"], stride, 1), w, f"{p}.bn1", eps))
        yq, ys = quant(y, f"{name}.q1")
        y2 = _bn(_qconv(yq, ys, w[f"{p}.conv2.weight"], 1, 1), w, f"{p}.bn2", eps)
        if f"{p}.downsample_conv.weight" in w:
            res = _bn(_qconv(xq, xs, w[f"{p}.downsample_conv.weight"], stride, 0), w,
                      f"{p}.downsample_bn", eps)
        else:
            res = xq * xs
        xq, xs = quant(F.relu(y2 + res), f"{name}.q_out")
    return amax


def _affine(w: dict, p: str, eps: float) -> tuple:
    """Eval BatchNorm as a * x + b, (C,) fp32 each."""
    a = w[f"{p}.weight"] * torch.rsqrt(w[f"{p}.running_var"] + eps)
    return a, w[f"{p}.bias"] - w[f"{p}.running_mean"] * a


def _requant(v: torch.Tensor) -> torch.Tensor:
    """A non-negative activation onto its int8 grid: round(relu(v)) up to 127."""
    return torch.clamp(torch.round(torch.relu(v)), max=127.0)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _blocks(xq: torch.Tensor, w: dict, cfg: dict, scales: dict, xs: torch.Tensor) -> torch.Tensor:
    """The 8 static-int8 BasicBlocks over int8-valued (N, 64, 17, 17) at
    scale ``xs``, each BatchNorm and dequantisation folded ahead of its
    requantisation -> (N, 512) pooled features."""
    prefix, eps = "tower.features", cfg["bn_eps"]
    for name, stride in zip(block_names(cfg), BLOCK_STRIDES):
        p = f"{prefix}.{name}"
        q1s, qos = static_scale(scales[f"{name}.q1"]), static_scale(scales[f"{name}.q_out"])
        w1, s1 = quant_weight(w[f"{p}.conv1.weight"])
        a1, b1 = _affine(w, f"{p}.bn1", eps)
        y1 = _requant(_exact(xq, w1, stride, 1) * _col(a1 * (xs * s1) / q1s) + _col(b1 / q1s))
        w2, s2 = quant_weight(w[f"{p}.conv2.weight"])
        a2, b2 = _affine(w, f"{p}.bn2", eps)
        y2 = _exact(y1, w2, 1, 1) * _col(a2 * (q1s * s2) / qos) + _col(b2 / qos)
        if f"{p}.downsample_conv.weight" in w:
            wd, sd = quant_weight(w[f"{p}.downsample_conv.weight"])
            ad, bd = _affine(w, f"{p}.downsample_bn", eps)
            res = _exact(xq, wd, stride, 0) * _col(ad * (xs * sd) / qos) + _col(bd / qos)
        else:
            res = xq * (xs / qos)
        xq, xs = _requant(y2 + res), qos
    return xq.sum(dim=(2, 3)) * (xs / 9.0)


def int8_trunk(frames: torch.Tensor, w: dict, cfg: dict, scales: dict,
               dtype: torch.dtype, chunk: int = 4096) -> torch.Tensor:
    """The served static-int8 trunk over (N, 1, 67, 67) -> (N, 512) fp32,
    with the calibrated ``scales``. The stem convolution takes all frames in
    one call, as the served tower does; the rest goes ``chunk`` frames at a
    time."""
    prefix, eps = "tower.features", cfg["bn_eps"]
    stem = stem_conv(frames, w, prefix, dtype, channels_last=frames.is_cuda)
    s = static_scale(scales["q_stem"])
    a, b = _affine(w, f"{prefix}.bn1", eps)
    out = []
    for i in range(0, stem.shape[0], chunk):
        q = _requant(stem[i:i + chunk].float() * _col(a / s) + _col(b / s))
        q = F.max_pool2d(F.pad(q, (1, 1, 1, 1), value=-128.0), 3, stride=2)
        out.append(_blocks(q, w, cfg, scales, s))
    return torch.cat(out)


def float_trunk(frames: torch.Tensor, w: dict, cfg: dict, train: bool) -> torch.Tensor:
    """fp32 trunk over (N, 1, 67, 67) -> (N, 512); ``train``: BatchNorm on
    batch statistics (E[x^2] - E[x]^2)."""
    prefix, eps = "tower.features", cfg["bn_eps"]
    bn = (lambda x, p: _bn_train(x, w, p, eps)) if train else (lambda x, p: _bn(x, w, p, eps))
    x = F.conv2d(frames, gray_stem_kernel(w, prefix), stride=2, padding=3)
    x = F.max_pool2d(F.relu(bn(x, f"{prefix}.bn1")), 3, stride=2, padding=1)
    for name, stride in zip(block_names(cfg), BLOCK_STRIDES):
        p = f"{prefix}.{name}"
        y = F.relu(bn(F.conv2d(x, w[f"{p}.conv1.weight"], stride=stride, padding=1), f"{p}.bn1"))
        y = bn(F.conv2d(y, w[f"{p}.conv2.weight"], padding=1), f"{p}.bn2")
        if f"{p}.downsample_conv.weight" in w:
            x = bn(F.conv2d(x, w[f"{p}.downsample_conv.weight"], stride=stride), f"{p}.downsample_bn")
        x = F.relu(y + x)
    return x.mean(dim=(2, 3))


# ------------------------------------------------------------------ fusion

def count_sketch(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (..., d) through the count sketch whose dense (d, out) sign matrix
    is ``m``: out[h(i)] += s(i) x[i]."""
    h = m.abs().argmax(dim=1)
    s = m.gather(1, h[:, None])[:, 0]
    out = x.new_zeros(*x.shape[:-1], m.shape[1])
    return out.index_add_(-1, h, x * s)


def mcb(a: torch.Tensor, v: torch.Tensor, w: dict) -> torch.Tensor:
    """Compact bilinear pooling: the circular convolution of the two
    sketches, through the real FFT."""
    sa, sv = count_sketch(a.float(), w["mcb.sketch1"]), count_sketch(v.float(), w["mcb.sketch2"])
    n = sa.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(sa, dim=-1) * torch.fft.rfft(sv, dim=-1), n=n, dim=-1)


def fuse(a: torch.Tensor, v: torch.Tensor, w: dict, cfg: dict, train: bool) -> torch.Tensor:
    eps = cfg["fusion_eps"]
    y = mcb(a, v, w)
    y = torch.sign(y) * torch.sqrt(y.abs() + eps)
    y = y / torch.clamp(torch.sqrt(torch.sum(y * y)).detach(), min=1e-12)
    c = y.shape[-1]
    flat = y.reshape(-1, c)
    flat = (_bn_train(flat, w, "mcb_bn", eps, fast_variance=False) if train
            else _bn(flat, w, "mcb_bn", eps))
    return flat.reshape(y.shape)


# -------------------------------------------------------------------- LSTM

def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, in fp32; the gradient passes straight through."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


def lstm_layer(x: torch.Tensor, w: dict, p: str, dtype: torch.dtype) -> torch.Tensor:
    """(B, T, D) -> (B, T, H) in ``dtype``: the input projection in
    ``dtype``, the recurrence fp32 h x bf16-rounded W_hh."""
    w_ih, w_hh, bias = w[f"{p}.w_ih"], w[f"{p}.w_hh"], w[f"{p}.bias"]
    xp = (x.to(dtype) @ w_ih.to(dtype) + bias.to(dtype)).float()
    b, t, _ = x.shape
    hsz = w_hh.shape[0]
    wr = bf16_rounded(w_hh)
    hh = xp.new_zeros(b, hsz)
    cc = xp.new_zeros(b, hsz)
    ys = []
    for step in range(t):
        i, f, g, o = (xp[:, step] + hh @ wr).split(hsz, dim=-1)
        cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
        hh = torch.sigmoid(o) * torch.tanh(cc)
        ys.append(hh)
    return torch.stack(ys, dim=1).to(dtype)


def lstm_stack(x, w, prefix, layers, dtype):
    for i in range(layers):
        x = lstm_layer(x, w, f"{prefix}.layer_{i}", dtype)
    return x


def head(y: torch.Tensor, w: dict, p: str) -> torch.Tensor:
    return y.float() @ w[f"{p}.weight"].t() + w[f"{p}.bias"]


# ----------------------------------------------------------------- serving

def calibrate(w: dict, cfg: dict, video: torch.Tensor, dtype: torch.dtype) -> dict:
    """Static activation scales: the max |x| at every quantisation point of
    the int8 trunk over the frames of ``video`` (B, T_v, 67, 67)."""
    return calibrate_trunk(video.reshape(-1, 1, *video.shape[2:]).float(), w, cfg, dtype)


def serve_probs(w: dict, cfg: dict, wave: torch.Tensor, video: torch.Tensor | None,
                idx: torch.Tensor | None, t_frames: int, scales: dict | None,
                dtype: torch.dtype) -> torch.Tensor:
    """The served probabilities (B, T, y_dim) of one batch: waveform (B, n),
    and for AVVAD unique camera-rate frames (B, T_v, 67, 67), the gather
    onto the audio timeline and the calibrated scales."""
    a = frontend(wave, cfg, t_frames)
    layers = cfg["lstm_layers"]
    if cfg["model"] == "AudioVAD":
        y = lstm_stack(a, w, "lstm_audio", layers, dtype)
        return torch.sigmoid(head(y, w, "vad_audio"))
    b, tv = video.shape[:2]
    frames = video.reshape(b * tv, 1, *video.shape[2:]).float()
    v = int8_trunk(frames, w, cfg, scales, dtype).reshape(b, tv, -1).index_select(1, idx.long())
    y = lstm_stack(fuse(a, v, w, cfg, train=False), w, "lstm_merged", layers, dtype)
    return torch.sigmoid(head(y, w, "vad_merged"))
