"""ResNet-18 feature trunk, float path (port of avvad_tpu/models/resnet.py).

NCHW for cuDNN; the converter transposes the JAX package's HWIO kernels to
OIHW. Same topology and numerics as the JAX float trunk: gray stem (the
(64, 3, 7, 7) kernel summed over its input channels; ``gray_input=False``
takes 3-channel frames through the whole kernel), BatchNorm eps 1e-5
computed in fp32, a -inf-padded 3x3/2 max pool, four stages of two
BasicBlocks (64, 128, 256, 512) with 1x1/2 downsample shortcuts (flax
``SAME`` at 17 -> 9 -> 5 -> 3 pads nothing, as torch's padding 0), and a
global mean pool. With ``dtype=bfloat16`` the convs run in bf16 and every
BatchNorm output is fp32, as in the JAX module. In train mode every
BatchNorm normalises with batch statistics and updates its running ones by
flax's rule (``batch_norm``), with the params frozen or not; a forward that
``torch.utils.checkpoint`` recomputes in the backward pass
(``running_stats_frozen``) leaves them alone, as flax's ``nn.remat`` keeps
the primal pass's update only. The convs are plain cuDNN
convolutions: the JAX package leaves them to XLA, outside any Pallas kernel.
A train-mode BatchNorm with its ReLU and the block's residual add (at the
stem, the max pool) runs as the port's kernels (``ops/bn_fused.py``) where
no gradient flows through it, on an fp32 CUDA tensor, outside a
data-parallel step (``_takes_fused_bn``): the frozen trunk of AV training.

``quant_int8`` turns on the W8A8 trunk (resnet.py:204-225,364-461): the
stem conv stays float, its BatchNorm output is quantised with the ``q_stem``
scale before an int8 max pool, and each block takes and returns (int8,
scale) with its ``q1`` and ``q_out`` scales; the scales are 0-d float32
buffers, "dynamic" (per-tensor max-abs on the fly), "calibrate" (the same,
recording the running max in the buffers) or "static" (the recorded max).
With ``stages_pallas`` and static scales the stem epilogue and the eight
blocks run as the fused kernels of ``ops/stem_fused.py`` and
``ops/conv_fused.py`` (NHWC int8); otherwise the unfused path runs each int8
convolution exactly as a float64 convolution over the integer values. The
fold (quantised and packed weights, folded affines) is computed once and
kept on the trunk until a parameter, a BatchNorm statistic or a scale
changes (``ResNet18.folded``); a forward that ``torch.export`` traces reads
the kept fold and never computes or writes it (fake tensors have no
storage), so a program is exported after one eager forward.

``stem_int8`` (resnet.py:293-318, 362-378) quantises the raw fp32 input with
the static ``q_in`` scale, convolves the int8 values and dequantises with
``x_scale * w_scale`` before the same BatchNorm / ReLU / ``q_stem`` / pool
chain (on the fused route: K3, then the eight K2). On the CPU the stem's int32
sums are a float64 convolution; on the card an fp32 convolution rounded to
the nearest integer, exact because every sum is an integer of magnitude at
most 127 * 127 * 49 * C_in < 2^24 (C_in = 1 gray, 3 RGB). ``stem_s2d`` keeps the JAX option's
parameter and runs the plain 7x7/2 convolution: the space-to-depth rewrite
(resnet.py:245-290) is a TPU layout trick with the same result.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sync import all_reduce_sum, data_group
from ..ops import bn_fused
from ..ops.conv_fused import conv_exact, fold_block, quant_hwio, trunk_features_int8
from ..ops.stem_fused import fold_stem, stem_epilogue_pool_quant
from ..utils.profiling import span

QUANT_MODES = ("dynamic", "calibrate", "static")

# set while torch.utils.checkpoint recomputes a forward (``remat``)
_stats_frozen = False


@contextlib.contextmanager
def running_stats_frozen():
    """Within: train-mode ``batch_norm`` normalises with batch statistics
    but leaves the running ones alone. The recompute context of the trunk's
    checkpoint, so that a remat step updates each statistic once."""
    global _stats_frozen
    saved, _stats_frozen = _stats_frozen, True
    try:
        yield
    finally:
        _stats_frozen = saved


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) over every axis but the output one (OIHW / (out, in))."""
    fan_in = math.prod(w.shape[1:])
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
          dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=padding)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               fast_variance: bool = True) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9)`` over every axis of ``x`` but the
    channel axis 1, in fp32 (float64 stays float64). Eval mode: ``bn`` with
    its running statistics. Train mode: the batch mean and BIASED variance
    (``fast_variance``: E[x^2] - E[x]^2 clamped at 0, flax's default; else
    the two-pass E[(x - mean)^2]), normalised in flax's order (x - mean) *
    (rsqrt(var + eps) * scale) + bias, and the running statistics updated as
    flax does, ra = (1 - m) ra + m batch with torch's momentum m = 0.1
    (flax's 0.9) and the biased variance (torch's own update would take the
    unbiased one), unless a recompute has them frozen
    (``running_stats_frozen``). Gradients flow through the batch
    statistics. Under ``parallel.sync.data_parallel`` the statistics are
    those of the global batch: the sum, the sum of squares (two-pass: the
    sum of squared deviations from the global mean) and the count, added
    over the data group's ranks, so every rank normalises and updates its
    running statistics as the one device would."""
    x = _at_least_fp32(x)
    if not bn.training:
        return bn(x)
    axes = [0, *range(2, x.ndim)]
    shape = [1, -1] + [1] * (x.ndim - 2)
    group = data_group()
    if group is not None:
        mean, var = _global_batch_stats(x, axes, shape, fast_variance, group)
    elif fast_variance:
        mean, var = bn_fused.moments(x, axes)
    else:
        mean = x.mean(axes)
        var = torch.mean(torch.square(x - mean.view(shape)), axes)
    mul = bn_fused.multiplier(mean, var, bn.weight, bn.running_mean, bn.running_var, bn.eps,
                              bn.momentum, not _stats_frozen)
    return bn_fused.normalise(x, mean, mul, bn.bias)


def _global_batch_stats(x: torch.Tensor, axes: list, shape: list,
                        fast_variance: bool, group) -> tuple:
    """(mean, biased variance) per channel over the data group's rows."""
    count = torch.tensor([x.numel() / x.shape[1]], dtype=x.dtype, device=x.device)
    if fast_variance:
        sums = all_reduce_sum(torch.cat([x.sum(axes), (x * x).sum(axes), count]), group)
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        return mean, torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
    sums = all_reduce_sum(torch.cat([x.sum(axes), count]), group)
    mean = sums[:-1] / sums[-1]
    sq = all_reduce_sum(torch.square(x - mean.view(shape)).sum(axes), group)
    return mean, sq / sums[-1]


def _trunk_bn_relu(bn: nn.BatchNorm2d, x: torch.Tensor, shortcut: Optional[torch.Tensor] = None,
                   shortcut_bn: Optional[nn.BatchNorm2d] = None,
                   pool: bool = False) -> torch.Tensor:
    """relu(batch_norm(bn, x) + s) in the float trunk, then the stem's 3x3/2
    max pool if ``pool``, as one ``bn`` span: s is nothing, ``shortcut`` (the
    identity), or batch_norm(shortcut_bn, shortcut) (the downsample). Where
    ``_takes_fused_bn`` holds, the kernels of ``ops/bn_fused.py`` (a
    statistics pass a BatchNorm, then one pass that normalises, adds, applies
    the ReLU and pools); else these expressions, under autograd where a
    gradient flows."""
    with span("bn"):
        bns = (bn,) if shortcut_bn is None else (bn, shortcut_bn)
        if _takes_fused_bn(x, shortcut, bns):
            return bn_fused.bn_relu(bn, x, shortcut, shortcut_bn, update=not _stats_frozen,
                                    pool=pool)
        y = batch_norm(bn, x)
        if shortcut_bn is not None:
            shortcut = batch_norm(shortcut_bn, shortcut)
        return bn_fused.epilogue(y, shortcut, True, pool)


def _takes_fused_bn(x: torch.Tensor, shortcut: Optional[torch.Tensor], bns: tuple) -> bool:
    """Whether the trunk's BatchNorms ``bns`` over x (and the shortcut) run as
    the fused kernels: train mode, an fp32 tensor on a device that has them
    (the op raises on a shape they do not take), no data group (the
    statistics of one process's rows), and no gradient through them (the
    kernels have no backward)."""
    if not (bns[0].training and x.dtype == torch.float32
            and x.device.type in bn_fused.KERNEL_DEVICE_TYPES and data_group() is None):
        return False
    if not torch.is_grad_enabled():
        return True
    tensors = [x, *(() if shortcut is None else (shortcut,)),
               *(p for bn in bns for p in (bn.weight, bn.bias))]
    return not any(t.requires_grad for t in tensors)


def _at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bn_int8(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm in flax's order of operations, which the int8
    path's requantisation is sensitive to: (x - mean) * (rsqrt(var + eps)
    * scale) + bias."""
    col = lambda v: v.float().view(1, -1, 1, 1)  # noqa: E731
    mul = torch.rsqrt(col(bn.running_var) + bn.eps) * col(bn.weight)
    return (x.float() - col(bn.running_mean)) * mul + col(bn.bias)


def act_quant(x: torch.Tensor, amax_buf: torch.Tensor, mode: str):
    """Activation -> (int8, 0-d float32 scale) (resnet.py:40-68): scale =
    max(amax, 1e-8) / 127, q = clip(round(x / scale), -127, 127). amax is
    the tensor's max |x| ("dynamic"; "calibrate" also folds it into
    ``amax_buf`` as a running max) or the recorded ``amax_buf`` ("static")."""
    if mode == "static":
        scale = static_scale(amax_buf)
    elif mode in ("dynamic", "calibrate"):
        batch_max = x.abs().amax()
        if mode == "calibrate":
            amax_buf.copy_(torch.maximum(amax_buf, batch_max))
        scale = static_scale(batch_max)
    else:
        raise ValueError(f"unknown quant mode: {mode!r}")
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def static_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127: the scale of ``act_quant`` for that amax."""
    return torch.clamp(amax, min=1e-8) / 127.0


def max_pool_i8(x_q: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool of NCHW int8 with -128 padding (resnet.py:71-81)."""
    xp = F.pad(x_q.float(), (1, 1, 1, 1), value=-128.0)
    return F.max_pool2d(xp, 3, stride=2).to(torch.int8)


def qconv_int8(x_q: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
               stride: int, padding: int) -> torch.Tensor:
    """W8A8 conv (resnet.py:84-102): NCHW int8 input and its scale, OIHW
    float weight quantised per output channel -> float32. The int32 sums
    are exact as a float64 conv (|acc| <= 127^2 * 4608 < 2^53; float32
    would not be above K ~ 1040)."""
    w_q, w_s = quant_hwio(w)
    acc = conv_exact(x_q, w_q.permute(3, 2, 0, 1), stride, padding)
    return acc * (x_scale * w_s).view(1, -1, 1, 1)


def _bn_params(bn: nn.BatchNorm2d) -> tuple:
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity / 1x1-downsample shortcut."""

    def __init__(self, in_features: int, features: int, stride: int,
                 dtype: torch.dtype, norm_eps: float,
                 generator: torch.Generator, quant_int8: bool = False):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.norm_eps = norm_eps
        self.quant_int8 = quant_int8
        if quant_int8:
            self.register_buffer("q1", torch.zeros(()))
            self.register_buffer("q_out", torch.zeros(()))
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=norm_eps)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=norm_eps)
        convs = [self.conv1, self.conv2]
        self.has_downsample = stride != 1 or in_features != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_features, features, 1, stride,
                                             0, bias=False)
            self.downsample_bn = nn.BatchNorm2d(features, eps=norm_eps)
            convs.append(self.downsample_conv)
        for c in convs:
            lecun_normal_(c.weight, generator)

    def forward_int8(self, x: tuple, mode: str) -> tuple:
        """(NCHW int8, scale) -> (NCHW int8, scale), unfused."""
        x_q, x_scale = x
        y = qconv_int8(x_q, x_scale, self.conv1.weight, self.stride, 1)
        y_q, y_scale = act_quant(F.relu(_bn_int8(self.bn1, y)), self.q1, mode)
        y = _bn_int8(self.bn2, qconv_int8(y_q, y_scale, self.conv2.weight, 1, 1))
        if self.has_downsample:
            residual = _bn_int8(self.downsample_bn, qconv_int8(
                x_q, x_scale, self.downsample_conv.weight, self.stride, 0))
        else:
            residual = x_q.float() * x_scale
        return act_quant(F.relu(y + residual), self.q_out, mode)

    def folded(self, x_scale: torch.Tensor) -> tuple:
        """-> (fold_block arguments for the fused kernel, out_scale), from
        the static scales (resnet.py:160-180). ``ResNet18.folded`` keeps
        the result between forwards."""
        params = {"conv1": self.conv1.weight, "conv2": self.conv2.weight,
                  "bn1": _bn_params(self.bn1), "bn2": _bn_params(self.bn2)}
        if self.has_downsample:
            params["downsample_conv"] = self.downsample_conv.weight
            params["downsample_bn"] = _bn_params(self.downsample_bn)
        q1_s, qo_s = static_scale(self.q1), static_scale(self.q_out)
        return fold_block(x_scale, params, q1_s, qo_s, eps=self.norm_eps), qo_s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = _trunk_bn_relu(self.bn1, _conv(x, self.conv1.weight, self.stride, 1, dt))
        y = _conv(y, self.conv2.weight, 1, 1, dt)
        if self.has_downsample:
            return _trunk_bn_relu(self.bn2, y, _conv(x, self.downsample_conv.weight,
                                                     self.stride, 0, dt), self.downsample_bn)
        return _trunk_bn_relu(self.bn2, y, x)


class _StemGray(nn.Module):
    """7x7/2 stem on the torchvision-shaped (64, 3, 7, 7) kernel. ``gray``:
    one-channel input and the kernel summed over its input channels (exact
    for a channel-replicated gray image); otherwise 3-channel input
    through the whole kernel, flax's ``nn.Conv`` stem."""

    def __init__(self, dtype: torch.dtype, generator: torch.Generator,
                 gray: bool = True):
        super().__init__()
        self.dtype = dtype
        self.gray = gray
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        """x (N, 1 or 3, H, W) -> (N, 64, H', W'). ``channels_last``: the
        output channels-last, the layout the fused int8 path's epilogue
        reads. On the card the input and the kernel are restrided to
        channels-last (one input channel: the same bytes, no copy), so that
        cuDNN writes the output channels-last itself. On the CPU the NCHW
        convolution's output is copied into that layout: oneDNN's
        channels-last float32 convolution sums in another order, and the
        requantisation after it would turn those ulps into one-LSB flips
        against the JAX package."""
        k = self.weight.sum(dim=1, keepdim=True) if self.gray else self.weight
        if not channels_last:
            return _conv(x, k, 2, 3, self.dtype)
        if not x.is_cuda:
            return _conv(x, k, 2, 3, self.dtype).contiguous(memory_format=torch.channels_last)
        return F.conv2d(_channels_last(x.to(self.dtype)),
                        _channels_last(k.to(self.dtype)), stride=2, padding=3)

    def forward_int8(self, x_q: torch.Tensor, x_scale: torch.Tensor,
                     channels_last: bool = False) -> torch.Tensor:
        """W8A8 stem (resnet.py:293-318): int8 x_q (N, C, H, W) and its scale,
        the kernel (summed when ``gray``) quantised per output channel ->
        float32 (N, 64, H', W') = int32 sums * (x_scale * w_scale).
        ``channels_last``: as ``forward``."""
        k = self.weight.sum(dim=1, keepdim=True) if self.gray else self.weight
        w_q, w_s = quant_hwio(k)
        w = w_q.permute(3, 2, 0, 1)
        if x_q.is_cuda:
            xf, wf = x_q.float(), w.float()
            if channels_last:
                xf, wf = _channels_last(xf), _channels_last(wf)
            # every product and partial sum is an integer below 2^24 in
            # magnitude, so cuDNN's strided algorithms (products summed in
            # fp32) give it exactly and the rounding only guards the order;
            # chip_smoke.py holds this route bit for bit against float64
            acc = F.conv2d(xf, wf, stride=2, padding=3).round_()
        else:
            acc = conv_exact(x_q, w, 2, 3)
            if channels_last:
                acc = acc.contiguous(memory_format=torch.channels_last)
        # in place on the sums of this call: one (N, 64, 34, 34) fp32 buffer
        return acc.mul_((x_scale * w_s).view(1, -1, 1, 1))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> channels-last; for one channel the same bytes with
    channels-last strides (no copy)."""
    t = t.contiguous()
    n, c, h, w = t.shape
    if c != 1:
        return t.contiguous(memory_format=torch.channels_last)
    return t.as_strided(t.shape, (h * w, 1, w, 1))


class ResNet18(nn.Module):
    """Gray input (N, 1, H, W), or (N, 3, H, W) with ``gray_input=False``,
    -> (N, 512) pooled features, float32. ``quant_mode`` and
    ``stages_pallas`` are plain attributes: ``calibrate`` switches them for
    its run and restores them. ``stem_int8`` (with ``quant_int8``): the W8A8
    stem on the ``q_in`` input scale; ``stem_s2d``: the JAX option's
    space-to-depth stem, the same 7x7/2 convolution here; the two are
    exclusive."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32, norm_eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None,
                 quant_int8: bool = False, quant_mode: str = "dynamic",
                 stages_pallas: bool = False, gray_input: bool = True,
                 stem_int8: bool = False, stem_s2d: bool = False):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode: {quant_mode!r}")
        if stem_int8 and stem_s2d:
            raise ValueError("stem_int8 and stem_s2d are exclusive")
        if stem_int8 and not quant_int8:
            raise ValueError("stem_int8 requires quant_int8")
        self.quant_int8 = quant_int8
        self.quant_mode = quant_mode
        self.stages_pallas = stages_pallas
        self.stem_int8 = stem_int8
        self.stem_s2d = stem_s2d
        self.conv1 = _StemGray(dtype, generator, gray=gray_input)
        self.bn1 = nn.BatchNorm2d(64, eps=norm_eps)
        if quant_int8:
            self.register_buffer("q_stem", torch.zeros(()))
        if stem_int8:
            self.register_buffer("q_in", torch.zeros(()))
        self.block_names = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, BasicBlock(cin, width, stride, dtype,
                                                 norm_eps, generator, quant_int8))
                self.block_names.append(name)
                cin = width

        self._fold = None  # (key, (a, b, specs)) of the last fold

    def blocks(self) -> list:
        return [getattr(self, name) for name in self.block_names]

    def _fold_key(self) -> tuple:
        """What the fold was computed from: identity, storage and version
        counter of every parameter and buffer. An in-place update (an
        optimizer step, ``load_state_dict``, calibration's ``copy_``, a
        train-mode BatchNorm) bumps the version; ``.to()`` or an assignment
        swaps the tensor or its storage."""
        return tuple((id(t), t.data_ptr(), t._version, t.device, t.dtype)
                     for t in (*self.parameters(), *self.buffers()))

    def folded(self) -> tuple:
        """The fused path's constants: (a, b) of ``fold_stem`` and the 8
        ``fold_block`` specs, tile-packed weights included. Computed at the
        first call and again only after a parameter, a BatchNorm statistic
        or a scale buffer changed. While a forward is traced the kept fold
        is returned as it is (``ServingArtifact.build`` runs the model once
        before it traces)."""
        if torch.compiler.is_compiling():  # torch.export traces this forward
            if self._fold is None:
                raise RuntimeError("ResNet18.folded: run the model once before "
                                   "tracing it, so that the fold is kept")
            return self._fold[1]
        key = self._fold_key()
        if self._fold is None or self._fold[0] != key:
            # ordinary tensors even under a live step's inference mode: an
            # exported program keeps them as its constants
            with torch.inference_mode(False), torch.no_grad():
                a, b = fold_stem(self.bn1, self.q_stem)
                scale, specs = static_scale(self.q_stem), []
                for block in self.blocks():
                    spec, scale = block.folded(scale)
                    specs.append(spec)
            self._fold = (key, (a, b, specs))
        return self._fold[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant_int8:
            with span("tower.stem"):
                x = self.conv1(x)
            x = _trunk_bn_relu(self.bn1, x, pool=True)
            for block in self.blocks():
                x = block(x)
            return _at_least_fp32(x.mean(dim=(2, 3)))
        if self.stages_pallas:
            return self._fused_int8(self._stem(x, channels_last=True))
        mode = self.quant_mode
        y = F.relu(_bn_int8(self.bn1, self._stem(x)))
        x_q, scale = act_quant(y, self.q_stem, mode)
        xs = (max_pool_i8(x_q), scale)
        for block in self.blocks():
            xs = block.forward_int8(xs, mode)
        return (xs[0].float() * xs[1]).mean(dim=(2, 3))

    def _stem(self, x: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        """The int8 tower's stem conv: float, or with ``stem_int8`` the W8A8
        stem on the raw fp32 input quantised by ``q_in`` (resnet.py:366-378:
        not the model-dtype cast, whose rounding would stack under the
        quantisation; symmetric quantisation keeps the zero padding exact).
        The ``tower.stem`` span."""
        with span("tower.stem"):
            if not self.stem_int8:
                return self.conv1(x, channels_last=channels_last)
            x_q, x_s = act_quant(x.float(), self.q_in, self.quant_mode)
            return self.conv1.forward_int8(x_q, x_s, channels_last=channels_last)

    def _fused_int8(self, stem: torch.Tensor) -> torch.Tensor:
        """Stem conv output (channels-last) -> stem epilogue kernel (K3) -> 8
        fused block kernels (K2) -> pooled features (resnet.py:411-447)."""
        if self.quant_mode != "static":
            raise ValueError("stages_pallas requires quant_mode='static'")
        if self.training:
            raise ValueError("stages_pallas is inference-only")
        a, b, specs = self.folded()
        x_q = stem_epilogue_pool_quant(stem, a, b)
        return trunk_features_int8(x_q, specs)
