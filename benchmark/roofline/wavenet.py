"""The WaveNet encoder of ``RawAudioVAD``, whole: the entry convolution, the
dilated and 1x1 dense convolutions of every block and the 1x1 bottleneck, at
the bf16 peak. Operations: 2 per multiply-add of each convolution at its
VALID output length (ReLUs, residual adds and the pool left out). Bytes: the
fp32 waveform read once and the bf16 pooled features written once; the
weights (under 100 KB) are left out. Whatever kernels compute it, the bound
is the encoder's."""

PRECISION = "bf16"


def cost(cfg: dict, mix: dict) -> tuple:
    """-> (operations, bytes) of one encoder pass over the mix's batch."""
    b, frames = mix["batch"], mix["frames"]
    fw, res, dil = cfg["filter_width"], cfg["residual_channels"], cfg["dilation_channels"]
    n = cfg["hop"] * (frames - 1) + cfg["nfft"]
    length = n - (fw - 1)
    macs = length * res * fw * cfg["quantization_channels"]
    for d in cfg["dilations"]:
        length -= d * (fw - 1)
        macs += length * (dil * res * fw + res * dil)
    macs += length * res * cfg["bottleneck_width"]
    return 2.0 * b * macs, b * (4 * n + 2 * frames * cfg["bottleneck_width"])
