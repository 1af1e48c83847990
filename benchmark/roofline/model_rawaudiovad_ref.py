"""Operations of one RawAudioVAD serving step from the configuration's
shapes, by part and by the precision the configuration states for it (bf16
model): the WaveNet encoder bf16 (``roofline/wavenet.py``), the LSTM input
projections bf16 (the first from the bottleneck's width), the recurrences
fp32 h x bf16 W_hh (no tensor-core form: fp32), the head fp32."""

from . import wavenet


def parts(cfg: dict, mix: dict) -> list:
    """-> [(part, operations, precision)] of one step of the mix."""
    b, t, h, layers = mix["batch"], mix["frames"], cfg["lstm_hidden_size"], cfg["lstm_layers"]
    frames = b * t
    rec = 2.0 * frames * h * 4 * h
    proj = [2.0 * frames * (cfg["bottleneck_width"] if i == 0 else h) * 4 * h
            for i in range(layers)]
    head = 2.0 * frames * h * cfg["y_dim"]
    return [("encoder", wavenet.cost(cfg, mix)[0], "bf16"),
            ("lstm_projections", sum(proj), "bf16"),
            ("lstm_recurrences", layers * rec, "fp32"), ("head", head, "fp32")]
