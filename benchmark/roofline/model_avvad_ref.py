"""Operations of one AVVAD step from the configuration's shapes, by part and
by the precision the configuration states for it, whatever kernels compute
them. A real DFT of n points is counted as its dense product with the cos
and sin bases (2 x 2 n (n/2 + 1) a frame), in the STFT and in MCB alike;
elementwise work is left out. Serving (bf16 model, int8 tower): the STFT and
MCB fp32, the stem convolution bf16, the eight BasicBlocks int8, the LSTM
input projections bf16, the recurrences fp32 h x bf16 W_hh (no tensor-core
form: fp32), the head fp32. Training (fp32 throughout, the trunk frozen):
the trunk's and MCB's forward only; each LSTM layer's projection and
recurrence forward, and backward their weight and input gradients."""

from . import k2


def _dft(frames: int, n: int) -> float:
    return 2.0 * 2 * frames * n * (n // 2 + 1)


def _mcb(frames: int, cfg: dict) -> float:
    d = cfg["mcb_output_size"]
    f = d // 2 + 1
    return 2.0 * 2 * frames * f * (cfg["x_dim"] + cfg["num_video_features"] + d)


def _trunk(n: int) -> tuple:
    stem = 2.0 * n * 34 * 34 * 64 * 49
    return stem, sum(ops for ops, _ in k2.cost(n))


def parts(cfg: dict, mix: dict) -> list:
    """-> [(part, operations, precision)] of one step of the mix."""
    b, t, h, layers = mix["batch"], mix["frames"], cfg["lstm_hidden_size"], cfg["lstm_layers"]
    frames = b * t
    rec = 2.0 * frames * h * 4 * h
    proj = [2.0 * frames * (cfg["mcb_output_size"] if i == 0 else h) * 4 * h
            for i in range(layers)]
    head = 2.0 * frames * h * cfg["y_dim"]
    if mix["driver"] == "serve":
        from ..reference.model import frame_schedule

        t_src = frame_schedule(t, cfg["video_fps"], cfg["fs"] / cfg["hop"])[0]
        stem, blocks = _trunk(b * t_src)
        return [("stft", _dft(frames, cfg["nfft"]), "fp32"), ("stem_conv", stem, "bf16"),
                ("trunk_blocks", blocks, "int8"), ("mcb", _mcb(frames, cfg), "fp32"),
                ("lstm_projections", sum(proj), "bf16"), ("lstm_recurrences", layers * rec, "fp32"),
                ("head", head, "fp32")]
    stem, blocks = _trunk(frames)
    return [("trunk_forward", stem + blocks, "fp32"), ("mcb", _mcb(frames, cfg), "fp32"),
            ("lstm_projections", 3 * sum(proj), "fp32"),
            ("lstm_recurrences", 3 * layers * rec, "fp32"), ("head", 3 * head, "fp32")]
