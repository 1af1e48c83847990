"""Operations of one AudioVAD step from the configuration's shapes, by part
and by the precision the configuration states for it. Serving (bf16 model):
the STFT fp32 (a real DFT counted as its dense product with the cos and sin
bases), the LSTM input projections bf16, the recurrences fp32 h x bf16 W_hh
(fp32), the head fp32. Training (fp32; the features are inputs): each LSTM
layer's projection and recurrence forward, and backward their weight
gradients and the input gradient of every layer but the first."""


def parts(cfg: dict, mix: dict) -> list:
    """-> [(part, operations, precision)] of one step of the mix."""
    b, t, h, layers = mix["batch"], mix["frames"], cfg["lstm_hidden_size"], cfg["lstm_layers"]
    frames = b * t
    rec = 2.0 * frames * h * 4 * h
    proj = [2.0 * frames * (cfg["x_dim"] if i == 0 else h) * 4 * h for i in range(layers)]
    head = 2.0 * frames * h * cfg["y_dim"]
    if mix["driver"] == "serve":
        nfft = cfg["nfft"]
        stft = 2.0 * 2 * frames * nfft * (nfft // 2 + 1)
        return [("stft", stft, "fp32"), ("lstm_projections", sum(proj), "bf16"),
                ("lstm_recurrences", layers * rec, "fp32"), ("head", head, "fp32")]
    return [("lstm_projections", 2 * proj[0] + 3 * sum(proj[1:]), "fp32"),
            ("lstm_recurrences", 3 * layers * rec, "fp32"), ("head", 3 * head, "fp32")]
