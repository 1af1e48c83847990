"""K1a, ``lstm_infer_persist_kernel<0>``: one inference LSTM layer's
recurrence, fp32 h and c against W_hh in bf16 (an fp32 x bf16 product has no
tensor-core form, so its operations are counted at the fp32 peak). Each input
is read once (x_proj fp32, W_hh bf16, h0, c0) and each output written once
(y, c); 2 operations per multiply-add of the (B, H) x (H, 4H) product of
every step."""

PRECISION = "fp32"


def cost(b: int, t: int, h: int) -> tuple:
    """-> (operations, bytes) of one launch (one layer)."""
    ops = 2.0 * b * t * h * 4 * h
    nbytes = b * t * 4 * h * 4 + h * 4 * h * 2 + 3 * b * h * 4 + b * t * h * 4
    return ops, nbytes
