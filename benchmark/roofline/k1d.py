"""K1d, ``lstm_fwd_persist_kernel<true>``: one training LSTM layer's forward
recurrence, fp32 h x bf16 W_hh at the fp32 peak. Inputs x_proj, W_hh (bf16),
h0, c0 read once; y, c_seq and the activated gates written once."""

PRECISION = "fp32"


def cost(b: int, t: int, h: int) -> tuple:
    """-> (operations, bytes) of one launch (one layer)."""
    ops = 2.0 * b * t * h * 4 * h
    nbytes = 4 * (2 * b * t * 4 * h + 2 * b * t * h + 2 * b * h) + 2 * h * 4 * h
    return ops, nbytes
