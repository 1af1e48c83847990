"""K1e, ``lstm_bwd_persist_kernel``: one training LSTM layer's reverse-time
gradient recurrence, d_gates x bf16 W^T at the fp32 peak. Inputs dy, c_seq,
c_prev, the gates and W^T (bf16) read once; d_gates, dh0 and dc0 written
once."""

PRECISION = "fp32"


def cost(b: int, t: int, h: int) -> tuple:
    """-> (operations, bytes) of one launch (one layer)."""
    ops = 2.0 * b * t * h * 4 * h
    nbytes = 4 * (2 * b * t * 4 * h + 3 * b * t * h + 2 * b * h) + 2 * h * 4 * h
    return ops, nbytes
