"""K3, ``stem_epilogue_pool_nhwc_kernel``: the int8 tower's stem epilogue
(folded BatchNorm, ReLU, requantisation and the 3x3/2 max pool) over the
channels-last bf16 stem output (N, 34, 34, 64) -> (N, 17, 17, 64) int8.
Bytes: the bf16 input and the two fp32 vectors read once, the int8 output
written once. Operations, fp32: multiply, add, max, round, min per input and
8 maxima per output."""

PRECISION = "fp32"


def cost(n: int, c: int = 64) -> tuple:
    """-> (operations, bytes) of one launch over ``n`` frames."""
    x = n * 34 * 34 * c
    out = n * 17 * 17 * c
    return 5.0 * x + 8.0 * out, x * 2 + 2 * c * 4 + out
