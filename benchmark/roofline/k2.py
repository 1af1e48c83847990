"""K2, ``int8_basic_block_kernel``: one whole int8 ResNet BasicBlock a
launch, eight launches a trunk pass at 67x67 input (17x17x64 after the stem).
Operations: 2 per multiply-add of the two 3x3 convolutions and the 1x1
downsample, at the int8 peak. Bytes: the int8 input, the int8 weights and the
folded fp32 vectors read once, the int8 output written once."""

PRECISION = "int8"

# (H_in, stride, C_in, C_out) of the eight blocks of the ResNet-18 trunk
BLOCKS = ((17, 1, 64, 64), (17, 1, 64, 64), (17, 2, 64, 128), (9, 1, 128, 128),
          (9, 2, 128, 256), (5, 1, 256, 256), (5, 2, 256, 512), (3, 1, 512, 512))


def block_cost(n: int, h: int, stride: int, cin: int, cout: int) -> tuple:
    """-> (operations, bytes) of one block's launch over ``n`` frames."""
    ho = (h - 1) // stride + 1
    down = stride != 1 or cin != cout
    macs = n * ho * ho * cout * (9 * cin + 9 * cout + (cin if down else 0))
    w_bytes = 9 * cin * cout + 9 * cout * cout + (cin * cout if down else 0)
    v_bytes = 4 * cout * (6 if down else 4)
    return 2.0 * macs, n * h * h * cin + w_bytes + v_bytes + n * ho * ho * cout


def cost(n: int) -> list:
    """-> [(operations, bytes)] of the eight launches of one trunk pass."""
    return [block_cost(n, *blk) for blk in BLOCKS]
