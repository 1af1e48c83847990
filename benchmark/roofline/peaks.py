"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity), the rates every roofline and ``mfu``
here are taken against: fp32 outside the tensor cores, bf16 and int8 on them,
and HBM3 bandwidth."""

PEAK = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
MEM_BW = 3.35e12


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """Least time of a launch: max(operations over the precision's peak,
    bytes over the memory rate)."""
    return max(ops / PEAK[precision], nbytes / MEM_BW)
