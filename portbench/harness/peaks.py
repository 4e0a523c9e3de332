"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the card's full 700 W), the roofline's ceilings.
The card's own power limit is read and printed beside every run."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)
