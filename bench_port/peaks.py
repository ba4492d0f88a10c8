"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
limit, dense, from NVIDIA's data sheet."""

FLOPS = {"torch.float32": 67e12,      # CUDA cores
         "torch.bfloat16": 989e12}    # tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time: the larger of the operations over the peak rate
    of ``dtype`` and the bytes over the memory rate."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
