"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit).  Shares of a peak or
a roofline are stated against these, whatever the card's own limit."""

HBM_BYTES_PER_S = 3.35e12

# dense tensor-core rates by the dtype a cell computes in; float32 (TF32
# off) runs on the CUDA cores
FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}


def least_time_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time for work that moves ``nbytes`` and does ``flops``
    in ``dtype``: the larger of the memory and the arithmetic time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype])
