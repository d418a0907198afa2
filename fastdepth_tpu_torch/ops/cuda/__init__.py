"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Nothing here builds or loads CUDA code at import time (``_build``).
"""
