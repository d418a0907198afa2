"""Functional ops on tensors (``blocks``) and the hand-written CUDA kernels (``cuda``)."""
