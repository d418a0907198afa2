"""Checkpoint interchange with the JAX package's npz parameter tree."""

from fastdepth_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax  # noqa: F401
