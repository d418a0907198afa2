"""Checkpoints: the npz format (``io``, the JAX package's format), the
reference ``.pth`` converter (``convert``) and the parameter-tree
interchange with the port's state dicts (``from_jax``)."""

from fastdepth_tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint  # noqa: F401
from fastdepth_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax  # noqa: F401
