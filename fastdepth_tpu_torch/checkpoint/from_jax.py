"""The JAX package's npz parameter tree <-> the port's state dict.

The tree (``checkpoint.io``, the JAX package's npz format; nested dicts of numpy arrays,
NHWC/HWIO layout) is the interchange format.  A state-dict key is the
npz key with ``/`` replaced by ``.``; every 4-D weight goes through one
permutation, ``transpose(3, 2, 0, 1)``: HWIO ``(kh, kw, cin, cout)`` ->
OIHW ``(cout, cin, kh, kw)``, a depthwise ``(k, k, 1, C)`` -> ``(C, 1, k,
k)``, and a transposed conv's HWOI ``(kh, kw, cout / g, cin)`` -> torch's
ConvTranspose2d layout ``(cin, cout / g, kh, kw)``, dense or grouped.
Every other leaf (biases ``b``, BatchNorm ``scale/bias/mean/var``, the
classifier's 2-D ``fc.w (features, classes)``, which the port multiplies
as ``x @ w`` as JAX does) is copied as is, so both ``{'w','bn'}`` and
``{'w','b'}`` trees of every model family convert, and the round trip is
bit-exact.  bfloat16 leaves (``ml_dtypes.bfloat16`` arrays in the tree,
as ``checkpoint.io`` loads them) keep their dtype both ways.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fastdepth_tpu_torch.checkpoint.io import _to_numpy, flatten_tree, unflatten_tree


def _is_conv_weight(key: str, arr) -> bool:
    return key.rsplit(".", 1)[-1] == "w" and arr.ndim == 4


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """npz parameter tree -> flat state dict of CPU tensors (OIHW convs)."""
    sd = {}
    for key, arr in flatten_tree(tree).items():
        key = key.replace("/", ".")
        if _is_conv_weight(key, arr):
            arr = arr.transpose(3, 2, 0, 1)
        if arr.dtype.name == "bfloat16":  # torch takes ml_dtypes' arrays as their bits
            sd[key] = torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
        else:
            sd[key] = torch.tensor(arr)  # a copy: npz and JAX arrays may be read-only
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Flat state dict -> npz parameter tree of numpy arrays (HWIO convs)."""
    flat = {}
    for key, t in state_dict.items():
        arr = _to_numpy(t)
        if _is_conv_weight(key, arr):
            arr = arr.transpose(2, 3, 1, 0)
        flat[key.replace(".", "/")] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)
