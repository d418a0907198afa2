"""Native checkpoint save/restore — the port's copy of
``fastdepth_tpu/checkpoint/io.py``, byte-compatible with it in both
directions (the same npz layout and JSON sidecar).

The reference release only *loads* checkpoints ({epoch, best_result,
model} pickles, main.py:49-57); the rebuild provides the full save/resume
cycle with best-result tracking (SURVEY.md §5 'Checkpoint / resume').

Format: a single ``.npz`` holding flattened 'a/b/c' param paths plus a
JSON sidecar entry for config/meta — dependency-free, memory-mappable,
and framework-agnostic.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from fastdepth_tpu_torch.config import ModelConfig

_SEP = "/"


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if _SEP in str(k):
            # a separator inside a key would silently restructure the
            # tree on round-trip (unflatten splits on it) — fail loudly
            raise ValueError(
                f"tree key {k!r} contains the flatten separator {_SEP!r}")
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(
    path: str,
    params: Dict,
    config: ModelConfig,
    *,
    epoch: int = 0,
    best_result: Optional[Dict[str, float]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    flat = flatten_tree(_to_numpy(params))
    # numpy can't serialize ml_dtypes (bfloat16 etc.: dtype kind 'V') —
    # npz round-trips them as raw void and the load explodes.  Store the
    # bit pattern as an unsigned view and record the real dtype in meta.
    custom_dtypes: Dict[str, str] = {}
    for k, v in list(flat.items()):
        if v.dtype.kind == "V":
            custom_dtypes[k] = v.dtype.name
            flat[k] = v.view(f"u{v.dtype.itemsize}")
    meta = {
        "config": dataclasses.asdict(config),
        "epoch": epoch,
        "best_result": best_result or {},
        "extra": extra or {},
        "dtypes": custom_dtypes,
        "format_version": 1,
    }
    # atomic: a crash mid-save must not corrupt an existing checkpoint
    # (this is the resume file) — write a temp sibling, then os.replace
    final = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_checkpoint(path: str) -> Tuple[Dict, ModelConfig, Dict[str, Any]]:
    # same normalization as save_checkpoint, so a suffix-less path
    # round-trips: save('run/ckpt') writes run/ckpt.npz
    if not str(path).endswith(".npz") and not os.path.exists(path):
        path = str(path) + ".npz"
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    custom = meta.pop("dtypes", {})
    if custom:
        import ml_dtypes  # bfloat16/float8 numpy dtype definitions

        for k, name in custom.items():
            dt = np.dtype(getattr(ml_dtypes, name, name))
            flat[k] = flat[k].view(dt)
    from fastdepth_tpu_torch.config import config_from_dict

    config = config_from_dict(meta.pop("config"))
    return unflatten_tree(flat), config, meta


def save_train_checkpoint(
    path: str,
    state,
    config: ModelConfig,
    *,
    epoch: int,
    best_result: Optional[Dict[str, float]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Full resumable training state — params, SGD momentum buffers and
    the step counter — in one atomic npz, in the JAX package's layout
    (``params/…``, ``momentum/…`` in NHWC/HWIO, an int32 ``step``,
    ``extra.train_state``), so either package resumes it.  ``state`` is a
    ``train.trainer.TrainState`` (duck-typed: ``.params`` a parameter
    tree, ``.momentum`` a dict keyed like its state dict, ``.step``)."""
    from fastdepth_tpu_torch.checkpoint.from_jax import params_to_jax

    tree = {
        "params": params_to_jax(state.params.state_dict()),
        "momentum": params_to_jax(state.momentum),
        "step": np.asarray(int(state.step), np.int32),
    }
    save_checkpoint(
        path, tree, config, epoch=epoch, best_result=best_result,
        extra=dict(extra or {}, train_state=True),
    )


def load_train_checkpoint(path: str) -> Tuple[Dict, ModelConfig, Dict[str, Any]]:
    """Load a checkpoint written by :func:`save_train_checkpoint` (by
    either package).  Returns ``({'params','momentum','step'}, config,
    meta)``, the trees in the npz layout (``Trainer.restore`` converts)."""
    tree, config, meta = load_checkpoint(path)
    if not meta.get("extra", {}).get("train_state"):
        raise ValueError(
            f"{path!r} is a params-only checkpoint, not a training state; "
            "resume needs the checkpoint.npz written by cli.train (it holds "
            "the optimizer momentum and step counter too)"
        )
    return tree, config, meta


def _to_numpy(tree):
    """numpy arrays and torch tensors -> host numpy, recursively; a torch
    bfloat16 tensor becomes an ml_dtypes bfloat16 array (the dtype the
    npz sidecar records)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if type(tree).__module__.startswith("torch"):
        import torch

        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(tree)
