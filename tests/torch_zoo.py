"""Shared pieces of the model zoo's CPU tests (``tests/test_torch_zoo_ops.py``,
``test_torch_decoders.py``, ``test_torch_resnet.py``): one seeded numpy
parameter tree fed to both packages, the JAX package's forward on it, and
the comparison bound.

The tree comes from the port's own init (fast: the JAX init of a ResNet
compiles for tens of seconds on the CPU) with every BatchNorm given
random statistics, so folding and inference-mode BatchNorm do real work;
its keys and shapes are held against the JAX init's separately
(:func:`jax_init_shapes`)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_from_jax, params_to_jax
from fastdepth_tpu_torch.checkpoint.io import flatten_tree, unflatten_tree
from fastdepth_tpu_torch.models import build

from torch_port_config import to_port

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
# the shuffle decoders divide the width by 4 five times (tests/test_models.py:437)
ENC_1024 = TINY_ENC[:13] + (1024,)


def random_tree(cfg, seed: int) -> dict:
    """The npz tree of a random model of ``cfg`` (a JAX ModelConfig): He
    weights from the port's init, BatchNorm scale and var in [0.5, 1.5),
    mean N(0, 0.1) and bias in [0, 0.2), in [1, 1.2) on the depth head (a
    positive shift keeps the tiny models' ReLUs from all going dark: a
    head over 4 channels is otherwise negative everywhere for some
    seeds)."""
    rng = np.random.RandomState(seed)
    model = build(to_port(cfg))
    flat = flatten_tree(params_to_jax(model.init(torch.Generator().manual_seed(seed))
                                      .state_dict()))
    for k in sorted(flat):
        leaf = k.rsplit("/", 1)[-1]
        if "/bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "var": rng.rand(*n) + 0.5,
                       "mean": rng.randn(*n) * 0.1, "bias": rng.rand(*n) * 0.2}[leaf]
            if leaf == "bias" and k.startswith(("decoder/final/", "decoder/decode_conv6/")):
                flat[k] = flat[k] + 1.0
            flat[k] = flat[k].astype(np.float32)
        else:
            flat[k] = np.array(flat[k], np.float32)
    return unflatten_tree(flat)


def port_model(cfg, tree):
    """(port Model, its params holding ``tree``) for a JAX ModelConfig."""
    model = build(to_port(cfg))
    return model, model.load(params_from_jax(tree))


def jax_apply(cfg, tree, x: np.ndarray) -> np.ndarray:
    """The JAX package's straight forward on ``tree``, jitted (a ResNet's
    eager forward compiles op by op, ~6x slower on the CPU)."""
    return np.asarray(jax.jit(jax_build(cfg).apply)(jax.tree.map(jnp.asarray, tree),
                                                    jnp.asarray(x)))


def jax_fold(cfg, tree) -> dict:
    """The JAX package's ``Model.fold`` of ``tree``, jitted, as numpy."""
    return jax.tree.map(np.asarray, jax.jit(jax_build(cfg).fold)(jax.tree.map(jnp.asarray,
                                                                              tree)))


def jax_init_shapes(cfg) -> dict:
    """The JAX init's state-dict keys and shapes, traced with eval_shape
    (nothing is drawn)."""
    tree = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


def assert_close(got, want, bound: float = 1e-4, err_msg: str = ""):
    """|got - want| <= bound * max(1, max|want|): f32 atol ``bound`` on
    outputs of order one, relative on the random ResNets' larger ones."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)
