"""The port's random init (``ops/init.py``, ``Model.init``) against the JAX
package's ``ops/init.py`` semantics: the same tree (keys and shapes as
``params_from_jax(jax_model.init(key))``), He-normal conv weights with
n = k^2 * C_out, BatchNorm leaves at their defaults.  JAX keys and torch
Generators draw different numbers, so the weights are held to the
formula's standard deviation, not to JAX's values."""

import math

import numpy as np
import pytest
import torch

import jax

from fastdepth_tpu.config import FASTDEPTH_PRUNED, FASTDEPTH_UNPRUNED, ModelConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_from_jax
from fastdepth_tpu_torch.models import build as port_build
from fastdepth_tpu_torch.ops import init as I
from torch_port_config import to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CONFIGS = {
    "pruned": FASTDEPTH_PRUNED,
    "unpruned": FASTDEPTH_UNPRUNED,
    "tiny_concat": ModelConfig(skip="concat", encoder_channels=TINY_ENC,
                               decoder_channels=TINY_DEC),
}


def build(cfg):
    """The port's model for a configuration built with the JAX class."""
    return port_build(to_port(cfg))


def _formula_std(shape):
    cout, _, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * cout))


def _jax_init_shapes(cfg):
    """params_from_jax(jax_model.init(key))'s keys and shapes, traced with
    eval_shape (nothing is drawn)."""
    tree = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_tree_has_the_jax_trees_keys_and_shapes(name):
    cfg = CONFIGS[name]
    want = _jax_init_shapes(cfg)
    got = build(cfg).init(torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want


@pytest.mark.parametrize("name", ["pruned", "unpruned"])
def test_init_conv_std_follows_the_formula_and_bn_is_exact(name):
    cfg = CONFIGS[name]
    sd = build(cfg).init(torch.Generator().manual_seed(0)).state_dict()
    pooled = []
    for k, v in sd.items():
        if k.endswith(".w"):
            std = _formula_std(v.shape)
            pooled.append((v / std).flatten())
            if v.numel() >= 500:  # a 10% band is > 3 standard errors here
                assert abs(float(v.std()) / std - 1) <= 0.1, k
            assert abs(float(v.mean())) <= 0.2 * std + 4 * std / math.sqrt(v.numel()), k
        else:
            leaf = k.rsplit(".", 1)[-1]
            fill = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}[leaf]
            assert torch.equal(v, torch.full_like(v, fill)), k
    z = torch.cat(pooled)
    assert abs(float(z.std()) - 1) <= 0.02 and abs(float(z.mean())) <= 0.02


def test_init_is_seeded_by_its_generator():
    model = build(CONFIGS["tiny_concat"])
    a = model.init(torch.Generator().manual_seed(3)).state_dict()
    b = model.init(torch.Generator().manual_seed(3)).state_dict()
    c = model.init(torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv0.w"], c["encoder.conv0.w"])


def test_init_params_fold_and_run():
    cfg = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    assert params["encoder"]["conv1"]["pw"].w.is_contiguous(memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        y = model.apply(model.fold(params), x)
    assert tuple(y.shape) == (2, 64, 64, 1) and torch.isfinite(y).all()


def test_init_tree_rejects_folded_leaves():
    model = build(CONFIGS["tiny_concat"])
    folded = model.fold(model.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="unfolded"):
        I.init_tree(folded, torch.Generator())


def test_he_normal_conv_shape_and_scale():
    w = I.he_normal_conv((64, 1, 5, 5), torch.Generator().manual_seed(0))
    assert tuple(w.shape) == (64, 1, 5, 5)
    assert abs(float(w.std()) / math.sqrt(2.0 / (25 * 64)) - 1) <= 0.1


@pytest.mark.parametrize("kind,shape_oihw", [("conv", (96, 48, 3, 3)), ("depthwise", (256, 1, 5, 5))])
def test_std_rule_matches_the_jax_init(kind, shape_oihw):
    """The same n per layer kind as fastdepth_tpu/ops/init.py: both draws
    land within 5% of one standard deviation."""
    from fastdepth_tpu.ops import init as JI

    o, i, k, _ = shape_oihw
    key = jax.random.PRNGKey(0)
    jw = (JI.he_normal_conv(key, k, k, i, o) if kind == "conv"
          else JI.he_normal_depthwise(key, k, k, o))
    tw = I.he_normal_conv(shape_oihw, torch.Generator().manual_seed(0))
    std = _formula_std(shape_oihw)
    assert abs(float(np.asarray(jw).std()) / std - 1) <= 0.05
    assert abs(float(tw.std()) / std - 1) <= 0.05
