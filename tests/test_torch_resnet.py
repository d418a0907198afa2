"""The ResNet family in the port against the JAX package on the same
numpy tree and frames (CPU, f32, bound 1e-4 * max(1, max|JAX|): the
random ResNets' outputs reach the thousands): ResNet-18 and -34 plain,
skip-add and skip-concat, ResNet-50 plain and with ``bottleneck_skips``
add / concat, straight and folded; the refusals (the Bottleneck guard,
unknown depths and families) with JAX's errors; and a ResNet-18 + UpProj
train step in f64 on both sides against JAX's ``make_train_step``
(jitted, with its stem's max pool swapped for a form jit can
differentiate: :func:`_differentiable_max_pool`)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from fastdepth_tpu.checkpoint.io import flatten_tree as jax_flatten
from fastdepth_tpu.config import ModelConfig
from fastdepth_tpu.config import TrainConfig as JaxTrainConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.models import resnet as JRN
from fastdepth_tpu.ops import blocks as JB
from fastdepth_tpu.train import trainer as JT
from fastdepth_tpu_torch.checkpoint import params_from_jax, params_to_jax
from fastdepth_tpu_torch.checkpoint.io import flatten_tree
from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models import resnet as RN
from fastdepth_tpu_torch.train.trainer import make_train_step, sgd_init

import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from torch_port_config import to_port
from torch_zoo import (TINY_DEC, assert_close, jax_apply, jax_fold, jax_init_shapes, port_model,
                       random_tree)

CONFIGS = {
    "resnet18_upproj": (ModelConfig(encoder="resnet18", decoder="upproj", skip=None,
                                    decoder_channels=TINY_DEC), 32, 2),
    "resnet18_skipadd": (ModelConfig(encoder="resnet18", decoder="nnconv5", skip="add"), 64, 1),
    "resnet18_skipconcat": (ModelConfig(encoder="resnet18", decoder="nnconv5", skip="concat"),
                            32, 2),
    "resnet34_deconv3": (ModelConfig(encoder="resnet34", decoder="deconv3", skip=None,
                                     decoder_channels=TINY_DEC), 32, 2),
    "resnet34_skipadd": (ModelConfig(encoder="resnet34", decoder="nnconv5", skip="add"), 32, 2),
    "resnet34_skipconcat": (ModelConfig(encoder="resnet34", decoder="nnconv5", skip="concat"),
                            32, 1),
    "resnet50_upproj": (ModelConfig(encoder="resnet50", decoder="upproj", skip=None,
                                    decoder_channels=TINY_DEC), 32, 1),
    "resnet50_skipadd_bottleneck": (ModelConfig(encoder="resnet50", decoder="nnconv5",
                                                skip="add", bottleneck_skips=True), 32, 1),
    "resnet50_skipconcat_bottleneck": (ModelConfig(encoder="resnet50", decoder="nnconv5",
                                                   skip="concat", bottleneck_skips=True), 32, 2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_resnet_matches_jax_straight_and_folded(rng, name):
    cfg, size, batch = CONFIGS[name]
    tree = random_tree(cfg, list(CONFIGS).index(name))
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    want = jax_apply(cfg, tree, x)
    assert want.shape == (batch, size, size, 1) and float(np.abs(want).max()) > 1e-3
    model, p = port_model(cfg, tree)
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == jax_init_shapes(cfg)
    folded = model.fold(p)
    if name == "resnet50_skipadd_bottleneck":  # every leaf kind: conv2, skip_proj
        jflat = jax_flatten(jax_fold(cfg, tree))
        tflat = flatten_tree(params_to_jax(folded.state_dict()))
        assert jflat.keys() == tflat.keys()
        for k in jflat:
            np.testing.assert_allclose(tflat[k], jflat[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # no ResNet takes the head-commute or the kernels' forward: straight
    assert _pick_apply(model, folded, "auto", batch) == model.apply
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert_close(model.apply(p, xt).numpy(), want, err_msg="straight")
        assert_close(model.apply(folded, xt).numpy(), want, err_msg="folded")


def test_skip_proj_keys_are_sorted_and_project_only_mismatched_taps():
    """bottleneck_skips on add: 1x1 + BN projections for the taps whose
    width differs from the add width (x3..x6 on ResNet-50, not x1), under
    sorted keys as in the JAX tree; none on the BasicBlock depths."""
    p = RN.make_resnet_depth(to_port(CONFIGS["resnet50_skipadd_bottleneck"][0]))
    proj = p["decoder"]["skip_proj"]
    assert list(proj) == ["x3", "x4", "x5", "x6"]
    assert tuple(proj["x6"].w.shape) == (512, 2048, 1, 1)
    assert "skip_proj" not in RN.make_resnet_depth(to_port(CONFIGS["resnet18_skipadd"][0]))[
        "decoder"]


REFUSED = [
    dict(encoder="resnet50", skip="add"),                       # the Bottleneck guard
    dict(encoder="resnet101", skip="concat"),
    dict(encoder="resnet18", decoder="upproj", skip="add"),     # skip models are nnconv only
    dict(encoder="resnet18", skip="add", bottleneck_skips=True),
    dict(encoder="vgg16", skip=None),                           # unknown family
]


@pytest.mark.parametrize("kw", REFUSED)
def test_refusals_equal_the_jax_ones(kw):
    with pytest.raises(ValueError) as want:
        jax_build(ModelConfig(**kw))
    with pytest.raises(ValueError) as got:
        build(to_port(ModelConfig(**kw)))
    assert str(got.value) == str(want.value)


def test_bottleneck_guard_below_validate_and_unknown_depths_equal_the_jax_ones():
    """The tree builder's own guard, reached by a caller that skips
    ModelConfig.validate(), and a depth torchvision does not define
    (build accepts it, as JAX's does; making the tree refuses it)."""
    cfg = ModelConfig(encoder="resnet50", skip="add")
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda k: JRN.init_resnet_depth(k, cfg), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        RN.make_resnet_depth(to_port(cfg))
    assert str(got.value) == str(want.value) and "bottleneck_skips=True" in str(got.value)
    cfg = ModelConfig(encoder="resnet20", skip=None)
    jm, tm = jax_build(cfg), build(to_port(cfg))
    with pytest.raises(ValueError) as want:
        jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        tm.init(torch.Generator())
    assert str(got.value) == str(want.value)


def test_resnet50_upproj_name_parses_as_jax():
    from fastdepth_tpu.models import from_name as jax_from_name
    from fastdepth_tpu_torch.models import from_name

    for name in ("resnet50-upproj", "resnet18-nnconv5-skipconcat", "resnet34-nnconv5-skipadd"):
        assert dataclasses.asdict(from_name(name).config) == \
            dataclasses.asdict(jax_from_name(name).config), name


# --- a train step in f64 --------------------------------------------------

TRAIN_CFG = CONFIGS["resnet18_upproj"][0]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _differentiable_max_pool(x):
    """JAX's ``blocks.max_pool_3x3_s2`` with a Python ``-inf`` as the
    init value: JAX then lowers it to its max-pool primitive, which jit
    can differentiate; with the package's array init value (JAX 0.9) the
    jitted gradient fails ("Linearization failed"), so the JAX package
    cannot train a ResNet jitted.  The same values forward."""
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                             ((0, 0), (1, 1), (1, 1), (0, 0)))


def test_resnet18_upproj_train_steps_match_jax_in_f64(monkeypatch):
    """Two SGD steps (momentum, weight decay, train-mode BatchNorm) of
    ResNet-18 + UpProj (decoder widths cut to 18..4) at 32x32 b4, from one
    tree and batch, in f64 on both sides (the f32 gradient at random init
    is ill-conditioned: tests/test_torch_train.py): loss rtol 1e-5 each
    step; every parameter, momentum buffer and BatchNorm running statistic
    (the port's paths, ('encoder', 'layer1', 'block0', 'conv1', 'bn'),
    are JAX's) within 1e-4 after."""
    rng = np.random.RandomState(3)
    tree = _f64(random_tree(TRAIN_CFG, 11))
    rgb = rng.rand(4, 32, 32, 3)
    depth = rng.rand(4, 32, 32, 1) * 5 + 0.5
    depth[0, :4, :4, 0] = 0.0
    model = build(to_port(TRAIN_CFG))
    state = sgd_init(model.load(params_from_jax(tree)).double())
    assert (("encoder", "layer1", "block0", "conv1", "bn"), "mean") in state.flat.running_keys
    step = make_train_step(model, TrainConfig(lr=0.01, weight_decay=1e-4))
    probe = jnp.asarray(rng.randn(2, 9, 9, 3))
    np.testing.assert_array_equal(np.asarray(_differentiable_max_pool(probe)),
                                  np.asarray(JB.max_pool_3x3_s2(probe)))
    monkeypatch.setattr(JB, "max_pool_3x3_s2", _differentiable_max_pool)
    with jax.enable_x64(True):
        jstep = jax.jit(JT.make_train_step(jax_build(TRAIN_CFG),
                                           JaxTrainConfig(lr=0.01, weight_decay=1e-4)))
        jstate = JT.sgd_init(jax.tree.map(jnp.asarray, tree))
        for _ in range(2):
            jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(0.01))
            state, loss = step(state, torch.from_numpy(rgb), torch.from_numpy(depth), 0.01)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jflat = jax_flatten(jax.tree.map(np.asarray, jstate.params))
        jflat.update({"momentum/" + k: v for k, v in
                      jax_flatten(jax.tree.map(np.asarray, jstate.momentum)).items()})
    flat = flatten_tree(params_to_jax(state.params.state_dict()))
    flat.update({"momentum/" + k: v for k, v in
                 flatten_tree(params_to_jax(state.momentum)).items()})
    assert flat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(flat[k], jflat[k], atol=1e-4, rtol=0, err_msg=k)
