"""The port's ops and models against the JAX package on the same numpy
parameters and inputs (CPU; the fused path runs K1's plain version)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.checkpoint.io import load_checkpoint
from fastdepth_tpu.config import FASTDEPTH_PRUNED, FASTDEPTH_UNPRUNED, ModelConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.ops import blocks as JB
from fastdepth_tpu_torch.checkpoint import params_from_jax
from torch_port_config import to_port
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.models import build, from_name
from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.registry import fastdepth_pruned, fastdepth_unpruned
from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
# skip=concat widens decode_conv3..5 inputs: any widths line up
CONFIGS = {
    "add": ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
    "concat": ModelConfig(skip="concat", encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
    "dense": ModelConfig(decoder="nnconv5", encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """name -> (config, jax model, jax params, folded jax params)."""
    out = {}
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        model = jax_build(cfg)
        params = model.init(jax.random.PRNGKey(i))
        out[name] = (cfg, model, params, model.fold(params))
    return out


def _port(cfg, tree):
    model = build(to_port(cfg))
    return model, model.load(params_from_jax(_np(tree)))


# --- ops ----------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 32, 7])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (1, 1)])
@pytest.mark.parametrize("depthwise", [False, True])
def test_conv_padding_matches_jax(rng, size, k, stride, depthwise):
    """Symmetric (k-1)//2 padding gives the same output size and values
    as the JAX convs, including stride 2 on odd and even sizes."""
    cin, cout = 6, (6 if depthwise else 5)
    x = rng.randn(2, size, size, cin).astype(np.float32)
    w = rng.randn(k, k, 1 if depthwise else cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    jf, tf = (JB.depthwise_conv2d, TB.depthwise_conv2d) if depthwise else (JB.conv2d, TB.conv2d)
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(w), stride=stride, bias=jnp.asarray(b)))
    got = tf(TB.from_nhwc(torch.from_numpy(x)), torch.from_numpy(w.transpose(3, 2, 0, 1)),
             stride=stride, bias=torch.from_numpy(b))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(TB.to_nhwc(got).numpy(), want, atol=1e-4)


def test_bn_fold_relu_upsample_match_jax(rng):
    c = 7
    bn = {k: rng.rand(c).astype(np.float32) + 0.5 for k in ("scale", "bias", "mean", "var")}
    x = rng.randn(2, 5, 5, c).astype(np.float32) * 4
    w = rng.randn(3, 3, 1, c).astype(np.float32)

    class _BN:
        pass

    tbn = _BN()
    for k, v in bn.items():
        setattr(tbn, k, torch.from_numpy(v))
    jbn = {k: jnp.asarray(v) for k, v in bn.items()}
    tx = TB.from_nhwc(torch.from_numpy(x))
    np.testing.assert_allclose(TB.to_nhwc(TB.batch_norm(tx, tbn)).numpy(),
                               np.asarray(JB.batch_norm(jnp.asarray(x), jbn)), rtol=1e-6, atol=1e-6)
    jw, jb = JB.fold_bn(jnp.asarray(w), jbn)
    tw, tb = TB.fold_bn(torch.from_numpy(w.transpose(3, 2, 0, 1)), tbn)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw).transpose(3, 2, 0, 1), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    for jf, tf in ((JB.relu, TB.relu), (JB.relu6, TB.relu6),
                   (JB.upsample_nearest2x, TB.upsample_nearest2x)):
        np.testing.assert_array_equal(TB.to_nhwc(tf(tx)).numpy(), np.asarray(jf(jnp.asarray(x))))


# --- models -------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("size", [64, 32])
def test_straight_forward_matches_jax(rng, tiny, name, size):
    cfg, jmodel, params, _ = tiny[name]
    x = rng.rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    model, p = _port(cfg, params)
    with torch.no_grad():
        got = model.apply(p, torch.from_numpy(x))
    assert tuple(got.shape) == (2, size, size, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("impl", ["fused", "opt", "xla"])
@pytest.mark.parametrize("size", [64, 32])
def test_folded_forwards_match_jax(rng, tiny, impl, size):
    """Each forward of the port on folded weights vs the JAX straight
    forward on the same folded weights."""
    cfg, jmodel, _, folded = tiny["add"]
    x = rng.rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jmodel.apply(folded, jnp.asarray(x)))
    model, p = _port(cfg, folded)
    p = model.fold(p)
    before = COUNTER["K1"]
    with torch.no_grad():
        got = _pick_apply(model, p, impl, 2)(p, torch.from_numpy(x))
    assert COUNTER["K1"] == before  # CPU: K1's plain version, never a launch
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", ["add", "concat"])
def test_opt_forward_matches_jax_opt(rng, tiny, name):
    from fastdepth_tpu.models.fused import apply_fastdepth_opt as jax_opt

    cfg, _, _, folded = tiny[name]
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_opt(folded, jnp.asarray(x), cfg))
    model, p = _port(cfg, folded)
    with torch.no_grad():
        got = F.apply_fastdepth_opt(p, torch.from_numpy(x), model.config)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_folded_matches_unfolded(rng, tiny, name):
    cfg, _, params, _ = tiny[name]
    model, p = _port(cfg, params)
    x = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    folded = model.fold(p)
    assert F.tree_has_bn(p) and not F.tree_has_bn(folded)
    with torch.no_grad():
        np.testing.assert_allclose(model.apply(folded, x).numpy(),
                                   model.apply(p, x).numpy(), atol=1e-4)
    # folding copies: the caller's tree keeps its BatchNorms
    assert F.tree_has_bn(p)


def test_fold_attaches_k1_layouts_outside_the_state_dict(tiny):
    cfg, _, params, _ = tiny["add"]
    model, p = _port(cfg, params)
    folded = model.fold(p)
    stage = folded["decoder"]["decode_conv1"]
    assert tuple(stage.k1_dw.shape) == (25, TINY_ENC[-1])
    assert tuple(stage.k1_pw.shape) == (TINY_ENC[-1], TINY_DEC[0])
    assert not any("k1_" in k for k in folded.state_dict())
    # the fused forward needs them: a tree folded some other way is refused
    bare = build(model.config).load(folded.state_dict())
    with pytest.raises(ValueError, match="Model.fold"):
        F.apply_fastdepth_fused(bare, torch.zeros(1, 32, 32, 3), model.config)


def test_fullwidth_pruned_rehearsal_weights_match_jax(rng):
    """The flagship at full width, 224x224, batch 2, with the committed
    trained weights: the port's default (fused) forward vs the JAX
    forward.  atol 1e-3 / rtol 1e-4: 28 f32 conv layers summed in
    another order."""
    tree, cfg, _ = load_checkpoint(os.path.join(REPO, "docs", "rehearsal_model_r5.npz"))
    assert cfg == FASTDEPTH_PRUNED
    jmodel = jax_build(cfg)
    jfolded = jmodel.fold(jax.tree.map(jnp.asarray, tree))
    x = rng.rand(2, 224, 224, 3).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(jfolded, jnp.asarray(x)))
    model = build(to_port(cfg))
    p = model.fold(model.load(params_from_jax(tree)))
    with torch.no_grad():
        got = _pick_apply(model, p, "auto", 2)(p, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 224, 224, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)


# --- registry and dispatch ----------------------------------------------

def test_registry_names_and_unported_families():
    """The flagship names, and every family the JAX registry builds (the
    port once refused all but the MobileNet skip family): each name
    builds and parses to JAX's config (their trees are held against the
    JAX init's in tests/test_torch_{decoders,resnet,zoo_ops}.py)."""
    from fastdepth_tpu.models import from_name as jax_from_name

    assert from_name("mobilenet-nnconv5dw-skipadd-pruned").config == to_port(FASTDEPTH_PRUNED)
    assert fastdepth_pruned().config == to_port(FASTDEPTH_PRUNED)
    assert fastdepth_unpruned().config == to_port(FASTDEPTH_UNPRUNED)
    assert from_name("mobilenet-nnconv5dw-skipconcat").config.skip == "concat"
    for name in ("resnet50-upproj", "mobilenet-nnconv5", "resnet18-nnconv5-skipconcat",
                 "resnet18-nnconv5-skipadd", "mobilenet-nnconv5dw", "mobilenet-deconv3",
                 "mobilenet-shuffle9dw", "resnet152-blconv7dw"):
        assert from_name(name).config == to_port(jax_from_name(name).config), name


def test_pick_apply_dispatch(tiny, monkeypatch):
    cfg, _, params, _ = tiny["add"]
    model, p = _port(cfg, params)
    folded = model.fold(p)
    calls = []
    for name in ("apply_fastdepth_fused", "apply_fastdepth_opt", "apply_fastdepth_mixed"):
        monkeypatch.setattr(F, name, lambda *a, name=name: calls.append(name))
    x = torch.zeros(2, 32, 32, 3)

    def picks(m, params, impl, batch, tuning=None):
        calls.clear()
        fn = _pick_apply(m, params, impl, batch, tuning=tuning)
        if fn == m.apply:
            return "xla"
        fn(params, x)
        return calls[0]

    # auto: K1 on folded params at any batch size; straight when unfolded
    assert picks(model, folded, "auto", 1) == "apply_fastdepth_fused"
    assert picks(model, folded, "auto", 8) == "apply_fastdepth_fused"
    assert picks(model, p, "auto", 8) == "xla"
    assert picks(model, folded, "opt", 8) == "apply_fastdepth_opt"
    assert picks(model, folded, "xla", 8) == "xla"
    for impl in ("fused", "opt"):
        with pytest.raises(ValueError, match="folded"):
            _pick_apply(model, p, impl, 2)
    # the tuned dispatch: mixed with a winner map; refused without one
    assert picks(model, folded, "mixed", 8, {1: "pallas"}) == "apply_fastdepth_mixed"
    for impl in ("mixed", "bogus"):
        with pytest.raises(ValueError, match="impl"):
            _pick_apply(model, folded, impl, 2)
    # skip=concat is outside K1's stage shape: auto follows the JAX rule
    ccfg, _, _, cfolded = tiny["concat"]
    cmodel, cp = _port(ccfg, cfolded)
    with pytest.raises(ValueError, match="skip-add"):
        _pick_apply(cmodel, cp, "fused", 2)
    assert picks(cmodel, cp, "auto", 1) == "xla"
    assert picks(cmodel, cp, "auto", 2) == "apply_fastdepth_opt"
