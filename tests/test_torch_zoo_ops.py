"""The model zoo's ops, init rules, classifier and parameter interchange in
the port against the JAX package on the same numpy inputs (CPU, f32,
atol 1e-4 unless said): transposed convs dense and grouped, bilinear x2,
zero unpool, pixel shuffle, both pools, the transposed BatchNorm fold,
the ConvTranspose / biased-conv / classifier init rules, the ImageNet
classifier with its top-k (ties included), ``params_from_jax`` /
``params_to_jax`` bit for bit on a model of every family, the trainer on
transposed leaves, and the engine's entry points (Evaluator, validate(),
compile_forward, InferenceServer) on zoo models."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.config import ModelConfig
from fastdepth_tpu.models import mobilenet as JMN
from fastdepth_tpu.ops import blocks as JB
from fastdepth_tpu.ops import init as JI
from fastdepth_tpu_torch.checkpoint import params_from_jax, params_to_jax
from fastdepth_tpu_torch.checkpoint.io import flatten_tree
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models import mobilenet as MN
from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops import init as I

import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from torch_port_config import to_port
from torch_zoo import ENC_1024, TINY_DEC, TINY_ENC, jax_init_shapes, port_model, random_tree


def _t(x_nhwc: np.ndarray) -> torch.Tensor:
    return TB.from_nhwc(torch.from_numpy(x_nhwc))


def _np(y: torch.Tensor) -> np.ndarray:
    return TB.to_nhwc(y).numpy()


class _BN:
    def __init__(self, rng, c):
        for k in ("scale", "bias", "mean", "var"):
            setattr(self, k, torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5))

    def jax(self):
        return {k: jnp.asarray(getattr(self, k).numpy()) for k in ("scale", "bias", "mean", "var")}


# --- ops ----------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 4, 5, 9])
@pytest.mark.parametrize("grouped", [False, True])
def test_conv2d_transpose_matches_jax(rng, k, grouped):
    """Dense and depthwise (groups == C) transposed convs at the deconv
    decoders' stride 2, padding (k-1)//2, output_padding k%2, with a bias;
    the HWOI weight reaches torch's layout through params_from_jax's
    permutation."""
    cin = 6
    cout_g, groups = (1, cin) if grouped else (5, 1)
    x = rng.randn(2, 7, 7, cin).astype(np.float32)
    w = rng.randn(k, k, cout_g, cin).astype(np.float32)
    b = rng.randn(cout_g * groups).astype(np.float32)
    kw = dict(stride=2, padding=(k - 1) // 2, output_padding=k % 2, groups=groups)
    want = np.asarray(JB.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                                          **kw))
    tw = params_from_jax({"convt": {"w": w}})["convt.w"]
    assert tuple(tw.shape) == (cin, cout_g, k, k)
    got = _np(TB.conv2d_transpose(_t(x), tw, bias=torch.from_numpy(b), **kw))
    assert got.shape == want.shape == (2, 14, 14, cout_g * groups)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("size", [5, 8])
def test_bilinear_unpool_and_pixel_shuffle_match_jax(rng, size):
    x = rng.randn(2, size, size, 8).astype(np.float32)
    for jf, tf, tol in ((JB.upsample_bilinear2x, TB.upsample_bilinear2x, 1e-5),
                        (JB.unpool_zero, TB.unpool_zero, 0),
                        (lambda v: JB.pixel_shuffle(v, 2), lambda v: TB.pixel_shuffle(v, 2), 0)):
        want = np.asarray(jf(jnp.asarray(x)))
        y = tf(_t(x))
        assert y.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_np(y), want, atol=tol, rtol=0)


@pytest.mark.parametrize("size", [7, 8, 9])
def test_pools_match_jax(rng, size):
    """The stem's max pool pads with -inf (all-negative input: a zero pad
    would win); the classifier's average pool over the whole map and over
    2x2 windows."""
    x = (rng.rand(2, size, size, 3) - 1.5).astype(np.float32)
    np.testing.assert_array_equal(_np(TB.max_pool_3x3_s2(_t(x))),
                                  np.asarray(JB.max_pool_3x3_s2(jnp.asarray(x))))
    for window in (size, 2):
        np.testing.assert_allclose(_np(TB.avg_pool(_t(x), window)),
                                   np.asarray(JB.avg_pool(jnp.asarray(x), window)), atol=1e-6)


@pytest.mark.parametrize("grouped", [False, True])
def test_transposed_fold_matches_jax(rng, grouped):
    """A dense transposed weight (Cin, Cout, k, k) folds along dim 1, a
    depthwise one (C, 1, k, k) along dim 0, as the JAX fold (transpose=True
    on dense HWOI, the trailing axis on grouped); and conv_transpose with
    the folded weight + bias equals BatchNorm after the unfolded one."""
    c, cout, k = 6, (1 if grouped else 5), 5
    groups = c if grouped else 1
    w = rng.randn(k, k, cout, c).astype(np.float32)
    bn = _BN(rng, cout * groups)
    jw, jb = JB.fold_bn(jnp.asarray(w), bn.jax(), transpose=not grouped)
    tw, tb = TB.fold_bn(params_from_jax({"c": {"w": w}})["c.w"], bn, transpose=True)
    np.testing.assert_allclose(params_to_jax({"c.w": tw})["c"]["w"], np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    x = _t(rng.randn(1, 4, 4, c).astype(np.float32))
    kw = dict(stride=2, padding=2, output_padding=1, groups=groups)
    w_t = params_from_jax({"c": {"w": w}})["c.w"]
    want = TB.batch_norm(TB.conv2d_transpose(x, w_t, **kw), bn)
    np.testing.assert_allclose(TB.conv2d_transpose(x, tw, bias=tb, **kw).detach().numpy(),
                               want.detach().numpy(), atol=1e-4)


def test_transposed_fold_refuses_other_groupings(rng):
    bn = _BN(rng, 6)
    with pytest.raises(ValueError, match="transpose fold"):
        TB.fold_bn(torch.zeros(6, 2, 3, 3), bn, transpose=True)


# --- init rules ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 32, 5, 5), (256, 1, 9, 9)])
def test_convtranspose_std_is_k2_cin_as_in_jax(shape):
    """torch's (Cin, Cout/g, k, k): he_normal_conv's shape[0] is C_in, the
    reference's ConvTranspose2d rule n = k^2 * C_in, as JAX's
    he_normal_convt (drawn in HWOI) gives."""
    cin, coutg, k, _ = shape
    std = math.sqrt(2.0 / (k * k * cin))
    tw = I.he_normal_conv(shape, torch.Generator().manual_seed(0))
    jw = JI.he_normal_convt(jax.random.PRNGKey(0), k, k, coutg, cin)
    for got in (float(tw.std()), float(np.asarray(jw).std())):
        assert abs(got / std - 1) <= 0.05


def test_init_fills_transposed_biased_and_bn_leaves():
    """Model.init on a plain ResNet-18 with a dense deconv decoder: the
    transposed stage weights by k^2 * C_in, conv2's He w (n = 1024) with a
    zero bias, BatchNorm at its defaults."""
    cfg = ModelConfig(encoder="resnet18", decoder="deconv5", skip=None,
                      decoder_channels=(64, 32, 32, 16, 16))
    p = build(to_port(cfg)).init(torch.Generator().manual_seed(1))
    w1 = p["decoder"]["stage1"]["conv"].w
    assert tuple(w1.shape) == (1024, 64, 5, 5)
    assert abs(float(w1.std()) / math.sqrt(2.0 / (25 * 1024)) - 1) <= 0.05
    c2 = p["conv2"]
    assert c2.bn is None and torch.equal(c2.b, torch.zeros(1024))
    assert abs(float(c2.w.std()) / math.sqrt(2.0 / 1024) - 1) <= 0.05
    bn = p["decoder"]["stage1"]["conv"].bn
    assert torch.equal(bn.scale, torch.ones(64)) and torch.equal(bn.var, torch.ones(64))


def test_classifier_init_is_torch_linears_uniform():
    head = MN.init_classifier(torch.Generator().manual_seed(0), 256, 100)
    bound = 1 / math.sqrt(256)
    w, b = head["fc"].w, head["fc"].b
    assert tuple(w.shape) == (256, 100) and tuple(b.shape) == (100,)
    for v in (w, b):
        assert float(v.abs().max()) <= bound
    # U(-a, a) has std a / sqrt(3)
    assert abs(float(w.std()) / (bound / math.sqrt(3)) - 1) <= 0.05
    jhead = JMN.init_classifier(jax.random.PRNGKey(0), 256, 100)
    assert {k: tuple(v.shape) for k, v in params_from_jax(jhead).items()} == \
        {k: tuple(v.shape) for k, v in head.state_dict().items()}


# --- classifier ---------------------------------------------------------

def test_classifier_logits_match_jax(rng):
    feats = rng.randn(3, 7, 7, 32).astype(np.float32)
    jhead = {"fc": {"w": rng.randn(32, 10).astype(np.float32),
                    "b": rng.randn(10).astype(np.float32)}}
    want = np.asarray(JMN.apply_classifier(jax.tree.map(jnp.asarray, jhead), jnp.asarray(feats)))
    head = MN.make_classifier(32, 10)
    head.load_state_dict(params_from_jax(jhead), strict=True)
    got = MN.apply_classifier(head, _t(feats))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)


def test_classifier_topk_matches_jax_with_ties(rng):
    """Top-1/top-5 fractions equal JAX's (lax.top_k: the lower index wins
    a tie) on random logits and on logits with ties across the top-5
    boundary, where the labels sit on the tied classes."""
    logits = rng.randn(16, 10).astype(np.float32)
    labels = rng.randint(0, 10, 16)
    tied = np.zeros((6, 10), np.float32)
    tied[:, 3:9] = 1.0  # six classes tie for first: top-5 is 3..7, not 8
    tied_labels = np.array([3, 7, 8, 2, 9, 0])
    tied[5] = np.arange(10)[::-1] // 3  # ties by threes
    for lg, lb in ((logits, labels), (tied, tied_labels)):
        want = JMN.classifier_topk(jnp.asarray(lg), jnp.asarray(lb))
        got = MN.classifier_topk(torch.from_numpy(lg), torch.from_numpy(lb))
        assert got.keys() == want.keys() == {1, 5}
        for k in (1, 5):
            assert float(got[k]) == float(want[k]), (k, float(got[k]), float(want[k]))
    got = MN.classifier_topk(torch.from_numpy(tied[:1]), torch.tensor([8]), ks=(1, 5, 6))
    assert (float(got[1]), float(got[5]), float(got[6])) == (0.0, 0.0, 1.0)


# --- the parameter interchange ------------------------------------------

FAMILIES = {
    "mobilenet_skipadd": ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
    "mobilenet_deconv3": ModelConfig(decoder="deconv3", skip=None, encoder_channels=TINY_ENC,
                                     decoder_channels=TINY_DEC),
    "mobilenet_deconv5dw": ModelConfig(decoder="deconv5dw", skip=None,
                                       encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
    "mobilenet_shuffle3": ModelConfig(decoder="shuffle3", skip=None, encoder_channels=ENC_1024,
                                      decoder_channels=TINY_DEC),
    "resnet18_upproj": ModelConfig(encoder="resnet18", decoder="upproj", skip=None,
                                   decoder_channels=TINY_DEC),
    "resnet34_skipconcat": ModelConfig(encoder="resnet34", decoder="nnconv5", skip="concat"),
    "resnet50_skipadd_bottleneck": ModelConfig(encoder="resnet50", decoder="nnconv5", skip="add",
                                               bottleneck_skips=True),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_round_trip_is_bit_exact_for_every_family(name):
    """npz tree -> params_from_jax -> Model.load (strict, the JAX init's
    keys and shapes) -> state dict -> params_to_jax: the same bits, folded
    and unfolded; conv and transposed weights permuted, the rest as is."""
    cfg = FAMILIES[name]
    tree = random_tree(cfg, 2)
    model, p = port_model(cfg, tree)
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == jax_init_shapes(cfg)
    folded = model.fold(p)
    for params in (p, folded):
        src = flatten_tree(params_to_jax(params.state_dict()))
        again = model.load(params_from_jax(params_to_jax(params.state_dict())))
        back = flatten_tree(params_to_jax(again.state_dict()))
        assert src.keys() == back.keys()
        for k in src:
            assert src[k].dtype == back[k].dtype and np.array_equal(src[k], back[k]), k
    flat = flatten_tree(tree)
    got = flatten_tree(params_to_jax(p.state_dict()))
    assert all(np.array_equal(flat[k], got[k]) for k in flat)


def test_classifier_head_round_trip_keeps_fc_w_as_is(rng):
    head = {"fc": {"w": rng.randn(16, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}}
    sd = params_from_jax(head)
    assert tuple(sd["fc.w"].shape) == (16, 5)
    back = params_to_jax(sd)
    assert np.array_equal(back["fc"]["w"], head["fc"]["w"])


# --- the trainer on transposed and biased leaves --------------------------

def test_trainer_steps_a_transposed_decoder_as_jax_in_f64():
    """Two SGD steps of a tiny plain MobileNet + deconv3 (dense transposed
    stages, channels_last (Cin, Cout, k, k) leaves in the trainer's flat
    buffers) at 32x32 b4, in f64 on both sides against JAX's
    make_train_step: loss rtol 1e-5, every parameter, momentum buffer and
    running statistic within 1e-4 (the f64 rule of
    tests/test_torch_train.py).  ResNet's biased conv2 is held the same way
    in tests/test_torch_resnet.py."""
    from fastdepth_tpu.checkpoint.io import flatten_tree as jax_flatten
    from fastdepth_tpu.config import TrainConfig as JaxTrainConfig
    from fastdepth_tpu.models import build as jax_build
    from fastdepth_tpu.train import trainer as JT
    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.train.trainer import make_train_step, sgd_init

    cfg = FAMILIES["mobilenet_deconv3"]
    rng = np.random.RandomState(5)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), random_tree(cfg, 12))
    rgb, depth = rng.rand(4, 32, 32, 3), rng.rand(4, 32, 32, 1) * 5 + 0.5
    model, params = port_model(cfg, tree)
    state = sgd_init(params.double())
    w = state.params["decoder"]["stage1"]["conv"].w
    assert w.is_contiguous(memory_format=torch.channels_last) and w.requires_grad
    step = make_train_step(model, TrainConfig(lr=0.01, weight_decay=1e-4))
    with jax.enable_x64(True):
        jstep = jax.jit(JT.make_train_step(jax_build(cfg),
                                           JaxTrainConfig(lr=0.01, weight_decay=1e-4)))
        jstate = JT.sgd_init(jax.tree.map(jnp.asarray, tree))
        for _ in range(2):
            jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(0.01))
            state, loss = step(state, torch.from_numpy(rgb), torch.from_numpy(depth), 0.01)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jflat = jax_flatten(jax.tree.map(np.asarray, {"p": jstate.params,
                                                      "m": jstate.momentum}))
    flat = flatten_tree({"p": params_to_jax(state.params.state_dict()),
                         "m": params_to_jax(state.momentum)})
    assert flat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(flat[k], jflat[k], atol=1e-4, rtol=0, err_msg=k)


# --- the engine's entry points on zoo models --------------------------------

class _Loader:
    """Host batches already in memory, as validate() takes them."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = range(sum(b[2] for b in batches))

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("name,impl", [("mobilenet_nnconv5", "opt"),
                                       ("resnet18_upproj", "straight")])
def test_evaluator_compile_forward_and_server_run_zoo_models(rng, name, impl):
    """Evaluator + validate(), compile_forward and InferenceServer on the
    CPU, each on the folded zoo model their _prepare builds, against the
    straight forward on the unfolded tree (bound 1e-4 * max(1, max|ref|));
    plain MobileNet + nnconv takes the head-commute forward, a ResNet the
    straight one, neither the kernels'."""
    from fastdepth_tpu_torch.engine.aot import compile_forward
    from fastdepth_tpu_torch.engine.evaluator import Evaluator, validate
    from fastdepth_tpu_torch.engine.server import InferenceServer
    from fastdepth_tpu_torch.models import fused as F
    from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER

    from torch_zoo import assert_close

    cfg = (ModelConfig(decoder="nnconv5", skip=None, encoder_channels=TINY_ENC,
                       decoder_channels=TINY_DEC) if name == "mobilenet_nnconv5"
           else FAMILIES[name])
    model, params = port_model(cfg, random_tree(cfg, 21))
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = model.apply(params, torch.from_numpy(x)).numpy()
    depth = (rng.rand(4, 32, 32, 1) * 5 + 0.5).astype(np.float32)

    ev = Evaluator(model, params, batch_size=2, device="cpu")
    assert (ev._apply == model.apply) == (impl == "straight")
    assert F.supports_opt(model.config) == (impl == "opt")
    launches = COUNTER["K1"]
    avg = validate(_Loader([(x[:2], depth[:2], 2), (x[2:], depth[2:], 2)]), ev, print_freq=0,
                   make_images=False, log=lambda s: None)
    assert np.isfinite([avg.rmse, avg.mae, avg.delta1]).all()
    assert_close(ev(ev.put(x[:2]), ev.put(depth[:2]))[0].numpy(), want[:2])

    fn, p = compile_forward(model, params, batch_size=2, image_size=(32, 32), device="cpu")
    assert_close(fn(p, torch.from_numpy(x[2:])).numpy(), want[2:])

    srv = InferenceServer(model, params, batch_size=2, image_size=(32, 32), device="cpu")
    try:
        got = np.stack([f.result(timeout=60) for f in [srv.submit(v) for v in x]])
    finally:
        srv.close()
    assert_close(got, want)
    assert COUNTER["K1"] == launches
