"""Every registry decoder (``DECODER_NAMES``) on a tiny plain MobileNet in
the port against the JAX package, on the same numpy tree and frames (CPU,
f32, bound 1e-4 * max(1, max|JAX|)): straight, folded (the deconv
decoders' folded leaves against JAX's fold too) and through
``_pick_apply('auto')``; the
head-commute forward on the plain nnconv models; and ``cli.convert`` on
reference-style pickles (ResNet + UpProj, MobileNet + DeConv) writing the
npz the JAX package's ``cli.convert`` writes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.checkpoint.io import flatten_tree as jax_flatten
from fastdepth_tpu.config import DECODER_NAMES, ModelConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.models.fused import apply_fastdepth_opt as jax_opt
from fastdepth_tpu_torch.checkpoint.io import flatten_tree
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.models import fused as F

import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from torch_zoo import (ENC_1024, TINY_DEC, TINY_ENC, assert_close, jax_apply, jax_init_shapes,
                       port_model, random_tree)

SIZE, BATCH = 32, 2
OPT_NAMES = ["nnconv5", "nnconv3dw"]


def _cfg(name):
    enc = ENC_1024 if name.startswith("shuffle") else TINY_ENC
    return ModelConfig(decoder=name, skip=None, encoder_channels=enc, decoder_channels=TINY_DEC)


@pytest.fixture(scope="module")
def jax_sweep():
    """Every decoder's seeded tree, the frames, and the JAX package's
    forward on them (with its fold for the deconv decoders), all in one
    jit: one XLA compile for the 34 models instead of 34, the sweep's
    largest cost on the CPU."""
    cfgs = {name: _cfg(name) for name in DECODER_NAMES}
    trees = {name: random_tree(cfgs[name], i) for i, name in enumerate(DECODER_NAMES)}
    x = np.random.RandomState(0).rand(BATCH, SIZE, SIZE, 3).astype(np.float32)

    def run(trees, x):
        models = {name: jax_build(cfg) for name, cfg in cfgs.items()}
        out = {name: (m.apply(trees[name], x),
                      m.fold(trees[name]) if name.startswith("deconv") else None)
               for name, m in models.items()}
        out.update({f"opt_{name}": jax_opt(models[name].fold(trees[name]), x, cfgs[name])
                    for name in OPT_NAMES})
        return out

    out = jax.jit(run)(jax.tree.map(jnp.asarray, trees), jnp.asarray(x))
    return trees, x, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", DECODER_NAMES)
def test_every_registry_decoder_matches_jax(jax_sweep, name):
    trees, x, out = jax_sweep
    cfg, tree = _cfg(name), trees[name]
    want, jfold = out[name]
    assert want.shape == (BATCH, SIZE, SIZE, 1) and float(np.abs(want).max()) > 1e-3
    model, p = port_model(cfg, tree)
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == jax_init_shapes(cfg)
    folded = model.fold(p)
    if jfold is not None:
        # the port's fold of transposed leaves (dense on dim 1, depthwise
        # on dim 0) is JAX's, leaf for leaf
        jflat = jax_flatten(jfold)
        tflat = flatten_tree(params_to_jax(folded.state_dict()))
        assert jflat.keys() == tflat.keys()
        for k in jflat:
            np.testing.assert_allclose(tflat[k], jflat[k], rtol=1e-5, atol=1e-6, err_msg=k)
    auto = _pick_apply(model, folded, "auto", BATCH)
    assert (auto == model.apply) != F.supports_opt(model.config)  # nnconv: opt, else straight
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for how, got in (("straight", model.apply(p, xt)), ("folded", model.apply(folded, xt)),
                         ("auto", auto(folded, xt))):
            assert_close(got.numpy(), want, err_msg=f"{name} {how}")


@pytest.mark.parametrize("name", OPT_NAMES)
def test_opt_forward_on_plain_models_matches_jax_opt(jax_sweep, name):
    """The head-commute forward reads the plain models' stage1..5 + final
    naming, as JAX's does (skip_naming)."""
    trees, x, out = jax_sweep
    model, p = port_model(_cfg(name), trees[name])
    with torch.no_grad():
        got = F.apply_fastdepth_opt(model.fold(p), torch.from_numpy(x), model.config)
    assert_close(got.numpy(), out[f"opt_{name}"])


def test_fullwidth_names_parse_as_jax():
    from fastdepth_tpu.models import from_name as jax_from_name
    from fastdepth_tpu_torch.models import from_name

    for name in ("mobilenet-nnconv5", "mobilenet-deconv3dw", "mobilenet-upproj",
                 "mobilenet-shuffle5"):
        assert dataclasses.asdict(from_name(name).config) == \
            dataclasses.asdict(jax_from_name(name).config), name


# --- cli.convert --------------------------------------------------------

def _cbr(nn, cin, cout, k):
    return nn.Sequential(nn.Conv2d(cin, cout, k, 1, (k - 1) // 2, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


def _resnet_upproj(gen):
    """A reference-style ResNet-18 + UpProj pickle (the oracle of
    tests/test_models.py, narrower decoder widths)."""
    import torch.nn as nn

    import torch_oracle as TO

    widths = (1024,) + TINY_DEC
    dec = TO.UpProj()
    for i in range(1, 6):
        cin, cout = widths[i - 1], widths[i]
        m = nn.Module()
        m.branch1 = nn.Sequential(
            nn.Conv2d(cin, cout, 5, 1, 2, bias=False), nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True),
            nn.Conv2d(cout, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout))
        m.branch2 = nn.Sequential(nn.Conv2d(cin, cout, 5, 1, 2, bias=False),
                                  nn.BatchNorm2d(cout))
        setattr(dec, f"upproj{i}", m)
    dec.convf = _cbr(nn, TINY_DEC[-1], 1, 1)
    tm = TO.ResNet()
    enc = TO.TorchResNetEncoder(18)
    for name in ("conv1", "bn1", "maxpool", "layer1", "layer2", "layer3", "layer4"):
        setattr(tm, name, getattr(enc, name))
    tm.conv2 = nn.Conv2d(512, 1024, 1)
    tm.decoder = dec
    return tm


def _mobilenet_deconv(gen):
    """A reference-style plain MobileNet + DeConv5dw pickle (grouped
    transposed stages)."""
    import torch.nn as nn

    import torch_oracle as TO

    tm = TO.TorchMobileNetNNConv(TINY_ENC, TINY_DEC, k=5, dw=True)
    dec = TO.DeConv()
    widths = (TINY_ENC[-1],) + TINY_DEC
    for i in range(1, 6):
        cin, cout = widths[i - 1], widths[i]
        setattr(dec, f"convt{i}", nn.Sequential(
            nn.Sequential(nn.ConvTranspose2d(cin, cin, 5, 2, 2, 1, groups=cin, bias=False),
                          nn.BatchNorm2d(cin), nn.ReLU(inplace=True)),
            nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
                          nn.ReLU(inplace=True))))
    dec.convf = _cbr(nn, TINY_DEC[-1], 1, 1)
    tm.decoder = dec
    return tm


@pytest.mark.parametrize("oracle,arch", [(_resnet_upproj, ("resnet18", "upproj")),
                                         (_mobilenet_deconv, ("mobilenet", "deconv5dw"))])
def test_convert_cli_writes_the_jax_npz_and_the_forward_matches(tmp_path, rng, oracle, arch):
    from fastdepth_tpu.checkpoint.io import load_checkpoint as jax_load
    from fastdepth_tpu.cli import convert as jax_convert
    from fastdepth_tpu_torch.checkpoint.io import load_checkpoint
    from fastdepth_tpu_torch.cli import convert

    from torch_oracle import randomize_bn_stats

    gen = torch.Generator().manual_seed(7)
    tm = oracle(gen).eval()
    randomize_bn_stats(tm, gen)
    pth = str(tmp_path / "model_best.pth.tar")
    torch.save({"epoch": 4, "best_result": None, "model": tm}, pth)
    jcfg = jax_convert.main([pth, str(tmp_path / "jax.npz"), "--quiet"])
    cfg = convert.main([pth, str(tmp_path / "port.npz"), "--quiet"])
    assert (cfg.encoder, cfg.decoder) == arch
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jtree, _, jmeta = jax_load(str(tmp_path / "jax.npz"))
    tree, _, meta = load_checkpoint(str(tmp_path / "port.npz"))
    assert meta == jmeta
    jflat, flat = jax_flatten(jtree), flatten_tree(tree)
    assert flat.keys() == jflat.keys()
    for k in flat:
        assert flat[k].dtype == jflat[k].dtype and np.array_equal(flat[k], jflat[k]), k
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    want = jax_apply(jcfg, jtree, x)
    model, p = port_model(jcfg, tree)
    with torch.no_grad():
        assert_close(model.apply(p, torch.from_numpy(x)).numpy(), want)
        if arch[0] == "mobilenet":  # the oracle's own layers, composed as DeConv runs them
            y = tm.mobilenet(torch.from_numpy(x.transpose(0, 3, 1, 2)))
            for i in range(1, 6):
                y = getattr(tm.decoder, f"convt{i}")(y)
            assert_close(tm.decoder.convf(y).numpy().transpose(0, 2, 3, 1), want, bound=2e-4)
