"""The port's copy of the configuration (``fastdepth_tpu_torch/config.py``)
against the JAX package's ``fastdepth_tpu/config.py``: every constant,
every dataclass's fields, the registry's configurations, the dict/JSON
readers and the validation errors, field for field."""

import dataclasses
import json
import os

import ml_dtypes
import numpy as np
import pytest

from fastdepth_tpu import config as J
from fastdepth_tpu.models import registry as JR
from fastdepth_tpu_torch import config as T
from fastdepth_tpu_torch.models import registry as TR
from torch_port_config import to_jax, to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONSTANTS = sorted(n for n in vars(J) if n.isupper())
CLASSES = sorted(n for n, v in vars(J).items()
                 if isinstance(v, type) and dataclasses.is_dataclass(v))
NAMES = ["mobilenet-nnconv5dw-skipadd-pruned", "mobilenet-nnconv5dw-skipadd",
         "mobilenet-nnconv5dw-skipconcat", "mobilenet-nnconv5dw-skipconcat-pruned",
         "mobilenet-nnconv5-skipadd", "mobilenet-nnconv5-skipconcat",
         "mobilenet-nnconv3dw-skipconcat"]
UNPORTED = ["mobilenet-nnconv5dw", "mobilenet-deconv3", "resnet18-nnconv5dw-skipadd",
            "resnet50-upproj"]
INVALID = [
    dict(skip="both"),
    dict(decoder="deconv3", skip="add"),
    dict(encoder_channels=(32, 64)),
    dict(encoder="resnet18", skip="add", bottleneck_skips=True),
    dict(encoder="resnet50", skip="add"),
    dict(decoder_channels=(512, 200, 128, 64, 32)),
]


def _fields(obj):
    return {k: v for k, v in dataclasses.asdict(obj).items()}


def test_the_copy_has_every_public_name_of_the_original():
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}  # noqa: E731
    assert public(J) - {"annotations"} <= public(T)


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_the_jax_one(name):
    want, got = getattr(J, name), getattr(T, name)
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        assert _fields(got) == _fields(want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_equal_the_jax_ones(name):
    want, got = getattr(J, name), getattr(T, name)
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(got)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(want)]
    assert _fields(got()) == _fields(want())


@pytest.mark.parametrize("name", NAMES)
def test_registry_configuration_equals_the_jax_one(name):
    got, want = TR.from_name(name).config, JR.from_name(name).config
    assert isinstance(got, T.ModelConfig)
    assert _fields(got) == _fields(want)
    assert (got.decoder_kernel, got.decoder_depthwise) == \
        (want.decoder_kernel, want.decoder_depthwise)
    assert to_port(want) == got and to_jax(got) == want


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_registry_names_are_refused(name):
    """The names the port refused until the zoo was ported (plain
    MobileNet + registry decoder, the ResNets) now build, with the JAX
    package's configuration."""
    got, want = TR.from_name(name).config, JR.from_name(name).config
    assert isinstance(got, T.ModelConfig) and _fields(got) == _fields(want)


@pytest.mark.parametrize("kw", INVALID)
def test_validation_errors_equal_the_jax_ones(kw):
    with pytest.raises(ValueError) as want:
        J.ModelConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        T.ModelConfig(**kw).validate()
    assert str(got.value) == str(want.value)


def test_dict_and_json_readers_equal_the_jax_ones(tmp_path):
    for cfg in (J.FASTDEPTH_PRUNED, J.FASTDEPTH_UNPRUNED,
                J.ModelConfig(skip="concat", decoder="nnconv3dw")):
        d = json.loads(json.dumps(dataclasses.asdict(cfg)))  # tuples -> lists
        assert _fields(T.config_from_dict(d)) == _fields(J.config_from_dict(d))
        path = tmp_path / "arch.json"
        path.write_text(json.dumps(d))
        got = T.config_from_json(str(path))
        assert isinstance(got, T.ModelConfig) and _fields(got) == _fields(cfg)
    with pytest.raises(TypeError):
        T.config_from_dict({"encoder_chanels": [1]})


# --- the other copies: checkpoint format, roofline formulas, viz, deploy input ---

def _tree(rng):
    return {"encoder": {"conv0": {"w": rng.randn(3, 3, 3, 4).astype(np.float32),
                                  "b": rng.randn(4).astype(np.float32)}},
            "decoder": {"decode_conv6": {"pw": {"w": rng.randn(1, 1, 4, 1).astype(np.float32)}},
                        "half": {"w": rng.randn(5).astype(np.float32).astype(ml_dtypes.bfloat16)}},
            "step": np.array(7, np.int64)}


def _assert_trees_bit_equal(got, want):
    from fastdepth_tpu.checkpoint.io import flatten_tree

    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
        assert g[k].tobytes() == w[k].tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_written_by_either_package_load_in_the_other(tmp_path, writer):
    from fastdepth_tpu.checkpoint import io as JIO
    from fastdepth_tpu_torch.checkpoint import io as TIO

    tree = _tree(np.random.RandomState(0))
    save, load = (JIO.save_checkpoint, TIO.load_checkpoint) if writer == "jax" else \
        (TIO.save_checkpoint, JIO.load_checkpoint)
    cfg = J.FASTDEPTH_PRUNED if writer == "jax" else T.FASTDEPTH_PRUNED
    path = str(tmp_path / "ckpt")  # suffix-less: both append .npz
    save(path, tree, cfg, epoch=4, best_result={"rmse": 0.5}, extra={"note": "x"})
    got, got_cfg, meta = load(path)
    _assert_trees_bit_equal(got, tree)
    assert _fields(got_cfg) == _fields(cfg) and type(got_cfg).__module__ != type(cfg).__module__
    assert (meta["epoch"], meta["best_result"], meta["extra"]) == (4, {"rmse": 0.5}, {"note": "x"})
    # the same tree saved by both packages reads back the same
    other = str(tmp_path / "other.npz")
    (TIO.save_checkpoint if writer == "jax" else JIO.save_checkpoint)(
        other, tree, cfg, epoch=4, best_result={"rmse": 0.5}, extra={"note": "x"})
    with np.load(path + ".npz") as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_port_saves_torch_tensors_as_the_numpy_tree(tmp_path):
    import torch

    from fastdepth_tpu.checkpoint.io import load_checkpoint as jax_load
    from fastdepth_tpu_torch.checkpoint.io import save_checkpoint

    tree = _tree(np.random.RandomState(1))
    as_torch = {"encoder": {"conv0": {k: torch.from_numpy(v) for k, v in
                                      tree["encoder"]["conv0"].items()}},
                "decoder": {"decode_conv6": {"pw": {"w": torch.from_numpy(
                    tree["decoder"]["decode_conv6"]["pw"]["w"])}},
                    "half": {"w": torch.from_numpy(tree["decoder"]["half"]["w"].astype(
                        np.float32)).to(torch.bfloat16)}},
                "step": torch.tensor(7)}
    save_checkpoint(str(tmp_path / "t.npz"), as_torch, T.FASTDEPTH_PRUNED)
    got, _, _ = jax_load(str(tmp_path / "t.npz"))
    _assert_trees_bit_equal(got, tree)


def _tpu_probe(scale_seed):
    """The TPU probe payload the formulas were written for, each measured
    rate scaled by a seeded factor (a grid of ceilings)."""
    with open(os.path.join(REPO, "docs", "probe_r3_hbm.json")) as f:
        probe = json.load(f)
    rng = np.random.RandomState(scale_seed)
    for r in probe["rows"]:
        r["GBs"] *= float(rng.uniform(0.25, 4.0))
        r["per_pass_us"] *= float(rng.uniform(0.25, 4.0))
    return probe


ROOFLINE_CONFIGS = {
    "pruned": J.FASTDEPTH_PRUNED,
    "unpruned": J.FASTDEPTH_UNPRUNED,
    "tiny_concat": J.ModelConfig(skip="concat", encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16,
                                                                  16, 16, 16, 16, 20, 24),
                                 decoder_channels=(18, 14, 10, 6, 4)),
    "dense_nnconv3": J.ModelConfig(decoder="nnconv3", skip="concat"),
}


@pytest.mark.parametrize("name", list(ROOFLINE_CONFIGS))
@pytest.mark.parametrize("image_size", [224, 160, 64])
@pytest.mark.parametrize("scale_seed", [0, 1, 2])
def test_roofline_formulas_equal_the_jax_functions(name, image_size, scale_seed):
    from fastdepth_tpu.engine import roofline as JRL
    from fastdepth_tpu_torch.engine import roofline as RL

    cfg, probe = ROOFLINE_CONFIGS[name], _tpu_probe(scale_seed)
    for fn in ("measured_stage_bounds", "measured_composite_us"):
        assert getattr(RL, fn)(to_port(cfg), probe, image_size) == \
            getattr(JRL, fn)(cfg, probe, image_size)


def test_viz_and_deploy_input_equal_the_jax_ones(tmp_path):
    from fastdepth_tpu import viz as JV
    from fastdepth_tpu.cli.deploy import load_input as jax_load_input
    from fastdepth_tpu_torch import viz as TV
    from fastdepth_tpu_torch.cli.deploy import load_input

    rng = np.random.RandomState(5)
    rgb = rng.rand(16, 20, 3).astype(np.float32)
    d_in, d_gt, d_pred = (rng.uniform(0.5, 9, (16, 20)).astype(np.float32) for _ in range(3))
    for got, want in [
        (TV.colored_depthmap(d_gt), JV.colored_depthmap(d_gt)),
        (TV.colored_depthmap(d_gt, 1.0, 5.0), JV.colored_depthmap(d_gt, 1.0, 5.0)),
        (TV.merge_into_row(rgb, d_gt, d_pred), JV.merge_into_row(rgb, d_gt, d_pred)),
        (TV.merge_into_row_with_gt(rgb, d_in, d_gt, d_pred),
         JV.merge_into_row_with_gt(rgb, d_in, d_gt, d_pred)),
    ]:
        assert got.dtype == want.dtype and np.array_equal(got, want)
    row = JV.merge_into_row(rgb, d_gt, d_pred)
    assert np.array_equal(TV.add_row(row, row), JV.add_row(row, row))
    TV.save_image(row, str(tmp_path / "port.png"))
    JV.save_image(row, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for shape in [(16, 20, 3), (3, 16, 20), (1, 3, 16, 20)]:
        path = str(tmp_path / "in.npy")
        np.save(path, rng.rand(*shape))
        got, want = load_input(path), jax_load_input(path)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _reference_model(kind):
    import torch
    from torch_oracle import (TorchFastDepth, TorchMobileNetNNConv, TorchResNetSkip,
                              randomize_bn_stats)

    enc, dec = ROOFLINE_CONFIGS["tiny_concat"].encoder_channels, (18, 14, 10, 6, 4)
    tm = {"skipadd": lambda: TorchFastDepth(enc, dec, skip="add"),
          "skipconcat": lambda: TorchFastDepth(enc, dec, skip="concat"),
          "nnconv5dw": lambda: TorchMobileNetNNConv(enc, dec, dw=True),
          "nnconv5": lambda: TorchMobileNetNNConv(enc, dec, dw=False),
          "resnet18_skipconcat": lambda: TorchResNetSkip(18, skip="concat")}[kind]().eval()
    randomize_bn_stats(tm, torch.Generator().manual_seed(3))
    return tm


@pytest.mark.parametrize("kind", ["skipadd", "skipconcat", "nnconv5dw", "nnconv5",
                                  "resnet18_skipconcat"])
def test_pth_converter_equals_the_jax_one(tmp_path, kind):
    """The same reference .pth through both converters: bit-equal trees,
    equal configurations and metadata."""
    import torch

    from fastdepth_tpu.checkpoint.convert import convert_checkpoint as jax_convert
    from fastdepth_tpu_torch.checkpoint.convert import convert_checkpoint

    path = str(tmp_path / "model_best.pth.tar")
    torch.save({"epoch": 6, "best_result": None, "model": _reference_model(kind)}, path)
    got, got_cfg, got_meta = convert_checkpoint(path)
    want, want_cfg, want_meta = jax_convert(path)
    _assert_trees_bit_equal(got, want)
    assert isinstance(got_cfg, T.ModelConfig) and _fields(got_cfg) == _fields(want_cfg)
    assert got_meta == want_meta


def test_converter_constants_equal_the_jax_resnet_ones():
    from fastdepth_tpu.models import resnet as JRES
    from fastdepth_tpu_torch.checkpoint import convert as TC

    assert TC.BOTTLENECK == JRES.BOTTLENECK and TC.RESNET_LAYERS == JRES.RESNET_LAYERS
