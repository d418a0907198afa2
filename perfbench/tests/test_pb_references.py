"""The plain references against the port's straight forward, at a
small size on the CPU: the same parameter tree, the same frames."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, program
from perfbench.reference import common as C

CONFIGS = ["fastdepth-pruned-224", "resnet50-upproj-224"]


def small(name, hw=64):
    cfg = harness.config(name)
    cfg["image_size"] = [hw, hw]
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_reference_is_the_ports_straight_forward(name, kind):
    cfg = small(name)
    sd = program.draw_params(cfg, 2 ** 31 + 5, "cpu")
    model, params = program.load(cfg, sd, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8)
    if kind == "float32":
        x = torch.rand((2, 64, 64, 3), generator=g)
    with torch.no_grad():
        want = model.apply(model.fold(params), x.float() / 255 if kind == "uint8" else x)
        got = program.reference(cfg).forward(sd, x, cfg)
    assert got.shape == want.shape == (2, 64, 64, 1)
    assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_depth_is_positive(name):
    cfg = small(name)
    sd = program.draw_params(cfg, 3, "cpu")
    x = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)
    with torch.no_grad():
        out = program.reference(cfg).forward(sd, x, cfg)
    assert float(out.min()) >= 0.5


def test_draw_is_seeded():
    cfg = small(CONFIGS[0])
    a, b, c = (program.draw_params(cfg, s, "cpu") for s in (2 ** 31 + 9, 2 ** 31 + 9, 7))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv0.w"], c["encoder.conv0.w"])


def test_fold_matches_batchnorm():
    g = torch.Generator().manual_seed(0)
    sd = {"c.w": torch.randn(4, 3, 3, 3, generator=g), "c.bn.scale": torch.rand(4, generator=g),
          "c.bn.bias": torch.randn(4, generator=g), "c.bn.mean": torch.randn(4, generator=g),
          "c.bn.var": torch.rand(4, generator=g) + 0.5}
    x = torch.randn(2, 3, 8, 8, generator=g)
    want = torch.nn.functional.batch_norm(
        torch.nn.functional.conv2d(x, sd["c.w"], padding=1), sd["c.bn.mean"], sd["c.bn.var"],
        sd["c.bn.scale"], sd["c.bn.bias"], eps=C.BN_EPS)
    w, b = C.fold(sd, "c")
    assert torch.allclose(torch.nn.functional.conv2d(x, w, b, padding=1), want, atol=1e-5)


def test_depth_metrics_are_the_ports():
    from fastdepth_tpu_torch import metrics as M

    g = torch.Generator().manual_seed(0)
    pred = torch.rand(3, 16, 16, 1, generator=g) * 9 + 0.5
    depth = torch.rand(3, 16, 16, 1, generator=g) * 9.5 + 0.5
    got = C.depth_metrics(pred, depth)
    port = M.evaluate_batch(pred, depth)
    for i, f in enumerate(C.METRIC_FIELDS):
        assert torch.allclose(torch.as_tensor(got[i]), port[f].double(), rtol=1e-5), f


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    err = (C.fp8(x) - x).abs() / x.abs().clamp_min(1e-3)
    assert float(err[x.abs() > 0.1].max()) <= 2 ** -4 + 1e-6
    assert float(err[x.abs() > 0.1].max()) > 2 ** -8
