"""The benchmark's work counts against ``torch.utils.flop_counter`` on
the plain references, and the decoder levels' counts against the
port's ``engine/benchmark.stage_work``."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, program
from perfbench.work import common as W
from perfbench.work import mobilenet_skipadd, resnet_upproj


def counted(cfg):
    """FLOPs of the reference's forward of one frame, as the counter sees
    them (on meta tensors: nothing runs)."""
    sd = {k: v.to("meta") for k, v in program.draw_params(cfg, 0, "cpu").items()}
    x = torch.zeros((1, *cfg["image_size"], 3), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        program.reference(cfg).forward(sd, x, cfg)
    return fc.get_total_flops()


@pytest.mark.parametrize("hw", [224, 64])
def test_flagship_counts_equal_the_counters(hw):
    cfg = harness.config("fastdepth-pruned-224")
    cfg["image_size"] = [hw, hw]
    assert mobilenet_skipadd.step_flops(cfg) == counted(cfg)


@pytest.mark.parametrize("hw", [224, 64])
def test_upproj_counts_differ_by_the_zero_inputs_exactly(hw):
    cfg = harness.config("resnet50-upproj-224")
    cfg["image_size"] = [hw, hw]
    assert resnet_upproj.dense_flops(cfg) == counted(cfg)
    zero = sum(c["macs"] - c["needed_macs"] for c in resnet_upproj.convs(cfg))
    unpooled = [c for c in resnet_upproj.convs(cfg) if c["macs"] != c["needed_macs"]]
    assert {c["name"].rsplit(".", 1)[1] for c in unpooled} == {"branch1_conv1", "branch2_conv"}
    assert resnet_upproj.dense_flops(cfg) - resnet_upproj.step_flops(cfg) == 2 * zero


def test_zero_inputs_counted_by_brute_force():
    # a 5 x 5 'same' conv over a zero-inserted 8 x 6 map, tap by tap
    m = torch.zeros(8, 6)
    m[0::2, 0::2] = 1
    padded = torch.nn.functional.pad(m, (2, 2, 2, 2))
    hits = sum(int(padded[y:y + 5, x:x + 5].sum()) for y in range(8) for x in range(6))
    assert hits == resnet_upproj._taps_on_even(8) * resnet_upproj._taps_on_even(6)


def test_published_totals():
    fd = harness.config("fastdepth-pruned-224")
    up = harness.config("resnet50-upproj-224")
    assert 0.70e9 < mobilenet_skipadd.step_flops(fd) < 0.76e9
    assert round(resnet_upproj.dense_flops(up) / 1e9, 2) == 64.39


@pytest.mark.parametrize("elem", [2, 4])
def test_decoder_levels_are_stage_work(elem):
    from fastdepth_tpu_torch.engine.benchmark import stage_work

    cfg = harness.config("fastdepth-pruned-224")
    enc, dec = cfg["encoder_channels"], cfg["decoder_channels"]
    want, h, cin = [], 7, enc[-1]
    for i, cout in enumerate(dec, start=1):
        b, core, tensor = stage_work(128, h, h, cin, cout, i in (2, 3, 4), elem)
        want.append((b, core + tensor))
        h, cin = 2 * h, cout
    assert mobilenet_skipadd.decoder_levels(cfg, 128, elem) == want
    assert W.stage_work(2, 7, 7, 8, 4, True, 2) == (
        stage_work(2, 7, 7, 8, 4, True, 2)[0], sum(stage_work(2, 7, 7, 8, 4, True, 2)[1:]))
