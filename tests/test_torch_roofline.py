"""The port's roofline (``engine/roofline.py``) against the JAX module's
formulas, and the committed H100 ceilings (``docs/probe_h100_hbm.json``)
that the calibration wrote on the card."""

import json
import math
import os
import subprocess
import sys

import pytest

from fastdepth_tpu.config import FASTDEPTH_PRUNED, FASTDEPTH_UNPRUNED, ModelConfig
from fastdepth_tpu.engine import roofline as JRL
from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED as PORT_PRUNED
from fastdepth_tpu_torch.engine import calibrate
from fastdepth_tpu_torch.engine import roofline as RL
from torch_port_config import to_port
from torch_threads import child_env  # torch's CPU threads: a share per xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CONFIGS = {
    "pruned": FASTDEPTH_PRUNED,
    "unpruned": FASTDEPTH_UNPRUNED,
    "tiny_concat": ModelConfig(skip="concat", encoder_channels=TINY_ENC,
                               decoder_channels=TINY_DEC),
}


def _probe():
    with open(RL.CEILINGS_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("image_size", [224, 64])
def test_layer_bounds_are_the_jax_rows_without_lane_padding(name, image_size):
    cfg = CONFIGS[name]
    want = JRL.layer_bounds(cfg, image_size)
    got = RL.layer_bounds(to_port(cfg), image_size)
    assert len(got) == len(want) == 20
    for (k, macs, hbm, mxu, dw), (jk, jmacs, jhbm, jmxu, jvpu) in zip(got, want):
        assert (k, macs, hbm, mxu) == (jk, jmacs, jhbm, jmxu)
        assert dw == macs - mxu  # the depthwise MACs, unpadded
        assert dw <= jvpu  # the JAX row padded C up to 128 lanes


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_bounds_equal_the_jax_formulas_on_the_same_ceilings(dtype_bytes):
    """With the JAX module's constants injected, the device-memory and
    pointwise terms are the JAX terms; the depthwise term is the JAX VPU
    term scaled by unpadded / padded MACs."""
    ceil = RL.Ceilings(hbm_bps=JRL.HBM_BPS, pointwise_macs=JRL.MXU_MACS,
                       depthwise_macs=JRL.VPU_MACS)
    for (_, _, hbm, mxu, dw), (_, _, _, _, vpu) in zip(
            RL.layer_bounds(to_port(FASTDEPTH_PRUNED)), JRL.layer_bounds(FASTDEPTH_PRUNED)):
        got = RL.bound_components_us(hbm, mxu, dw, dtype_bytes, ceil, batch=128)
        want = JRL.bound_components_us(hbm, mxu, vpu, dtype_bytes, batch=128)
        assert got[:2] == pytest.approx(want[:2], rel=1e-12)
        assert got[2] * vpu == pytest.approx(want[2] * dw, rel=1e-12)
        assert RL.bound_seconds(hbm, mxu, dw, dtype_bytes, ceil, 128) == max(got) / 1e6


def test_shared_formulas_are_the_jax_functions_and_read_the_h100_json():
    """The port's copies of the two formulas give the JAX functions'
    results exactly, on the TPU probe payload they were written for; on
    the H100 JSON they give finite positive bounds."""
    with open(os.path.join(REPO, "docs", "probe_r3_hbm.json")) as f:
        tpu_probe = json.load(f)
    for name, cfg in CONFIGS.items():
        for fn in ("measured_stage_bounds", "measured_composite_us"):
            assert getattr(RL, fn)(to_port(cfg), tpu_probe) == getattr(JRL, fn)(cfg, tpu_probe)
    probe = _probe()
    stages = RL.measured_stage_bounds(to_port(FASTDEPTH_PRUNED), probe)
    assert sorted(stages) == [3, 4, 5]
    assert all(t > 0 and math.isclose(t, dw + pw + up) for t, dw, pw, up in stages.values())
    assert RL.measured_composite_us(to_port(FASTDEPTH_PRUNED), probe) > 0


def test_the_port_carries_no_tpu_constant():
    for name in ("HBM_BPS", "MXU_MACS", "VPU_MACS", "LANES"):
        assert not hasattr(RL, name)


def test_committed_ceilings_name_the_card_and_stay_under_the_data_sheet():
    probe = _probe()
    smi = probe["card"]["nvidia_smi"]
    assert "H100" in smi and smi.endswith(" W")  # name, power limit
    assert {"torch", "cuda"} <= set(probe["card"])
    names = {r["name"] for r in probe["rows"]}
    want_names = {name for name, _, _ in calibrate.FLAT} | {n for n, _ in calibrate.DW}
    want_names |= {f"mul {n}" for n in calibrate.SHAPES}
    want_names |= {"add+mul dec4_out (5 moves)", "pw 56->56 @112^2",
                   "matmul 8192^3 bf16 (x4)", "matmul 8192^3 f32 (x4)"}
    assert want_names <= names
    c = probe["ceilings"]
    assert "256MB" in c["hbm_source"]
    assert c["hbm_bps"] <= probe["data_sheet"]["hbm_GBs"] * 1e9
    assert "data sheet" in c["depthwise_source"]
    assert c["pointwise_macs"]["bf16"] > c["pointwise_macs"]["f32"] > 0
    for dtype_bytes in (2, 4):
        ceil = RL.load_ceilings(dtype_bytes)
        assert ceil.card == smi and ceil.hbm_bps == c["hbm_bps"]


def test_calibration_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        calibrate.calibrate("cpu")


def test_the_measurement_path_imports_no_jax():
    code = ("import sys\n"
            "import fastdepth_tpu_torch.engine.roofline, fastdepth_tpu_torch.engine.calibrate\n"
            "import fastdepth_tpu_torch.cli.profile, fastdepth_tpu_torch.cli.probe\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    env = child_env(PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_spec_aggregate_is_the_layer_bounds_at_the_data_sheet_rates():
    """By hand: every layer's bf16 bytes (the head's at a quarter) at the
    data sheet's 3,350 GB/s, its pointwise MACs at 989 TFLOP/s bf16 and
    its depthwise MACs at 67 TFLOP/s, the largest of the three a layer."""
    with open(RL.CEILINGS_PATH) as f:
        probe = json.load(f)
    ds = probe["data_sheet"]
    assert (ds["hbm_GBs"], ds["bf16_tensor_tflops"], ds["f32_tflops"]) == (3350.0, 989.0, 67.0)
    total = 0.0
    for key, _macs, hbm, mxu, dw in RL.layer_bounds(PORT_PRUNED):
        nbytes = 2 * hbm / (4 if key == "dec.head" else 1)
        total += max(nbytes / 3350e9, 2 * mxu / 989e12, 2 * dw / 67e12)
    assert RL.spec_composite_us(PORT_PRUNED, probe) == pytest.approx(total * 1e6, rel=1e-12)
