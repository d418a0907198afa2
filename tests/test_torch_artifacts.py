"""The port's committed card measurements (``docs/*_h100.json``) hold their
own arithmetic — the counterpart of ``tests/test_artifacts_r5.py``, which
holds the JAX package's TPU records to theirs.  Each file is checked
against what it says it derives from its own rows (means, spreads,
fractions, rates, the knee, the break-even link rate, the augmentation's
cost), never against a TPU ratio; a rerun that contradicts its own
derivation fails here instead of shipping."""

import glob
import json
import os
import re

import numpy as np
import pytest

import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from fastdepth_tpu_torch.scripts import _serving as S

DOCS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "docs")
H100 = sorted(os.path.basename(p) for p in glob.glob(os.path.join(DOCS, "*_h100.json")))
# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
CARD = re.compile(r"^NVIDIA .+, \d+(\.\d+)? W$")


def _load(name):
    with open(os.path.join(DOCS, name)) as f:
        return json.load(f)


def _cards(obj):
    """Every value under a ``card`` or ``nvidia_smi`` key, at any depth."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in ("card", "nvidia_smi") and isinstance(v, str):
                yield v
            else:
                yield from _cards(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _cards(v)


def test_the_modules_records_are_all_here():
    for name in ("probe_r5_device_gathers_h100.json", "probe_r5_lut_alternatives_h100.json",
                 "bench_train_device_aug_h100.json", "soak_server_socket_h100.json",
                 "spatial_halo_h100.json", "parity_rehearsal_h100.json"):
        assert name in H100, name


@pytest.mark.parametrize("name", H100)
def test_every_record_names_an_nvidia_card_and_its_power_limit(name):
    cards = list(_cards(_load(name)))
    assert cards, name
    for card in cards:
        assert CARD.match(card), card


@pytest.mark.parametrize("name", ["soak_fused_h100.json", "soak_opt_h100.json"])
def test_forward_soak_summarises_its_windows(name):
    d = _load(name)
    w = d["windows_fps"]
    assert d["frames_total"] > 0 and w
    assert d["mean_fps"] == round(float(np.mean(w)), 1)
    assert (d["min_fps"], d["max_fps"]) == (min(w), max(w))
    assert d["frames_total"] % (d["batch"] * d["chunk"]) == 0


def test_server_soak_summarises_its_windows():
    d = _load("soak_r4_h100.json")
    assert d["frames"] > 0
    red = S.reduce_windows(d["windows_fps"])
    assert (d["mean_fps"], d["spread_pct"]) == (red["mean_fps"], red["spread_pct"])
    assert 0 < d["occupancy"] <= 1 and d["latency_ms"]["p50"] <= d["latency_ms"]["p99"]


@pytest.mark.parametrize("name", ["soak_server_socket_h100.json", "soak_server_null_h100.json"])
def test_socket_soak_windows_and_its_fraction_of_the_engine_ceiling(name):
    d = _load(name)
    assert d["frames_total"] > 0
    assert len(d["windows"]) == len(d["window_fps"])
    assert [w["fps"] for w in d["windows"]] == d["window_fps"]
    assert abs(d["mean_fps"] - np.mean(d["window_fps"])) < 0.05
    spread = np.ptp(d["window_fps"]) / np.mean(d["window_fps"]) * 100
    assert abs(d["window_spread_pct"] - spread) < 0.005
    # mean_fps is rounded to 0.1 and the fraction to 0.001
    assert abs(d["fraction_of_engine_ceiling"] - d["mean_fps"] / d["engine_ceiling_fps"]) \
        <= 0.0005 + 0.05 / d["engine_ceiling_fps"]


def test_depth_frontier_rates_and_its_knee():
    d = _load("b1_depth_frontier_h100.json")
    rows = {r["depth"]: r for r in d["rows"]}
    for r in d["rows"]:
        # fps and ms_per_frame are rounded apart
        assert abs(r["fps"] * r["ms_per_frame"] - 1e3) / 1e3 < 0.02
    assert d["knee"] == S.knee(d["rows"])
    base = rows[min(rows)]["latency_ms"]["p50"]
    knee = d["knee"]["depth"]
    assert rows[knee]["latency_ms"]["p50"] <= 3 * base
    assert not [k for k in rows if k > knee and rows[k]["latency_ms"]["p50"] <= 3 * base]


def test_chain_serving_rates():
    for c in _load("b1_serving_h100.json")["cases"]:
        assert abs(c["fps"] * c["ms_per_frame"] - 1e3) / 1e3 < 0.02, c["case"]


def test_train_sweep_rates():
    for r in _load("bench_train_h100.json"):
        assert abs(r["train_fps"] - r["batch"] / r["step_ms"] * 1e3) / r["train_fps"] < 0.002, r


def test_b1_ordering_medians():
    for r in _load("probe_b1_confirm_h100.json")["rows"]:
        assert abs(r["us_med"] - float(np.median(r["us_all"]))) < 0.05, r["name"]


def test_host_pipeline_projection():
    d = _load("bench_host_pipeline_h100.json")
    assert abs(d["items_per_s_per_core"] - 1e3 / d["per_item_ms"]["full_item_native"]) < 0.1
    f = d["feed_projection"]
    assert abs(f["cores_at_linear_scaling_host_chain"]
               - f["device_train_fps"] / d["items_per_s_per_core"]) < 0.05
    assert abs(f["cores_at_linear_scaling_device_augment"]
               - f["device_train_fps"] / d["device_augment"]["items_per_s_per_core"]) < 0.05


def test_halo_break_even_rate_is_bytes_over_the_saved_time():
    d = _load("spatial_halo_h100.json")
    t1 = d["t1_b1_us"]
    assert t1 > 0
    for r in d["rows"]:
        s = r["space_shards"]
        saved = t1 * (1 - 1 / s)
        assert abs(r["compute_saved_us_vs_single"] - saved) <= 0.05 + 1e-9
        want = r["halo_bytes_per_device"] / (saved * 1e-6) / 1e9
        assert abs(r["breakeven_ici_GBs"] - want) <= 0.005 + 1e-9, s
        assert max(r["sent_bytes_by_rank"]) == r["halo_bytes_per_device"]


def test_rehearsal_report():
    d = _load("parity_rehearsal_h100.json")
    assert d["result"].startswith("PARITY OK")
    assert f"--expected-rmse {d['trained_rmse_m']:.6f}" in d["rerun"]
    assert f"--expected-delta1 {d['trained_delta1']:.6f}" in d["rerun"]
    assert d["weights"] in d["rerun"]
    pin = d["val16_cpu_row"]
    assert 0 < pin["delta1"] < 1 and pin["rmse_mm"] > pin["mae_mm"] > 0


def test_device_augment_cost_derives_from_its_rows_and_picks_the_default():
    """Each row is the median of its rounds, ``aug_cost_pct_<form>`` = 100
    (1 - aug / plain) on the rows and round by round on the runs, and the
    port's form (the gather form, the only one ``data/device_aug`` has)
    is the one whose step is faster."""
    import statistics

    d = _load("bench_train_device_aug_h100.json")
    rows, runs = d["rows"], d["runs"]
    assert set(rows) == set(runs) and all(len(v) == d["repeats"] for v in runs.values())
    for tag, fps in runs.items():
        assert rows[tag] == statistics.median(fps), tag
    for form in ("dot", "gather"):
        aug = f"device_augment_{form}_train_fps"
        got = d[f"aug_cost_pct_{form}"]
        assert abs(got - 100.0 * (1 - rows[aug] / rows["plain_train_fps"])) < 0.005, form
        for got, a, p in zip(d["aug_cost_pct_runs"][form], runs[aug], runs["plain_train_fps"]):
            assert abs(got - 100.0 * (1 - a / p)) < 0.005, form
    assert rows["device_augment_gather_train_fps"] > rows["device_augment_dot_train_fps"]


def test_gather_probe_decomposes_the_default_augmentation():
    """The port's form's stages (the rgb and depth gathers, three jitter
    slots and the /255) add up to the whole augmentation within 20%, and
    its whole is the faster of the two forms."""
    r = _load("probe_r5_device_gathers_h100.json")["rows"]
    stages = (r["rgb_u8_gather"] + r["depth_f32_gather"] + 3 * r["jitter_slot_2d_gather"]
              + r["unit_lut_take"])
    assert abs(stages - r["full_augment_gather"]) / r["full_augment_gather"] < 0.20
    assert r["full_augment_gather"] < r["full_augment"]
    assert r["jitter_slot_2d_gather"] < r["jitter_slot_2d"]


def test_lut_probe_ran_every_row():
    d = _load("probe_r5_lut_alternatives_h100.json")
    assert d["errors"] == {}
    assert d["lookups_per_call"] == d["batch"] * 224 * 224 * 3
    assert set(d["rows"]) == {"take_256", "onehot_dot", "select_sum", "select_sum_bt",
                              "onehot_dot_bt", "sat_two_dots", "block_gather_16"}
    assert all(v > 0 for v in d["rows"].values())
