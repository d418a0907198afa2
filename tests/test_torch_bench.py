"""The port's benchmark line (``fastdepth_tpu_torch/bench.py``) against the
root ``bench.py``, on the CPU: the rows (read from ``bench.py`` with
``ast``: tags, dtypes, batches, impls; ``bench.py`` is neither imported
nor run), the JSON line's keys with and without rows, the spec-peak
aggregate by hand, the rows at tiny widths on a 32^2 image (module
constants patched in this process), the time budget, a SIGTERM during
set-up and after a row, and the refusal without a card."""

import ast
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fastdepth_tpu_torch import ModelConfig, bench
from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED
from fastdepth_tpu_torch.engine import roofline as RL
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.models import fused as F

from torch_threads import child_env  # torch's CPU threads: a share per xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                   decoder_channels=(18, 14, 10, 6, 4))
FIRST_LINE_S, EXIT_S = 120, 60


def _root_bench():
    """(REQUIRED, OPTIONAL, the JSON line's dict literal) of the root
    bench.py's ``main``: each row as (tag, dtype name, impl, batch), the
    dict as {key: constant or None}."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    lists = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in ("REQUIRED", "OPTIONAL")):
            lists[node.targets[0].id] = [
                tuple(e.attr if isinstance(e, ast.Attribute) else e.value for e in row.elts)
                for row in node.value.elts]
    line = next(node for node in ast.walk(tree) if isinstance(node, ast.Dict)
                and any(getattr(k, "value", None) == "metric" for k in node.keys))
    keys = {k.value: (v.value if isinstance(v, ast.Constant) else None)
            for k, v in zip(line.keys, line.values)}
    return lists["REQUIRED"], lists["OPTIONAL"], keys


def _want_keys(rows):
    """The result keys bench.py's record() writes for ``rows``."""
    keys = set()
    for tag, _, _, batch in rows:
        keys.add(f"{tag}_b{batch}_fps")
        if batch == 1:
            keys.add(f"{tag}_b{batch}_latency_ms")
    return keys


@pytest.fixture
def tiny_bench(monkeypatch):
    """The port's bench at tiny widths on a 32^2 image, few calls."""
    for name, value in (("CONFIG", TINY), ("IMAGE_SIZE", 32), ("WARMUP", 1), ("CALLS", 3),
                        ("LATENCY_WARMUP", 1), ("LATENCY_REPEATS", 2), ("TRAIN_WARMUP", 1),
                        ("TRAIN_STEPS", 2)):
        monkeypatch.setattr(bench, name, value)
    return bench


def _run_main(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_rows_are_the_root_bench_rows():
    """Tags, batches and impls as bench.py's, its jnp dtypes by name, and
    the metric string."""
    required, optional, keys = _root_bench()
    assert bench.REQUIRED == required
    assert bench.OPTIONAL == optional
    assert keys["metric"] == bench.METRIC and keys["unit"] == "fps"
    assert bench.ROOFLINE_ROW == "bf16_opt_b128"
    # bench.py's pallas rows stay at b32, the TPU compile helper's limit
    assert ("bf16_pallas", "bfloat16", "pallas", 32) in bench.OPTIONAL


@pytest.mark.parametrize("impl, want", [("xla", "straight"), ("opt", "opt"), ("pallas", "fused")])
def test_each_jax_impl_maps_to_the_ports_forward(impl, want, monkeypatch):
    """``xla`` is ``model.apply``; ``opt`` runs apply_fastdepth_opt and
    ``pallas`` apply_fastdepth_fused (K1, K4), through _pick_apply."""
    monkeypatch.setattr(bench, "CONFIG", TINY)
    model, params = bench.flagship()
    assert bench.PORT_IMPL[impl] in ("xla", "opt", "fused")
    if want == "straight":
        assert _pick_apply(model, params, bench.PORT_IMPL[impl], 2) == model.apply
        return
    calls = []
    target = {"opt": "apply_fastdepth_opt", "fused": "apply_fastdepth_fused"}[want]
    real = getattr(F, target)
    monkeypatch.setattr(F, target, lambda *a, **k: calls.append(target) or real(*a, **k))
    bench.row_forward(model, params, impl, 2)(params, torch.rand(2, 32, 32, 3))
    assert calls == [target]


def test_the_line_has_bench_py_keys_with_no_rows():
    """A kill before any row: bench.py's keys, value 0.0, no best config,
    the note under ``aborted`` and nothing else in ``detail``."""
    _, _, keys = _root_bench()
    got = bench.line({}, 0.0, None, "killed by signal 15 mid-run; partial rows")
    assert list(got) == list(keys)
    assert got["value"] == 0.0 and got["vs_baseline"] == 0.0 and got["best_config"] is None
    assert got["detail"] == {"aborted": "killed by signal 15 mid-run; partial rows"}
    json.dumps(got)


@pytest.mark.parametrize("best_cfg", ["bf16_opt_b128", "bf16_pallas_b32"])
def test_the_roofline_ratios_follow_bench_py_rule(best_cfg):
    """The ratios appear only when the bf16 opt b128 row wins, on the
    card's denominators (not bench.py's v5e 37.7 us), vs_baseline on the
    TX2's 5.6 ms."""
    got = bench.line({"x_fps": 20000.0}, 20000.0, best_cfg)
    assert got["vs_baseline"] == round(20000.0 / (1000 / 5.6), 2)
    assert got["detail"]["best_us_per_frame"] == 50.0
    ratios = {"x_roofline_spec", "x_roofline_measured"}
    if best_cfg != "bf16_opt_b128":
        assert not ratios & set(got["detail"])
        return
    with open(RL.CEILINGS_PATH) as f:
        probe = json.load(f)
    assert "H100" in probe["card"]["name"]
    assert got["detail"]["x_roofline_spec"] == round(
        50.0 / RL.spec_composite_us(FASTDEPTH_PRUNED, probe), 2)
    assert got["detail"]["x_roofline_measured"] == round(
        50.0 / RL.measured_composite_us(FASTDEPTH_PRUNED, probe), 2)
    assert got["detail"]["x_roofline_spec"] != round(50.0 / 37.7, 2)


def test_the_ratios_drop_out_without_the_probe_file(tmp_path):
    assert bench.roofline_ratios(20000.0, str(tmp_path / "absent.json")) == {}
    (tmp_path / "bad.json").write_text("{")
    assert bench.roofline_ratios(20000.0, str(tmp_path / "bad.json")) == {}


def test_spec_aggregate_is_the_layer_bounds_at_the_data_sheet_rates():
    """By hand: every layer's bf16 bytes (the head's at a quarter) at the
    data sheet's 3,350 GB/s, its pointwise MACs at 989 TFLOP/s bf16 and
    its depthwise MACs at 67 TFLOP/s, the largest of the three a layer."""
    with open(RL.CEILINGS_PATH) as f:
        probe = json.load(f)
    ds = probe["data_sheet"]
    assert (ds["hbm_GBs"], ds["bf16_tensor_tflops"], ds["f32_tflops"]) == (3350.0, 989.0, 67.0)
    total = 0.0
    for key, _macs, hbm, mxu, dw in RL.layer_bounds(FASTDEPTH_PRUNED):
        nbytes = 2 * hbm / (4 if key == "dec.head" else 1)
        total += max(nbytes / 3350e9, 2 * mxu / 989e12, 2 * dw / 67e12)
    assert RL.spec_composite_us(FASTDEPTH_PRUNED, probe) == pytest.approx(total * 1e6, rel=1e-12)


def test_rows_run_at_tiny_widths_on_the_cpu(tiny_bench, capsys):
    """Every row and the train row, each a positive number under
    bench.py's keys; the best row is the headline value."""
    got, err = _run_main(capsys)
    required, optional, _ = _root_bench()
    rows = {k: v for k, v in got["detail"].items() if k.endswith(("_fps", "_latency_ms"))}
    assert set(rows) == _want_keys(required + optional) | {"train_bf16_b128_fps"}
    assert all(isinstance(v, float) and v > 0 for v in rows.values()), rows
    fps = {k[:-4]: v for k, v in rows.items() if k.endswith("_fps") and "train" not in k}
    assert got["best_config"] == max(fps, key=fps.get)
    assert got["value"] == fps[got["best_config"]]
    assert err.splitlines()[0].startswith("# bench device: cpu")
    assert "aborted" not in got["detail"]


def test_the_pallas_rows_forward_is_the_xla_rows(tiny_bench):
    """The fused forward (K1 and K4's plain versions on the CPU) and the
    head-commute forward within 1e-4 of the straight one, f32, on the
    rows' own functions."""
    model, params32 = bench.flagship()
    params = bench.cast(model, params32, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(4, 32, 32, 3).astype(np.float32))
    want = bench.row_forward(model, params, "xla", 4)(params, x)
    for impl in ("pallas", "opt"):
        got = bench.row_forward(model, params, impl, 4)(params, x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, err_msg=impl)


def test_the_budget_skips_the_optional_rows(tiny_bench, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    got, _ = _run_main(capsys)
    required, optional, _ = _root_bench()
    detail = got["detail"]
    assert _want_keys(required) <= set(detail)
    for tag, _, _, batch in optional:
        assert detail[f"skipped_{tag}_b{batch}"] == "over time budget"
    assert detail["skipped_train_bf16_b128"] == "over time budget"


def test_a_sigterm_mid_run_prints_the_line_and_exits_124():
    """``python -m fastdepth_tpu_torch.bench --device cpu`` (full width)
    killed after its first ``# bench`` line: rc 124 and one JSON line,
    ``aborted``, value 0.0."""
    proc = subprocess.Popen([sys.executable, "-m", "fastdepth_tpu_torch.bench", "--device",
                             "cpu"], cwd=REPO, env=child_env(PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    first = threading.Event()

    def watch():
        for text in proc.stderr:
            if text.startswith("# bench"):
                first.set()
    reader = threading.Thread(target=watch, daemon=True)
    reader.start()
    try:
        assert first.wait(FIRST_LINE_S), "no '# bench' line"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(EXIT_S) == 124  # stdout holds one short line: the pipe never fills
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(EXIT_S)
    lines = [s for s in out.splitlines() if s.strip()]
    assert len(lines) == 1, out
    got = json.loads(lines[0])
    assert got["value"] == 0.0 and "aborted" in got["detail"]


def test_a_sigterm_after_a_row_prints_that_row_and_exits_124():
    """The bench at tiny widths on 32^2 (module constants patched in the
    child) held after its first row's ``#   <row>: ... fps`` line, then
    killed: rc 124 and one JSON line with ``aborted``, that row as the
    value and best row, and the fields the handler derives from it
    (``best_us_per_frame``; the roofline ratios, since the first row is
    ``bench.ROOFLINE_ROW``)."""
    tag, _, _, batch = bench.REQUIRED[0]
    row = f"{tag}_b{batch}"
    code = (
        "import sys, time\n"
        "from fastdepth_tpu_torch import ModelConfig, bench\n"
        f"bench.CONFIG = ModelConfig(encoder_channels={TINY.encoder_channels!r}, "
        f"decoder_channels={TINY.decoder_channels!r})\n"
        "bench.IMAGE_SIZE, bench.WARMUP, bench.CALLS = 32, 1, 3\n"
        "log = bench.log\n"
        "def held(msg):\n"
        "    log(msg)\n"
        "    if msg.startswith('#   '):\n"
        "        time.sleep(600)  # the row is in: wait here for the signal\n"
        "bench.log = held\n"
        "sys.exit(bench.main(['--device', 'cpu']))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=child_env(PYTHONPATH=REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    measured = threading.Event()

    def watch():
        for text in proc.stderr:
            if text.startswith(f"#   {row}: "):
                measured.set()
    reader = threading.Thread(target=watch, daemon=True)
    reader.start()
    try:
        assert measured.wait(FIRST_LINE_S), f"no '#   {row}' line"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(EXIT_S) == 124
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(EXIT_S)
    lines = [s for s in out.splitlines() if s.strip()]
    assert len(lines) == 1, out
    got = json.loads(lines[0])
    detail = got["detail"]
    assert "aborted" in detail
    assert isinstance(detail[f"{row}_fps"], float) and detail[f"{row}_fps"] > 0
    assert got["value"] == detail[f"{row}_fps"] and got["best_config"] == row
    assert detail["best_us_per_frame"] > 0
    assert row == bench.ROOFLINE_ROW
    assert detail["x_roofline_spec"] > 0 and detail["x_roofline_measured"] > 0


def test_without_a_card_the_default_device_refuses():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "fastdepth_tpu_torch.bench"], cwd=REPO,
                          env=child_env(PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=EXIT_S)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "{" not in proc.stdout


def test_importing_the_bench_touches_no_torch():
    """The SIGTERM handler is registered before torch is imported, so the
    module itself must not pull torch in (``python -m`` runs its top
    level first)."""
    code = ("import sys, fastdepth_tpu_torch.bench\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=child_env(PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=EXIT_S)
    assert proc.returncode == 0, proc.stderr
