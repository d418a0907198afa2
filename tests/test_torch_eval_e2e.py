"""The port's evaluation slice end to end on the CPU: checkpoint -> build
-> fold -> Evaluator -> metrics -> validate() -> CSV, held against the
JAX CLI on the same data and against the committed trained weights'
pinned metric row."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_eval_e2e import nyu_val_root, torch_ckpt  # noqa: F401  (shared fixtures)
from test_rehearsal_weights import val16_tree  # noqa: F401  (shared fixture)
from torch_threads import child_env  # torch's CPU threads: a share per xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ["rmse", "mae", "delta1", "absrel", "lg10", "mse", "delta2", "delta3"]
TIMINGS = ["data_time", "gpu_time"]


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2, rows
    return rows[0], dict(zip(rows[0], rows[1]))


def test_cli_csv_matches_jax_cli(nyu_val_root, torch_ckpt, tmp_path, capsys):  # noqa: F811
    from fastdepth_tpu.cli import evaluate as jax_cli
    from fastdepth_tpu_torch.cli import evaluate as port_cli

    ckpt_path, _ = torch_ckpt
    os.symlink(os.path.dirname(nyu_val_root), tmp_path / "nyudepthv2")
    args = ["--evaluate", ckpt_path, "--data-root", str(tmp_path), "--batch-size", "2",
            "--print-freq", "2", "--no-images", "--workers", "2"]
    jax_cli.main(args + ["--csv", str(tmp_path / "jax.csv")])
    capsys.readouterr()
    port_cli.main(args + ["--csv", str(tmp_path / "port.csv"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "RMSE=" in out and "Delta1=" in out and "Test: [2/5]" in out

    jax_header, jax_row = _read_csv(tmp_path / "jax.csv")
    port_header, port_row = _read_csv(tmp_path / "port.csv")
    assert port_header == jax_header == METRICS + TIMINGS
    for f in METRICS:
        np.testing.assert_allclose(float(port_row[f]), float(jax_row[f]), rtol=1e-4,
                                   equal_nan=True, err_msg=f)
    for f in TIMINGS:
        assert float(port_row[f]) >= 0.0


def test_committed_weights_reproduce_the_pinned_row(val16_tree, monkeypatch):  # noqa: F811
    """docs/rehearsal_model_r5.npz through the port reproduces the CPU row
    the JAX package pinned (same tolerance as test_rehearsal_weights)."""
    from fastdepth_tpu.checkpoint.io import load_checkpoint
    from fastdepth_tpu.data import BatchLoader, NYUDataset
    from fastdepth_tpu_torch.checkpoint import params_from_jax
    from fastdepth_tpu_torch.engine import Evaluator, validate
    from fastdepth_tpu_torch.models import build
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K

    with open(os.path.join(REPO, "docs", "parity_rehearsal_r5.json")) as f:
        pin = json.load(f)["val16_cpu_row"]
    tree, cfg, _ = load_checkpoint(os.path.join(REPO, "docs", "rehearsal_model_r5.npz"))
    model = build(cfg)
    dataset = NYUDataset(os.path.join(val16_tree, "nyudepthv2", "val"), split="val")
    loader = BatchLoader(dataset, batch_size=8, num_workers=2, pad_last=True)
    ev = Evaluator(model, model.load(params_from_jax(tree)), batch_size=8, device="cpu")
    calls = []
    orig = K.fused_decoder_stage_reference
    monkeypatch.setattr(K, "fused_decoder_stage_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    avg = validate(loader, ev, print_freq=0, make_images=False, log=lambda *a: None)
    # the default impl ran the fused path: 5 decoder levels x (2 batches + warmup)
    assert len(calls) == 5 * 3
    np.testing.assert_allclose(avg.rmse, pin["rmse_mm"], rtol=5e-4)
    np.testing.assert_allclose(avg.mae, pin["mae_mm"], rtol=5e-4)
    np.testing.assert_allclose(avg.delta1, pin["delta1"], rtol=5e-4)
    np.testing.assert_allclose(avg.absrel, pin["absrel"], rtol=5e-4)


def _run(code_or_args, **kw):
    env = child_env(PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *code_or_args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300, **kw)


def test_port_imports_and_runs_without_jax():
    code = """
import sys
import numpy as np
import torch
import fastdepth_tpu_torch as fd
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth

cfg = fd.ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                     decoder_channels=(18, 14, 10, 6, 4))
model = fd.build(cfg)
gen = torch.Generator().manual_seed(0)
state = {k: torch.randn(v.shape, generator=gen) * 0.2
         for k, v in make_fastdepth(cfg, folded=True).state_dict().items()}
ev = fd.Evaluator(model, model.load(state), batch_size=2, device="cpu")
rgb = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
pred, metrics = ev(ev.put(rgb), ev.put(np.ones((2, 32, 32, 1), np.float32)))
assert tuple(pred.shape) == (2, 32, 32, 1) and tuple(metrics.shape) == (10, 2)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not jax_mods, jax_mods
print("no jax")
"""
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no jax"


def test_cli_device_cuda_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _run(["-m", "fastdepth_tpu_torch.cli.evaluate", "--evaluate",
                 os.path.join(REPO, "docs", "rehearsal_model_r5.npz"), "--device", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_evaluator_uint8_path_normalizes_bit_for_bit_with_the_host_path():
    """``--device-normalize``: the Evaluator's uint8 path hands the forward
    the f32 frames the host path (``data/native.gather_rgb_f32``, /255 on
    the host) makes, bit for bit, on all 256 values: it divides through
    ``engine.aot.normalize`` (a tensor divisor), never by a Python number
    (a reciprocal multiply on the card, 1 ulp off on 126 of them)."""
    import fastdepth_tpu_torch as fd
    from fastdepth_tpu_torch.data import native

    cfg = fd.ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                         decoder_channels=(18, 14, 10, 6, 4))
    model = fd.build(cfg)
    ev = fd.Evaluator(model, model.init(torch.Generator().manual_seed(0)), device="cpu")
    seen = []

    def record(params, x):
        seen.append(x.clone())
        return torch.zeros((*x.shape[:3], 1))

    ev._apply = record
    raw = np.stack([np.arange(256, dtype=np.uint8).reshape(16, 16),
                    np.arange(255, -1, -1, dtype=np.uint8).reshape(16, 16),
                    np.roll(np.arange(256, dtype=np.uint8), 7).reshape(16, 16)], axis=-1)
    host = native.gather_rgb_f32(raw, np.arange(16), np.arange(16))
    ev(ev.put(raw[None]), ev.put(np.ones((1, 16, 16, 1), np.float32)))
    assert seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy()[0], host)
