"""The port's tools (``cli/fidelity.py``, ``cli/parity.py``,
``cli/frontier.py``, ``cli/visualize.py`` over ``viz.py``) and the tuned
dispatch through the CLIs (``cli.evaluate``, ``cli.deploy``,
``cli.serve`` with ``--impl mixed --tuning``) on the CPU, held against
the JAX package's on the same inputs."""

import argparse
import importlib
import json
import os
import threading

import h5py
import numpy as np
import pytest
import torch  # noqa: F401  (both packages import at the top)

import jax.numpy as jnp

from test_cli_tools import tiny_ckpt  # noqa: F401  (shared fixture)
from test_eval_e2e import nyu_val_root  # noqa: F401  (shared fixture)
from test_torch_eval_e2e import METRICS, _read_csv
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the levels K1 runs under the record the CLI tests write (f32 and bf16)
MIXED = {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "xla"}


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    path = tmp_path_factory.mktemp("rec") / "tiny.json"
    recs = [{"stage": s, "dtype": d, "winner": w}
            for d in ("bfloat16", "float32") for s, w in MIXED.items()]
    path.write_text(json.dumps({"config": {}, "device": "x", "records": recs}))
    return str(path)


@pytest.fixture
def rgb_npy(tmp_path):
    path = str(tmp_path / "rgb.npy")
    np.save(path, np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    return path


# --- the tuned dispatch through the CLIs ---------------------------------------

def test_evaluate_cli_mixed_matches_jax(nyu_val_root, tiny_ckpt, record, tmp_path,  # noqa: F811
                                        capsys):
    """cli.evaluate --impl mixed --tuning: the CSV row equals the JAX
    CLI's with the same flags (rtol 1e-5)."""
    from fastdepth_tpu.cli import evaluate as jax_cli
    from fastdepth_tpu_torch.cli import evaluate as port_cli
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1

    os.symlink(os.path.dirname(nyu_val_root), tmp_path / "nyudepthv2")
    args = ["--evaluate", tiny_ckpt, "--data-root", str(tmp_path), "--batch-size", "2",
            "--no-images", "--workers", "1", "--impl", "mixed", "--tuning", record]
    jax_cli.main(args + ["--csv", str(tmp_path / "jax.csv")])
    calls = []
    orig = K1.fused_decoder_stage_reference
    K1.fused_decoder_stage_reference = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        port_cli.main(args + ["--csv", str(tmp_path / "port.csv"), "--device", "cpu"])
    finally:
        K1.fused_decoder_stage_reference = orig
    assert "RMSE=" in capsys.readouterr().out
    assert len(calls) == 2 * 4  # K1 on levels 1 and 3 of 3 batches + the warm-up
    (jh, jrow), (ph, prow) = _read_csv(tmp_path / "jax.csv"), _read_csv(tmp_path / "port.csv")
    assert ph == jh
    for f in METRICS:
        np.testing.assert_allclose(float(prow[f]), float(jrow[f]), rtol=1e-5, err_msg=f)


def test_deploy_cli_mixed_matches_jax(tiny_ckpt, record, rgb_npy, tmp_path):  # noqa: F811
    from fastdepth_tpu.cli import deploy as jax_cli
    from fastdepth_tpu_torch.cli import deploy as port_cli

    common = ["--model", tiny_ckpt, "--input-fp", rgb_npy, "--warmup", "0", "--run", "1",
              "--impl", "mixed", "--tuning", record]
    jax_cli.main(common + ["--output-fp", str(tmp_path / "jax.npy")])
    port_cli.main(common + ["--output-fp", str(tmp_path / "port.npy"), "--device", "cpu"])
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (1, 1, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serve_cli_mixed_matches_jax(tiny_ckpt, record, tmp_path):  # noqa: F811
    """The serve CLI's daemon with --impl mixed --tuning answers a ping
    with the JAX package's mixed forward of the same frame (1e-5)."""
    from fastdepth_tpu.cli.evaluate import load_params_and_model
    from fastdepth_tpu.engine.aot import _pick_apply as jax_pick_apply
    from fastdepth_tpu_torch.cli import serve as serve_cli
    from fastdepth_tpu_torch.engine.server import request

    sock = str(tmp_path / "fd.sock")
    ready, stop, rc = threading.Event(), threading.Event(), {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", serve_cli.main(
        ["--evaluate", tiny_ckpt, "--socket", sock, "--batch-size", "2", "--image-size", "64",
         "64", "--stats-every", "0", "--impl", "mixed", "--tuning", record, "--device", "cpu"],
        _ready=ready, _stop=stop)), daemon=True)
    t.start()
    try:
        assert ready.wait(60), "daemon never came up"
        frame = np.random.RandomState(1).rand(64, 64, 3).astype(np.float32)
        pred = request(sock, frame)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive() and rc.get("rc") == 0
    params, model, _ = load_params_and_model(tiny_ckpt)
    folded = model.fold(params)
    want = np.asarray(jax_pick_apply(model, folded, "mixed", tuning=record)(
        folded, jnp.asarray(frame[None])))[0]
    np.testing.assert_allclose(pred, want, rtol=0, atol=1e-5)


# every JAX flag (and choice) of these CLIs parses in the port's
FLAG_ARGV = {"deploy": ["--model", "x", "--input-fp", "y"], "serve": [], "autotune": [],
             "fidelity": ["--evaluate", "x"], "parity": ["--evaluate", "x"], "frontier": []}


@pytest.mark.parametrize("cli", list(FLAG_ARGV))
def test_every_jax_cli_flag_parses_in_the_port(cli, monkeypatch):
    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        parsers.append(self)
        return parse(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    for package in ("fastdepth_tpu", "fastdepth_tpu_torch"):
        importlib.import_module(f"{package}.cli.{cli}").parse_args(FLAG_ARGV[cli])
    jax_p, port_p = parsers
    port = {s: a for a in port_p._actions for s in a.option_strings}
    for action in jax_p._actions:
        for s in action.option_strings:
            assert s in port, s
            if action.choices:
                assert set(action.choices) <= set(port[s].choices), s


# --- fidelity --------------------------------------------------------------------

# bf16 against f32 on the tiny model's 2 images: |delta| of a metric at
# most 2% of its f32 value (the JAX test holds RMSE to 5%), or 0.02 for
# the delta ratios, which move in steps of 1/pixels
BF16_RTOL, BF16_ATOL = 2e-2, 2e-2


def test_fidelity_matches_jax(tmp_path, tiny_ckpt, capsys):  # noqa: F811
    """cli.fidelity on an h5 tree this test writes, in both packages: the
    f32 columns agree to rtol 1e-5, the JSON keys are the JAX ones, and
    each bf16 column is within the bf16 tolerance above of the JAX one."""
    from fastdepth_tpu.cli import fidelity as jax_cli
    from fastdepth_tpu_torch.cli import fidelity as port_cli

    rng = np.random.RandomState(3)
    root = tmp_path / "nyudepthv2" / "val" / "scene"
    root.mkdir(parents=True)
    for i in range(3):
        with h5py.File(root / f"{i:05d}.h5", "w") as f:
            f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    args = ["--evaluate", tiny_ckpt, "--data-root", str(tmp_path), "--batch-size", "2",
            "--limit", "2", "--workers", "1"]
    jax_cli.main(args + ["--json", str(tmp_path / "jax.json")])
    capsys.readouterr()
    port_cli.main(args + ["--json", str(tmp_path / "port.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[fp32]" in out and "[bf16]" in out and "rmse" in out
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert set(got) == set(want) and got["images"] == want["images"] == 2
    assert set(got["metrics"]) == set(want["metrics"])
    for f, row in want["metrics"].items():
        assert set(got["metrics"][f]) == set(row)
        np.testing.assert_allclose(got["metrics"][f]["fp32"], row["fp32"], rtol=1e-5, err_msg=f)
        np.testing.assert_allclose(got["metrics"][f]["bf16"], row["bf16"],
                                   rtol=BF16_RTOL, atol=BF16_ATOL, err_msg=f)


# --- parity ------------------------------------------------------------------------

def test_parity_skips_loudly_without_artifacts(tmp_path, capsys):
    from fastdepth_tpu_torch.cli.parity import main

    rc = main(["--evaluate", str(tmp_path / "nope.pth.tar"), "--data-root", str(tmp_path),
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 2
    assert "PARITY SKIPPED" in out and "parity_runbook" in out
    assert "checkpoint:" in out and "NYU val split:" in out


@pytest.mark.parametrize("argv, path", [
    ([], "results/mobilenet-nnconv5dw-skipadd-pruned.pth.tar"),
    ([], "some-unknown-model.pth.tar"),
    (["--expected-rmse", "0.5", "--expected-delta1", "0.8"], "anything"),
    (["--expected-rmse", "0.5"], "results/mobilenet-nnconv5dw-skipadd-pruned.pth.tar"),
])
def test_parity_expected_row_equals_jax(argv, path):
    from fastdepth_tpu.cli import parity as J
    from fastdepth_tpu_torch.cli import parity as P

    assert P.PUBLISHED == J.PUBLISHED
    got = P._expected_for(path, P.parse_args(["--evaluate", "x.npz", *argv]))
    assert got == J._expected_for(path, J.parse_args(["--evaluate", "x.npz", *argv]))


@pytest.mark.parametrize("mode", ["auto", "yes", "no"])
def test_normalize_golden_rgb_equals_jax(mode):
    from fastdepth_tpu.cli.parity import normalize_golden_rgb as jax_norm
    from fastdepth_tpu_torch.cli.parity import normalize_golden_rgb

    pre = np.random.RandomState(0).rand(8, 8, 3)
    for rgb in (pre, (pre * 255).astype(np.uint8), (pre * 255).astype(np.float32),
                np.full((4, 4, 3), 1.5, np.float32)):
        got_log, want_log = [], []
        got = normalize_golden_rgb(rgb, mode=mode, log=got_log.append)
        want = jax_norm(rgb, mode=mode, log=want_log.append)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got_log == want_log


# --- frontier ----------------------------------------------------------------------

@pytest.mark.parametrize("key", ["pruned", "unpruned", "nnconv5dw", "nnconv5"])
def test_frontier_macs_equal_jax(key):
    from fastdepth_tpu.cli import frontier as J
    from fastdepth_tpu_torch.cli import frontier as P

    assert P.SWEEP_MODELS == J.SWEEP_MODELS
    assert P.macs_g(P._build(key)) == J.macs_g(J._build(key))


def test_frontier_cli_on_the_cpu_writes_the_jax_rows(tmp_path):
    """One model, b1, one call, on the CPU: .json and .md with the JAX
    package's row keys and table header; no 'mixed' row without a card."""
    from fastdepth_tpu_torch.cli import frontier

    out = str(tmp_path / "frontier")
    rows = frontier.main(["--models", "mobilenet-nnconv5dw-skipadd-pruned", "--batches", "1",
                          "--dtypes", "float32", "--calls", "1", "--out", out,
                          "--device", "cpu"])
    assert [(r["impl"], r["batch"]) for r in rows] == [("xla", 1), ("opt", 1)]
    data = json.loads((tmp_path / "frontier.json").read_text())
    assert set(data) >= {"device", "image", "rows", "baseline_tx2_gpu_fps"}
    assert set(data["rows"][0]) == {"model", "dtype", "batch", "impl", "fps", "us_per_frame",
                                    "macs_g", "rmse_m_published", "delta1_published"}
    assert data["rows"][0]["macs_g"] > 0.3 and data["device"] == "cpu"
    assert "| model | dtype | batch | impl |" in (tmp_path / "frontier.md").read_text()
    assert frontier.parse_args([]).out == os.path.join("docs", "frontier_h100")
    with pytest.raises(SystemExit, match="unknown model"):
        frontier.main(["--models", "nope", "--out", out, "--device", "cpu"])


# --- visualize and the colormap ---------------------------------------------------

def test_visualize_pngs_are_byte_equal_to_jax(tmp_path):
    from fastdepth_tpu.cli import visualize as jax_cli
    from fastdepth_tpu_torch.cli import visualize as port_cli

    rng = np.random.RandomState(4)
    args = []
    for name, arr in (("rgb", rng.rand(20, 24, 3).astype(np.float32)),
                      ("depth", rng.uniform(0.5, 9, (20, 24)).astype(np.float32)),
                      ("pred", rng.uniform(0.5, 9, (1, 1, 20, 24)))):
        np.save(tmp_path / f"{name}.npy", arr)
        args += [f"--{name}", str(tmp_path / f"{name}.npy")]
    jax_cli.main(args + ["--out-dir", str(tmp_path / "jax")])
    port_cli.main(args + ["--out-dir", str(tmp_path / "port")])
    for name in ("rgb", "depth", "pred"):
        assert (tmp_path / "port" / f"{name}.png").read_bytes() == \
            (tmp_path / "jax" / f"{name}.png").read_bytes(), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_viridis_is_matplotlibs_bit_for_bit(dtype):
    """viz.viridis without matplotlib against matplotlib's colormap, edges
    included: 0, 1, below 0, above 1, NaN and every table entry."""
    import matplotlib.pyplot as plt

    from fastdepth_tpu_torch import viz

    x = np.random.RandomState(5).rand(40, 30).astype(dtype)
    x[0, :6] = [0.0, 1.0, -0.1, 1.5, np.nan, 255.5 / 256]
    x[1, :] = np.arange(30) / 29
    np.testing.assert_array_equal(viz.viridis(x), plt.cm.viridis(x)[..., :3])
