"""The port's modules of ``scripts/`` (``fastdepth_tpu_torch/scripts/``) on
the CPU, at the tiny widths of ``tests/test_pallas.py``:

(a) each serving module's server, built with its script's settings
    (compute in f32 here), against the JAX package's ``InferenceServer``
    with the same settings on the same numpy tree, chain mode included;
(b) the window reducer and the knee rule on the rows the scripts
    recorded in ``docs/``;
(c) every module run briefly through its ``main``, writing its script's
    JSON keys (read off each script's source, cited by line) plus the
    port's additions, and the substitutions where the script wrote a TPU
    figure (``device_b1_compute_us``, the engine ceiling, ``t1``);
(d) the JAX script ``soak_server_socket_r5.py --backend null`` and the
    port's, each ~3 s in a subprocess: the same keys, both fps > 0;
(e) the port's structured tree byte for byte the JAX script's;
(f) both packages' host-pipeline ``main``: the same keys;
(g) the device-augment modules (``probe_r5_device_gathers``,
    ``probe_r5_lut_alternatives``, ``bench_train_device_aug_r5``): their
    inputs drawn as their scripts draw them, each probe stage's output bit
    for bit the JAX expression its script times on the same inputs, every
    ``main`` at b1-b2 with its script's keys, and the train bench's dot
    step against its gather step, the port's own;
and the halo plan of ``analyze_spatial_halo`` against
``docs/spatial_halo_r3.json`` (the gloo ranks' bytes are held in
``tests/test_torch_spatial.py``, from ``tests/torch_spatial_ranks.py``'s
two-rank job)."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.engine import server as JS
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth
from fastdepth_tpu_torch.scripts import _serving as S
from fastdepth_tpu_torch.scripts import _trees
from fastdepth_tpu_torch.scripts import (
    analyze_spatial_halo,
    bench_chain_depth_frontier,
    bench_chain_serving,
    bench_host_pipeline,
    bench_serve_daemon,
    bench_train,
    bench_train_device_aug_r5,
    confirm_b1_opt,
    make_frontier_plot,
    make_roofline,
    probe_r5_device_gathers,
    probe_r5_lut_alternatives,
    soak_server_r4,
    soak_server_socket_r5,
    soak_serving,
    train_rehearsal,
)
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)
from torch_threads import child_env
from torch_port_config import to_jax
from test_torch_probes import _load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
HW = 64
RESULT_S = 60
# the keys the port adds to every module's JSON (a row's, for bench_train)
PORT_ADDED = {"card", "launches"}


def _docs(name):
    with open(os.path.join(REPO, "docs", name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def state_dict():
    """A seeded unfolded tiny tree, BatchNorm statistics away from their
    defaults so the fold matters (tests/test_torch_server.py's)."""
    rng = np.random.RandomState(0)
    sd = {}
    for key, v in make_fastdepth(CFG, folded=False).state_dict().items():
        shape, leaf = tuple(v.shape), key.rsplit(".", 1)[-1]
        if leaf == "w":
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf == "var":
            a = 1.0 + 0.2 * rng.rand(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


def _tiny_flagship(seed=0):
    model = build(CFG)
    return model, model.init(torch.Generator().manual_seed(seed))


@pytest.fixture
def tiny(monkeypatch):
    """The modules' flagship swapped for the tiny widths, on 64^2 frames."""
    monkeypatch.setattr(S, "flagship", _tiny_flagship)
    monkeypatch.setattr(S, "HW", HW)


# --- (a) the servers against the JAX package's --------------------------------

# each module's server at batch 4 on 64^2 frames (5 frames: a padded tail),
# and the queue its script gives it
SERVERS = {
    "soak_server_r4": (lambda m, p, **kw: soak_server_r4.build_server(
        m, p, batch=4, hw=HW, **kw), 8 * 4),
    "bench_serve_daemon float32": (lambda m, p, **kw: bench_serve_daemon.build_server(
        m, p, batch=4, input_dtype=np.float32, hw=HW, **kw), 1024),
    "bench_serve_daemon uint8": (lambda m, p, **kw: bench_serve_daemon.build_server(
        m, p, batch=4, input_dtype=np.uint8, hw=HW, **kw), 1024),
    "bench_chain_serving chain": (lambda m, p, **kw: bench_chain_serving.build_server(
        m, p, batch_size=4, chain=True, hw=HW, **kw), 4 * 4 + 64),
    "bench_chain_serving per-call": (lambda m, p, **kw: bench_chain_serving.build_server(
        m, p, batch_size=1, chain=False, hw=HW, **kw), 4 * 1 + 64),
    "bench_chain_depth_frontier": (lambda m, p, **kw: bench_chain_depth_frontier.build_server(
        m, p, k=4, depth=8, hw=HW, **kw), max(4 * 4, 8 + 4)),
    "soak_server_socket_r5": (lambda m, p, **kw: soak_server_socket_r5.build_server(
        m, p, batch=4, impl="auto", hw=HW, **kw), 8 * 4),
}


@pytest.fixture(scope="module")
def jax_answers(state_dict):
    """The JAX server's f32 answers by (input dtype, batch, chain), the
    tree and frames of :func:`_frames`."""
    tree = jax.tree.map(jnp.asarray, params_to_jax(state_dict))
    model = jax_build(to_jax(CFG))
    cache = {}

    def answers(input_dtype, batch, chain):
        key = (np.dtype(input_dtype).name, batch, chain)
        if key not in cache:
            with JS.InferenceServer(model, tree, batch_size=batch, image_size=(HW, HW),
                                    dtype=jnp.float32, input_dtype=input_dtype,
                                    output_dtype=np.float32, pipeline_depth=2, chain=chain,
                                    copy_inputs=False) as js:
                cache[key] = np.stack([f.result(timeout=RESULT_S) for f in
                                       [js.submit(x) for x in _frames(input_dtype)]])
        return cache[key]

    return answers


def _frames(input_dtype, n=5):
    rng = np.random.RandomState(3)
    return [(rng.rand(HW, HW, 3) * 255).astype(input_dtype) for _ in range(n)]


@pytest.mark.parametrize("name", list(SERVERS))
def test_module_server_matches_the_jax_server(name, state_dict, jax_answers):
    make, queue = SERVERS[name]
    model = build(CFG)
    with make(model, model.load(state_dict), dtype=torch.float32, device="cpu") as srv:
        # the script's settings
        assert (srv.pipeline_depth, srv._copy_inputs, srv._q.maxsize) == (2, False, queue)
        frames = _frames(srv.input_dtype)
        got = np.stack([f.result(timeout=RESULT_S) for f in [srv.submit(x) for x in frames]])
        settings = (srv.input_dtype, srv.output_dtype, srv.batch_size, srv.chain)
    want = jax_answers(settings[0], settings[2], settings[3])
    assert got.shape == want.shape == (5, HW, HW, 1) and got.dtype == settings[1]
    if settings[1] == np.float16:  # within one f16 rounding of the f32 answer
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert np.all(np.abs(got.astype(np.float32) - want) <= step + 1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_module_servers_default_to_the_scripts_bf16_uint8_f16():
    assert S.SERVER_SETTINGS == {"dtype": torch.bfloat16, "input_dtype": np.uint8,
                                 "output_dtype": np.float16, "pipeline_depth": 2,
                                 "copy_inputs": False}


def test_null_model_serves_the_channel_mean():
    model, params = S.null_model()
    frames = _frames(np.uint8, 3)
    with S.make_server(model, params, 2, image_size=(HW, HW), impl="xla", dtype=torch.float32,
                       output_dtype=np.float32, device="cpu") as srv:
        got = np.stack([f.result(timeout=RESULT_S) for f in [srv.submit(x) for x in frames]])
    want = (np.stack(frames).astype(np.float32) / np.float32(255)).mean(-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- (b) the reducer and the knee on the recorded rows ----------------------------


def test_window_reducer_gives_soak_r4s_mean_and_spread():
    red = S.reduce_windows(_docs("soak_r4.json")["windows_fps"])
    assert (red["mean_fps"], red["spread_pct"]) == (47.7, 97.94)


def test_window_reducer_gives_soak_r2s_mean_min_max():
    rec = _docs("soak_r2.json")
    red = S.reduce_windows(rec["windows_fps"])
    assert (red["mean_fps"], red["min_fps"], red["max_fps"]) == (
        rec["mean_fps"], rec["min_fps"], rec["max_fps"])


def test_knee_rule_gives_the_recorded_depth_frontier_knee():
    rec = _docs("b1_depth_frontier_r5.json")
    assert S.knee(rec["rows"]) == rec["knee"]
    assert rec["knee"]["depth"] == 32


def test_reducer_and_knee_without_rows():
    assert S.reduce_windows([])["mean_fps"] is None
    assert S.knee([]) is None and S.knee([{"depth": 1, "latency_ms": None}]) is None


# --- (c) every module through its main -------------------------------------------

# the scripts' JSON keys, read off their sources
SOAK_KEYS = {"batch", "impl", "dtype", "minutes", "chunk", "windows_fps", "mean_fps",
             "min_fps", "max_fps", "frames_total"}  # scripts/soak_serving.py:61-67
R4_KEYS = {"what", "minutes", "frames", "windows_fps", "mean_fps", "spread_pct", "occupancy",
           "client_depth", "latency_ms", "note"}  # scripts/soak_server_r4.py:84-101
DAEMON_KEYS = {"float32_engine_fps", "float32_socket_fps", "uint8_engine_fps",
               "uint8_socket_fps", "clients", "frames_per_client", "batch",
               "dtype"}  # scripts/bench_serve_daemon.py:62,73,79-80
CHAIN_KEYS = {"frames_per_case", "hw", "dtype", "cases",
              "device_b1_compute_us"}  # scripts/bench_chain_serving.py:55-56,108
CASE_KEYS = {"case", "batch_size", "chain", "fps", "ms_per_frame", "mean_occupancy",
             "latency_ms"}  # scripts/bench_chain_serving.py:89-95
FRONTIER_KEYS = {"surface", "k", "hw", "dtype", "rows",
                 "knee"}  # scripts/bench_chain_depth_frontier.py:57-62,114
FRONTIER_ROW_KEYS = {"depth", "frames", "fps", "ms_per_frame", "mean_occupancy",
                     "latency_ms"}  # scripts/bench_chain_depth_frontier.py:89-95
SOCKET_KEYS = {"surface", "backend", "minutes", "clients", "depth_per_client", "batch",
               "dtype", "frames_total", "mean_fps", "window_fps", "window_spread_pct",
               "windows", "engine_ceiling_fps", "fraction_of_engine_ceiling", "host_cores",
               "note"}  # scripts/soak_server_socket_r5.py:177-205
WINDOW_KEYS = {"t_s", "fps", "mean_occupancy", "latency_ms_p50",
               "latency_ms_p99"}  # scripts/soak_server_socket_r5.py:155-161
TRAIN_ROW_KEYS = {"batch", "remat", "dtype", "step_ms", "train_fps",
                  "final_loss"}  # scripts/bench_train.py:63-68 (+ accum when != 1)
REHEARSAL_KEYS = {"what", "result", "epochs", "train_items", "trained_rmse_m",
                  "trained_delta1", "train_time_best_row_bf16", "weights", "log", "rerun",
                  "val16_cpu_row"}  # scripts/train_rehearsal.py:210-242
HALO_KEYS = {"what", "t1_b1_us", "t1_source", "note",
             "rows"}  # scripts/analyze_spatial_halo.py:139-149
HALO_ROW_KEYS = {"space_shards", "halo_bytes_per_device", "collective_permutes",
                 "all_gathers", "compute_saved_us_vs_single", "breakeven_ici_GBs",
                 "by_shape"}  # scripts/analyze_spatial_halo.py:121-129
B1_KEYS = {"reps", "calls", "rows"}  # scripts/confirm_b1_opt.py:30,66-67
B1_ROW_KEYS = {"name", "us_med", "us_all"}  # scripts/confirm_b1_opt.py:66-67


def _run(module, argv, tmp_path, **kw):
    out = str(tmp_path / f"{module.__name__.rsplit('.', 1)[-1]}.json")
    res = module.main([*argv, "--device", "cpu", "--out", out], **kw)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    return res


def _one_forward_a_batch(res):
    """CPU runs launch no kernel: the counts are 0 over positive forwards."""
    assert res["launches"]["forwards"] > 0
    assert (res["launches"]["K1"], res["launches"]["K4"]) == (0, 0)


def test_soak_serving_main(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(soak_serving, "BATCH", 2)
    monkeypatch.setattr(soak_serving, "CHUNK", 2)
    res = _run(soak_serving, ["0.005", "--window-s", "0.2", "--impl", "fused"], tmp_path)
    assert set(res) == SOAK_KEYS | PORT_ADDED
    assert res["impl"] == "fused" and res["windows_fps"] and res["mean_fps"] > 0
    assert res["launches"]["forwards"] == res["frames_total"] // 2 + 1
    assert soak_serving.parse_args([]).impl == "opt"  # the script's forward by default


def test_soak_server_r4_main(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(soak_server_r4, "BATCH", 4)
    answers = []
    res = _run(soak_server_r4, ["0.005", "--window-s", "0.2"], tmp_path, answers=answers)
    assert set(res) == R4_KEYS | PORT_ADDED
    assert res["client_depth"] == 16 and res["windows_fps"] and res["frames"] > 0
    assert res["latency_ms"]["p50"] > 0 and 0 < res["occupancy"] <= 1
    assert answers[0].shape == (HW, HW, 1) and answers[0].dtype == np.float16
    _one_forward_a_batch(res)


def test_bench_serve_daemon_main(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(bench_serve_daemon, "CLIENTS", 2)
    monkeypatch.setattr(bench_serve_daemon, "BATCH", 4)
    res = _run(bench_serve_daemon, ["--frames-per-client", "3", "--socket-dir", str(tmp_path)],
               tmp_path)
    assert set(res) == DAEMON_KEYS | PORT_ADDED
    assert all(res[k] > 0 for k in DAEMON_KEYS if k.endswith("_fps"))


def test_bench_chain_serving_main_measures_the_b1_compute(tiny, tmp_path, monkeypatch):
    # the script's four cases at smaller windows and batches, and fewer b1 calls
    monkeypatch.setattr(bench_chain_serving, "CASES", [
        (tag, small, chain, frames) for (tag, _, chain, frames), small
        in zip(bench_chain_serving.CASES, (1, 4, 8, 8))])
    monkeypatch.setattr(bench_chain_serving, "B1_CALLS", 5)
    answers = []
    res = _run(bench_chain_serving, ["--frames", "16"], tmp_path, answers=answers)
    assert set(res) == CHAIN_KEYS | PORT_ADDED
    assert [c["case"] for c in res["cases"]] == [c[0] for c in bench_chain_serving.CASES]
    assert all(set(c) == CASE_KEYS and c["fps"] > 0 for c in res["cases"])
    # substitution: the script wrote a TPU figure (274.8); this run measured its own
    assert res["device_b1_compute_us"] > 0 and res["device_b1_compute_us"] != 274.8
    assert [t for t, _ in answers] == [c["case"] for c in res["cases"]]
    # chain counts a forward a frame: warm-ups and timed frames of both chain cases
    chain_frames = sum(2 * c["batch_size"] + 16 for c in res["cases"] if c["chain"])
    plain = [c for c in res["cases"] if not c["chain"]]
    assert res["launches"]["forwards"] >= chain_frames + len(plain)


def test_bench_chain_depth_frontier_main(tiny, tmp_path):
    res = _run(bench_chain_depth_frontier, ["--depths", "1,4", "--k", "4", "--max-frames",
                                            "64"], tmp_path)
    assert set(res) == FRONTIER_KEYS | PORT_ADDED | {"window_padding"}
    assert [r["depth"] for r in res["rows"]] == [1, 4]
    assert all(set(r) == FRONTIER_ROW_KEYS for r in res["rows"])
    assert res["knee"] == S.knee(res["rows"])
    # no padding: a depth-1 request is one forward
    assert res["launches"]["forwards"] == sum(2 * 4 + r["frames"] for r in res["rows"])
    assert res["rows"][0]["mean_occupancy"] == pytest.approx(1 / 4, abs=0.01)


def test_soak_server_socket_main_measures_its_engine_ceiling(tiny, tmp_path):
    res = _run(soak_server_socket_r5, ["0.005", "--window-s", "0.2", "--batch", "4",
                                       "--clients", "2", "--depth", "4",
                                       "--backend", "cuda", "--socket",
                                       str(tmp_path / "s.sock")], tmp_path)
    assert set(res) == SOCKET_KEYS | PORT_ADDED
    assert all(set(w) == WINDOW_KEYS for w in res["windows"])
    # substitution: the script divided by a TPU figure (19615.0); this run measured
    assert res["engine_ceiling_fps"] > 0 and res["engine_ceiling_fps"] != 19615.0
    assert res["fraction_of_engine_ceiling"] == round(res["mean_fps"]
                                                      / res["engine_ceiling_fps"], 3)
    _one_forward_a_batch(res)


def test_soak_server_socket_cpu_tiny_runs_the_tiny_widths_on_the_cpu():
    args = soak_server_socket_r5.parse_args(["--backend", "cpu-tiny"])
    assert args.device == "cpu"
    model, _, impl = soak_server_socket_r5.backend_model("cpu-tiny")
    assert model.config.decoder_channels == TINY_DEC and impl == "auto"
    assert soak_server_socket_r5.parse_args([]).device == "cuda"


def test_bench_train_main(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(bench_train, "WARMUP", 1)
    rows = _run(bench_train, ["--batches", "4", "--remat", "0,1", "--dtypes", "fp32,bf16",
                              "--accum", "1,2", "--steps", "1"], tmp_path)
    assert len(rows) == 8
    for row in rows:
        assert set(row) == TRAIN_ROW_KEYS | {"card"} | ({"accum"} if "accum" in row else set())
        assert row["step_ms"] > 0 and np.isfinite(row["final_loss"])
    assert sorted({(r["remat"], r["dtype"], r.get("accum", 1)) for r in rows}) == sorted(
        {(m, d, a) for m in (False, True) for d in ("fp32", "bf16") for a in (1, 2)})


def test_train_rehearsal_main(tmp_path, monkeypatch):
    arch = tmp_path / "tiny.json"
    arch.write_text(json.dumps({"encoder_channels": TINY_ENC, "decoder_channels": TINY_DEC}))
    monkeypatch.setattr(train_rehearsal, "ARCH", ["--arch-json", str(arch)])
    res = _run(train_rehearsal, ["--epochs", "1", "--train-items", "4", "--val-items", "2",
                                 "--batch-size", "2", "--weights-out", str(tmp_path / "w.npz"),
                                 "--log", str(tmp_path / "r.log")], tmp_path)
    assert set(res) == REHEARSAL_KEYS | {"card"}
    assert res["result"] == "PARITY OK (exit 0)" and os.path.isfile(tmp_path / "w.npz")
    assert set(res["val16_cpu_row"]) == {"what", "rmse_mm", "mae_mm", "delta1", "absrel"}
    # the default report is the port's own, never the JAX package's record
    assert train_rehearsal.parse_args([]).out.endswith("docs/parity_rehearsal_h100.json")


def test_confirm_b1_opt_main(tiny, tmp_path):
    res = _run(confirm_b1_opt, ["--reps", "1", "--calls", "1"], tmp_path)
    assert set(res) == B1_KEYS | PORT_ADDED
    names = [r["name"] for r in res["rows"]]
    assert names == [f"{d} b1 {i}" for d in ("fp32", "bf16") for i in ("xla", "opt", "fused")] \
        + ["bf16 b1 AOT(opt)", "bf16 b1 AOT(xla)", "bf16 b1 AOT(fused)",
           "bf16 b1 bundle(fused)"]
    assert all(set(r) == B1_ROW_KEYS and r["us_med"] > 0 for r in res["rows"])
    assert set(res["launches"]) == set(names)


def test_analyze_spatial_halo_main_measures_t1(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(analyze_spatial_halo, "SHARDS", (2, 4))
    res = _run(analyze_spatial_halo, [], tmp_path)
    assert set(res) == HALO_KEYS | {"card"}
    assert [r["space_shards"] for r in res["rows"]] == [2, 4]
    assert all(set(r) == HALO_ROW_KEYS | {"sent_bytes_by_rank"} for r in res["rows"])
    # substitution: the script's t1 was a TPU figure (274.8)
    assert res["t1_b1_us"] > 0 and res["t1_b1_us"] != 274.8


def test_make_roofline_from_a_profile_json(tmp_path):
    from fastdepth_tpu_torch.cli import profile

    prof = str(tmp_path / "p.json")
    profile.main(["--mode", "prefix", "--batch", "1", "--image-size", "224", "--calls", "1",
                  "--device", "cpu", "--json", prof])
    lines = make_roofline.main(["--profile", prof, "--out", str(tmp_path / "r.md")])
    rows = [ln for ln in lines if ln.startswith("| ") and not ln.startswith("| layer")]
    assert len(rows) == 20 and rows[0].startswith("| enc0 stem 3x3s2 3->16 @112")
    assert rows[-1].startswith("| dec6 head 1x1 16->1 @224")
    assert (tmp_path / "r.md").read_text().splitlines() == lines


def test_make_frontier_plot_draws_each_model_and_dtype(tmp_path):
    from PIL import Image

    data = {"rows": [{"model": m, "dtype": d, "fps": f, "batch": 8, "impl": "fused"}
                     for m, d, f in (("mobilenet-nnconv5", "float32", 1000.0),
                                     ("mobilenet-nnconv5", "bfloat16", 3000.0),
                                     ("mobilenet-nnconv5", "bfloat16", 2000.0))]}
    src = tmp_path / "f.json"
    src.write_text(json.dumps(data))
    assert make_frontier_plot.best_rows(data)[("mobilenet-nnconv5", "bfloat16")]["fps"] == 3000
    out = make_frontier_plot.main(["--frontier", str(src), "--out", str(tmp_path / "f.png")])
    img = np.asarray(Image.open(out))
    assert img.shape[1] == make_frontier_plot.WIDTH and img.dtype == np.uint8
    # the bf16 bar is 3x the f32 one, each in its series' colour
    lengths = []
    for _, pos in make_frontier_plot.SERIES:
        from fastdepth_tpu_torch.viz import viridis

        colour = (viridis(np.array([pos]))[0] * 255).astype(np.uint8)
        lengths.append(int(np.all(img == colour, axis=-1).sum(axis=1).max()))
    assert lengths[0] == pytest.approx(3 * lengths[1], abs=2)


# --- (d) the socket soak's null backend, both packages ---------------------------


def test_socket_soak_null_backend_of_both_packages(tmp_path):
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    procs = [
        subprocess.Popen([sys.executable, os.path.join("scripts", "soak_server_socket_r5.py"),
                          "0.05", "--backend", "null", "--out", str(jax_out)], cwd=REPO,
                         env=child_env(PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, "-m",
                          "fastdepth_tpu_torch.scripts.soak_server_socket_r5", "0.05",
                          "--backend", "null", "--device", "cpu", "--batch", "32", "--socket",
                          str(tmp_path / "s.sock"), "--out", str(port_out)], cwd=REPO,
                         env=child_env(PYTHONPATH=REPO), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, out[-2000:] + err[-3000:]
    jax_res, port_res = (json.loads(p.read_text()) for p in (jax_out, port_out))
    assert set(port_res) == set(jax_res) | PORT_ADDED
    assert jax_res["mean_fps"] > 0 and port_res["mean_fps"] > 0
    assert port_res["backend"] == jax_res["backend"] == "null"
    assert port_res["launches"]["K1"] == port_res["launches"]["K4"] == 0


# --- (e) the structured tree -------------------------------------------------------


def test_structured_tree_is_the_scripts_byte_for_byte(tmp_path):
    ns = _load_script("scripts/train_rehearsal.py", {"_depth_field", "make_structured_tree"})
    for split, seed in (("train", 7), ("val", 1007)):
        ns["make_structured_tree"](str(tmp_path / "jax"), split, 4, seed)
        assert train_rehearsal.make_structured_tree(str(tmp_path / "port"), split, 4,
                                                    seed) == "h5"
        d = os.path.join("nyudepthv2", split, "scene_0")
        names = sorted(os.listdir(tmp_path / "jax" / d))
        assert names == sorted(os.listdir(tmp_path / "port" / d)) and len(names) == 4
        for n in names:
            assert (tmp_path / "jax" / d / n).read_bytes() == (tmp_path / "port" / d / n
                                                               ).read_bytes(), (split, n)


def test_npz_tree_reads_as_the_h5_tree(tmp_path):
    from fastdepth_tpu_torch.data.nyu import h5_loader

    for fmt in ("h5", "npz"):
        _trees.make_structured_tree(str(tmp_path / fmt), "val", 2, 1007, fmt=fmt)
    d = os.path.join("nyudepthv2", "val", "scene_0", "00000.h5")
    for a, b in zip(h5_loader(str(tmp_path / "h5" / d)), _trees.npz_loader(
            str(tmp_path / "npz" / d))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- (f) the host pipeline, both packages --------------------------------------------


def test_host_pipeline_main_of_both_packages_gives_the_same_keys(tmp_path, monkeypatch):
    ns = _load_script("scripts/bench_host_pipeline.py", {"main"})
    jax_out = tmp_path / "jax.json"
    ns["main"](argparse.Namespace(items=16, batch_size=4, workers="1,2", modes="thread",
                                  out=str(jax_out)))
    # the card's b128 bf16 train step stands in for the script's TPU rate; not on the CPU
    monkeypatch.setattr(bench_host_pipeline, "device_train_fps", lambda device: 100.0)
    port = _run(bench_host_pipeline, ["--items", "16", "--batch-size", "4", "--workers", "1,2",
                                      "--modes", "thread", "--calls", "8"], tmp_path)
    want = json.loads(jax_out.read_text())
    assert set(port) == set(want) | {"card", "reader"}
    for key in ("per_item_ms", "device_augment"):
        assert set(port[key]) == set(want[key]), key
    assert set(port["device_augment"]["per_item_ms"]) == set(
        want["device_augment"]["per_item_ms"])
    # substitution: the script projected against a TPU train rate (4348.0)
    assert set(port["feed_projection"]) == set(want["feed_projection"]) | {
        "device_train_fps_source"}
    assert port["feed_projection"]["device_train_fps"] == 100.0
    assert [(r["mode"], r["workers"], r["augment"]) for r in port["loader"]] == [
        (r["mode"], r["workers"], r["augment"]) for r in want["loader"]]


# --- the halo plan against the JAX analysis ------------------------------------------

# where the two plans part: the port shards a level only where its rows split
# into S shards of at least 2 (parallel/spatial.py) and gathers the first level
# that does not; GSPMD shards further and gathers elsewhere.  The levels by
# width (= rows) whose exchanges differ:
PLANS_DIFFER = {2: set(), 4: {14, 28}, 8: {14, 28, 56}}


def _by_level(rows):
    """{level width: Counter of (kind, shape)} with the port's ``halo``
    named as the script's ``collective-permute``."""
    import collections

    out = collections.defaultdict(collections.Counter)
    for r in rows:
        out[r["shape"][2]][(r["kind"].replace("halo", "collective-permute"),
                            tuple(r["shape"]))] += r["count"]
    return out


@pytest.fixture(scope="module")
def flagship_plans():
    model, params, x = analyze_spatial_halo.flagship_input()
    return {s: analyze_spatial_halo.summarize(analyze_spatial_halo.plan(model, params, s, x))
            for s in (2, 4, 8)}


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_halo_plan_matches_the_jax_analysis_where_both_shard(flagship_plans, n_shards):
    jax_row = next(r for r in _docs("spatial_halo_r3.json")["rows"]
                   if r["space_shards"] == n_shards)
    port, want = _by_level(flagship_plans[n_shards]["by_shape"]), _by_level(jax_row["by_shape"])
    differ = {w for w in set(port) | set(want) if port.get(w) != want.get(w)}
    assert differ == PLANS_DIFFER[n_shards]


# --- (g) the device-augment modules ------------------------------------------

GATHER_KEYS = {"batch", "calls", "rows"}  # scripts/probe_r5_device_gathers.py:87
LUT_KEYS = {"batch", "calls", "lookups_per_call", "rows",
            "errors"}  # scripts/probe_r5_lut_alternatives.py:143-144
AUG_TRAIN_KEYS = {"batch", "calls", "dtype", "rows", "aug_cost_pct_dot",
                  "aug_cost_pct_gather"}  # scripts/bench_train_device_aug_r5.py:74,144
AUG_TRAIN_PORT_KEYS = {"repeats", "runs", "aug_cost_pct_runs"}  # the port's rounds
# the scripts' rows (scripts/probe_r5_device_gathers.py:67-85,117;
# probe_r5_lut_alternatives.py:133-141; bench_train_device_aug_r5.py:96,114,139)
# and the port's gather forms beside the dot forms
GATHER_ROWS = ["rgb_u8_gather", "rgb_u32_gather", "depth_f32_gather", "jitter_slot_2d",
               "jitter_slot_2d_gather", "small_lut_256", "unit_lut_take", "pil_l_compute",
               "full_augment", "full_augment_gather"]
LUT_ROWS = ["take_256", "onehot_dot", "select_sum", "select_sum_bt", "onehot_dot_bt",
            "sat_two_dots", "block_gather_16"]
AUG_TRAIN_ROWS = {"plain_train_fps", "device_augment_dot_train_fps",
                  "device_augment_gather_train_fps"}


def _script_gather_inputs(b):
    """scripts/probe_r5_device_gathers.py:52-62, 102-104, its draws as it
    makes them."""
    from fastdepth_tpu.data import transforms as JT

    n, hw = 224 * 224, 480 * 640
    rng = np.random.RandomState(0)
    out = [rng.randint(0, 256, (b, hw, 3)),
           rng.randint(0, 2**31, (b, hw), dtype=np.int64).astype(np.uint32),
           rng.rand(b, hw), rng.randint(0, hw, (b, n)), rng.randint(0, 256, (b, n, 3)),
           np.stack([JT.blend_grid(f) for f in rng.uniform(0.6, 1.4, b)]),
           rng.randint(0, 256, (b, 256))]
    out += [np.where(rng.rand(b, n) < 0.02, -1, rng.randint(0, hw, (b, n))),
            rng.rand(b) * 0.5 + 1.0]
    return out


def test_the_gather_probes_inputs_are_its_scripts():
    x = probe_r5_device_gathers.make_inputs(2)
    names = ["rgb_u8", "rgb_u32", "depth", "idx", "vals", "tab2d", "tab1d", "flat", "scale"]
    for name, want in zip(names, _script_gather_inputs(2)):
        np.testing.assert_array_equal(x[name], want.astype(x[name].dtype), err_msg=name)
    assert x["tables"].shape == (2, 3, 256, 256) and (x["tables"][:, 1] == x["tab2d"]).all()
    assert (x["kinds3"] == [1, 2, 3]).all() and (x["kinds"] == 3).all()


def _np(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def gather_stages():
    """The gather probe's inputs at b1 and its stages on the CPU."""
    x = probe_r5_device_gathers.make_inputs(1)
    return x, probe_r5_device_gathers.stages(x, "cpu")


@pytest.mark.parametrize("tag", GATHER_ROWS)
def test_gather_probe_stage_is_the_jax_expression_bit_for_bit(gather_stages, tag):
    """Each stage on the CPU against the JAX expression its script times
    (scripts/probe_r5_device_gathers.py:67-85, 107), on the same seeded
    inputs, exactly; the port's gather rows against JAX's gather forms."""
    from fastdepth_tpu.data import device_aug as JD

    x, st = gather_stages
    j = {k: jnp.asarray(v) for k, v in x.items()}
    b = x["rgb_u8"].shape[0]
    aug = (j["rgb_u8"].reshape(b, 480, 640, 3), j["depth"].reshape(b, 480, 640), j["flat"],
           j["scale"], j["tables"], j["kinds3"])
    vals, tab2d, kinds = j["vals"], j["tab2d"], j["kinds"]
    # (the script's function, its arguments): arguments, not constants, so
    # that XLA cannot fold the depth's divisor into a reciprocal
    fn_want, args_want = {
        "rgb_u8_gather": (lambda a, i: jnp.take_along_axis(a, i[..., None], axis=1),
                          (j["rgb_u8"], j["idx"])),
        "rgb_u32_gather": (lambda a, i: jnp.take_along_axis(a, i, axis=1),
                           (j["rgb_u32"], j["idx"])),
        "depth_f32_gather": (lambda a, i: jnp.take_along_axis(a, i, axis=1),
                             (j["depth"], j["idx"])),
        "jitter_slot_2d": (lambda v, t, k: JD._jitter_slot(v, t, k), (vals, tab2d, kinds)),
        "jitter_slot_2d_gather": (lambda v, t, k: JD._jitter_slot(v, t, k, lut_impl="gather"),
                                  (vals, tab2d, kinds)),
        "small_lut_256": (lambda v, t: jnp.take_along_axis(
            t, v.astype(jnp.int32).reshape(b, -1), axis=1).reshape(v.shape),
            (vals, j["tab1d"])),
        "unit_lut_take": (lambda v: jnp.take(JD._unit_lut(), v.astype(jnp.int32)), (vals,)),
        "pil_l_compute": (lambda v: (JD._pil_l(v), jnp.sum(JD._pil_l(v), axis=-1)), (vals,)),
        "full_augment": (lambda *a: JD.apply_train_augment(*a), aug),
        "full_augment_gather": (lambda *a: JD.apply_train_augment(*a, lut_impl="gather"), aug),
    }[tag]
    fn, args = st[tag]
    got = _np(fn(*args))
    wanted = _np(jax.jit(fn_want)(*args_want))
    if tag == "rgb_u32_gather":
        got = [g.view(np.uint32) for g in got]
    assert len(got) == len(wanted)
    for g, w in zip(got, wanted):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_the_lut_probes_inputs_are_its_scripts():
    """scripts/probe_r5_lut_alternatives.py:57-70, its draws as it makes
    them."""
    b, n, npx, hw = 2, 224 * 224 * 3, 224 * 224, 480 * 640
    rng = np.random.RandomState(0)
    want = [rng.randint(0, 256, (b, n)), rng.rand(256), rng.rand(b, 256),
            rng.rand(b, 256, 256), rng.randint(0, 256, (b, npx)),
            rng.randint(0, 2**31, (b, hw), dtype=np.int64).astype(np.uint32),
            rng.randint(0, hw - 32, (b, npx // 16)), rng.randint(0, 16, (b, npx))]
    x = probe_r5_lut_alternatives.make_inputs(b)
    for name, w in zip(["v", "lut", "lut_b", "grid_b", "lpx", "raw32", "starts", "offs"], want):
        np.testing.assert_array_equal(x[name], w.astype(x[name].dtype), err_msg=name)


def _jax_lut_stages(j, b):
    """``{tag: (fn, args)}``: scripts/probe_r5_lut_alternatives.py:73-130,
    the script's functions (the tables closed over, as there) and its
    inputs as jnp arrays ``j``."""
    n, npx = 224 * 224 * 3, 224 * 224
    lut, lut_b, grid_b = j["lut"], j["lut_b"], j["grid_b"]

    def take_256(v):
        return jnp.take(lut, v.astype(jnp.int32))

    def onehot_dot(v):
        oh = (v[..., None] == jnp.arange(256, dtype=jnp.int32)).astype(jnp.bfloat16)
        return oh @ lut.astype(jnp.bfloat16)

    def select_sum(v):
        vi = v.astype(jnp.int32)
        acc = jnp.zeros(v.shape, jnp.float32)
        for k in range(256):
            acc = acc + lut[k] * (vi == k)
        return acc

    def select_sum_bt(v):
        vi = v.astype(jnp.int32)
        acc = jnp.zeros(v.shape, jnp.float32)
        for k in range(256):
            acc = acc + lut_b[:, k, None] * (vi == k)
        return acc

    def onehot_dot_bt(v):
        oh = (v[..., None] == jnp.arange(256, dtype=jnp.int32)).astype(jnp.bfloat16)
        return jnp.einsum("bpk,bk->bp", oh, lut_b.astype(jnp.bfloat16))

    def sat_two_dots(lpx, v):
        ohl = (lpx[..., None] == jnp.arange(256, dtype=jnp.int32)).astype(jnp.bfloat16)
        rows = jnp.einsum("bpk,bkv->bpv", ohl, grid_b.astype(jnp.bfloat16))
        vv = v.reshape(b, npx, 3).astype(jnp.int32)
        ohv = (vv[..., None] == jnp.arange(256, dtype=jnp.int32)).astype(jnp.bfloat16)
        return jnp.einsum("bpv,bpcv->bpc", rows, ohv)

    def block_gather_16(raw32, starts, offs):
        nblk = npx // 16
        sl = jax.vmap(lambda a, s: jax.vmap(
            lambda st: jax.lax.dynamic_slice(a, (st,), (32,)))(s))(raw32, starts)
        blk16 = jnp.broadcast_to(sl.reshape(b, nblk, 1, 32), (b, nblk, 16, 32)).reshape(
            b, npx, 32)
        out = jnp.zeros((b, npx), jnp.uint32)
        for jj in range(16):
            out = out + jnp.where(offs == jj, blk16[..., jj], jnp.uint32(0))
        return out

    assert j["v"].shape == (b, n)
    v = j["v"]
    return {"take_256": (take_256, (v,)), "onehot_dot": (onehot_dot, (v,)),
            "select_sum": (select_sum, (v,)), "select_sum_bt": (select_sum_bt, (v,)),
            "onehot_dot_bt": (onehot_dot_bt, (v,)), "sat_two_dots": (sat_two_dots, (j["lpx"], v)),
            "block_gather_16": (block_gather_16, (j["raw32"], j["starts"], j["offs"]))}


@pytest.fixture(scope="module")
def lut_stages():
    """The lut probe's inputs at b1 and its stages on the CPU."""
    x = probe_r5_lut_alternatives.make_inputs(1)
    return x, probe_r5_lut_alternatives.stages(x, "cpu")


@pytest.mark.parametrize("tag", LUT_ROWS)
def test_lut_probe_stage_is_the_jax_expression_bit_for_bit(lut_stages, tag):
    """Each formulation on the CPU against the script's JAX function on the
    same seeded inputs: the f32 select-sums exactly, the bf16 one-hot
    products exactly (one nonzero term a sum), the 32-bit slices bit for
    bit."""
    x, st = lut_stages
    j = {k: jnp.asarray(v) for k, v in x.items()}
    fn_want, args_want = _jax_lut_stages(j, 1)[tag]
    want = np.asarray(jax.jit(fn_want)(*args_want))
    fn, args = st[tag]
    got = fn(*args)
    got = (got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy())
    if tag == "block_gather_16":
        got = got.view(np.uint32)
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_probe_r5_device_gathers_main(tmp_path, monkeypatch):
    monkeypatch.setattr(probe_r5_device_gathers, "WARMUP", 1)
    res = _run(probe_r5_device_gathers, ["--batch", "1", "--calls", "2"], tmp_path)
    assert set(res) == GATHER_KEYS | {"card"} and res["card"] == "cpu"
    assert list(res["rows"]) == GATHER_ROWS and all(v > 0 for v in res["rows"].values())
    assert (res["batch"], res["calls"]) == (1, 2)
    assert probe_r5_device_gathers.parse_args([]).batch == 128
    assert probe_r5_device_gathers.parse_args([]).device == "cuda"


def test_probe_r5_lut_alternatives_main(tmp_path, monkeypatch):
    monkeypatch.setattr(probe_r5_device_gathers, "WARMUP", 1)
    res = _run(probe_r5_lut_alternatives, ["--batch", "1", "--calls", "2"], tmp_path)
    assert set(res) == LUT_KEYS | {"card"} and res["errors"] == {}
    assert list(res["rows"]) == LUT_ROWS and all(v > 0 for v in res["rows"].values())
    assert res["lookups_per_call"] == 224 * 224 * 3
    assert probe_r5_lut_alternatives.parse_args([]).batch == 32


def test_the_lut_probe_records_an_out_of_memory_row(tmp_path, monkeypatch):
    """An OOM is a datum: it goes into ``errors`` and the other rows run;
    any other error propagates."""
    real = probe_r5_lut_alternatives.stages

    def stages(x, device, exc=torch.OutOfMemoryError):
        st = real(x, device)

        def oom(*a):
            raise exc("CUDA out of memory. Tried to allocate 9.9 GiB")
        st["onehot_dot"] = (oom, ())
        return st

    monkeypatch.setattr(probe_r5_device_gathers, "WARMUP", 0)
    monkeypatch.setattr(probe_r5_lut_alternatives, "stages", stages)
    res = _run(probe_r5_lut_alternatives, ["--batch", "1", "--calls", "1"], tmp_path)
    assert list(res["errors"]) == ["onehot_dot"]
    assert res["errors"]["onehot_dot"].startswith("OutOfMemoryError: CUDA out of memory")
    assert set(res["rows"]) == set(LUT_ROWS) - {"onehot_dot"}
    monkeypatch.setattr(probe_r5_lut_alternatives, "stages",
                        lambda x, d: stages(x, d, exc=RuntimeError))
    with pytest.raises(RuntimeError):
        _run(probe_r5_lut_alternatives, ["--batch", "1", "--calls", "1"], tmp_path)


def test_the_train_benchs_batches_are_its_scripts():
    """scripts/bench_train_device_aug_r5.py:72-111, its draws as it makes
    them."""
    from fastdepth_tpu.data import transforms as JT

    b, n_out = 2, 224 * 224
    rng = np.random.RandomState(0)
    want = [rng.rand(b, 224, 224, 3), rng.rand(b, 224, 224, 1) * 5 + 0.5]
    tables = np.stack([np.stack([JT.blend_grid(f) for f in rng.uniform(0.6, 1.4, 3)])
                       for _ in range(b)])
    want += [rng.randint(0, 256, (b, 480, 640, 3)), rng.rand(b, 480, 640) * 5 + 0.5,
             np.where(rng.rand(b, n_out) < 0.02, -1, rng.randint(0, 480 * 640, (b, n_out))),
             rng.rand(b) * 0.5 + 1.0, tables, np.tile(np.array([1, 2, 3]), (b, 1))]
    plain, raw = bench_train_device_aug_r5.make_batches(b)
    for got, w in zip(plain + raw, want):
        np.testing.assert_array_equal(got, w.astype(got.dtype))


def test_bench_train_device_aug_main(tiny, tmp_path, monkeypatch):
    """Two rounds, the order reversed in the second: each row's median of
    its rounds, each cost from the medians and round by round."""
    monkeypatch.setattr(bench_train_device_aug_r5, "WARMUP", 1)
    res = _run(bench_train_device_aug_r5, ["--batch", "2", "--calls", "1", "--repeats", "2"],
               tmp_path)
    assert set(res) == AUG_TRAIN_KEYS | AUG_TRAIN_PORT_KEYS | {"card"} and res["dtype"] == "bf16"
    assert set(res["rows"]) == AUG_TRAIN_ROWS and all(v > 0 for v in res["rows"].values())
    assert res["repeats"] == 2 and set(res["runs"]) == AUG_TRAIN_ROWS
    runs, plain = res["runs"], res["runs"]["plain_train_fps"]
    for tag, fps in runs.items():
        assert len(fps) == 2 and res["rows"][tag] == (fps[0] + fps[1]) / 2
    for form in ("dot", "gather"):
        aug = f"device_augment_{form}_train_fps"
        assert res[f"aug_cost_pct_{form}"] == round(
            100.0 * (1 - res["rows"][aug] / res["rows"]["plain_train_fps"]), 2)
        assert res["aug_cost_pct_runs"][form] == [
            round(100.0 * (1 - a / p), 2) for a, p in zip(runs[aug], plain)]
    assert bench_train_device_aug_r5.parse_args([]).repeats == 5


def test_the_benchs_dot_and_gather_steps_are_the_same_step():
    """The bench's dot step (``augment_dot``, then the plain step) and its
    gather step (the port's ``make_train_step(device_augment=True)``),
    one bf16 step each from the same tiny tree over the bench's raw
    batch: the same loss and parameters bit for bit."""
    import copy

    from fastdepth_tpu_torch.config import TrainConfig
    from fastdepth_tpu_torch.train import sgd_init

    model, params = _tiny_flagship()
    steps = bench_train_device_aug_r5.make_steps(model, TrainConfig(lr=0.01))
    assert list(steps) == ["plain_train_fps", "device_augment_dot_train_fps",
                           "device_augment_gather_train_fps"]
    _, raw = bench_train_device_aug_r5.make_batches(2)
    raw = [torch.from_numpy(a) for a in raw]
    s_d, l_d = steps["device_augment_dot_train_fps"](sgd_init(copy.deepcopy(params)), *raw, 0.01)
    s_g, l_g = steps["device_augment_gather_train_fps"](sgd_init(copy.deepcopy(params)), *raw,
                                                        0.01)
    assert float(l_d) == float(l_g)
    for (k, a), b in zip(s_d.params.state_dict().items(), s_g.params.state_dict().values()):
        assert torch.equal(a, b), k
