"""The port stands alone: no module of ``fastdepth_tpu_torch`` and not
``chip_smoke.py`` imports, opens or executes anything of the JAX package
``fastdepth_tpu`` or of ``jax``.  Checked twice: statically (``ast``) over
every source, and by importing and running the port with both packages
blocked from import."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import child_env  # torch's CPU threads: a share per xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "fastdepth_tpu_torch", "**", "*.py"), recursive=True))
SOURCES.append("chip_smoke.py")
FORBIDDEN = ("fastdepth_tpu", "jax", "jaxlib")
# calls that open, run or import what a string names
LOADERS = {"open", "exec", "execfile", "run_path", "run_module", "spec_from_file_location",
           "import_module", "__import__", "load_source", "Popen", "run", "call", "check_call",
           "check_output", "system", "CDLL", "LoadLibrary"}
# the blocked run: the JAX package and JAX import as None, so any import raises
BLOCK = ('import sys\nfor _m in ("fastdepth_tpu", "jax", "jaxlib"):\n'
         '    sys.modules[_m] = None\n')


def _forbidden_module(name):
    return name is not None and any(name == m or name.startswith(m + ".") for m in FORBIDDEN)


def _strings(node):
    return [n.value for n in ast.walk(node) if isinstance(n, ast.Constant)
            and isinstance(n.value, str)]


def _names_jax_package(s):
    """A string that names the JAX package as a module or a path into it."""
    s = s.replace("\\", "/")
    return (_forbidden_module(s) or s.startswith("fastdepth_tpu/")
            or "/fastdepth_tpu/" in s or s == "fastdepth_tpu")


def violations(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [f"{node.lineno}: import {a.name}" for a in node.names
                    if _forbidden_module(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden_module(node.module):
                bad.append(f"{node.lineno}: from {node.module} import ...")
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name in LOADERS:
                args = [*node.args, *(k.value for k in node.keywords)]
                bad += [f"{node.lineno}: {name}({s!r})" for a in args for s in _strings(a)
                        if _names_jax_package(s)]
    return bad


@pytest.mark.parametrize("path", SOURCES)
def test_no_source_imports_or_loads_the_jax_package(path):
    assert violations(path) == []


def test_the_walk_covers_the_train_slice():
    for path in ("fastdepth_tpu_torch/train/__init__.py", "fastdepth_tpu_torch/train/loss.py",
                 "fastdepth_tpu_torch/train/trainer.py", "fastdepth_tpu_torch/cli/train.py"):
        assert path in SOURCES, path


def test_the_guard_catches_what_it_forbids(tmp_path, monkeypatch):
    src = ("import jax.numpy as jnp\nfrom fastdepth_tpu.config import ModelConfig\n"
           "import fastdepth_tpu_torch\nfrom . import sibling\n"
           "open('fastdepth_tpu/engine/roofline.py')\n"
           "importlib.import_module('fastdepth_tpu.data')\n"
           "spec_from_file_location('m', os.path.join(root, 'fastdepth_tpu/viz.py'))\n"
           "print('fastdepth_tpu/ops/pallas/fused_decoder.py:50')\n")
    (tmp_path / "m.py").write_text(src)
    monkeypatch.setattr(sys.modules[__name__], "REPO", str(tmp_path))
    assert [v.split(":")[0] for v in violations("m.py")] == ["1", "2", "5", "6", "7"]


def _run(code, cwd=REPO, timeout=300):
    env = child_env(PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCK + code], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_the_walk_covers_the_serve_slice():
    for path in ("fastdepth_tpu_torch/engine/server.py", "fastdepth_tpu_torch/cli/serve.py"):
        assert path in SOURCES, path


def test_the_walk_covers_the_input_slice():
    for path in ("fastdepth_tpu_torch/data/device_aug.py", "fastdepth_tpu_torch/engine/staging.py",
                 "fastdepth_tpu_torch/cli/benchmark.py"):
        assert path in SOURCES, path


def test_the_walk_covers_the_parallel_slice():
    for path in ("fastdepth_tpu_torch/parallel/__init__.py",
                 "fastdepth_tpu_torch/parallel/distributed.py",
                 "fastdepth_tpu_torch/parallel/mesh.py", "fastdepth_tpu_torch/parallel/dryrun.py"):
        assert path in SOURCES, path


def test_the_walk_covers_the_root_entry_points_slice():
    for path in ("fastdepth_tpu_torch/bench.py", "fastdepth_tpu_torch/graft_entry.py",
                 "fastdepth_tpu_torch/parallel/halo_check.py"):
        assert path in SOURCES, path


def test_the_walk_covers_the_scripts_slice():
    for name in ("_serving", "_trees", "soak_serving", "soak_server_r4", "bench_serve_daemon",
                 "bench_chain_serving", "bench_chain_depth_frontier", "soak_server_socket_r5",
                 "bench_train", "bench_host_pipeline", "train_rehearsal", "make_roofline",
                 "make_frontier_plot", "analyze_spatial_halo", "confirm_b1_opt",
                 "probe_r5_device_gathers", "probe_r5_lut_alternatives",
                 "bench_train_device_aug_r5"):
        assert f"fastdepth_tpu_torch/scripts/{name}.py" in SOURCES, name


@pytest.mark.parametrize("path", [p for p in SOURCES if p.startswith("fastdepth_tpu_torch/")])
def test_no_port_module_imports_the_root_scripts(path):
    """The port's modules keep their own copies of what they take from the
    root ``scripts/`` (``make_structured_tree``, ...): no module of the
    port imports that directory."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [n.lineno for n in ast.walk(tree)
           if (isinstance(n, ast.Import) and any(a.name.split(".")[0] == "scripts"
                                                 for a in n.names))
           or (isinstance(n, ast.ImportFrom) and n.level == 0
               and (n.module or "").split(".")[0] == "scripts")]
    assert bad == []


def test_bench_and_graft_entry_run_on_the_cpu_with_the_jax_package_blocked():
    """The benchmark line at tiny widths on a 32^2 image and the graft
    entry's forward, on the CPU, with both packages blocked."""
    out = _run(TINY + """
import contextlib, io, json
from fastdepth_tpu_torch import bench, graft_entry
bench.CONFIG, bench.IMAGE_SIZE, bench.CALLS, bench.TRAIN_STEPS = CFG, 32, 2, 1
text = io.StringIO()
with contextlib.redirect_stdout(text):
    assert bench.main(["--device", "cpu"]) == 0
line = json.loads(text.getvalue().splitlines()[-1])
assert line["value"] > 0 and line["detail"]["train_bf16_b128_fps"] > 0, line
assert graft_entry.main(["--device", "cpu"]) == 0
""")
    assert out.strip().endswith("entry ok: (8, 224, 224, 1) float32")


def test_benchmark_cli_help_runs_with_the_jax_package_blocked():
    out = _run("""
import contextlib, io
from fastdepth_tpu_torch.cli import benchmark
from fastdepth_tpu_torch.data import device_aug
text = io.StringIO()
with contextlib.redirect_stdout(text):
    try:
        benchmark.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
assert "--device-augment" in text.getvalue() and "--device-preprocess" in text.getvalue()
print("ok")
""")
    assert out.strip().endswith("ok")


def test_every_module_imports_with_the_jax_package_blocked():
    code = """
import importlib, pkgutil
import fastdepth_tpu_torch as fd
names = ["fastdepth_tpu_torch"]
for sub in ("cli", "engine", "models", "checkpoint", "data", "ops", "ops.cuda", "parallel",
            "scripts", "train"):
    pkg = importlib.import_module("fastdepth_tpu_torch." + sub)
    names.append(pkg.__name__)
    names += [pkg.__name__ + "." + m.name for m in pkgutil.iter_modules(pkg.__path__)]
for n in ("config", "metrics", "viz", "bench", "graft_entry"):
    names.append("fastdepth_tpu_torch." + n)
for n in names:
    importlib.import_module(n)
for n in fd._EXPORTS:
    getattr(fd, n)
print(len(names))
"""
    assert int(_run(code).strip()) >= 40


TINY = ("from fastdepth_tpu_torch import ModelConfig\n"
        "CFG = ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, "
        "24), decoder_channels=(18, 14, 10, 6, 4))\n")


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    """A tiny random-weight npz checkpoint written by the port alone."""
    path = str(tmp_path_factory.mktemp("iso") / "tiny.npz")
    _run(TINY + f"""
import torch
from fastdepth_tpu_torch.checkpoint import params_to_jax, save_checkpoint
from fastdepth_tpu_torch.models import build
model = build(CFG)
save_checkpoint({path!r}, params_to_jax(model.init(torch.Generator().manual_seed(0)).state_dict()),
                CFG, epoch=3)
""")
    return path


def test_evaluate_cli_runs_on_the_cpu_with_the_jax_package_blocked(tiny_npz, tmp_path):
    root = tmp_path / "nyudepthv2" / "val" / "scene"
    root.mkdir(parents=True)
    code = f"""
import h5py, numpy as np
rng = np.random.RandomState(0)
for i in range(3):
    with h5py.File({str(root)!r} + f"/{{i:05d}}.h5", "w") as f:
        f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
        f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
from fastdepth_tpu_torch.cli import evaluate
avg = evaluate.main(["--evaluate", {tiny_npz!r}, "--data-root", {str(tmp_path)!r},
                     "--batch-size", "2", "--device", "cpu", "--no-images", "--workers", "1"])
print("rmse", avg.rmse)
"""
    out = _run(code)
    assert "rmse" in out and "RMSE=" in out


def test_deploy_cli_runs_on_the_cpu_with_the_jax_package_blocked(tiny_npz, tmp_path):
    rgb = str(tmp_path / "rgb.npy")
    np.save(rgb, np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    pred, loaded, prefix = (str(tmp_path / n) for n in ("pred.npy", "loaded.npy", "bundle"))
    _run(f"""
from fastdepth_tpu_torch.cli import deploy
deploy.main(["--model", {tiny_npz!r}, "--input-fp", {rgb!r}, "--output-fp", {pred!r},
             "--warmup", "1", "--run", "2", "--device", "cpu", "--save-bundle", {prefix!r}])
deploy.main(["--load-bundle", {prefix!r}, "--input-fp", {rgb!r}, "--output-fp", {loaded!r},
             "--warmup", "1", "--run", "2", "--device", "cpu"])
""")
    out = np.load(pred)
    assert out.shape == (1, 1, 64, 64) and np.isfinite(out).all()
    np.testing.assert_array_equal(np.load(loaded), out)  # the bundle, written and run alone


def test_train_cli_runs_on_the_cpu_with_the_jax_package_blocked(tmp_path):
    """One tiny epoch of cli.train, --device cpu, on an h5 tree: the four
    outputs, and a checkpoint that resumes."""
    root = tmp_path / "nyudepthv2"
    out = tmp_path / "out"
    code = TINY + f"""
import dataclasses, json, os, h5py, numpy as np
rng = np.random.RandomState(0)
for split, n in (("train", 4), ("val", 2)):
    d = os.path.join({str(root)!r}, split, "scene")
    os.makedirs(d)
    for i in range(2, 2 + n):
        with h5py.File(os.path.join(d, f"{{i:05d}}.h5"), "w") as f:
            f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
arch = os.path.join({str(tmp_path)!r}, "tiny.json")
with open(arch, "w") as f:
    json.dump(dataclasses.asdict(CFG), f)
from fastdepth_tpu_torch.cli import train
common = ["--data-root", {str(tmp_path)!r}, "--batch-size", "2", "--eval-batch-size", "2",
          "--workers", "1", "--print-freq", "0", "--output-dir", {str(out)!r}, "--device", "cpu"]
train.main(common + ["--arch-json", arch, "--epochs", "1"])
best = train.main(common + ["--epochs", "2", "--resume", os.path.join({str(out)!r},
                                                                       "checkpoint.npz")])
print("rmse", best.rmse)
"""
    log = _run(code)
    assert "=> resumed at epoch 1" in log and "rmse" in log
    for name in ("train.csv", "test.csv", "model_best.npz", "checkpoint.npz"):
        assert (out / name).exists(), name


def test_profile_and_probe_clis_run_on_the_cpu_with_the_jax_package_blocked(tmp_path):
    out = _run(TINY + f"""
from fastdepth_tpu_torch.cli import probe, profile
from fastdepth_tpu_torch.models import build
profile._model = lambda name: build(CFG)
prof = profile.main(["--device", "cpu", "--batch", "1", "--image-size", "64", "--calls", "1",
                     "--mode", "prefix", "--json", {str(tmp_path / "p.json")!r}])
assert len(prof["layers"]) == 20
assert probe.main(["--device", "cpu", "--calls", "1",
                   "--tags", "A_static_dma", "matmul_128to64", "E_full_compute"]) == 0
print("ok")
""")
    assert out.strip().endswith("ok")


def test_convert_cli_runs_on_the_cpu_with_the_jax_package_blocked(tmp_path):
    """``cli.convert --help`` exits 0, and one conversion of a reference-style
    pickle (plain MobileNet + NNConv, the released mobilenet-nnconv5dw
    format, from tests/torch_oracle.py) writes an npz the port builds and
    runs, all with both packages blocked."""
    pth, npz = str(tmp_path / "m.pth.tar"), str(tmp_path / "m.npz")
    out = _run(f"""
import contextlib, io, sys
import torch
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
from torch_oracle import TorchMobileNetNNConv
from fastdepth_tpu_torch.cli import convert
help_text = io.StringIO()
with contextlib.redirect_stdout(help_text):
    try:
        convert.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
assert "output" in help_text.getvalue()
enc = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
torch.save({{"epoch": 2, "best_result": None,
             "model": TorchMobileNetNNConv(enc, (18, 14, 10, 6, 4)).eval()}}, {pth!r})
cfg = convert.main([{pth!r}, {npz!r}])
from fastdepth_tpu_torch import build, load_checkpoint, params_from_jax
tree, cfg2, meta = load_checkpoint({npz!r})
assert cfg2 == cfg and meta["epoch"] == 2
model = build(cfg)
with torch.no_grad():
    y = model.apply(model.load(params_from_jax(tree)), torch.rand(1, 32, 32, 3))
print("converted", cfg.decoder, cfg.skip, tuple(y.shape))
""")
    assert "=> config:" in out
    assert out.strip().endswith("converted nnconv5dw None (1, 32, 32, 1)")


def test_serve_cli_runs_on_the_cpu_with_the_jax_package_blocked(tiny_npz, tmp_path):
    """engine.server imports, ``cli.serve --help`` exits 0, and a daemon
    launched by ``cli.serve.main`` on the CPU answers the CLI's --ping and
    --stats over a unix socket, all with both packages blocked."""
    sock = str(tmp_path / "fd.sock")
    rgb = str(tmp_path / "rgb.npy")
    np.save(rgb, np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    out = _run(f"""
import contextlib, io, threading
from fastdepth_tpu_torch.engine import server
from fastdepth_tpu_torch.cli import serve
help_text = io.StringIO()
with contextlib.redirect_stdout(help_text):
    try:
        serve.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
assert "--device" in help_text.getvalue()
ready, stop = threading.Event(), threading.Event()
t = threading.Thread(target=serve.main, args=(["--evaluate", {tiny_npz!r}, "--socket", {sock!r},
                     "--batch-size", "2", "--image-size", "64", "64", "--stats-every", "0",
                     "--device", "cpu"],), kwargs=dict(_ready=ready, _stop=stop), daemon=True)
t.start()
assert ready.wait(60)
assert serve.main(["--socket", {sock!r}, "--ping", {rgb!r}]) == 0
assert serve.main(["--socket", {sock!r}, "--stats"]) == 0
stop.set()
t.join(30)
assert not t.is_alive()
print("served", server.InferenceServer.__name__)
""")
    assert "pred shape=(64, 64, 1)" in out and '"frames": 1' in out
    assert out.strip().endswith("served InferenceServer")


def test_the_package_data_ships_every_native_source():
    """A non-editable install carries every file under
    ``fastdepth_tpu_torch/csrc/``: each matches a ``package-data`` glob of
    ``pyproject.toml`` (the CUDA kernels, their headers and the native
    preprocessing library's ``preprocess.cpp``, which ``data/native.py``
    builds at first use)."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["fastdepth_tpu_torch"]
    pkg = os.path.join(REPO, "fastdepth_tpu_torch")
    files = sorted(os.path.relpath(p, pkg) for p in glob.glob(os.path.join(pkg, "csrc", "*")))
    assert "csrc/preprocess.cpp" in files and any(f.endswith(".cu") for f in files)
    unshipped = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert unshipped == []
