"""The port's device preprocessing for evaluation and what measures the
input pipeline, on the CPU: ``Evaluator(val_pipeline=...)`` against the
host path (bit for bit) and against the JAX package's (1e-6), its raw-size
guard, ``cli.evaluate --device-preprocess``, ``metrics.evaluate``,
``engine/benchmark.throughput_sweep``, ``cli.benchmark`` with the JAX
CLI's JSON keys, and the page-locked staging ring's wait."""

import ast
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastdepth_tpu import metrics as JM
from fastdepth_tpu.checkpoint.convert import convert_checkpoint
from fastdepth_tpu.checkpoint.io import numpy_to_jax
from fastdepth_tpu.data import BatchLoader as JaxBatchLoader
from fastdepth_tpu.data import NYUDataset as JaxNYUDataset
from fastdepth_tpu.engine import Evaluator as JaxEvaluator
from fastdepth_tpu.engine import validate as jax_validate
from fastdepth_tpu.models import build as jax_build

from fastdepth_tpu_torch import metrics as M
from fastdepth_tpu_torch.cli.evaluate import load_params_and_model
from fastdepth_tpu_torch.data import BatchLoader, NYUDataset
from fastdepth_tpu_torch.data.pipeline import ValPipeline
from fastdepth_tpu_torch.engine import Evaluator, validate
from fastdepth_tpu_torch.engine.staging import PinnedRing

from test_eval_e2e import nyu_val_root, torch_ckpt  # noqa: F401  (shared fixtures)
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("rmse", "mae", "delta1", "delta2", "delta3", "absrel", "lg10", "mse", "irmse", "imae")


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def port_model(torch_ckpt):  # noqa: F811
    params, model, _ = load_params_and_model(torch_ckpt[0])
    return model, params


# --- Evaluator(val_pipeline=...) ---------------------------------------------

def test_device_preprocess_equals_the_host_path_bit_for_bit(nyu_val_root, port_model):  # noqa: F811
    """Raw 480x640 frames through the gather equal the host val pipeline's
    items: the same metric stack for every batch, bit for bit, and the
    same validate() averages."""
    model, params = port_model
    ds_host = NYUDataset(nyu_val_root, split="val")
    ds_raw = NYUDataset(nyu_val_root, split="val", raw_items=True)
    ev_host = Evaluator(model, params, batch_size=2, device="cpu")
    ev_raw = Evaluator(model, params, batch_size=2, val_pipeline=ds_raw.val_pipeline,
                       device="cpu")
    l_host = BatchLoader(ds_host, batch_size=2, num_workers=2)
    l_raw = BatchLoader(ds_raw, batch_size=2, num_workers=2)
    for (rh, dh, nh), (rr, dr, nr) in zip(l_host, l_raw):
        assert nh == nr and rr.dtype == np.uint8 and rr.shape[1:3] == (480, 640)
        pred_h, stack_h = ev_host(ev_host.put(rh), ev_host.put(dh))
        pred_r, stack_r = ev_raw(ev_raw.put(rr), ev_raw.put(dr))
        assert torch.equal(pred_h, pred_r) and torch.equal(stack_h, stack_r)
    a = validate(l_host, ev_host, print_freq=0, make_images=False, log=_quiet)
    b = validate(l_raw, ev_raw, print_freq=0, make_images=False, log=_quiet)
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def test_device_preprocess_matches_the_jax_evaluator(nyu_val_root, torch_ckpt):  # noqa: F811
    """The port's device preprocessing against JAX's on the same raw frames
    and checkpoint: every averaged metric within rtol 1e-6
    (tests/test_eval_e2e.py's bound between JAX's two paths)."""
    tree, cfg, _ = convert_checkpoint(torch_ckpt[0])
    j_ds = JaxNYUDataset(nyu_val_root, split="val", raw_items=True)
    j_ev = JaxEvaluator(jax_build(cfg), numpy_to_jax(tree), batch_size=5,
                        val_pipeline=j_ds.val_pipeline)
    want = jax_validate(JaxBatchLoader(j_ds, batch_size=5, num_workers=2), j_ev, print_freq=0,
                        make_images=False, log=_quiet)
    params, model, _ = load_params_and_model(torch_ckpt[0])
    ds = NYUDataset(nyu_val_root, split="val", raw_items=True)
    ev = Evaluator(model, params, batch_size=5, val_pipeline=ds.val_pipeline, device="cpu")
    got = validate(BatchLoader(ds, batch_size=5, num_workers=2), ev, print_freq=0,
                   make_images=False, log=_quiet)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("rgb_hw, depth_hw", [
    ((224, 224), (224, 224)),   # preprocessed frames
    ((488, 648), (488, 648)),   # larger than the gather was built for
    ((480, 640), (224, 224)),   # a raw rgb beside a preprocessed depth
])
def test_the_raw_size_guard_raises_the_jax_message(nyu_val_root, torch_ckpt, port_model,  # noqa: F811
                                                   rgb_hw, depth_hw):
    tree, cfg, _ = convert_checkpoint(torch_ckpt[0])
    pipe = ValPipeline.create()
    rgb = np.zeros((2, *rgb_hw, 3), np.float32)
    depth = np.zeros((2, *depth_hw, 1), np.float32)
    j_ev = JaxEvaluator(jax_build(cfg), numpy_to_jax(tree), batch_size=2, val_pipeline=pipe)
    with pytest.raises(ValueError) as want:
        j_ev(jnp.asarray(rgb), jnp.asarray(depth))
    model, params = port_model
    ev = Evaluator(model, params, batch_size=2, val_pipeline=pipe, device="cpu")
    with pytest.raises(ValueError) as got:
        ev(ev.put(rgb), ev.put(depth))
    assert str(got.value) == str(want.value)
    assert "exactly 480x640 raw frames" in str(got.value)


def test_a_pipeline_without_raw_size_guards_with_its_largest_index(port_model):
    """A hand-built pipeline (no raw_size) refuses frames smaller than its
    largest index, as JAX's does."""
    model, params = port_model
    full = ValPipeline.create()
    pipe = ValPipeline(rows=full.rows, cols=full.cols, output_size=full.output_size)
    ev = Evaluator(model, params, batch_size=1, val_pipeline=pipe, device="cpu")
    small = np.zeros((1, 224, 224, 3), np.float32)
    with pytest.raises(ValueError, match="at least"):
        ev(ev.put(small), ev.put(small[..., :1]))


def test_evaluate_cli_device_preprocess_writes_the_comparison_strip(nyu_val_root,  # noqa: F811
                                                                   torch_ckpt, tmp_path):
    """cli.evaluate --device-preprocess: the host path's metrics, and the
    comparison strip rendered from the raw frames through viz_transform."""
    from fastdepth_tpu_torch.cli import evaluate as port_cli

    ckpt = tmp_path / "ckpt" / "model_best.pth.tar"
    ckpt.parent.mkdir()
    os.symlink(torch_ckpt[0], ckpt)
    os.symlink(os.path.dirname(nyu_val_root), tmp_path / "nyudepthv2")
    args = ["--evaluate", str(ckpt), "--data-root", str(tmp_path), "--batch-size", "2",
            "--print-freq", "0", "--workers", "2", "--device", "cpu"]
    host = port_cli.main(args + ["--no-images"])
    dev = port_cli.main(args + ["--device-preprocess"])
    for f in FIELDS:
        assert getattr(host, f) == getattr(dev, f), f
    strip = ckpt.parent / "comparison_7.png"
    assert strip.exists()
    from PIL import Image

    assert Image.open(strip).size == (3 * 224, 224)  # one row: rgb | target | prediction


# --- metrics.evaluate ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 1), (1, 16, 16, 1)])
def test_metrics_evaluate_equals_the_jax_one(shape):
    rng = np.random.RandomState(3)
    out = rng.uniform(0.5, 5, shape).astype(np.float32)
    tgt = rng.uniform(0.5, 5, shape).astype(np.float32)
    tgt.reshape(-1)[:20] = 0.0  # holes
    got = M.evaluate(torch.from_numpy(out), torch.from_numpy(tgt))
    want = JM.evaluate(jnp.asarray(out), jnp.asarray(tgt))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6, err_msg=f)


def test_metrics_evaluate_refuses_a_batch_with_the_jax_message():
    batch = np.ones((2, 8, 8, 1), np.float32)
    with pytest.raises(ValueError) as want:
        JM.evaluate(jnp.asarray(batch), jnp.asarray(batch))
    with pytest.raises(ValueError) as got:
        M.evaluate(torch.from_numpy(batch), torch.from_numpy(batch))
    assert str(got.value) == str(want.value)


# --- throughput_sweep ---------------------------------------------------------

def test_throughput_sweep_refuses_unfolded_params_and_reports_each_batch(port_model):
    from fastdepth_tpu_torch.engine.benchmark import throughput_sweep

    model, params = port_model
    with pytest.raises(ValueError, match="pre-folded params"):
        throughput_sweep(model, params, batch_sizes=(1,), device="cpu")
    out = throughput_sweep(model, model.fold(params), batch_sizes=(1, 2), image_size=(32, 32),
                           warmup=1, calls=2, device="cpu")
    assert list(out) == ["1", "2"]
    for b, row in out.items():
        assert set(row) == {"mean_s", "median_s", "total_s", "calls", "fps"}
        assert row["fps"] == pytest.approx(int(b) / row["mean_s"])


# --- cli.benchmark ------------------------------------------------------------

def _jax_result_keys():
    """The keys of the result dicts the JAX CLI prints: (eval, train)."""
    path = os.path.join(REPO, "fastdepth_tpu", "cli", "benchmark.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keys = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main", "train_main"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                        and getattr(node.targets[0], "id", None) == "result"):
                    keys[fn.name] = {k.value for k in node.value.keys}
    return keys["main"], keys["train_main"]


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    from fastdepth_tpu_torch import ModelConfig
    from fastdepth_tpu_torch.checkpoint import params_to_jax, save_checkpoint
    from fastdepth_tpu_torch.models import build

    cfg = ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                      decoder_channels=(18, 14, 10, 6, 4))
    path = str(tmp_path_factory.mktemp("bench") / "tiny.npz")
    save_checkpoint(path, params_to_jax(build(cfg).init(torch.Generator().manual_seed(0))
                                        .state_dict()), cfg, epoch=0)
    return path


@pytest.mark.parametrize("flags", [[], ["--device-preprocess"], ["--train"],
                                   ["--train", "--device-augment"]])
def test_benchmark_cli_runs_each_mode_with_the_jax_keys(tiny_npz, flags, capsys):
    import json

    from fastdepth_tpu_torch.cli import benchmark as bench_cli

    result = bench_cli.main(["--evaluate", tiny_npz, "--synthetic", "8", "--batch-size", "4",
                             "-j", "2", "--device", "cpu", "--json"] + flags)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    eval_keys, train_keys = _jax_result_keys()
    assert (train_keys if "--train" in flags else eval_keys) <= set(result)
    assert result["frames"] == 8 and result["fps"] > 0 and result["device"] == "cpu"
    # the JAX CLI's rounding (fastdepth_tpu/cli/benchmark.py): seconds to 3
    # places, frames/s to 1, the loss to 4
    places = {"elapsed_s": 3, "fps": 1, **({"final_loss": 4} if "--train" in flags else {})}
    for key, n in places.items():
        assert result[key] == round(result[key], n), (key, result[key])
    if "--train" in flags:
        assert result["device_augment"] == ("--device-augment" in flags)
        assert np.isfinite(result["final_loss"])
        assert result["metric"].startswith("end-to-end streaming TRAIN")
    else:
        assert result["device_preprocess"] == ("--device-preprocess" in flags)


def test_benchmark_cli_refuses_mismatched_flags_and_names_h5py(monkeypatch, tmp_path):
    from fastdepth_tpu_torch.cli import benchmark as bench_cli

    with pytest.raises(SystemExit):
        bench_cli.parse_args(["--device-augment"])
    with pytest.raises(SystemExit):
        bench_cli.parse_args(["--train", "--device-preprocess"])
    root = bench_cli.make_synthetic_tree(4, "train", root=str(tmp_path))
    assert len(NYUDataset(os.path.join(root, "nyudepthv2", "train"), split="train")) == 4
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit, match="h5py"):
        bench_cli.make_synthetic_tree(2, "val", str(tmp_path / "none"))


# --- the page-locked staging ring ---------------------------------------------

class _DelayedRing(PinnedRing):
    """The ring's staging path with a stream that runs each copy on a thread
    which starts reading the buffer only after a delay; its event is that
    copy's completion."""

    def __init__(self, slots, delay=0.2):
        super().__init__("cpu", slots=slots)
        self.delay = delay

    @property
    def staged(self):
        return True

    def _alloc(self, arr):
        return torch.from_numpy(arr.copy())

    def _copy(self, host):
        result = {}

        def copy():
            time.sleep(self.delay)
            result["out"] = host.clone()

        worker = threading.Thread(target=copy)
        worker.start()

        class Done:
            @staticmethod
            def synchronize():
                worker.join(timeout=30)
                assert not worker.is_alive()
        return result, Done


def test_the_ring_refills_a_slot_only_after_its_copy_completed():
    """One slot: the second put must wait for the first copy, which reads
    the buffer 0.2 s late, before it overwrites the buffer; each copy gets
    its own batch."""
    ring = _DelayedRing(slots=1)
    a, b = np.full(1024, 1.0, np.float32), np.full(1024, 2.0, np.float32)
    t0 = time.perf_counter()
    got_a = ring.put(a)
    got_b = ring.put(b)
    assert time.perf_counter() - t0 >= 0.2  # the refill waited
    ring._slots[0].done.synchronize()
    assert (got_a["out"] == 1.0).all() and (got_b["out"] == 2.0).all()


def test_the_ring_cycles_its_slots_and_reallocates_on_a_new_shape():
    ring = _DelayedRing(slots=2, delay=0.0)
    first = [ring.put(np.full(8, float(i), np.float32)) for i in range(4)]
    hosts = [s.host for s in ring._slots]
    ring.put(np.zeros((2, 3), np.float32))  # slot 0, another shape
    assert ring._slots[0].host.shape == (2, 3) and ring._slots[1].host is hosts[1]
    for s in ring._slots:
        s.done.synchronize()
    assert [float(r["out"][0]) for r in first] == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="at least one slot"):
        PinnedRing("cpu", slots=0)


def test_the_ring_wraps_arrays_on_the_cpu():
    ring = PinnedRing("cpu")
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = ring.put(arr)
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), arr)
