"""End-to-end slice test: torch full-module checkpoint -> converter ->
batched jitted eval over a synthetic NYU val tree -> metrics identical to
running the torch model + reference metric formulas directly
(the rebuild of reference `main.py --evaluate`, SURVEY.md §7 step 3)."""

import os

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastdepth_tpu.data import BatchLoader, NYUDataset
from fastdepth_tpu.engine import Evaluator, validate
from fastdepth_tpu.metrics import AverageMeter
from fastdepth_tpu.models import build

from test_metrics import torch_reference_metrics
from torch_oracle import TorchFastDepth, randomize_bn_stats

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)


@pytest.fixture(scope="module")
def nyu_val_root(tmp_path_factory):
    rng = np.random.RandomState(42)
    root = tmp_path_factory.mktemp("nyud") / "val"
    for scene, files in {"scene_a": ["00001.h5", "00007.h5"],
                         "scene_b": ["00050.h5", "00051.h5", "00052.h5"]}.items():
        d = root / scene
        d.mkdir(parents=True)
        for fname in files:
            with h5py.File(d / fname, "w") as f:
                f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
                f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    return str(root)


@pytest.fixture(scope="module")
def torch_ckpt(tmp_path_factory):
    gen = torch.Generator().manual_seed(0)
    # the layers draw their weights from the global generator: seed it here,
    # or the weights follow whatever ran before (about 1 state in 60 gives
    # an all-zero depth, whose metric stack holds NaN)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        tm = TorchFastDepth(TINY_ENC, TINY_DEC, skip="add").eval()
    randomize_bn_stats(tm, gen)
    path = tmp_path_factory.mktemp("ckpt") / "model_best.pth.tar"
    torch.save({"epoch": 7, "best_result": None, "model": tm}, path)
    return str(path), tm


def _torch_validate(tm, dataset):
    """Reference-semantics oracle loop: torch forward + reference metric
    formulas, per image, count-averaged."""
    meter = AverageMeter()
    from fastdepth_tpu.metrics import Result

    for i in range(len(dataset)):
        rgb, depth = dataset[i]
        x = torch.from_numpy(rgb.transpose(2, 0, 1)[None])
        with torch.no_grad():
            pred = tm(x).numpy()[0, 0]
        vals = torch_reference_metrics(pred, depth[..., 0])
        meter.update(Result(**vals))
    return meter.average()


def test_e2e_eval_matches_torch_oracle(nyu_val_root, torch_ckpt, tmp_path):
    ckpt_path, tm = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, meta = convert_checkpoint(ckpt_path)
    assert meta["epoch"] == 7
    assert cfg.encoder_channels == TINY_ENC

    dataset = NYUDataset(nyu_val_root, split="val")
    loader = BatchLoader(dataset, batch_size=2, num_workers=2, pad_last=True)
    evaluator = Evaluator(build(cfg), numpy_to_jax(params), batch_size=2)
    avg = validate(loader, evaluator, print_freq=2, make_images=False, log=lambda *a: None)

    ref = _torch_validate(tm, dataset)
    np.testing.assert_allclose(avg.rmse, ref.rmse, rtol=1e-3)
    np.testing.assert_allclose(avg.delta1, ref.delta1, rtol=1e-3)
    np.testing.assert_allclose(avg.absrel, ref.absrel, rtol=1e-3)
    np.testing.assert_allclose(avg.mae, ref.mae, rtol=1e-3)


def test_e2e_unfolded_bn_tightens_parity(nyu_val_root, torch_ckpt):
    """Without BN folding the numerics match torch even tighter."""
    ckpt_path, tm = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, _ = convert_checkpoint(ckpt_path)
    dataset = NYUDataset(nyu_val_root, split="val")
    loader = BatchLoader(dataset, batch_size=5, num_workers=2)
    evaluator = Evaluator(build(cfg), numpy_to_jax(params), batch_size=5, fold_bn=False)
    avg = validate(loader, evaluator, print_freq=0, make_images=False, log=lambda *a: None)
    ref = _torch_validate(tm, dataset)
    np.testing.assert_allclose(avg.rmse, ref.rmse, rtol=2e-4)
    np.testing.assert_allclose(avg.delta1, ref.delta1, rtol=2e-4)


def test_e2e_mesh_sharded_eval_matches_single(nyu_val_root, torch_ckpt):
    """Data-parallel eval over the 8-device CPU mesh == single-device
    results (the multi-chip path, BASELINE.json config #4)."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax
    from fastdepth_tpu.parallel import make_mesh

    params, cfg, _ = convert_checkpoint(ckpt_path)
    dataset = NYUDataset(nyu_val_root, split="val")
    model = build(cfg)

    loader = BatchLoader(dataset, batch_size=8, num_workers=2, pad_last=True)
    ev1 = Evaluator(model, numpy_to_jax(params), batch_size=8)
    avg1 = validate(loader, ev1, print_freq=0, make_images=False, log=lambda *a: None)

    mesh = make_mesh(8)
    ev8 = Evaluator(model, numpy_to_jax(params), batch_size=8, mesh=mesh)
    avg8 = validate(loader, ev8, print_freq=0, make_images=False, log=lambda *a: None)

    np.testing.assert_allclose(avg1.rmse, avg8.rmse, rtol=1e-5)
    np.testing.assert_allclose(avg1.delta1, avg8.delta1, rtol=1e-5)


def test_cli_end_to_end(nyu_val_root, torch_ckpt, tmp_path, capsys):
    """The argparse surface mirrors the reference CLI (utils.py:12-34)."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.cli import evaluate as cli

    data_root = os.path.dirname(os.path.dirname(nyu_val_root))
    data_name = os.path.basename(os.path.dirname(nyu_val_root))
    # --data is gated to nyudepthv2 like the reference; rename via symlink
    link = tmp_path / "nyudepthv2"
    os.symlink(os.path.dirname(nyu_val_root), link)
    csv_path = tmp_path / "out.csv"
    result = cli.main([
        "--evaluate", ckpt_path,
        "--data-root", str(tmp_path),
        "--batch-size", "2",
        "--print-freq", "2",
        "--no-images",
        "--csv", str(csv_path),
    ])
    out = capsys.readouterr().out
    assert "RMSE=" in out and "Delta1=" in out
    assert result.rmse > 0
    assert csv_path.exists()
    header = csv_path.read_text().splitlines()[0]
    assert header.split(",") == [
        "rmse", "mae", "delta1", "absrel", "lg10", "mse", "delta2", "delta3",
        "data_time", "gpu_time",
    ]


def test_device_normalize_matches_host_normalize(nyu_val_root, torch_ckpt):
    """uint8-to-device + on-device /255 == host-side f32 path exactly."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, _ = convert_checkpoint(ckpt_path)
    model = build(cfg)
    ev = Evaluator(model, numpy_to_jax(params), batch_size=5)

    ds_host = NYUDataset(nyu_val_root, split="val")
    ds_dev = NYUDataset(nyu_val_root, split="val", device_normalize=True)
    l_host = BatchLoader(ds_host, batch_size=5, num_workers=2)
    l_dev = BatchLoader(ds_dev, batch_size=5, num_workers=2)
    a = validate(l_host, ev, print_freq=0, make_images=False, log=lambda *x: None)
    b = validate(l_dev, ev, print_freq=0, make_images=False, log=lambda *x: None)
    np.testing.assert_allclose(a.rmse, b.rmse, rtol=1e-6)
    np.testing.assert_allclose(a.delta1, b.delta1, rtol=1e-6)


def test_device_preprocess_matches_host_pipeline(nyu_val_root, torch_ckpt, tmp_path):
    """Raw 480x640 frames + the on-device gather == the host val
    pipeline across every metric (the resize/crop chain is ONE index
    gather, value-preserving on either side), and the comparison strip
    still renders via viz_transform."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, _ = convert_checkpoint(ckpt_path)
    model = build(cfg)

    ds_host = NYUDataset(nyu_val_root, split="val")
    ds_raw = NYUDataset(nyu_val_root, split="val", raw_items=True)
    ev_host = Evaluator(model, numpy_to_jax(params), batch_size=5)
    ev_raw = Evaluator(model, numpy_to_jax(params), batch_size=5,
                       val_pipeline=ds_raw.val_pipeline)
    l_host = BatchLoader(ds_host, batch_size=5, num_workers=2)
    l_raw = BatchLoader(ds_raw, batch_size=5, num_workers=2)
    a = validate(l_host, ev_host, print_freq=0, make_images=False,
                 log=lambda *x: None)
    out_dir = str(tmp_path)
    b = validate(l_raw, ev_raw, print_freq=0, output_dir=out_dir,
                 make_images=True, viz_transform=ds_raw.val_pipeline,
                 log=lambda *x: None)
    for f in ("rmse", "mae", "delta1", "absrel", "lg10", "mse"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-6,
                                   err_msg=f)
    # train split must refuse raw_items (its on-device form is
    # device_augment, which ships the augmentation parameters too)
    with pytest.raises(ValueError, match="device_augment"):
        NYUDataset(nyu_val_root, split="train", raw_items=True)


def test_val_pipeline_rejects_preprocessed_frames(nyu_val_root, torch_ckpt):
    """The on-device gather clamps out-of-range indices under jit instead
    of raising, so feeding already-preprocessed 224x224 items through a
    val_pipeline Evaluator would silently produce garbage metrics — the
    trace-time shape guard must reject them loudly."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, _ = convert_checkpoint(ckpt_path)
    ds_raw = NYUDataset(nyu_val_root, split="val", raw_items=True)
    ev = Evaluator(build(cfg), numpy_to_jax(params), batch_size=2,
                   val_pipeline=ds_raw.val_pipeline)
    rgb = jnp.zeros((2, 224, 224, 3), jnp.float32)
    depth = jnp.zeros((2, 224, 224, 1), jnp.float32)
    with pytest.raises(ValueError, match="raw frames"):
        ev(rgb, depth)
    # LARGER frames must be rejected too: they pass any max-index bound
    # but the gather's resize ratio was computed for exactly 480x640 —
    # the metrics would be silently skewed (review finding r4)
    rgb_big = jnp.zeros((2, 488, 648, 3), jnp.float32)
    depth_big = jnp.zeros((2, 488, 648, 1), jnp.float32)
    with pytest.raises(ValueError, match="exactly"):
        ev(rgb_big, depth_big)


def test_validate_empty_loader_raises(torch_ckpt):
    """An empty split must fail loudly, not return a zero-count average
    (the AverageMeter would divide by zero or report garbage)."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.checkpoint.convert import convert_checkpoint
    from fastdepth_tpu.checkpoint.io import numpy_to_jax

    params, cfg, _ = convert_checkpoint(ckpt_path)
    ev = Evaluator(build(cfg), numpy_to_jax(params), batch_size=2)

    class _EmptyLoader:
        dataset = ()

        def __iter__(self):
            return iter(())

    with pytest.raises(ValueError, match="no batches"):
        validate(_EmptyLoader(), ev, make_images=False, log=lambda *a: None)


class _SlowLoader:
    """First batch instant, later batches block 80 ms — discriminates the
    direct loader-wait data_time measurement from the old t0-vs-end
    arithmetic, which clamps every batch after the first to 0."""

    def __init__(self, batches):
        self.batches = batches
        self.dataset = range(sum(c for _, _, c in batches))

    def __iter__(self):
        import time as _t

        for i, b in enumerate(self.batches):
            if i > 0:
                _t.sleep(0.08)
            yield b

    def __len__(self):
        return len(self.batches)


def test_validate_data_time_measures_loader_wait(tmp_path):
    """avg.data_time must reflect real blocking waits on the loader under
    the one-ahead pipeline, and a short run (<400 images) must still
    write its comparison strip at the end."""
    from fastdepth_tpu.config import ModelConfig

    model = build(ModelConfig(encoder_channels=TINY_ENC,
                              decoder_channels=TINY_DEC))
    import jax

    params = model.fold(model.init(jax.random.PRNGKey(0)))
    ev = Evaluator(model, params, batch_size=2, fold_bn=False)
    rng = np.random.RandomState(0)
    batches = [
        (rng.rand(2, 64, 64, 3).astype(np.float32),
         (rng.rand(2, 64, 64, 1) * 5 + 0.5).astype(np.float32), 2)
        for _ in range(4)
    ]
    avg = validate(_SlowLoader(batches), ev, print_freq=0,
                   output_dir=str(tmp_path), make_images=True,
                   log=lambda *a: None)
    # 3 of 4 batches waited 80 ms for 2 images each: avg/img >= ~30 ms
    assert avg.data_time > 0.02, avg.data_time
    assert os.path.exists(tmp_path / "comparison_0.png")


def test_evaluator_rejects_preprocessed_depth_with_pipeline(nyu_val_root):
    """The raw-shape trace guard must check DEPTH too: a preprocessed
    depth next to a raw rgb would clamp-gather silently otherwise."""
    from fastdepth_tpu.config import ModelConfig

    dataset = NYUDataset(nyu_val_root, split="val", raw_items=True)
    model = build(ModelConfig(encoder_channels=TINY_ENC,
                              decoder_channels=TINY_DEC))
    import jax

    params = model.fold(model.init(jax.random.PRNGKey(0)))
    ev = Evaluator(model, params, batch_size=1, fold_bn=False,
                   val_pipeline=dataset.val_pipeline)
    rgb = np.zeros((1, 480, 640, 3), np.float32)
    depth = np.zeros((1, 224, 224, 1), np.float32)
    with pytest.raises(ValueError, match="depth"):
        ev(ev.put(rgb), ev.put(depth))


def test_cli_mesh_args_validated_upfront(torch_ckpt, tmp_path):
    """Bad mesh arguments must fail with a clear message before any
    device work, not with a low-level sharding error on the first
    batch: --mesh-spatial must divide the 224-row image height and
    --batch-size must divide by --mesh-devices."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.cli import evaluate as cli

    base = ["--evaluate", ckpt_path, "--data-root", str(tmp_path),
            "--no-images", "--print-freq", "0"]
    with pytest.raises(SystemExit, match="224"):
        cli.main(base + ["--mesh-spatial", "3"])
    with pytest.raises(SystemExit, match="divide"):
        cli.main(base + ["--batch-size", "3", "--mesh-devices", "2"])


def test_cli_mesh_spatial_matches_plain(nyu_val_root, torch_ckpt, tmp_path):
    """--mesh-spatial S shards image height over a (data, space) mesh;
    final metrics match the meshless run (spatial partitioning is
    forward-exact — tests/test_spatial.py proves the mechanism, this
    proves the CLI surface end to end)."""
    ckpt_path, _ = torch_ckpt
    from fastdepth_tpu.cli import evaluate as cli

    link = tmp_path / "nyudepthv2"
    os.symlink(os.path.dirname(nyu_val_root), link)
    args = [
        "--evaluate", ckpt_path,
        "--data-root", str(tmp_path),
        "--batch-size", "2",
        "--print-freq", "0",
        "--no-images",
    ]
    plain = cli.main(args)
    spatial = cli.main(args + ["--mesh-devices", "2", "--mesh-spatial", "4"])
    np.testing.assert_allclose(spatial.rmse, plain.rmse, rtol=1e-5)
    np.testing.assert_allclose(spatial.delta1, plain.delta1, rtol=1e-5)
    # --device-preprocess shards RAW 480-row frames (the resize runs on
    # device inside the sharded step); 4 divides 480, metrics must agree
    dp = cli.main(args + ["--device-preprocess",
                          "--mesh-devices", "2", "--mesh-spatial", "4"])
    np.testing.assert_allclose(dp.rmse, plain.rmse, rtol=1e-5)
    np.testing.assert_allclose(dp.delta1, plain.delta1, rtol=1e-5)
