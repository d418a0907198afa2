"""Two-process dryrun of the port's public multi-process CLI surface —
counterpart of the JAX package's ``scripts/dryrun_multiprocess.py``.

Two ranks, each a process of its own over gloo on the CPU, run the
commands a launcher would run:

    python -m fastdepth_tpu_torch.cli.train --coord HOST:PORT \\
        --num-processes 2 --process-id K --mesh-devices 2 --device cpu ...
    python -m fastdepth_tpu_torch.cli.evaluate --coord HOST:PORT2 ... \\
        -e model_best.npz

through the sharded BatchLoader, the epochs, the checkpoints (rank 0),
validate() (the metric all-gather) and the CSVs, and every artifact is
compared with the same commands in one process without a mesh: the
train.csv losses, the test.csv metrics, the parameters of model_best.npz
and checkpoint.npz (and their config and best epoch) and the evaluation
CSV of the trained model_best.npz, each within 1e-5 relative, and the
running statistics of both checkpoints within 1e-4.  The two sides
differ in float arithmetic only: each rank's moments merged over two
ranks against one F.batch_norm, and the gradient's all-reduce.  Two of
these differences are not association noise:
- at random init this model's gradient is ill-conditioned in f32
  (``tests/test_torch_train.py``: two f32 implementations' first-step
  gradients differ by percents of a leaf's largest entry), so, as the
  port's other f32 CLI comparisons, the runs train at ``--lr 1e-5`` and
  the momentum buffers (the gradients) are not compared: the f64
  two-rank step in ``tests/test_torch_parallel.py`` holds them at 1e-9;
- on the CPU, F.batch_norm sums a channel's 100,352 values (b8 at 112²)
  in f32 a thread's chunk at a time: on one thread its variance can be
  more than 1e-5 relative off the f64 one, and the running variances
  keep that, so the running statistics are held at the JAX dryrun's 1e-4.

The items are seeded raw 480x640 frames in place of the h5 reads (empty
``*.h5`` names; no h5py needed, which the card machine lacks), through
the real train and val transforms, and no comparison PNGs are drawn (no
matplotlib there either).

    python -m fastdepth_tpu_torch.parallel.dryrun [--report report.json]

prints the JSON report and exits non-zero if a check fails.

    python -m fastdepth_tpu_torch.parallel.dryrun --space [--report report.json]

runs the ``space`` axis instead, over gloo ranks spawned on the CPU, on
the pruned flagship at full width and 224^2 with the committed trained
weights (``docs/rehearsal_model_r5.npz``): two ranks at S = 2 run the
height-sharded forward (``impl='auto'``: the encoder's halo convs, K1's
row windows, K4; the plain versions on the CPU) at b1 against the
single-process forward (atol :data:`SPACE_ATOL`), and four ranks on
``make_mesh_2d(2, 2)`` run the Evaluator over seeded frames against one
process's metric rows: the means within :data:`TOLERANCE` relative, the
delta fractions within :data:`DELTA_PIXELS` pixels of the image.  The
sharded convs add in another order than the whole image's (f32 on the
CPU: about 1e-5 m on these depths), and a pixel whose depth ratio lies
that close to 1.25^k crosses it: the first run here moved one pixel of
one image's delta1, 1 / 50176 of it (7e-5 relative).

    python -m fastdepth_tpu_torch.parallel.dryrun --space --model resnet50-upproj

runs the same two checks on any model of the registry (``models.
from_name``) at 224^2 with random weights: ``Model.init`` seeded with
:data:`ZOO_SEED`, every BatchNorm's statistics drawn and the last conv
made non-negative (:func:`zoo_model`; random deep models otherwise give
depth maps that are ~0 or dark).  Those outputs reach far above 1, so
the forward is held within :data:`SPACE_ATOL` of ``max(1, max|one
process|)``, the report's ``forward_scale``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

EPOCHS = 2
BATCH = 8
N_TRAIN, N_VAL = 8, 4
TOLERANCE = 1e-5
STATS_TOLERANCE = 1e-4  # the running statistics (module docstring)
SPACE_ATOL = 1e-4  # the height-sharded forward against one process (f32)
SPACE_EVAL_BATCH = 4  # the 2x2 Evaluator's global batch
DELTA_PIXELS = 2  # pixels a delta fraction may move under the 2x2 mesh (docstring)
ZOO_SEED = 9  # Model.init's and the drawn BatchNorms' seed under --model
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "rehearsal_model_r5.npz")
# tiny widths that satisfy the skip-add tap constraint
TINY_CFG = {
    "encoder_channels": [4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24],
    "decoder_channels": [18, 14, 10, 6, 4],
}
METRIC_FIELDS = ["rmse", "mae", "delta1", "absrel", "lg10", "mse",
                 "delta2", "delta3"]  # test.csv minus the timing columns


class SeededFrames:
    """The item reader NYUDataset calls with an ``*.h5`` path: a seeded raw
    480x640 uint8 RGB frame and f32 depth, keyed by the file's number."""

    def __call__(self, path: str):
        rng = np.random.RandomState(int(os.path.basename(path)[:-3]))
        return (rng.randint(0, 256, (480, 640, 3), dtype=np.uint8),
                rng.uniform(0.5, 10.0, (480, 640)).astype(np.float32))


@contextlib.contextmanager
def seeded_frames():
    """The CLIs' ``NYUDataset`` reads :class:`SeededFrames` inside."""
    from fastdepth_tpu_torch import data

    original = data.NYUDataset

    class Seeded(original):
        def __init__(self, *a, **kw):
            kw.setdefault("loader", SeededFrames())
            super().__init__(*a, **kw)

    data.NYUDataset = Seeded
    try:
        yield
    finally:
        data.NYUDataset = original


@contextlib.contextmanager
def without_train_images():
    """cli.train writes no comparison PNGs between epochs inside: they need
    matplotlib, which the card machine lacks (cli.train has no flag for
    it, as the JAX one has none; cli.evaluate takes --no-images)."""
    from fastdepth_tpu_torch.cli import train as train_cli

    train_loop = train_cli.train_loop
    train_cli.train_loop = lambda *a, **kw: train_loop(*a, **{**kw, "make_images": False})
    try:
        yield
    finally:
        train_cli.train_loop = train_loop


def make_dataset(root: str) -> str:
    """Empty ``*.h5`` names for the train and val splits (from 00002: 00001
    is the holdout split's) and the tiny config; returns the config path."""
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        d = os.path.join(root, "nyudepthv2", split, "scene_a")
        os.makedirs(d)
        for i in range(2, 2 + n):
            open(os.path.join(d, f"{i:05d}.h5"), "w").close()
    cfg = os.path.join(root, "tiny.json")
    with open(cfg, "w") as f:
        json.dump(TINY_CFG, f)
    return cfg


def train_argv(root: str, out_dir: str):
    return ["--data-root", root, "--arch-json", os.path.join(root, "tiny.json"),
            "--epochs", str(EPOCHS), "--batch-size", str(BATCH),
            "--eval-batch-size", str(BATCH), "--workers", "2", "--print-freq", "0",
            "--seed", "3", "--lr", "1e-5", "--output-dir", out_dir, "--device", "cpu"]


def eval_argv(root: str, out_dir: str):
    return ["--evaluate", os.path.join(out_dir, "model_best.npz"), "--data-root", root,
            "--batch-size", str(BATCH), "--print-freq", "0", "--no-images",
            "--csv", os.path.join(out_dir, "eval.csv"), "--device", "cpu"]


def dist_argv(port: int, rank: int):
    return ["--mesh-devices", "2", "--coord", f"localhost:{port}",
            "--num-processes", "2", "--process-id", str(rank)]


def run_both(root: str, out_dir: str, extra_train=(), extra_eval=()) -> None:
    """cli.train, then cli.evaluate over its model_best.npz, in this
    process, on seeded frames."""
    from fastdepth_tpu_torch.cli import evaluate as eval_cli
    from fastdepth_tpu_torch.cli import train as train_cli

    with seeded_frames(), without_train_images():
        train_cli.main(train_argv(root, out_dir) + list(extra_train))
        eval_cli.main(eval_argv(root, out_dir) + list(extra_eval))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(root: str, out_dir: str):
    """The two rank processes (this module with ``--rank K``), started;
    each runs the train and the evaluate command as rank K."""
    ports = [_free_port(), _free_port()]
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // 2)))
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return [subprocess.Popen(
        [sys.executable, "-m", "fastdepth_tpu_torch.parallel.dryrun", "--rank", str(rank),
         "--root", root, "--out", out_dir, "--ports", *map(str, ports)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]


def wait_ranks(procs, timeout: float = 600) -> None:
    logs = []
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} failed ({p.returncode}):\n{log[-4000:]}")


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1e-9, abs(a))


def _arrays(path):
    with np.load(path) as d:
        return {k: np.asarray(d[k], np.float64) for k in d.files if k != "__meta__"}


def compare(sp: str, mp: str, epochs: int = EPOCHS) -> dict:
    """The checks of the module docstring, single-process run ``sp``
    against the two-rank run ``mp`` (``epochs`` long): relative
    differences and verdicts."""
    from fastdepth_tpu_torch.checkpoint.io import load_checkpoint

    checks = {}
    sp_tr, mp_tr = _read_csv(os.path.join(sp, "train.csv")), _read_csv(
        os.path.join(mp, "train.csv"))
    checks["train_csv_rows"] = len(sp_tr) == len(mp_tr) == epochs
    checks["train_loss_max_rel_diff"] = max(
        _rel(float(a["loss"]), float(b["loss"])) for a, b in zip(sp_tr, mp_tr))
    sp_te, mp_te = _read_csv(os.path.join(sp, "test.csv")), _read_csv(
        os.path.join(mp, "test.csv"))
    checks["test_csv_rows"] = len(sp_te) == len(mp_te) == epochs
    checks["val_metrics_max_rel_diff"] = max(
        _rel(float(a[f]), float(b[f])) for a, b in zip(sp_te, mp_te) for f in METRIC_FIELDS)
    for name in ("model_best.npz", "checkpoint.npz"):
        a, b = _arrays(os.path.join(sp, name)), _arrays(os.path.join(mp, name))
        checks[f"{name}_same_leaves"] = a.keys() == b.keys()
        # each array's largest difference against max(1, its largest
        # entry), the JAX dryrun's relative form; no momentum (docstring)
        rel = {k: float(np.abs(a[k] - b[k]).max()) / max(1.0, float(np.abs(a[k]).max()))
               for k in a if not k.startswith("momentum/")}
        stats = [k for k in rel if k.endswith(("/bn/mean", "/bn/var"))]
        checks[f"{name}_params_max_rel_diff"] = max(v for k, v in rel.items() if k not in stats)
        checks[f"{name}_stats_max_rel_diff"] = max(rel[k] for k in stats)
    _, cfg_sp, meta_sp = load_checkpoint(os.path.join(sp, "model_best.npz"))
    _, cfg_mp, meta_mp = load_checkpoint(os.path.join(mp, "model_best.npz"))
    checks["best_config_equal"] = cfg_sp == cfg_mp
    checks["best_epoch_equal"] = meta_sp["epoch"] == meta_mp["epoch"]
    ev_sp = _read_csv(os.path.join(sp, "eval.csv"))[-1]
    ev_mp = _read_csv(os.path.join(mp, "eval.csv"))[-1]
    checks["eval_cli_max_rel_diff"] = max(
        _rel(float(ev_sp[f]), float(ev_mp[f])) for f in METRIC_FIELDS)
    ok = all(v <= bound(k) if k.endswith("_rel_diff") else v for k, v in checks.items())
    return {"ok": bool(ok), "tolerance": TOLERANCE, "stats_tolerance": STATS_TOLERANCE,
            "checks": checks}


def bound(check: str) -> float:
    """The bound of a ``*_rel_diff`` check of :func:`compare`."""
    return STATS_TOLERANCE if "_stats_" in check else TOLERANCE


def run(work: str) -> dict:
    """The whole dryrun in ``work``: the two ranks and, meanwhile, the
    single-process reference in this process; returns the report."""
    root = os.path.join(work, "data")
    make_dataset(root)
    sp, mp = os.path.join(work, "sp"), os.path.join(work, "mp")
    procs = start_ranks(root, mp)
    try:
        run_both(root, sp)
    finally:
        wait_ranks(procs)
    report = compare(sp, mp)
    report.update({
        "surface": "public CLI (cli.train + cli.evaluate, --coord/--num-processes/"
                   "--process-id --mesh-devices 2 --device cpu)",
        "topology": {"single": "1 process, no mesh",
                     "multi": "2 processes, one gloo rank each"},
        "protocol": f"{EPOCHS} epochs, global batch {BATCH}, {N_TRAIN} train / "
                    f"{N_VAL} val seeded frames, sharded BatchLoader -> checkpoint -> "
                    "validate -> separate cli.evaluate pass",
    })
    return report


def flagship():
    """(model, params) of the committed trained pruned flagship."""
    from fastdepth_tpu_torch.checkpoint import load_checkpoint, params_from_jax
    from fastdepth_tpu_torch.models import build

    tree, cfg, _ = load_checkpoint(WEIGHTS)
    model = build(cfg)
    return model, model.load(params_from_jax(tree))


# the last conv of each decoder: the depth head, or the shuffle decoders'
# last stage (their output is its pixel shuffle)
LAST_CONVS = ("decoder.final.pw", "decoder.decode_conv6.pw", "decoder.conv4.pw",
              "decoder.conv4.conv")


def random_bn(params, seed: int):
    """Make Model.init's tree carry signal to the output, in place: draw
    every BatchNorm's statistics (scale and var in [0.5, 1.5), mean N(0,
    0.1), bias in [0, 0.2)) and make the last conv's weights non-negative.
    Model.init leaves BatchNorm at its defaults, and the reference's He
    rule for a depthwise conv (n = k^2 * C) shrinks activations C-fold a
    layer: at init a MobileNet's depth map is ~1e-17 (measured on one H100).
    Deep random ResNets go the other way: their activations grow into a
    common mode per channel, so a random head's sign is the same at every
    pixel and its ReLU can be dark on the whole map.  Non-negative weights
    over non-negative (post-ReLU) inputs and a positive bias keep the
    output lit wherever its input is."""
    from fastdepth_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in params.named_modules():
            if isinstance(m, BatchNorm):
                c = m.mean.numel()
                m.scale.copy_(torch.rand(c, generator=gen) + 0.5)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)
                m.mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.bias.copy_(torch.rand(c, generator=gen) * 0.2)
            elif name in LAST_CONVS:
                m.w.abs_()
    return params


def zoo_model(name: str, seed: int = ZOO_SEED):
    """(model, params on the CPU) of a registry model: Model.init's tree,
    seeded, given signal by :func:`random_bn`."""
    from fastdepth_tpu_torch.models import from_name

    model = from_name(name)
    return model, random_bn(model.init(torch.Generator().manual_seed(seed)), seed)


def space_model(name=None):
    """(model, params): the trained flagship, or with ``name`` the
    registry model of :func:`zoo_model`."""
    return flagship() if name is None else zoo_model(name)


def space_inputs():
    """The seeded b1 frame of the forward check and the seeded
    (rgb, depth) batch of the Evaluator check, 224^2."""
    rng = np.random.RandomState(11)
    x = rng.rand(1, 224, 224, 3).astype(np.float32)
    rgb = rng.rand(SPACE_EVAL_BATCH, 224, 224, 3).astype(np.float32)
    depth = rng.uniform(0.5, 10.0, (SPACE_EVAL_BATCH, 224, 224, 1)).astype(np.float32)
    return x, rgb, depth


def space_forward(model, params, x, mesh=None) -> np.ndarray:
    """The pruned flagship's ``impl='auto'`` forward of ``x`` (f32, the
    CPU), height-sharded over ``mesh``'s space axis and gathered (the
    whole image in one process without a mesh)."""
    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.parallel.mesh import fetch_global, put_sharded

    p, apply = _prepare(model, params, batch_size=x.shape[0], dtype=torch.float32,
                        fold_bn=True, impl="auto", device="cpu",
                        space=None if mesh is None else mesh.partition())
    with torch.inference_mode():
        if mesh is None:
            return apply(p, torch.from_numpy(x)).numpy()
        return fetch_global(apply(p, put_sharded(x, mesh)), mesh, dim=0, space_dim=1)


def space_eval(model, params, rgb, depth, mesh=None) -> np.ndarray:
    """The Evaluator's ``(fields, N)`` metric rows of one batch, each rank
    putting its data rows of it under ``mesh``."""
    from fastdepth_tpu_torch.engine import Evaluator

    if mesh is not None:
        n = rgb.shape[0] // mesh.size
        rgb, depth = (a[mesh.rank * n:(mesh.rank + 1) * n] for a in (rgb, depth))
    ev = Evaluator(model, params, batch_size=SPACE_EVAL_BATCH, mesh=mesh,
                   device=None if mesh is not None else "cpu")
    return ev.fetch(ev(ev.put(rgb), ev.put(depth))[1], dim=1)


def _space_rank(rank: int, world: int, tmp: str, threads: int, name=None) -> None:
    """One gloo rank of :func:`space_run`: S = 2 forward (two ranks) or the
    2x2 Evaluator (four); rank 0 saves the result."""
    import torch.distributed as dist

    from fastdepth_tpu_torch.parallel.distributed import init_group
    from fastdepth_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    torch.set_num_threads(threads)
    init_group("cpu", rank, world, store=dist.FileStore(os.path.join(tmp, "store"), world))
    try:
        model, params = space_model(name)
        x, rgb, depth = space_inputs()
        if world == 2:
            out = space_forward(model, params, x, make_mesh(2, "space"))
        else:
            out = space_eval(model, params, rgb, depth, make_mesh_2d(2, 2))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.save(os.path.join(tmp, "result.npy"), out)


def space_run(work: str, name=None) -> dict:
    """The ``--space`` dryrun in ``work`` on the trained flagship, or with
    ``name`` on that registry model (:func:`space_model`): the two- and
    the four-rank job spawned together, the single-process references
    meanwhile; returns the report."""
    import time

    t0 = time.perf_counter()
    threads = max(1, torch.get_num_threads() // 6)
    ctxs = {}
    for world in (2, 4):
        tmp = os.path.join(work, f"w{world}")
        os.makedirs(tmp)
        ctxs[world] = (tmp, torch.multiprocessing.start_processes(
            _space_rank, args=(world, tmp, threads, name), nprocs=world, start_method="spawn",
            join=False))
    model, params = space_model(name)
    x, rgb, depth = space_inputs()
    want_fwd = space_forward(model, params, x)
    want_eval = space_eval(model, params, rgb, depth)
    got = {}
    for world, (tmp, ctx) in ctxs.items():
        while not ctx.join():
            pass
        got[world] = np.load(os.path.join(tmp, "result.npy"))
    fwd_err = float(np.abs(got[2] - want_fwd).max())
    from fastdepth_tpu_torch.metrics import METRIC_FIELDS

    fin = np.isfinite(want_eval)
    delta = np.array([f.startswith("delta") for f in METRIC_FIELDS])
    diff = np.abs(got[4] - want_eval)
    mean_rows = fin & ~delta[:, None]
    eval_rel = float((diff[mean_rows] / np.maximum(np.abs(want_eval[mean_rows]),
                                                   1e-6 / TOLERANCE)).max())
    delta_pixels = float(diff[delta].max() * 224 * 224)
    checks = {
        "forward_shape_ok": got[2].shape == want_fwd.shape == (1, 224, 224, 1),
        "forward_finite": bool(np.isfinite(got[2]).all()),
        "forward_max_abs_diff": fwd_err,
        "eval_finite_equal": bool(np.array_equal(np.isfinite(got[4]), fin)) and bool(fin.any()),
        "eval_max_rel_diff": eval_rel,
        "eval_delta_max_pixels": delta_pixels,
    }
    fwd_bound = SPACE_ATOL
    if name is not None:  # random weights: the bound scales with the output
        checks["forward_scale"] = max(1.0, float(np.abs(want_fwd).max()))
        fwd_bound = SPACE_ATOL * checks["forward_scale"]
    ok = (checks["forward_shape_ok"] and checks["forward_finite"] and fwd_err <= fwd_bound
          and checks["eval_finite_equal"] and eval_rel <= TOLERANCE
          and delta_pixels <= DELTA_PIXELS + 1e-3)
    return {"ok": bool(ok), "checks": checks,
            "bounds": {"forward_max_abs_diff": fwd_bound, "eval_max_rel_diff": TOLERANCE,
                       "eval_delta_max_pixels": DELTA_PIXELS},
            "topology": {"forward": "2 gloo ranks, make_mesh(2, 'space')",
                         "eval": "4 gloo ranks, make_mesh_2d(2, 2)"},
            "model": ("mobilenet-nnconv5dw-skipadd-pruned, 224x224, docs/rehearsal_model_r5.npz"
                      if name is None else f"{name}, 224x224, random weights (seed "
                                           f"{ZOO_SEED}, drawn BatchNorms)"),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None, help="also write the JSON report here")
    ap.add_argument("--space", action="store_true",
                    help="the space axis's dryrun (module docstring) instead")
    ap.add_argument("--model", default=None, metavar="NAME",
                    help="with --space: a registry model (e.g. resnet50-upproj) at random "
                         "weights instead of the trained flagship")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--ports", type=int, nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.model is not None and not args.space:
        ap.error("--model takes --space")
    if args.rank is not None:  # one rank of run()'s pair
        run_both(args.root, args.out, dist_argv(args.ports[0], args.rank),
                 dist_argv(args.ports[1], args.rank))
        return 0
    with tempfile.TemporaryDirectory(prefix="fdtorch_dryrun_") as work:
        report = space_run(work, args.model) if args.space else run(work)
    print(json.dumps(report, indent=1))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
