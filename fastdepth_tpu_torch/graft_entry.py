"""The single-device forward check and the multi-device dry run — the
port's counterpart of the repo's root ``__graft_entry__.py``.

    python -m fastdepth_tpu_torch.graft_entry [--device cuda|cpu]
    python -m fastdepth_tpu_torch.graft_entry multichip [N] [--device cuda|cpu]

The first runs :func:`entry`'s forward once and prints ``entry ok:`` with
the output's shape and dtype; the second runs :func:`dryrun_multichip`
over N ranks (default 8) and prints its ``ok`` line.  ``--device cuda``
(the default) needs a card, and N of them for the dry run, one rank a
card over NCCL (``parallel/distributed.launch``: N = 1 in this process
over a group of one, more spawned); it refuses without them, naming how
many there are.  ``--device cpu`` runs the ranks over gloo on the CPU,
the counterpart of XLA's virtual CPU devices, and the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from fastdepth_tpu_torch.config import FASTDEPTH_PRUNED, ModelConfig, TrainConfig

IMAGE_SIZE = 224
ENTRY_BATCH = 8
LR = 0.01
# the device-augment step's tiny widths (__graft_entry__.py:130-152): a
# cheap second model at the production shapes, raw 480x640 in, 224x224 out
TINY = ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                   decoder_channels=(18, 14, 10, 6, 4))
RAW_HW = (480, 640)
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6


def entry(device: str = "cuda"):
    """(forward, example_args): the forward of the flagship model — the
    NetAdapt-pruned FastDepth (mobilenet-nnconv5dw-skipadd-pruned), its
    seeded ``Model.init`` BN-folded, the straight NHWC forward
    (``model.apply``) in true f32 (``engine/aot._prepare``: TF32 off),
    under inference mode — and ``(params, zeros (8, 224, 224, 3) f32)``
    on ``device``.  A CUDA ``device`` must exist."""
    import torch

    from fastdepth_tpu_torch.engine.aot import _prepare
    from fastdepth_tpu_torch.models import fastdepth_pruned

    model = fastdepth_pruned()
    params, apply = _prepare(model, model.init(torch.Generator().manual_seed(0)),
                             batch_size=ENTRY_BATCH, dtype=torch.float32, fold_bn=True,
                             impl="xla", device=device)

    def forward(params, rgb):
        with torch.inference_mode():
            return apply(params, rgb)

    rgb = torch.zeros((ENTRY_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=torch.float32,
                      device=device)
    return forward, (params, rgb)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """A data-parallel train step over an n-device mesh, then two eval
    surfaces, as ``__graft_entry__.py``'s dry run: two steps of the real
    flagship at 224x224, batch max(8, n), with remat; the DP-sharded
    Evaluator's metric rows against one device's (rtol 1e-5, atol 1e-6
    over the finite entries, whose places must agree); when n divides by
    4, the Evaluator over the 2-D ``make_mesh_2d(n // 4, 4)`` (data,
    space) mesh, the image height sharded four ways, against the same;
    and a device-augment train step of a tiny model sharded over
    ``data``.  ``space`` is inference-only: the Trainer refuses it.

    One rank a device (``parallel/distributed.launch``): NCCL on cards,
    gloo with ``device='cpu'``; fewer devices than ``n_devices`` exits
    naming how many there are.  Prints and returns the ``ok`` line;
    raises where a check fails."""
    from fastdepth_tpu_torch.parallel.distributed import launch

    got = launch(_dryrun_rank, argparse.Namespace(mesh_devices=n_devices, device=device))
    batch = got["batch"]
    m1, mN = got["m1"], got["mN"]
    fin = _same_finite(m1, mN, "sharded eval")
    np.testing.assert_allclose(mN[fin], m1[fin], rtol=METRIC_RTOL, atol=METRIC_ATOL)
    rel = np.abs(mN[fin] - m1[fin]) / (np.abs(m1[fin]) + 1e-9)
    rel_max = float(rel.max()) if rel.size else 0.0
    sp_note = "skipped (n_devices not divisible by 4)"
    if got["mS"] is not None:
        _same_finite(m1, got["mS"], "spatial eval")
        np.testing.assert_allclose(got["mS"][fin], m1[fin], rtol=METRIC_RTOL, atol=METRIC_ATOL)
        sp_note = f"== single-device over a {n_devices // 4}x4 (data, space) mesh too"
    if not np.isfinite(got["aug_loss"]):
        raise AssertionError(f"device-augment train step: loss {got['aug_loss']}")
    losses = got["losses"]
    msg = (f"dryrun_multichip({n_devices}) ok: FASTDEPTH_PRUNED@{IMAGE_SIZE} b{batch} "
           f"losses={losses[0]:.4f},{losses[1]:.4f}; sharded eval == "
           f"single-device across {m1.shape[0]} metrics x {batch} images "
           f"(max |rel diff| {rel_max:.2e} over {int(fin.sum())} finite "
           f"entries); spatial eval {sp_note}; device-augment train step "
           f"sharded over 'data' ok (loss {got['aug_loss']:.4f})")
    print(msg, flush=True)
    return msg


def _same_finite(want: np.ndarray, got: np.ndarray, what: str) -> np.ndarray:
    """The finite entries of ``want`` (random-weight predictions can make
    lg10 / irmse entries non-finite), which must be ``got``'s too."""
    fin = np.isfinite(want)
    if got.shape != want.shape or not np.array_equal(np.isfinite(got), fin):
        raise AssertionError(f"{what}: metric rows {got.shape} finite at other places than "
                             f"the single device's {want.shape}")
    return fin


def _dryrun_rank(args) -> dict:
    """One rank of :func:`dryrun_multichip` (every rank runs the same
    program on its rows; rank 0 also evaluates the whole batch on its one
    device).  Returns rank 0's numbers."""
    import torch
    import torch.distributed as dist

    from fastdepth_tpu_torch.engine import Evaluator
    from fastdepth_tpu_torch.models import build
    from fastdepth_tpu_torch.parallel.mesh import block_of, make_mesh, make_mesh_2d
    from fastdepth_tpu_torch.train import Trainer

    n = args.mesh_devices
    mesh = make_mesh(n)

    def rows(a: np.ndarray, m) -> torch.Tensor:
        """This rank's rows of a global batch (dim 0) on its device."""
        return block_of(torch.from_numpy(a), m).to(m.device)

    # the real flagship at the real resolution: a toy-width dry run would
    # not prove the production training path (remat keeps the activations
    # of the CPU ranks small)
    model = build(FASTDEPTH_PRUNED)
    trainer = Trainer(model, model.init(torch.Generator().manual_seed(0)), TrainConfig(lr=LR),
                      mesh=mesh, remat=True)
    rng = np.random.RandomState(0)
    batch = max(8, n)
    hw = (IMAGE_SIZE, IMAGE_SIZE)
    rgb = rng.rand(batch, *hw, 3).astype(np.float32)
    depth = (rng.rand(batch, *hw, 1) * 5 + 0.5).astype(np.float32)
    x, d = rows(rgb, mesh), rows(depth, mesh)
    losses = []
    for _ in range(2):  # two steps: the state's round trip too
        trainer.state, loss = trainer._step(trainer.state, x, d, LR)
        losses.append(float(loss))

    # the sharded Evaluator over the same mesh with the trained params
    eval_params = trainer.state.params
    rgb_h = rng.rand(batch, *hw, 3).astype(np.float32)
    depth_h = (rng.rand(batch, *hw, 1) * 5 + 0.5).astype(np.float32)

    def metrics(m):
        ev = Evaluator(model, eval_params, batch_size=batch, mesh=m)
        n_rows = batch // m.size
        lo = m.rank * n_rows
        rows_m = ev(ev.put(rgb_h[lo:lo + n_rows]), ev.put(depth_h[lo:lo + n_rows]))[1]
        return ev.fetch(rows_m, dim=1)

    mN = metrics(mesh)
    m1 = None
    if dist.get_rank() == 0:
        ev1 = Evaluator(model, eval_params, batch_size=batch, device=mesh.device)
        m1 = ev1(ev1.put(rgb_h), ev1.put(depth_h))[1].cpu().numpy()
    # the height sharded over a 2-D (data, space) mesh: the halo exchanges
    mS = metrics(make_mesh_2d(n // 4, 4)) if n % 4 == 0 else None

    # a device-augment train step over the mesh: raw frames and per-item
    # gather maps / jitter grids shard over 'data', the pixel pipeline
    # (data/device_aug.py) runs inside the step
    tmodel = build(TINY)
    taug = Trainer(tmodel, tmodel.init(torch.Generator().manual_seed(1)), TrainConfig(lr=LR),
                   mesh=mesh, device_augment=True)
    n_out = IMAGE_SIZE * IMAGE_SIZE
    raw = [
        rng.randint(0, 256, (batch, *RAW_HW, 3)).astype(np.uint8),
        (rng.rand(batch, *RAW_HW) * 5 + 0.5).astype(np.float32),
        rng.randint(-1, RAW_HW[0] * RAW_HW[1], (batch, n_out)).astype(np.int32),
        (rng.rand(batch) * 0.5 + 1.0).astype(np.float32),
        np.broadcast_to(np.arange(256, dtype=np.uint8)[None, None, None, :],
                        (batch, 3, 256, 256)).copy(),
        np.zeros((batch, 3), np.int32),
    ]
    taug.state, aug_loss = taug._step(taug.state, *[rows(a, mesh) for a in raw], LR)
    return {"batch": batch, "losses": losses, "m1": m1, "mN": mN, "mS": mS,
            "aug_loss": float(aug_loss)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["multichip"],
                    help="multichip: the dry run over N ranks; absent: the entry forward")
    ap.add_argument("n_devices", nargs="?", type=int, default=8, metavar="N")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.mode == "multichip":
        dryrun_multichip(args.n_devices, args.device)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("graft_entry: --device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    from fastdepth_tpu_torch.engine.benchmark import sync

    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    sync(args.device)
    print("entry ok:", tuple(out.shape), str(out.dtype).removeprefix("torch."))
    return 0


if __name__ == "__main__":
    sys.exit(main())
