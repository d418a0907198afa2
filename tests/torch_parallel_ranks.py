"""The rank side of ``tests/test_torch_parallel.py``, and what both sides
share.  Run as a script, ``python tests/torch_parallel_ranks.py OUT``
spawns two gloo ranks over a ``FileStore`` in OUT; each runs
:func:`scenarios` on its rows of the shared batches and pickles what it
got to ``OUT/rank{K}.pkl``.  The test imports this module for the same
model, batches and steps in one process.  (A rank function must unpickle
in a fresh interpreter: a module run by its path does, a test module
under pytest-xdist's import path is fragile.)"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fastdepth_tpu_torch import ModelConfig  # noqa: E402
from fastdepth_tpu_torch.config import TrainConfig  # noqa: E402
from fastdepth_tpu_torch.data.loader import BatchLoader, shard_rows  # noqa: E402
from fastdepth_tpu_torch.engine import Evaluator, validate  # noqa: E402
from fastdepth_tpu_torch.models import build  # noqa: E402
from fastdepth_tpu_torch.parallel.distributed import validate_distributed_batches  # noqa: E402
from fastdepth_tpu_torch.train.trainer import Trainer, make_train_step, sgd_init  # noqa: E402

WORLD = 2
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
MODEL = build(CFG)
BATCH, HW = 8, 32
LR, WD = 0.05, 1e-3
EVAL_ITEMS, EVAL_BATCH = 6, 4  # the second batch: 2 real rows, 2 of padding


def init(dtype=torch.float64):
    """The port's seeded init of the tiny model (the same on every rank)."""
    return MODEL.init(torch.Generator().manual_seed(0)).to(dtype)


def batch(dtype=np.float64):
    """One seeded global batch (NHWC).  Its depth holes fall unevenly over
    the two ranks' rows, so their valid-pixel counts differ: a loss
    averaged per rank would be another loss than the global one."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(BATCH, HW, HW, 3).astype(dtype)
    depth = (rng.rand(BATCH, HW, HW, 1) * 5 + 0.5).astype(dtype)
    depth[0, :4, :4, 0] = 0.0
    depth[5, :12] = 0.0
    return rgb, depth


def state_arrays(state) -> dict:
    """A train state's parameters, running statistics and momentum as
    numpy copies by state-dict key (momentum under ``momentum.``)."""
    out = {k: v.detach().cpu().numpy().copy() for k, v in state.params.state_dict().items()}
    out.update({"momentum." + k: v.cpu().numpy().copy() for k, v in state.momentum.items()})
    return out


def step(accum: int = 1, dtype=torch.float64, compute_dtype=None, mesh=None, rank=0):
    """One SGD step from :func:`init` on :func:`batch` (this rank's rows of
    it under ``mesh``, laid out by ``shard_rows``); (loss, state arrays)."""
    rgb, depth = batch()
    if mesh is not None:
        rows = shard_rows(BATCH, mesh.size, rank, accum)
        rgb, depth = rgb[rows], depth[rows]
    st = sgd_init(init(dtype))
    fn = make_train_step(MODEL, TrainConfig(lr=LR, weight_decay=WD), accum_steps=accum,
                         compute_dtype=compute_dtype, mesh=mesh)
    st, loss = fn(st, *(torch.from_numpy(a).to(dtype) for a in (rgb, depth)), LR)
    return float(loss), state_arrays(st)


class Frames:
    """``EVAL_ITEMS`` seeded (rgb, depth) items of HW x HW."""

    def __len__(self):
        return EVAL_ITEMS

    def __getitem__(self, i):
        rng = np.random.RandomState(100 + i)
        return (rng.rand(HW, HW, 3).astype(np.float32),
                (rng.rand(HW, HW, 1) * 5 + 0.5).astype(np.float32))


def evaluate(mesh=None, rank=0) -> dict:
    """validate() over :class:`Frames` at batch 4 (a padded tail batch),
    every rank loading its rows; the averaged metrics."""
    loader = BatchLoader(Frames(), batch_size=EVAL_BATCH, num_workers=1, pad_last=True,
                         num_shards=1 if mesh is None else mesh.size, shard_id=rank)
    ev = Evaluator(MODEL, init(torch.float32), batch_size=EVAL_BATCH, mesh=mesh,
                   device=None if mesh is not None else "cpu")
    r = validate(loader, ev, print_freq=0, make_images=False, log=lambda *a: None)
    return {f: getattr(r, f) for f in ("rmse", "mae", "delta1", "absrel", "lg10", "mse",
                                       "delta2", "delta3")}


def _error(fn) -> str:
    """The message of the ValueError or SystemExit ``fn`` raises ('' if none)."""
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return str(e)
    return ""


def scenarios(mesh, rank: int) -> dict:
    """What one rank of a two-rank gloo mesh computes, by scenario."""
    out = {f"f64_accum{k}": step(k, mesh=mesh, rank=rank) for k in (1, 2)}
    out["bf16"] = step(1, torch.float32, torch.bfloat16, mesh=mesh, rank=rank)[0]

    # a NaN in rank 1's rows only: every rank must skip the update
    rgb, depth = batch(np.float32)
    rows = shard_rows(BATCH, mesh.size, rank)
    rgb, depth = rgb[rows], depth[rows]
    if rank == 1:
        rgb[0, 0, 0, 0] = np.nan
    st = sgd_init(init(torch.float32))
    before = state_arrays(st)
    st, loss = make_train_step(MODEL, TrainConfig(lr=LR, weight_decay=WD), mesh=mesh)(
        st, torch.from_numpy(rgb), torch.from_numpy(depth), LR)
    after = state_arrays(st)
    out["nan"] = {"loss": float(loss), "step": int(st.step),
                  "unchanged": all(np.array_equal(before[k], after[k]) for k in before)}

    out["eval"] = evaluate(mesh, rank)

    # guards: a step built without the mesh, and a padded global batch
    out["guard_unmeshed"] = _error(lambda: make_train_step(MODEL, TrainConfig())(
        sgd_init(init(torch.float32)), torch.from_numpy(rgb), torch.from_numpy(depth), LR))

    class _Padded:
        def __iter__(self):  # 4 local rows a rank, 7 real rows in the global 8
            yield np.zeros((4, HW, HW, 3), np.float32), np.ones((4, HW, HW, 1), np.float32), 7

        def __len__(self):
            return 1

    trainer = Trainer(MODEL, init(torch.float32), TrainConfig(lr=LR), mesh=mesh)
    out["guard_padded"] = _error(lambda: trainer.run_epoch(_Padded(), 0, log=lambda *a: None))
    out["guard_batches"] = _error(lambda: validate_distributed_batches(
        True, WORLD, **{"--batch-size": 3}))
    return out


def _rank(rank: int, out_dir: str) -> None:
    from fastdepth_tpu_torch.parallel.mesh import make_mesh

    # a fresh interpreter: its share of the threads the parent was given
    torch.set_num_threads(max(1, torch.get_num_threads() // WORLD))
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(os.path.join(out_dir, "store"), WORLD))
    try:
        result = scenarios(make_mesh(WORLD), rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    torch.multiprocessing.start_processes(_rank, args=(sys.argv[1],), nprocs=WORLD,
                                          start_method="spawn")
