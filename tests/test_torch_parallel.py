"""The port's data parallelism (``fastdepth_tpu_torch/parallel``) on the
CPU, over gloo: the mesh and the distributed flags, the loader's
microbatch layout, a two-rank train step against the port's
single-process step and the JAX package's single-device step, a two-rank
Evaluator, the guards, and the two mesh CLIs against their runs without
a mesh.

The multi-rank jobs are processes of their own, started together once
for the module (the ``jobs`` fixture) while this process computes the
references:
- ``tests/torch_parallel_ranks.py``: two spawned ranks run every step,
  evaluation and guard scenario and pickle what they got;
- ``cli.train --device-augment`` then ``cli.evaluate``, each
  ``--mesh-devices 2 --device cpu`` (the CLI spawns its two ranks) over
  an h5 tree;
- ``parallel/dryrun.py``'s two ``--coord`` ranks over seeded frames.

The train step is compared in f64 (atol 1e-9, rtol 1e-7, the bound of
``tests/mesh_equiv_f64.py``): at random init the model's gradient is
ill-conditioned in f32 (``test_torch_train.py``'s docstring), so the f32
CLIs train at ``--lr 1e-5`` and are compared where f32 can agree, at
1e-5 relative, and their running statistics at 1e-4: the reference's
own F.batch_norm moments can be more than 1e-5 off f64 on one CPU
thread (``parallel/dryrun.py``'s docstring).
"""

import argparse
import json
import os
import re
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from fastdepth_tpu.checkpoint.io import flatten_tree
from fastdepth_tpu.config import TrainConfig as JaxTrainConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.train import trainer as JT

from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.data.loader import BatchLoader, shard_rows
from fastdepth_tpu_torch.parallel import distributed as D
from fastdepth_tpu_torch.parallel import dryrun as DR
from fastdepth_tpu_torch.parallel import mesh as M
from fastdepth_tpu_torch.train import Trainer

from test_cli_tools import _make_nyu_tree
from torch_port_config import to_jax
from torch_threads import child_env
import torch_parallel_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 300
# cli.train then cli.evaluate with --mesh-devices 2: each spawns two ranks.
# The train run augments on the device (each rank its rows of every
# device-augment array, the (B,) ones included): its items are bit for bit
# the host items of the run without a mesh it is compared with
CLI_JOB = """
import sys
from fastdepth_tpu_torch.cli import evaluate, train
from fastdepth_tpu_torch.parallel import dryrun as DR
root, out = sys.argv[1:]
train.main(DR.train_argv(root, out) + ["--mesh-devices", "2", "--device-augment"])
evaluate.main(DR.eval_argv(root, out) + ["--mesh-devices", "2"])
"""


def _wait(proc, what):
    try:
        log = proc.communicate(timeout=JOB_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"{what} failed ({proc.returncode}):\n{log[-4000:]}"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every multi-rank job of the module, started at once (module
    docstring); the fixtures below wait for the one they read."""
    base = tmp_path_factory.mktemp("parallel")
    env = child_env(PYTHONPATH=REPO)
    ranks = base / "ranks"
    ranks.mkdir()
    cli_root = str(base / "cli")
    for split, n in (("train", DR.N_TRAIN), ("val", DR.N_VAL)):
        _make_nyu_tree(os.path.join(cli_root, "nyudepthv2", split), np.random.RandomState(7), n)
    with open(os.path.join(cli_root, "tiny.json"), "w") as f:
        json.dump(DR.TINY_CFG, f)
    dry_root = str(base / "dry")
    DR.make_dataset(dry_root)
    procs = {
        "ranks": subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                                "torch_parallel_ranks.py"),
                                   str(ranks)], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True),
        "cli": subprocess.Popen([sys.executable, "-c", CLI_JOB, cli_root, str(base / "cli_mp")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, cwd=str(base)),
    }
    dry_procs = DR.start_ranks(dry_root, str(base / "dry_mp"))
    yield {"base": base, "procs": procs, "dry_procs": dry_procs, "cli_root": cli_root,
           "dry_root": dry_root}
    for p in [*procs.values(), *dry_procs]:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ranks(jobs):
    """Each rank's pickled scenario results (torch_parallel_ranks.py)."""
    _wait(jobs["procs"]["ranks"], "the two-rank scenario job")
    out = []
    for r in range(R.WORLD):
        with open(jobs["base"] / "ranks" / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_steps(jobs):
    """JAX's single-device f64 step (accum_steps 1 and 2) from the port's
    init on the same batch: {accum: (loss, flat state by JAX key)}.  Both
    compile at once, one thread each (~15 s of XLA each on the CPU),
    while the jobs (started first) run."""
    tree = params_to_jax(R.init().state_dict())
    rgb, depth = R.batch()

    def run(accum):
        with jax.enable_x64(True):
            fn = jax.jit(JT.make_train_step(jax_build(to_jax(R.CFG)),
                                            JaxTrainConfig(lr=R.LR, weight_decay=R.WD),
                                            accum_steps=accum))
            state = JT.sgd_init(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree))
            state, loss = fn(state, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(R.LR))
            flat = flatten_tree(jax.tree.map(np.asarray, state.params))
            flat.update({"momentum/" + k: v for k, v in
                         flatten_tree(jax.tree.map(np.asarray, state.momentum)).items()})
            return float(loss), flat

    with ThreadPoolExecutor(2) as pool:
        return dict(zip((1, 2), pool.map(run, (1, 2))))


def _jax_flat(arrays: dict) -> dict:
    """A :func:`torch_parallel_ranks.state_arrays` dict under JAX's flat keys."""
    params = {k: torch.from_numpy(v) for k, v in arrays.items() if not k.startswith("momentum.")}
    mom = {k[len("momentum."):]: torch.from_numpy(v) for k, v in arrays.items()
           if k.startswith("momentum.")}
    flat = flatten_tree(params_to_jax(params))
    flat.update({"momentum/" + k: v for k, v in flatten_tree(params_to_jax(mom)).items()})
    return flat


def _assert_f64_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=1e-7, err_msg=k)


# --- a two-rank train step, evaluation and guards -----------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("reference", ["port_single_process", "jax_single_device"])
def test_two_rank_f64_step_equals_the_single_device_step(accum, reference, jax_steps, ranks):
    """Rank 0's parameters, momentum and running statistics after one f64
    step on its rows (its share of each microbatch under accum_steps 2)
    equal one step on the whole batch in one process: the port's, and the
    JAX package's single-device step (atol 1e-9, rtol 1e-7)."""
    loss, arrays = ranks[0][f"f64_accum{accum}"]
    if reference == "port_single_process":
        want_loss, want = R.step(accum)
        got = arrays
    else:
        want_loss, want = jax_steps[accum]
        got = _jax_flat(arrays)
    np.testing.assert_allclose(loss, want_loss, atol=1e-9, rtol=1e-7)
    _assert_f64_close(got, want)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_replicas_stay_bit_equal(accum, ranks):
    (l0, a0), (l1, a1) = ranks[0][f"f64_accum{accum}"], ranks[1][f"f64_accum{accum}"]
    assert l0 == l1
    assert a0.keys() == a1.keys()
    for k in a0:
        assert np.array_equal(a0[k], a1[k]), k


def test_two_rank_bf16_step_loss_matches_the_single_process_step(ranks):
    """The bound of tests/test_train.py's bf16 step: rtol 3e-3."""
    want = R.step(1, torch.float32, torch.bfloat16)[0]
    for r in ranks:
        np.testing.assert_allclose(r["bf16"], want, rtol=3e-3)


def test_nan_on_one_rank_skips_the_step_on_every_rank(ranks):
    for r in ranks:
        assert np.isnan(r["nan"]["loss"]) and r["nan"]["step"] == 1
        assert r["nan"]["unchanged"], "a rank applied a step that another rank's NaN poisoned"


def test_two_rank_evaluator_over_a_padded_tail_matches_one_process(ranks):
    """validate() over 6 frames at global batch 4: rank 1's rows of the
    tail batch are all padding.  Every rank reports the global means,
    within rtol 1e-5 of one process (tests/test_eval_e2e.py's bound)."""
    want = R.evaluate()
    for r in ranks:
        assert r["eval"].keys() == want.keys()
        for f, v in want.items():
            np.testing.assert_allclose(r["eval"][f], v, rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("guard, message", [
    ("guard_unmeshed", "built without a mesh inside a process group of 2 ranks"),
    ("guard_padded", "padded batch .7 real rows in a global batch of 8"),
    ("guard_batches", "--batch-size 3 must divide by the process count 2"),
])
def test_two_rank_guards(guard, message, ranks):
    for r in ranks:
        assert re.search(message, r[guard]), r[guard]


# --- the CLIs: spawned ranks (--mesh-devices 2) and --coord ranks (dryrun) ---

@pytest.fixture(scope="module")
def cli_report(jobs):
    """cli.train + cli.evaluate without a mesh here, against the spawned
    --mesh-devices 2 job, by parallel/dryrun.compare."""
    sp = str(jobs["base"] / "cli_sp")
    from fastdepth_tpu_torch.cli import evaluate as eval_cli
    from fastdepth_tpu_torch.cli import train as train_cli

    train_cli.main(DR.train_argv(jobs["cli_root"], sp))
    eval_cli.main(DR.eval_argv(jobs["cli_root"], sp))
    _wait(jobs["procs"]["cli"], "cli.train / cli.evaluate --mesh-devices 2")
    return DR.compare(sp, str(jobs["base"] / "cli_mp"))


@pytest.fixture(scope="module")
def dryrun_reports(jobs):
    """parallel/dryrun.py: its single-process reference here, and an
    in-process --mesh-devices 1 run (a group of one), against its two
    --coord ranks."""
    root, base = jobs["dry_root"], jobs["base"]
    DR.run_both(root, str(base / "dry_sp"))
    DR.run_both(root, str(base / "dry_m1"), ["--mesh-devices", "1"], ["--mesh-devices", "1"])
    DR.wait_ranks(jobs["dry_procs"])
    return {"coord": DR.compare(str(base / "dry_sp"), str(base / "dry_mp")),
            "mesh1": DR.compare(str(base / "dry_sp"), str(base / "dry_m1"))}


CHECKS = ["train_loss_max_rel_diff", "val_metrics_max_rel_diff",
          "model_best.npz_params_max_rel_diff", "model_best.npz_stats_max_rel_diff",
          "checkpoint.npz_params_max_rel_diff", "checkpoint.npz_stats_max_rel_diff",
          "eval_cli_max_rel_diff"]


def _assert_check(report, check):
    checks = report["checks"]
    assert checks["train_csv_rows"] and checks["test_csv_rows"]
    assert checks["best_config_equal"] and checks["best_epoch_equal"]
    assert checks["model_best.npz_same_leaves"] and checks["checkpoint.npz_same_leaves"]
    assert checks[check] <= DR.bound(check), checks


@pytest.mark.parametrize("check", CHECKS)
def test_spawned_mesh_clis_match_their_runs_without_a_mesh(check, cli_report):
    _assert_check(cli_report, check)


@pytest.mark.parametrize("check", CHECKS)
def test_coord_dryrun_matches_the_single_process_run(check, dryrun_reports):
    _assert_check(dryrun_reports["coord"], check)


@pytest.mark.parametrize("check", CHECKS)
def test_mesh_devices_1_in_process_matches_no_mesh(check, dryrun_reports):
    _assert_check(dryrun_reports["mesh1"], check)


# --- the mesh and the flags ---------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("call, error, message", [
    (lambda: M.make_mesh(1), RuntimeError, "needs a torch.distributed process group"),
    (lambda: M.make_mesh(1, "model"), ValueError, "carry neither 'data' nor 'space'"),
    (lambda: M.make_mesh(2, "space"), NotImplementedError, "ROADMAP A12b"),
    (lambda: M.make_mesh_2d(2, 4), NotImplementedError, "ROADMAP A12b"),
    (lambda: M.mesh_from_cli(None, 4), SystemExit, "ROADMAP A12b"),
    (lambda: M.mesh_from_cli(2, None, batch_size=3), SystemExit,
     "--batch-size 3 must divide by --mesh-devices 2"),
])
def test_mesh_refusals(call, error, message):
    with pytest.raises(error, match=message):
        call()


def test_make_mesh_over_a_group_of_one(world1):
    mesh = M.make_mesh()
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
    assert mesh.device == torch.device("cpu") and mesh.rank == 0
    with pytest.raises(ValueError, match="need 2 devices for the mesh, have 1"):
        M.make_mesh(2)
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(M.fetch_global(M.put_sharded(x, mesh), mesh), x)
    np.testing.assert_array_equal(M.fetch_global(M.put_replicated(torch.ones(2), mesh)),
                                  np.ones(2))


def _dist_args(argv):
    p = argparse.ArgumentParser()
    D.add_distributed_args(p)
    p.add_argument("--mesh-devices", type=int, default=None)
    p.add_argument("--device", default="cpu")
    return p.parse_args(argv)


@pytest.mark.parametrize("argv, message", [
    (["--num-processes", "2", "--process-id", "0"], "--coord"),
    (["--coord", "h:1", "--num-processes", "2"], "pair"),
    (["--coord", "h:1", "--num-processes", "2", "--process-id", "2"], "out of range"),
    (["--coord", "h:1", "--num-processes", "1", "--process-id", "0"], ">= 2"),
    (["--coord", "h:1"], "no pod auto-detection"),
    (["--coord", "h:1", "--num-processes", "2", "--process-id", "0", "--mesh-devices", "4"],
     "--mesh-devices 4 must equal --num-processes 2"),
])
def test_distributed_flag_validation(argv, message, monkeypatch):
    """The JAX package's cases (tests/test_multiprocess.py) and the port's
    one-rank-a-device rule: SystemExit before any connection."""
    for var in ("FDTPU_COORD", "FDTPU_NUM_PROCESSES", "FDTPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=message):
        D.init_distributed(_dist_args(argv))


def test_no_distributed_flag_is_single_process(monkeypatch):
    for var in ("FDTPU_COORD", "FDTPU_NUM_PROCESSES", "FDTPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    args = _dist_args([])
    assert D.init_distributed(args) is False
    assert D.launch(lambda a: "ran", args) == "ran"
    assert (D.process_count(), D.process_index(), D.is_primary()) == (1, 0, True)
    assert D.shard_kwargs() == {"num_shards": 1, "shard_id": 0, "microbatches": 1}
    with pytest.raises(SystemExit, match="needs --mesh-devices"):
        D.validate_distributed_batches(True, None, **{"--batch-size": 8})
    D.validate_distributed_batches(False, None, **{"--batch-size": 3})


@pytest.mark.parametrize("device, n", [("cuda", 2), ("cpu", 10 ** 6)])
def test_a_mesh_larger_than_the_host_exits_up_front(device, n, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    have = 1 if device == "cuda" else os.cpu_count()
    with pytest.raises(SystemExit, match=f"need {n} devices for the mesh, have {have}"):
        D.launch(lambda a: pytest.fail("ran"), _dist_args(["--mesh-devices", str(n),
                                                            "--device", device]))


# --- the microbatch layout ------------------------------------------------------

@pytest.mark.parametrize("world, accum", [(2, 1), (2, 2), (4, 2), (2, 4)])
def test_shard_rows_reassemble_the_global_microbatches(world, accum):
    """Microbatch i is the global rows [i*mb, (i+1)*mb): each rank's i-th
    chunk of its rows, in rank order (the JAX mesh step's P(None, 'data'))."""
    n = 16
    mb, k = n // accum, n // accum // world
    rows = [shard_rows(n, world, r, accum) for r in range(world)]
    assert sorted(np.concatenate(rows)) == list(range(n))
    for i in range(accum):
        got = np.concatenate([r[i * k:(i + 1) * k] for r in rows])
        np.testing.assert_array_equal(got, np.arange(i * mb, (i + 1) * mb))


def test_loader_feeds_each_rank_its_microbatch_rows():
    class DS:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return np.full((2, 2, 3), i, np.float32), np.full((2, 2, 1), i, np.float32)

    kw = dict(batch_size=8, shuffle=True, seed=3, num_workers=2, drop_last=True,
              pad_last=False)
    ref = BatchLoader(DS(), **kw)
    shards = [BatchLoader(DS(), num_shards=2, shard_id=r, microbatches=2, **kw) for r in (0, 1)]
    for ld in (ref, *shards):
        ld.set_epoch(1)
    got = [list(ld) for ld in shards]
    for b, (rgb, _, count) in enumerate(ref):
        assert all(g[b][2] == count == 8 for g in got)
        for r in (0, 1):
            np.testing.assert_array_equal(got[r][b][0], rgb[shard_rows(8, 2, r, 2)])
    with pytest.raises(ValueError, match="must divide by the data-axis size 4"):
        shard_rows(8, 4, 0, 4)
    with pytest.raises(ValueError, match="needs drop_last=True"):
        BatchLoader(DS(), batch_size=8, microbatches=2)


# --- a group of one in this process, the refusals that stay -------------------

def test_mesh_of_one_trains_and_evaluates_as_no_mesh(world1):
    """The card's path at world size 1: the same collectives, and in f32
    what a forward fixes (module docstring) near the step without a mesh
    (merged per-rank moments against one F.batch_norm): the loss within
    rtol 1e-5, the running statistics within 1e-4 (the dryrun's bound);
    the metric rows 0 apart."""
    mesh = M.make_mesh(1)
    loss_m, arrays_m = R.step(1, torch.float32, mesh=mesh)
    loss_1, arrays_1 = R.step(1, torch.float32)
    np.testing.assert_allclose(loss_m, loss_1, rtol=1e-5)
    stats = [k for k in arrays_1 if k.endswith((".bn.mean", ".bn.var"))
             and not k.startswith("momentum.")]
    assert stats
    for k in stats:
        np.testing.assert_allclose(arrays_m[k], arrays_1[k], atol=DR.STATS_TOLERANCE,
                                   rtol=DR.STATS_TOLERANCE, err_msg=k)
    assert R.evaluate(mesh) == R.evaluate()


def test_trainer_refuses_a_space_mesh():
    """The port's copy of tests/test_spatial.py's refusal: a mesh with a
    'space' axis (the port cannot build one yet: ROADMAP A12b) is refused
    for training with the JAX package's reason."""
    mesh = M.Mesh(("data", "space"), None, torch.device("cpu"))
    with pytest.raises(ValueError, match="'space' mesh axis"):
        Trainer(R.MODEL, R.init(torch.float32), TrainConfig(lr=0.05), mesh=mesh)


@pytest.mark.parametrize("flags, message", [
    (["--mesh-spatial", "2"], "ROADMAP A12b"),
    (["--impl", "mixed"], "ROADMAP A14"),
    (["--tuning", "tuning/h100.json"], "ROADMAP A14"),
    (["--mesh-devices", "3"], "--batch-size 8 must divide by --mesh-devices 3"),
])
def test_evaluate_cli_refusals(flags, message, tmp_path):
    from fastdepth_tpu_torch.cli import evaluate as eval_cli

    with pytest.raises(SystemExit, match=message):
        eval_cli.main(["--evaluate", str(tmp_path / "none.npz"), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags, message", [
    (["--mesh-devices", "3"], "--batch-size 8 must divide by --mesh-devices 3"),
    (["--mesh-devices", "2", "--eval-batch-size", "3"],
     "--eval-batch-size 3 must divide by --mesh-devices 2"),
    (["--mesh-devices", "4", "--accum-steps", "4"],
     "microbatch size 2 .* must divide by --mesh-devices 4"),
])
def test_train_cli_mesh_flag_checks(flags, message, tmp_path):
    from fastdepth_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--data-root", str(tmp_path), "--device", "cpu", *flags])


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_every_jax_cli_flag_parses_in_the_port(cli, monkeypatch):
    """No flag (nor choice) of the JAX CLI fails with an argparse error in
    the port's: refused flags are parsed, then refused by name."""
    import importlib

    parsers = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        parsers.append(self)
        return parse(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    argv = ["--evaluate", "x"] if cli == "evaluate" else []
    for package in ("fastdepth_tpu", "fastdepth_tpu_torch"):
        importlib.import_module(f"{package}.cli.{cli}").parse_args(argv)
    jax_p, port_p = parsers
    port = {s: a for a in port_p._actions for s in a.option_strings}
    for action in jax_p._actions:
        for s in action.option_strings:
            assert s in port, s
            if action.choices:
                assert set(action.choices) <= set(port[s].choices), s
