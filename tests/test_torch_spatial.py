"""The port's ``space`` mesh axis (``fastdepth_tpu_torch/parallel/spatial.py``
and ``parallel/mesh.py``) and serving over a mesh, on the CPU over gloo —
the port's counterpart of ``tests/test_spatial.py``:

- the row partition and K1's row window, in plain versions, without
  ranks;
- the height-sharded fused, opt and straight forwards of the MobileNet +
  NNConv family at S = 2 and 4 (two and four spawned ranks,
  ``tests/torch_spatial_ranks.py``) against the port's single-process
  forward (f64 atol 1e-9, the fused one through K1's and K4's plain
  versions; f32, through the kernels' wrappers, atol 1e-5) and against
  JAX's jitted forward on ``make_mesh(S, 'space')`` (the conftest's
  virtual CPU devices; f32 atol 1e-4);
- the Evaluator over ``make_mesh_2d(2, 2)`` against JAX's Evaluator on
  ``make_mesh_2d(2, 2)`` and against the port without a mesh (rtol 1e-5,
  atol 1e-6, tests/test_spatial.py's bound);
- the mesh servers (``data`` = 2, ``space`` = 2 with and without chain,
  2 x 2) against the single-process prediction (atol 1e-5,
  tests/test_server.py's), their refusals, and a follower that dies;
- the pruned flagship at full width under the space dryrun's helpers
  (``parallel/dryrun.py``), run by the same ranks;
- a world-1 ``space`` mesh in this process: the forwards and the
  Evaluator bit for bit the runs without a mesh (what the card runs);
- ``cli.evaluate --mesh-devices 2 --mesh-spatial 2 --device cpu`` against
  the run without a mesh (rtol 1e-5, tests/test_eval_e2e.py's);
- the rest of the zoo refused under ``space``, naming ROADMAP A12c.

The spawned jobs start together once for the module (the ``jobs``
fixture) while this process computes the references.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from fastdepth_tpu.engine import Evaluator as JaxEvaluator
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.parallel import make_mesh as jax_make_mesh
from fastdepth_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from fastdepth_tpu.parallel import replicate, shard_activations
from fastdepth_tpu.parallel.mesh import put_replicated as jax_put_replicated
from fastdepth_tpu.parallel.mesh import put_sharded as jax_put_sharded

from fastdepth_tpu_torch.checkpoint import params_to_jax, save_checkpoint
from fastdepth_tpu_torch.engine import Evaluator
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.metrics import METRIC_FIELDS
from fastdepth_tpu_torch.models import from_name
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
from fastdepth_tpu_torch.parallel import dryrun as DR
from fastdepth_tpu_torch.parallel import mesh as M
from fastdepth_tpu_torch.parallel import spatial as S

from test_cli_tools import _make_nyu_tree
from torch_port_config import to_jax
from torch_threads import child_env
import torch_spatial_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 300
F64_ATOL, F32_ATOL, JAX_ATOL = 1e-9, 1e-5, 1e-4
# cli.evaluate on a tiny checkpoint over an h5 tree: without a mesh, then
# --mesh-devices 2 --mesh-spatial 2 (four spawned ranks), then the same
# with --device-preprocess (whole raw frames, each rank gathering its
# rows of the 224-row output)
CLI_JOB = """
import pickle, sys
from fastdepth_tpu_torch.cli import evaluate
ckpt, root, out = sys.argv[1:]
base = ["--evaluate", ckpt, "--data-root", root, "--batch-size", "2", "--print-freq", "0",
        "--no-images", "--workers", "1", "--device", "cpu"]
mesh = ["--mesh-devices", "2", "--mesh-spatial", "2"]
runs = {"plain": evaluate.main(base), "mesh": evaluate.main(base + mesh),
        "device_preprocess": evaluate.main(base + ["--device-preprocess"] + mesh)}
with open(out, "wb") as f:
    pickle.dump({k: v.as_dict() for k, v in runs.items()}, f)
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
    """Every spawned job of the module, started at once: the two- and
    the four-rank scenario runs, and the CLI job."""
    base = tmp_path_factory.mktemp("spatial")
    env = child_env(PYTHONPATH=REPO)
    procs = {}
    for world in (2, 4):
        out = base / f"w{world}"
        out.mkdir()
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_spatial_ranks.py"), str(world),
             str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    root = base / "cli"
    _make_nyu_tree(str(root / "nyudepthv2" / "val"), np.random.RandomState(7), 4)
    ckpt = str(base / "tiny.npz")
    save_checkpoint(ckpt, params_to_jax(R.init().state_dict()), R.CFGS["skipadd"])
    procs["cli"] = subprocess.Popen(
        [sys.executable, "-c", CLI_JOB, ckpt, str(root), str(base / "cli.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(base))
    yield {"base": base, "procs": procs}
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _result(jobs, key, path):
    _wait(jobs["procs"][key], f"the {key} job")
    with open(jobs["base"] / path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(jobs):
    """Rank 0's gathered results of each world: {2: ..., 4: ...}."""
    return {w: _result(jobs, w, f"w{w}/result.pkl") for w in (2, 4)}


@pytest.fixture(scope="module")
def cli_runs(jobs):
    return _result(jobs, "cli", "cli.pkl")


# --- the row partition and K1's window, without ranks -----------------------

LEVELS_224 = (224, 112, 56, 28, 14, 7)
LEVELS_64 = (64, 32, 16, 8, 4, 2)


@pytest.mark.parametrize("levels, replicated", [
    (LEVELS_224, {2: {7}, 4: {14, 7}, 8: {28, 14, 7}}),
    (LEVELS_64, {2: {2}, 4: {4, 2}, 8: {8, 4, 2}}),
], ids=["224", "64"])
@pytest.mark.parametrize("n_space", [2, 4, 8])
def test_every_level_is_covered_once(levels, replicated, n_space):
    """Each level's shards cover its rows exactly once (a replicated
    level: every rank all of them); the replicated levels are the deep
    ones the rule names (224^2: 7 at S = 2, 28 and below at S = 8)."""
    parts = [S.Partition(n_space, s) for s in range(n_space)]
    got = set()
    for rows in levels:
        bounds = [p.bounds(rows) for p in parts]
        if parts[0].sharded(rows):
            covered = [r for lo, hi in bounds for r in range(lo, hi)]
            assert covered == list(range(rows)), rows
            assert all(hi - lo >= S.MIN_ROWS for lo, hi in bounds)
        else:
            got.add(rows)
            assert bounds == [(0, rows)] * n_space
    assert got == replicated[n_space]


def _stage_operands(h, c=12, cout=8, n=2, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, dtype=torch.float64) * scale).to(dtype)

    x = rnd(n, c, h, h).contiguous(memory_format=torch.channels_last)
    weights = (rnd(25, c, scale=0.2), rnd(c, scale=0.1), rnd(c, cout, scale=c ** -0.5),
               rnd(cout, scale=0.1))
    skip = rnd(n, cout, 2 * h, 2 * h).contiguous(memory_format=torch.channels_last)
    return x, weights, skip


def _tile(x, r0, r1):
    """Rows ``[r0, r1)`` of ``x``, zero outside it."""
    n, c, h, w = x.shape
    t = x.new_zeros((n, c, r1 - r0, w))
    lo, hi = max(r0, 0), min(r1, h)
    t[:, :, lo - r0:hi - r0] = x[:, :, lo:hi]
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-12), (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("h, n_space", [(7, 2), (14, 2), (28, 4), (14, 4), (56, 8), (28, 8),
                                        (112, 8)])
def test_k1_window_equals_the_whole_stage_sliced(h, n_space, dtype, atol):
    """K1's plain version in row-window mode, at every rank's tile and
    window of the level, equals the whole-image stage sliced to the
    window (the skip sliced likewise): in f32 within 1e-6, in f64 within
    1e-12 (the CPU's convolution adds a cropped tile in another order:
    about 1e-15 apart).  Odd windows included (7 -> 14 rows at S = 2:
    [0, 7) and [7, 14))."""
    x, w, skip = _stage_operands(h, dtype=dtype)
    whole = K1.fused_decoder_stage_reference(x, *w, skip)
    # the wrapper (its plain version here) takes f32 and bf16 only
    stage = K1.fused_decoder_stage_reference if dtype == torch.float64 else K1.fused_decoder_stage
    tiles = S.k1_tiles(h, n_space)
    assert len(tiles) == n_space
    for (r0, r1), window in tiles:
        o0, o1 = window[2:]
        sk = skip[:, :, o0:o1].contiguous(memory_format=torch.channels_last)
        got = stage(_tile(x, r0, r1), *w, sk, window=window)
        assert got.shape == (x.shape[0], w[3].shape[0], o1 - o0, 2 * h)
        np.testing.assert_allclose(got.numpy(), whole[:, :, o0:o1].numpy(), rtol=0, atol=atol)


def test_k1_whole_image_window_is_the_call_without_one():
    x, w, skip = _stage_operands(14, dtype=torch.float32)
    want = K1.fused_decoder_stage(x, *w, skip)
    assert torch.equal(K1.fused_decoder_stage(x, *w, skip, window=(0, 14, 0, 28)), want)


@pytest.mark.parametrize("window, message", [
    ((0, 14, 0, 29), "not inside the 28-row map"),
    ((2, 14, 0, 14), r"the tile holds \[2, 10\)"),
    ((4, 14, 14, 28), r"read image rows \[5, 14\)"),
])
def test_k1_window_refusals(window, message):
    x, w, _ = _stage_operands(14, dtype=torch.float32)
    with pytest.raises(ValueError, match=message):
        K1.fused_decoder_stage(x[:, :, :8].contiguous(memory_format=torch.channels_last), *w,
                               window=window)


# --- the height-sharded forwards ---------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name, impl, dtype", R.FORWARDS,
                         ids=[f"{n}-{i}-{str(d)[6:]}" for n, i, d in R.FORWARDS])
def test_sharded_forward_matches_the_single_process_forward(ranks, world, name, impl, dtype):
    """S = world ranks' gathered forward against the port's forward of
    the whole image in one process (f64 1e-9; f32 1e-5).  At 64^2 and
    S = 4 the 4- and 2-row levels run replicated (the partition test)."""
    got = ranks[world]["forwards"][(name, impl, str(dtype))]
    want = R.forward(name, impl, dtype, R.rgb()).numpy()
    assert got.shape == want.shape == (R.FWD_BATCH, R.HW, R.HW, 1)
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F64_ATOL if dtype == torch.float64 else F32_ATOL)


@pytest.fixture(scope="module")
def jax_space_forwards(jobs):
    """JAX's jitted straight forward of the skip-add model on
    ``make_mesh(S, 'space')`` for S = 2, 4, the same numpy params (the
    port's init through ``params_to_jax``), f32: {S: NHWC array}."""
    model = jax_build(to_jax(R.CFGS["skipadd"]))
    tree = jax.tree.map(jnp.asarray, params_to_jax(R.init().state_dict()))
    x = jnp.asarray(R.rgb(dtype=np.float32))
    out = {}
    for n_space in (2, 4):
        mesh = jax_make_mesh(n_space, "space")
        f = jax.jit(model.apply,
                    in_shardings=(jax.tree.map(lambda _: replicate(mesh), tree),
                                  shard_activations(mesh)),
                    out_shardings=shard_activations(mesh))
        out[n_space] = np.asarray(f(jax_put_replicated(tree, mesh), jax_put_sharded(x, mesh)))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl", ["fused", "mixed", "opt", "xla"])
def test_sharded_forward_matches_jax_on_a_space_mesh(ranks, jax_space_forwards, world, impl):
    got = ranks[world]["forwards"][("skipadd", impl, str(torch.float32))]
    np.testing.assert_allclose(got, jax_space_forwards[world], rtol=0, atol=JAX_ATOL)


# --- the Evaluator over a 2 x 2 mesh -------------------------------------------

@pytest.fixture(scope="module")
def jax_eval_2d(jobs):
    """JAX's Evaluator on ``make_mesh_2d(2, 2)`` (unfolded, as
    tests/test_spatial.py runs it) over the same batch and params."""
    model = jax_build(to_jax(R.CFGS["skipadd"]))
    tree = jax.tree.map(jnp.asarray, params_to_jax(R.init().state_dict()))
    x, d = R.eval_batch()
    ev = JaxEvaluator(model, tree, batch_size=R.EVAL_BATCH, fold_bn=False,
                      mesh=jax_make_mesh_2d(2, 2))
    return np.asarray(ev(ev.put(x), ev.put(d))[1])


def _port_eval(**kw):
    x, d = R.eval_batch()
    ev = Evaluator(R.MODELS["skipadd"], R.init(), batch_size=R.EVAL_BATCH, device="cpu", **kw)
    return ev(ev.put(x), ev.put(d))[1].numpy()


@pytest.mark.parametrize("key, kw", [("eval_straight", {"fold_bn": False}), ("eval_fused", {})],
                         ids=["straight", "fused"])
def test_evaluator_2d_mesh_matches_no_mesh_and_jax(ranks, jax_eval_2d, key, kw):
    got = ranks[4][key]
    for want in (_port_eval(**kw), jax_eval_2d):
        fin = np.isfinite(want)
        assert fin.any() and np.array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


def test_meshes_have_their_shapes(ranks):
    assert ranks[2]["shape"] == ({"space": 2}, {"data": 2})
    assert ranks[4]["shape"] == ({"space": 4}, {"data": 2, "space": 2})


# --- the mesh servers -----------------------------------------------------------

@pytest.mark.parametrize("world, key", [(2, "serve_data"), (2, "serve_space"),
                                        (2, "serve_space_chain"), (4, "serve_2d")])
def test_mesh_server_answers_the_single_process_prediction(ranks, world, key):
    """Every answer of the mesh server (data 2, space 2, chain over
    space only, 2 x 2) equals the single-process prediction within 1e-5
    (tests/test_server.py's bound); 5 frames at batch 2 pad a tail."""
    preds = ranks[world][key]
    want = R.forward("skipadd", "xla", torch.float32, np.stack(R.frames())).numpy()
    assert len(preds) == R.SERVE_FRAMES
    for got, ref in zip(preds, want):
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("key, message", [
    ("refuse_chain_data", "a 'data' mesh axis would shard the scan axis"),
    ("refuse_batch", "batch_size 3 must divide by the mesh's 2-way 'data' axis"),
    ("refuse_height", "image height 65 must divide by the mesh's 2-way 'space' axis"),
])
def test_mesh_server_refusals(ranks, key, message):
    """JAX's checks on a real mesh: chain with a data axis (its message),
    the batch against the data axis, the height against the space axis."""
    assert message in ranks[2][key]


def test_mesh_server_goes_down_when_a_follower_dies(ranks):
    """A follower rank that exits: rank 0's next batch fails its future
    with the collective's error and sets ``failed`` (the serve CLI then
    exits non-zero), well inside the group's timeout."""
    got = ranks[2]["follower_dies"]
    assert got["error"] and got["failed"]
    assert got["seconds"] < R.GROUP_TIMEOUT_S


def test_flagship_space_dryrun_helpers(ranks):
    """The pruned flagship at 224^2 with the trained weights through the
    dryrun's helpers on the same ranks: S = 2 forward (b1) within
    ``DR.SPACE_ATOL`` of one process; the 2 x 2 Evaluator's means within
    1e-5 relative and its delta fractions within ``DR.DELTA_PIXELS``
    pixels (the dryrun's docstring)."""
    model, params = DR.flagship()
    x, rgb, depth = DR.space_inputs()
    np.testing.assert_allclose(ranks[2]["dryrun_forward"], DR.space_forward(model, params, x),
                               rtol=0, atol=DR.SPACE_ATOL)
    want = DR.space_eval(model, params, rgb, depth)
    got = ranks[4]["dryrun_eval"]
    delta = np.array([f.startswith("delta") for f in METRIC_FIELDS])
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[~delta][fin[~delta]], want[~delta][fin[~delta]], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[delta], want[delta], rtol=0,
                               atol=DR.DELTA_PIXELS / 224 ** 2 + 1e-7)


# --- a world-1 space mesh in this process ----------------------------------------

@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    yield
    dist.destroy_process_group()


def test_world1_space_meshes_are_the_runs_without_a_mesh(world1):
    """What the card runs (one rank): ``make_mesh(1, 'space')`` and
    ``make_mesh_2d(1, 1)`` give every forward and the Evaluator's metric
    rows bit for bit as without a mesh, every collective issued."""
    for mesh in (M.make_mesh(1, "space"), M.make_mesh_2d(1, 1)):
        assert mesh.partition().size == 1 and mesh.space_rank == 0
        for name, impl, dtype in R.FORWARDS:
            got = R.forward(name, impl, dtype, M.put_sharded(R.rgb(), mesh),
                            space=mesh.partition())
            assert torch.equal(got, R.forward(name, impl, dtype, R.rgb())), (name, impl)
        x, d = R.eval_batch()
        ev = Evaluator(R.MODELS["skipadd"], R.init(), batch_size=R.EVAL_BATCH, mesh=mesh)
        got = ev.fetch(ev(ev.put(x), ev.put(d))[1], dim=1)
        np.testing.assert_array_equal(got, _port_eval())
    assert M.make_mesh_2d(1, 1).shape == {"data": 1, "space": 1}


def test_put_and_fetch_split_and_join_the_height(world1):
    mesh = M.make_mesh(1, "space")
    x = np.arange(2 * 4 * 3 * 1.0).reshape(2, 4, 3, 1)
    np.testing.assert_array_equal(M.fetch_global(M.put_sharded(x, mesh), mesh, 0, 1), x)
    part = S.Partition(2, 1)
    np.testing.assert_array_equal(M.take_rows(torch.from_numpy(x), part, 1).numpy(), x[:, 2:])


# --- the CLIs and the rest of the zoo ---------------------------------------------

@pytest.mark.parametrize("run", ["mesh", "device_preprocess"])
def test_evaluate_cli_mesh_spatial_matches_no_mesh(cli_runs, run):
    """``cli.evaluate --mesh-devices 2 --mesh-spatial 2 --device cpu``
    (four spawned ranks), with and without --device-preprocess, against
    the run without a mesh: every averaged metric within rtol 1e-5
    (tests/test_eval_e2e.py's bound)."""
    plain, got = cli_runs["plain"], cli_runs[run]
    for f in METRIC_FIELDS:
        np.testing.assert_allclose(got[f], plain[f], rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", [
    "resnet18-nnconv5dw-skipadd", "resnet50-upproj", "mobilenet-deconv3", "mobilenet-upconv",
    "mobilenet-blconv5dw", "mobilenet-shuffle5", "mobilenet-nnconv7dw",
])
def test_the_rest_of_the_zoo_is_refused_under_space_naming_a12c(name):
    model = from_name(name)
    part = S.Partition(2, 0)
    with pytest.raises(ValueError, match="ROADMAP A12c"):
        _pick_apply(model, None, "auto", space=part)
    with pytest.raises(ValueError, match="ROADMAP A12c"):
        model.apply(None, torch.zeros(1, 64, 64, 3), space=part)

