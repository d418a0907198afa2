"""The rank side of ``tests/test_torch_spatial.py``, and what both sides
share.  Run as a script, ``python tests/torch_spatial_ranks.py WORLD OUT``
spawns WORLD gloo ranks over a ``FileStore`` in OUT; each runs every
scenario of its world (:func:`scenarios`) and rank 0 pickles what they
got to ``OUT/result.pkl``.  Two ranks: the height-sharded forwards at
S = 2 and the mesh servers over ``data`` = 2 and ``space`` = 2; four
ranks: the forwards at S = 4 (through replicated levels) and, on
``make_mesh_2d(2, 2)`` in the same job, the Evaluator and the server.
Each world also runs the space dryrun's check on the full-width pruned
flagship (``parallel/dryrun.py``: the S = 2 forward, the 2 x 2
Evaluator), every sharded op of the zoo case by case (:data:`OP_CASES`)
and the height-sharded forwards of the rest of the zoo (:data:`ZOO`: the
MobileNet decoders other than NNConv{3,5}, and ResNets); the two-rank job
also serves a zoo model over ``space`` = 2, the four-rank job runs the
2 x 2 Evaluator on a ResNet.
(A rank function must unpickle in a fresh interpreter: a module run by
its path does, a test module under pytest-xdist's import path is
fragile.)"""

import contextlib
import dataclasses
import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fastdepth_tpu_torch import ModelConfig  # noqa: E402
from fastdepth_tpu_torch.engine import Evaluator  # noqa: E402
from fastdepth_tpu_torch.engine.server import InferenceServer  # noqa: E402
from fastdepth_tpu_torch.models import build  # noqa: E402
from fastdepth_tpu_torch.models import fused as F  # noqa: E402
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1  # noqa: E402
from fastdepth_tpu_torch.ops.cuda import head as K4  # noqa: E402
from fastdepth_tpu_torch.parallel import dryrun as DR  # noqa: E402
from fastdepth_tpu_torch.parallel import halo_check as H  # noqa: E402
from fastdepth_tpu_torch.parallel import spatial as S  # noqa: E402
from fastdepth_tpu_torch.parallel.mesh import (  # noqa: E402
    fetch_global,
    make_mesh,
    make_mesh_2d,
    put_sharded,
)

# tests/test_spatial.py's tiny widths at 64^2: the skip-add model stands
# for the pruned and the unpruned flagship (they differ in widths only),
# the plain MobileNet + nnconv5dw / nnconv5 for the other two models of
# the family
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFGS = {
    "skipadd": ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC),
    "nnconv5dw": ModelConfig(decoder="nnconv5dw", skip=None, encoder_channels=TINY_ENC,
                             decoder_channels=TINY_DEC),
    "nnconv5": ModelConfig(decoder="nnconv5", skip=None, encoder_channels=TINY_ENC,
                           decoder_channels=TINY_DEC),
}
# the rest of the zoo at the same tiny widths (the shuffle decoders
# divide the encoder's width by 4 five times: a 1024-wide last block),
# the ResNets at their fixed widths, the plain ones with TINY_DEC stages
ENC_1024 = TINY_ENC[:13] + (1024,)
ZOO_DECODERS = ("deconv3", "deconv5dw", "deconv7", "deconv9", "upconv", "upproj", "blconv3",
                "blconv5dw", "blconv9dw", "shuffle3", "shuffle5", "shuffle9", "nnconv7dw",
                "nnconv9")
CFGS.update({f"mobilenet-{d}": ModelConfig(
    decoder=d, skip=None, encoder_channels=ENC_1024 if d.startswith("shuffle") else TINY_ENC,
    decoder_channels=TINY_DEC) for d in ZOO_DECODERS})
CFGS.update({
    "resnet18-nnconv5": ModelConfig(encoder="resnet18", decoder="nnconv5", skip=None,
                                    decoder_channels=TINY_DEC),
    "resnet18-nnconv5dw-skipadd": ModelConfig(encoder="resnet18", decoder="nnconv5dw",
                                              skip="add"),
    "resnet18-nnconv5-skipconcat": ModelConfig(encoder="resnet18", decoder="nnconv5",
                                               skip="concat"),
    "resnet50-upproj": ModelConfig(encoder="resnet50", decoder="upproj", skip=None,
                                   decoder_channels=TINY_DEC),
})
ZOO = tuple(k for k in CFGS if k.startswith(("mobilenet-", "resnet")))
MODELS = {k: build(c) for k, c in CFGS.items()}
HW = 64
FWD_BATCH = 2
EVAL_BATCH = 8
SERVE_BATCH, SERVE_FRAMES = 2, 5
GROUP_TIMEOUT_S = 60  # the jobs' collective timeout: a dead rank fails a collective


def init(name: str = "skipadd", dtype=torch.float32):
    """The port's seeded init of a tiny model, the same on every rank,
    with drawn BatchNorm statistics (so that folding them is not the
    identity), non-negative BatchNorm biases and a non-negative head (at
    random ones the ReLUs leave the output 0 nearly everywhere)."""
    params = MODELS[name].init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for m in params.modules():
        if hasattr(m, "var") and hasattr(m, "mean"):
            c = m.var.shape[0]
            m.mean.copy_(torch.randn(c, generator=gen) * 0.1)
            m.var.copy_(torch.rand(c, generator=gen) + 0.5)
            m.scale.data.copy_(torch.rand(c, generator=gen) + 0.5)
            m.bias.data.copy_(torch.rand(c, generator=gen) * 0.2)
    dec = params["decoder"]
    if "conv4" in dec:  # a shuffle decoder: its last conv stage feeds the output
        head = dec["conv4"]["pw" if "pw" in dec["conv4"] else "conv"]
    else:
        head = dec["decode_conv6" if "decode_conv6" in dec else "final"]["pw"]
    head.w.data.abs_()
    head.bn.bias.data.abs_()
    return params.to(dtype)


def rgb(n: int = FWD_BATCH, seed: int = 0, dtype=np.float64) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, HW, HW, 3).astype(dtype)


def eval_batch():
    """tests/test_spatial.py's evaluation batch: 8 seeded 64^2 frames."""
    rng = np.random.RandomState(1)
    x = np.asarray(rng.rand(EVAL_BATCH, HW, HW, 3), np.float32)
    d = np.asarray(rng.rand(EVAL_BATCH, HW, HW, 1) * 9 + 0.5, np.float32)
    return x, d


def frames():
    rng = np.random.RandomState(5)
    return [rng.rand(HW, HW, 3).astype(np.float32) for _ in range(SERVE_FRAMES)]


@contextlib.contextmanager
def _plain_kernels(on: bool):
    """With ``on``, the fused forward calls K1's and K4's plain versions
    directly: their wrappers take f32 and bf16 only, the plain versions
    f64 too."""
    saved = F.fused_decoder_stage, F.pointwise_head
    if on:
        F.fused_decoder_stage = K1.fused_decoder_stage_reference
        F.pointwise_head = K4.pointwise_head_reference
    try:
        yield
    finally:
        F.fused_decoder_stage, F.pointwise_head = saved


# the mixed forward's winner map: K1 and the plain stage in turns, so
# that each hands the other sharded and replicated levels
MIXED = {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "pallas"}


def forward(name: str, impl: str, dtype, x, space=None):
    """One forward of a tiny model (``impl`` 'fused', 'mixed' (winners
    :data:`MIXED`), 'opt' or 'xla'): folded params for the first three,
    the unfolded tree straight; the fused and mixed forwards in f64
    through the kernels' plain versions."""
    model, params = MODELS[name], init(name, dtype)
    with torch.inference_mode(), _plain_kernels(impl in ("fused", "mixed")
                                                and dtype == torch.float64):
        x = torch.as_tensor(x).to(dtype)
        if impl == "xla":
            return model.apply(params, x, space=space)
        if impl == "mixed":
            return F.apply_fastdepth_mixed(model.fold(params), x, model.config, MIXED,
                                           space=space)
        fn = F.apply_fastdepth_fused if impl == "fused" else F.apply_fastdepth_opt
        return fn(model.fold(params), x, model.config, space=space)


# what the forward checks run: (model, impl, dtype); the fused and mixed
# forwards in f64 run the kernels' plain versions, in f32 their wrappers
FORWARDS = [("skipadd", "xla", torch.float64), ("skipadd", "opt", torch.float64),
            ("skipadd", "fused", torch.float64), ("skipadd", "mixed", torch.float64),
            ("skipadd", "fused", torch.float32), ("skipadd", "xla", torch.float32),
            ("skipadd", "opt", torch.float32), ("skipadd", "mixed", torch.float32),
            ("nnconv5dw", "xla", torch.float64), ("nnconv5dw", "opt", torch.float64),
            ("nnconv5", "xla", torch.float64), ("nnconv5", "opt", torch.float64)]


# the zoo's forwards held against JAX's space mesh in f32: every new
# halo rule (ResNet's stem, pool and strided 1x1 with the add skips and
# the bottleneck, the unpool, transposed 9x9, bilinear with a 9x9 dw,
# the pixel shuffle with a 9x9)
ZOO_JAX = ("resnet18-nnconv5dw-skipadd", "resnet50-upproj", "mobilenet-deconv9",
           "mobilenet-blconv9dw", "mobilenet-shuffle9")
ZOO_SERVED = "mobilenet-deconv9"  # the space = 2 mesh server's model
ZOO_EVALUATED = "resnet18-nnconv5dw-skipadd"  # the 2 x 2 Evaluator's
ZOO_CLI = "resnet18-nnconv5"  # the checkpoint of the test module's cli.evaluate job


# the NNConv 7x7 / 9x9 decoders through the head-commute forward too,
# what impl='auto' runs on them at batch > 1
ZOO_OPT = ("mobilenet-nnconv7dw", "mobilenet-nnconv9")


def zoo_forward(name: str, dtype, x, space=None, impl: str = "xla"):
    """A zoo model's forward of ``x``: straight on the unfolded tree
    (``impl`` 'xla'), or 'opt' on the folded one."""
    model, params = MODELS[name], init(name, dtype)
    with torch.inference_mode():
        x = torch.as_tensor(x).to(dtype)
        if impl == "opt":
            return F.apply_fastdepth_opt(model.fold(params), x, model.config, space=space)
        return model.apply(params, x, space=space)


def _zoo_forwards(mesh) -> dict:
    """Every :data:`ZOO` forward in f64, the :data:`ZOO_JAX` ones in f32
    and the :data:`ZOO_OPT` ones through 'opt' in f64, height-sharded
    over ``mesh``'s space axis, gathered: {(model, dtype name[, 'opt']):
    NHWC array}."""
    out = {}
    runs = ([(n, torch.float64, "xla") for n in ZOO] + [(n, torch.float32, "xla") for n in ZOO_JAX]
            + [(n, torch.float64, "opt") for n in ZOO_OPT])
    for name, dtype, impl in runs:
        y = zoo_forward(name, dtype, put_sharded(rgb(), mesh), space=mesh.partition(), impl=impl)
        key = (name, str(dtype)) + (() if impl == "xla" else (impl,))
        out[key] = fetch_global(y, mesh, dim=0, space_dim=1)
    return out


# --- the sharded ops, case by case (parallel/halo_check.py: the cases,
# their operands, the op sharded or not, a rank's level)
OP_CASES, op_operands, run_op, op_level = H.OP_CASES, H.op_operands, H.run_op, H.op_level


def _ops(mesh) -> dict:
    """Every :data:`OP_CASES` op on this rank's rows: {case name: [each
    rank's output rows]} (rank 0's all-gather)."""
    part = mesh.partition()
    out = {}
    for case in OP_CASES:
        x = op_operands(case)[0]
        level = S.Level(dataclasses.replace(part, min_rows=case[5]), x.shape[2])
        y = run_op(case, level.take(x), level)
        got = [None] * part.size
        dist.all_gather_object(got, y)
        out[case[0]] = got
    return out


def _forwards(mesh) -> dict:
    """Every forward of :data:`FORWARDS`, height-sharded over ``mesh``'s
    space axis, gathered: {(model, impl, dtype name): NHWC array}."""
    out = {}
    for name, impl, dtype in FORWARDS:
        x = put_sharded(rgb(), mesh)
        y = forward(name, impl, dtype, x, space=mesh.partition())
        out[(name, impl, str(dtype))] = fetch_global(y, mesh, dim=0, space_dim=1)
    return out


def _serve(mesh, name: str = "skipadd", **kw) -> list:
    """The mesh server's answers to :func:`frames` (rank 0; None on the
    others, whose servers follow until rank 0 closes)."""
    with InferenceServer(MODELS[name], init(name), batch_size=SERVE_BATCH,
                         image_size=(HW, HW), mesh=mesh, **kw) as srv:
        if dist.get_rank() != 0:
            return None
        futs = [srv.submit(f) for f in frames()]
        return [f.result(timeout=120) for f in futs]


def _follower_dies(mesh) -> dict:
    """The last scenario of the two-rank job: both ranks build a mesh
    server, then rank 1 exits; rank 0's next batch must fail its future
    and set ``failed`` (the daemon goes down) within the group's timeout,
    not hang."""
    srv = InferenceServer(MODELS["skipadd"], init(), batch_size=SERVE_BATCH,
                          image_size=(HW, HW), mesh=mesh)
    if dist.get_rank() != 0:
        os._exit(0)  # its follower thread is waiting for a header
    time.sleep(1)
    t0 = time.monotonic()
    try:
        srv.submit(frames()[0]).result(timeout=2 * GROUP_TIMEOUT_S)
        error = ""
    except Exception as e:  # the broadcast to the dead rank failed
        error = f"{type(e).__name__}: {e}"
    failed = srv.failed.wait(timeout=GROUP_TIMEOUT_S)
    srv.close()
    return {"error": error, "failed": failed, "seconds": time.monotonic() - t0}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return str(e)
    return ""


def _evaluate(mesh, name: str = "skipadd", **kw) -> np.ndarray:
    """The metric stack of :func:`eval_batch` through an Evaluator over
    ``mesh``, each rank putting its data rows."""
    x, d = eval_batch()
    n = EVAL_BATCH // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    ev = Evaluator(MODELS[name], init(name), batch_size=EVAL_BATCH, mesh=mesh, **kw)
    return ev.fetch(ev(ev.put(x[rows]), ev.put(d[rows]))[1], dim=1)


def scenarios(world: int) -> dict:
    """What the ranks of a ``world``-rank gloo job compute, by scenario
    (rank 0's gathered results)."""
    out = {}
    if world == 2:
        space, data = make_mesh(2, "space"), make_mesh(2)
        out["shape"] = (space.shape, data.shape)
        out["forwards"] = _forwards(space)
        out["serve_data"] = _serve(data)
        out["serve_space"] = _serve(space)
        out["serve_space_chain"] = _serve(space, chain=True)
        out["serve_zoo"] = _serve(space, ZOO_SERVED)
        out["ops"] = _ops(space)
        out["zoo"] = _zoo_forwards(space)
        model = MODELS["skipadd"]
        out["refuse_chain_data"] = _error(lambda: InferenceServer(
            model, init(), batch_size=2, image_size=(HW, HW), mesh=data, chain=True))
        out["refuse_batch"] = _error(lambda: InferenceServer(
            model, init(), batch_size=3, image_size=(HW, HW), mesh=data))
        out["refuse_height"] = _error(lambda: InferenceServer(
            model, init(), batch_size=2, image_size=(HW + 1, HW), mesh=space))
        flagship = DR.flagship()
        out["dryrun_forward"] = DR.space_forward(*flagship, DR.space_inputs()[0], space)
        out["follower_dies"] = _follower_dies(data)  # last: it ends rank 1
    else:
        space, mesh2 = make_mesh(4, "space"), make_mesh_2d(2, 2)
        out["shape"] = (space.shape, mesh2.shape)
        out["forwards"] = _forwards(space)
        out["eval_straight"] = _evaluate(mesh2, fold_bn=False)
        out["eval_fused"] = _evaluate(mesh2)
        out["serve_2d"] = _serve(mesh2)
        out["eval_zoo"] = _evaluate(mesh2, ZOO_EVALUATED, fold_bn=False)
        out["ops"] = _ops(space)
        out["zoo"] = _zoo_forwards(space)
        out["dryrun_eval"] = DR.space_eval(*DR.flagship(), *DR.space_inputs()[1:], mesh2)
    return out


def _rank(rank: int, world: int, out_dir: str) -> None:
    # a fresh interpreter: its share of the threads the parent was given
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = scenarios(world)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
            pickle.dump(result, f)


if __name__ == "__main__":
    n = int(sys.argv[1])
    torch.multiprocessing.start_processes(_rank, args=(n, sys.argv[2]), nprocs=n,
                                          start_method="spawn")
