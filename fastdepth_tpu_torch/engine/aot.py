"""Forward selection and preparation for a fixed shape, and the deploy
bundle — counterpart of ``fastdepth_tpu/engine/aot.py``.

JAX compiles the forward ahead of time for one input shape.  PyTorch runs
eagerly, so :func:`compile_forward` does what is left of that on the
card: it folds and casts the params once, picks the forward, builds the
kernels and runs the forward once at the fixed shape, so that the first
timed call neither builds nor allocates.  On CUDA it then captures the
forward at that shape in one CUDA graph, which a call replays: one graph
launch in place of the chain of small kernel launches that binds a
batch-1 forward on the host.  The graph is fixed at compile time, as
JAX's executable is.

:func:`save_bundle` writes the deploy artifact pair, the counterpart of
JAX's StableHLO blob + npz and of the reference's TVM deploy_lib /
deploy_graph / deploy_param set (reference deploy/tx2_run_tvm.py:13-26):
``<prefix>.pt2``, the forward at its fixed shape as a ``torch.export``
program whose decoder levels and head are the custom-op nodes
``fastdepth::fused_decoder_stage`` (K1) and ``fastdepth::pointwise_head``
(K4), and ``<prefix>.npz``, the folded, cast params in the JAX package's
checkpoint format.  The params are an input of the program, not
constants in it.  :func:`load_bundle` reads the pair back.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn
from torch.utils import _pytree as pytree

from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.models import dinov2_dpt as DD
from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.registry import Model
from fastdepth_tpu_torch.parallel import spatial as S

IMPLS = ("auto", "fused", "opt", "xla", "mixed")

GRAPH_REPLAYS = 0  # calls of a compile_forward forward that replayed its CUDA graph


def strict_f32() -> None:
    """Make f32 true f32 on the card: turn TF32 off for cuDNN's
    convolutions (PyTorch turns it on by default) and for matmuls.  The
    port's f32 contract (1e-4 a kernel against its plain version, 1e-3
    for a fused forward against the straight one) holds only without
    TF32's 10-bit mantissas."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def normalize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] frames -> ``dtype`` in [0, 1], bit for bit with the
    host path's ``astype(float32) / 255``: cast, then divide in ``dtype``.
    The divisor is a tensor on ``x``'s device: CUDA divides by a Python
    number as a multiply by its reciprocal, which is 1 ulp off on 126 of
    the 256 values in f32.  The evaluator's and the server's uint8 inputs
    both come through here."""
    return x.to(dtype) / torch.full((), 255.0, dtype=dtype, device=x.device)


def check_tuning(impl: str, tuning) -> None:
    """impl='mixed' and a tuning record come as a pair: each is refused
    without the other (the JAX package ignores a record without 'mixed';
    here it would silently run another forward than the one asked for),
    and a record path must name a file."""
    if impl == "mixed" and tuning is None:
        raise ValueError(
            "impl='mixed' needs a tuning record: pass tuning=<path to "
            "tuning/*.json> (or a {stage: 'xla'|'pallas'} dict)")
    if tuning is not None and impl != "mixed":
        raise ValueError(f"a tuning record applies to impl='mixed' only, got impl={impl!r}")
    if isinstance(tuning, (str, bytes, os.PathLike)) and not os.path.isfile(tuning):
        raise ValueError(f"no tuning record at {tuning!r}")


def check_tuning_flags(impl: str, tuning) -> None:
    """:func:`check_tuning` for a CLI's ``--impl`` / ``--tuning``, before
    anything loads: exits with its message."""
    try:
        check_tuning(impl, tuning)
    except ValueError as e:
        raise SystemExit(f"--impl/--tuning: {e}") from None


def _pick_apply(model: Model, params, impl: str, batch_size: int = 2, space=None,
                tuning=None):
    """The forward ``fn(params, x)`` an impl name selects.  ``space`` (a
    ``parallel.spatial.Partition``) makes it height-sharded: every impl
    takes it, on every depth model of the registry.

    'fused' runs decoder levels 1-5 through K1 and the head through K4;
    'opt' the plain-PyTorch head-commute forward; 'xla' the straight
    plain-PyTorch forward (the JAX package's name for it); 'mixed' each
    decoder level on the winner a tuning record names for it
    (``models/fused.apply_fastdepth_mixed``: 'pallas' is K1, 'xla' the
    plain cuDNN stage), the head through K4.  ``tuning`` (mixed only): a
    path to a ``tuning/*.json`` record or a ``{level: impl}`` winner map.
    A record's winners were measured per dtype, so from a path both maps
    are loaded once, here, and each call runs the map of its input's
    dtype (the bf16 map for any dtype but f32), as the JAX package picks
    by the traced dtype.  'auto' takes
    'fused' whenever K1 covers the architecture and the params are
    folded, at any batch size and on any device (on the CPU, the kernels'
    plain versions run, so CPU runs take the same dispatch).  Otherwise it
    follows the JAX package's rule: 'opt' when folded, batch > 1 and
    supported (the MobileNet nnconv decoders, skip or plain), else
    straight: the rest of the zoo (the other registry decoders, every
    ResNet) runs straight, never 'fused'.  That rule rests on TPU
    measurements; an H100 benchmark will revisit both choices.  The
    DINOv2 + DPT family runs straight and refuses 'fused', 'opt',
    'mixed' and ``space``.
    Folded-ness is read off the params tree."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    check_tuning(impl, tuning)
    cfg = model.config
    if DD.is_family(cfg) and impl in ("opt", "fused", "mixed"):
        raise ValueError(f"impl={impl!r}: {DD.refusal('straight only')} (impl 'auto' or "
                         "'xla'): no K1, K4 or head-commute path covers it")
    if DD.is_family(cfg) and space is not None:
        raise ValueError(DD.refusal(DD.WHOLE))
    if space is not None:
        S.check_model(cfg)
    folded = not F.tree_has_bn(params)
    if impl in ("opt", "fused", "mixed") and not folded:
        raise ValueError(
            f"impl={impl!r} requires BN-folded params ({{'w','b'}} leaves): "
            "fold via Model.fold (or pass fold_bn=True)")
    if impl in ("fused", "mixed") and not F.supports_fused(cfg):
        raise ValueError(
            f"impl={impl!r} runs K1, which covers the MobileNet nnconv5dw "
            f"skip-add family only; got decoder={cfg.decoder!r} skip={cfg.skip!r}")
    kw = {} if space is None else {"space": space}
    if impl == "mixed":
        if not isinstance(tuning, (str, bytes, os.PathLike)):
            return lambda p, x: F.apply_fastdepth_mixed(p, x, cfg, tuning, **kw)
        from fastdepth_tpu_torch.engine.autotune import load_tuning

        maps = {d: load_tuning(tuning, dtype=d) for d in (torch.bfloat16, torch.float32)}
        return lambda p, x: F.apply_fastdepth_mixed(
            p, x, cfg, maps.get(x.dtype, maps[torch.bfloat16]), **kw)
    if impl == "fused" or (impl == "auto" and folded and F.supports_fused(cfg)):
        return lambda p, x: F.apply_fastdepth_fused(p, x, cfg, **kw)
    if impl == "opt" or (impl == "auto" and folded and batch_size > 1
                         and F.supports_opt(cfg)):
        return lambda p, x: F.apply_fastdepth_opt(p, x, cfg, **kw)
    if space is not None:
        return lambda p, x: model.apply(p, x, space=space)
    return model.apply


def _prepare(model: Model, params, *, batch_size: int, dtype: torch.dtype, fold_bn: bool,
             impl: str, device: Union[str, torch.device], space=None, tuning=None):
    """The preamble :class:`Evaluator` and :func:`compile_forward` share:
    fold (in f32, before the cast), cast to ``dtype``, move to
    ``device``, pick the forward (``tuning``: :func:`_pick_apply`'s).
    Returns (params, apply).  The caller's tree is never moved or cast:
    both branches copy.

    f32 is true f32 (TF32 off): for ``dtype`` float32 it calls
    :func:`strict_f32` on any device, which sets the process-wide flags;
    bf16 leaves them as it finds them."""
    if dtype == torch.float32:
        strict_f32()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    params = (model.fold(params) if fold_bn or not F.tree_has_bn(params)
              else copy.deepcopy(params))
    params = params.to(device=device, dtype=dtype)
    return params, _pick_apply(model, params, impl, batch_size, space, tuning)


def compile_forward(
    model: Model,
    params,
    *,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (224, 224),
    dtype: torch.dtype = torch.float32,
    fold_bn: bool = True,
    impl: str = "auto",
    tuning=None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Callable, object]:
    """Returns (fn, params_prepared).  ``fn(params_prepared, rgb)`` takes
    an f32 NHWC ``(batch_size, H, W, 3)`` tensor on ``device``, runs the
    forward in ``dtype`` under inference mode and returns f32
    ``(batch_size, H, W, 1)``; any other input shape raises, as the JAX
    package's fixed-shape executable does.

    On CUDA the kernels are built (it raises if they cannot be), the
    forward runs once at the fixed shape, once more on a side stream, and
    is then captured in one CUDA graph on an f32 input buffer of that
    shape (a capture that fails raises).  The graph keeps the TF32 flags of the
    capture (off in f32: :func:`_prepare`) and the kernels the eager
    forward runs, K1 and K4 among them.  A call replays it when ``p`` is
    ``params_prepared`` itself (in-place updates of its tensors are seen)
    and ``rgb`` is f32 on the compiled device: ``rgb`` is copied into the
    graph's input, the graph replayed and its output cloned, so that no
    two calls share an answer's memory, all three on the current stream
    and under a lock.  Any other call (another tree, another dtype, the
    CPU) runs the forward eagerly.  A replay does not run K1's and K4's
    Python wrappers, so their counts in ``ops/cuda/kernel.COUNTER`` do not
    move: it counts in :data:`GRAPH_REPLAYS` instead.

    A call of ``fn`` is one ``engine/profiler.STEP`` span; a replay is
    one ``engine/profiler.GRAPH`` span inside it."""
    params, apply = _prepare(model, params, batch_size=batch_size, dtype=dtype,
                             fold_bn=fold_bn, impl=impl, device=device, tuning=tuning)
    shape = (batch_size, *image_size, 3)

    def run(p, x: torch.Tensor) -> torch.Tensor:
        return apply(p, x.to(dtype)).float()

    dev = torch.device(device)
    graph = _capture(run, params, shape, dev) if dev.type == "cuda" else None
    lock = threading.Lock()

    @torch.inference_mode()
    def forward(p, x: torch.Tensor) -> torch.Tensor:
        global GRAPH_REPLAYS
        with P.annotate(P.STEP):
            if tuple(x.shape) != shape:
                raise ValueError(f"compiled for input {shape}, got {tuple(x.shape)}")
            if (graph is None or p is not params or x.dtype != torch.float32
                    or x.device != graph.x.device):
                return run(p, x)
            with lock:
                graph.x.copy_(x)
                with P.annotate(P.GRAPH):
                    graph.graph.replay()
                GRAPH_REPLAYS += 1
                return graph.out.clone()

    return forward, params


class _Graph(NamedTuple):
    """A captured forward: the graph, its f32 input buffer and its output."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    out: torch.Tensor


@torch.inference_mode()
def _capture(run: Callable, params, shape: Tuple[int, ...], dev: torch.device) -> _Graph:
    """Builds the kernels, runs ``run(params, x)`` once on the current
    stream and once on a side stream (CUDA graphs want their warm-up off
    the capture stream, as ``engine/benchmark.time_graph`` does), then
    captures it on an f32 ``x`` of ``shape``."""
    from fastdepth_tpu_torch.ops.cuda import _build

    _build.load()
    with torch.cuda.device(dev):
        x = torch.zeros(shape, device=dev)
        run(params, x)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(params, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run(params, x)
    return _Graph(graph, x, out)


def flops_estimate(model: Model, params, *, batch_size: int = 1,
                   image_size: Tuple[int, int] = (224, 224)) -> float:
    """FLOPs of one straight forward at the given shape, counted by
    ``torch.utils.flop_counter`` on meta tensors (nothing runs).  The
    fused forwards do the same arithmetic: their kernels compute the same
    convolutions."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(params).to("meta")
    x = torch.zeros((batch_size, *image_size, 3), device="meta",
                    dtype=next(meta.parameters()).dtype)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.apply(meta, x)
    return float(counter.get_total_flops())


def param_tensors(params: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor of a parameter tree by name: its parameters and its
    buffers, the kernels' weight layouts (``models/fused.
    attach_kernel_weights``, kept out of the state dict) among them.  A
    bundle's program takes them as its first input."""
    return {**dict(params.named_parameters()), **dict(params.named_buffers())}


class _TreeForward(nn.ModuleDict):
    """A prepared tree (the same submodules) whose forward is
    ``apply(tree, x.to(dtype)).float()``, for ``torch.func.functional_call``."""

    def __init__(self, params: nn.ModuleDict, apply: Callable, dtype: torch.dtype):
        super().__init__(dict(params.items()))
        object.__setattr__(self, "fn", apply)
        object.__setattr__(self, "dtype", dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self, x.to(self.dtype)).float()


class _BundleForward(nn.Module):
    """The function a bundle exports: ``(param_tensors(params), rgb) ->
    f32 depth``.  The tree is held outside the module's registry, so that
    ``torch.export`` finds no parameter or buffer of its own to store:
    ``functional_call`` runs it with the input tensors in place of its
    own."""

    def __init__(self, params: nn.ModuleDict, apply: Callable, dtype: torch.dtype):
        super().__init__()
        object.__setattr__(self, "tree", _TreeForward(params, apply, dtype))

    def forward(self, tensors: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.tree, tensors, (x,), strict=True)


def save_bundle(
    path_prefix: str,
    model: Model,
    params,
    *,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (224, 224),
    dtype: torch.dtype = torch.float32,
    fold_bn: bool = True,
    impl: str = "auto",
    tuning=None,
    device: Union[str, torch.device] = "cuda",
):
    """Write a deploy bundle: ``<prefix>.pt2`` (``torch.export`` of the
    forward :func:`compile_forward` would run, at input ``(batch_size,
    *image_size, 3)`` f32, traced under ``torch.no_grad``) and
    ``<prefix>.npz`` (the folded, cast params, the config and
    ``extra={'bundle', 'batch_size', 'image_size', 'dtype'}``: the file
    the JAX package's ``save_bundle`` writes for the same params).
    Returns the ``ExportedProgram``.

    The program's inputs are ``(param_tensors(params), rgb)``: every
    tensor of the prepared tree, the kernels' weight layouts included,
    so a bundle called with other params runs every layer, K1 and K4
    too, on them.  It raises if the trace captured any tensor as a
    constant.  'mixed' with a record path fixes the winner map of
    ``dtype`` into the graph."""
    from fastdepth_tpu_torch.checkpoint import params_to_jax, save_checkpoint

    params, apply = _prepare(model, params, batch_size=batch_size, dtype=dtype,
                             fold_bn=fold_bn, impl=impl, device=device, tuning=tuning)
    x = torch.zeros((batch_size, *image_size, 3), device=torch.device(device))
    fwd = _BundleForward(params, apply, dtype)
    with torch.no_grad():
        exported = torch.export.export(fwd, (param_tensors(params), x))
    held = sorted(exported.state_dict) + sorted(exported.constants)
    if held:
        raise RuntimeError(f"the exported forward holds tensors as constants: {held[:5]}; "
                           "every tensor of the tree must be an input")
    torch.export.save(exported, path_prefix + ".pt2")
    save_checkpoint(path_prefix + ".npz", params_to_jax(params.state_dict()), model.config,
                    extra={"bundle": True, "batch_size": batch_size,
                           "image_size": list(image_size),
                           "dtype": str(dtype).replace("torch.", "")})
    return exported


def _program_inputs(exported, params: nn.Module, x: torch.Tensor) -> list:
    """The bundle program's flat inputs for ``params`` (all but the rgb,
    which comes last), checked once against what the program was traced
    with: the same tensor names, and each tensor's shape, dtype, device
    and strides (where a dimension is longer than 1).  A tree that fits
    runs every node as the trace did; any other raises here, before a
    kernel sees a pointer."""
    flat, spec = pytree.tree_flatten(((param_tensors(params), x), {}))
    if spec != exported.call_spec.in_spec:
        raise ValueError("the params are not the tree the bundle was saved with "
                         "(other tensor names)")
    metas = [n.meta["val"] for n in exported.graph_module.graph.nodes if n.op == "placeholder"]
    for i, (t, want) in enumerate(zip(flat[:-1], metas)):
        strides = [(s, w) for s, w, n in zip(t.stride(), want.stride(), t.shape) if n > 1]
        if (t.shape != want.shape or t.dtype != want.dtype or t.device != want.device
                or any(s != w for s, w in strides)):
            raise ValueError(
                f"params tensor {i} is {tuple(t.shape)} {t.dtype} on {t.device}, strides "
                f"{t.stride()}; the bundle was saved with {tuple(want.shape)} {want.dtype} on "
                f"{want.device}, strides {want.stride()}")
    return flat[:-1]


def load_bundle(path_prefix: str, device: Union[str, torch.device] = "cuda"):
    """Load a deploy bundle on ``device``; returns ``(call(params, rgb),
    params, config, spec)`` as the JAX package's ``load_bundle`` does:
    ``spec`` is what :func:`save_bundle` fixed, ``{'bundle',
    'batch_size', 'image_size', 'dtype'}``; ``params`` the tree rebuilt
    from the npz (its kernel weight layouts derived anew by
    ``Model.fold``); ``call`` runs the program under inference mode on
    an f32 NHWC input of the fixed shape and refuses any other.  It takes
    the tensors of a tree once, on the tree's first call, and checks
    them then (:func:`_program_inputs`); later calls with the same tree
    run the program's graph alone.

    The program runs on ``device`` whatever device it was saved on (its
    nodes are moved there): on CUDA, K1 and K4 launch; on the CPU their
    plain versions run.  CUDA without a card raises; there the kernels
    are built here.  An f32 bundle makes f32 true f32
    (:func:`strict_f32`); a bf16 one leaves the TF32 flags as found."""
    from torch.export.passes import move_to_device_pass

    from fastdepth_tpu_torch.checkpoint import load_checkpoint, params_from_jax
    from fastdepth_tpu_torch.models.registry import build
    from fastdepth_tpu_torch.ops.cuda import _build
    from fastdepth_tpu_torch.ops.cuda import fused_decoder, head  # noqa: F401  (the ops)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    tree, config, meta = load_checkpoint(path_prefix + ".npz")
    spec = meta.get("extra", {})
    dtype = getattr(torch, spec.get("dtype", "float32"))
    if dtype == torch.float32:
        strict_f32()
    if device.type == "cuda":
        _build.load()
    model = build(config)
    params = model.fold(model.load(params_from_jax(tree))).to(device=device, dtype=dtype)
    exported = move_to_device_pass(torch.export.load(path_prefix + ".pt2"), device)
    graph = exported.graph_module
    graph.recompile()  # the pass edits the nodes, not the code generated from them
    shape = (spec.get("batch_size", 1), *spec.get("image_size", (224, 224)), 3)
    bound = {"tree": None, "inputs": None}

    @torch.inference_mode()
    def call(p, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != shape:
            raise ValueError(f"bundle expects input {shape}, got {tuple(x.shape)}")
        if bound["tree"] is not p:
            bound["inputs"], bound["tree"] = _program_inputs(exported, p, x), p
        return graph(*bound["inputs"], x)[0]

    return call, params, config, spec
