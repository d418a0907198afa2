"""Forward selection and preparation for a fixed shape — counterpart of
``fastdepth_tpu/engine/aot.py``.

JAX compiles the forward ahead of time for one input shape.  PyTorch runs
eagerly, so :func:`compile_forward` does what is left of that on the
card: it folds and casts the params once, picks the forward, builds the
kernels and runs the forward once at the fixed shape, so that the first
timed call neither builds nor allocates.  Saved bundles (``torch.export``
of the kernels as ``torch.library`` custom ops) and a CUDA graph of the
forward are still to come (ROADMAP A8).
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Tuple, Union

import torch

from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.registry import Model
from fastdepth_tpu_torch.parallel import spatial as S

IMPLS = ("auto", "fused", "opt", "xla", "mixed")


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
    takes it, on the MobileNet + NNConv family only (the rest of the zoo
    is refused here, naming ROADMAP A12c).

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
    measurements; an H100 benchmark will revisit both choices.
    Folded-ness is read off the params tree."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    check_tuning(impl, tuning)
    cfg = model.config
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

    On CUDA the kernels are built (it raises if they cannot be) and the
    forward runs once at the fixed shape before this returns."""
    params, apply = _prepare(model, params, batch_size=batch_size, dtype=dtype,
                             fold_bn=fold_bn, impl=impl, device=device, tuning=tuning)
    shape = (batch_size, *image_size, 3)

    @torch.inference_mode()
    def forward(p, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != shape:
            raise ValueError(f"compiled for input {shape}, got {tuple(x.shape)}")
        return apply(p, x.to(dtype)).float()

    dev = torch.device(device)
    if dev.type == "cuda":
        from fastdepth_tpu_torch.ops.cuda import _build

        _build.load()
        forward(params, torch.zeros(shape, device=dev))
        torch.cuda.synchronize(dev)
    return forward, params


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
