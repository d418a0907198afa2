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
from typing import Callable, Tuple, Union

import torch

from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.registry import Model

IMPLS = ("auto", "fused", "opt", "xla")


def strict_f32() -> None:
    """Make f32 true f32 on the card: turn TF32 off for cuDNN's
    convolutions (PyTorch turns it on by default) and for matmuls.  The
    port's f32 contract (1e-4 a kernel against its plain version, 1e-3
    for a fused forward against the straight one) holds only without
    TF32's 10-bit mantissas."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _pick_apply(model: Model, params, impl: str, batch_size: int = 2):
    """The forward ``fn(params, x)`` an impl name selects.

    'fused' runs decoder levels 1-5 through K1 and the head through K4;
    'opt' the plain-PyTorch head-commute forward; 'xla' the straight
    plain-PyTorch forward (the JAX package's name for it).  'auto' takes
    'fused' whenever K1 covers the architecture and the params are
    folded, at any batch size and on any device (on the CPU, the kernels'
    plain versions run, so CPU runs take the same dispatch).  Otherwise it
    follows the JAX package's rule: 'opt' when folded, batch > 1 and
    supported, else straight.  That rule rests on TPU measurements; an
    H100 benchmark will revisit both choices.  Folded-ness is read off the
    params tree."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    cfg = model.config
    folded = not F.tree_has_bn(params)
    if impl in ("opt", "fused") and not folded:
        raise ValueError(
            f"impl={impl!r} requires BN-folded params ({{'w','b'}} leaves): "
            "fold via Model.fold (or pass fold_bn=True)")
    if impl == "fused" and not F.supports_fused(cfg):
        raise ValueError(
            "impl='fused' runs K1, which covers the MobileNet nnconv5dw "
            f"skip-add family only; got decoder={cfg.decoder!r} skip={cfg.skip!r}")
    if impl == "fused" or (impl == "auto" and folded and F.supports_fused(cfg)):
        return lambda p, x: F.apply_fastdepth_fused(p, x, cfg)
    if impl == "opt" or (impl == "auto" and folded and batch_size > 1
                         and F.supports_opt(cfg)):
        return lambda p, x: F.apply_fastdepth_opt(p, x, cfg)
    return model.apply


def _prepare(model: Model, params, *, batch_size: int, dtype: torch.dtype, fold_bn: bool,
             impl: str, device: Union[str, torch.device]):
    """The preamble :class:`Evaluator` and :func:`compile_forward` share:
    fold (in f32, before the cast), cast to ``dtype``, move to
    ``device``, pick the forward.  Returns (params, apply).  The caller's
    tree is never moved or cast: both branches copy.

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
    return params, _pick_apply(model, params, impl, batch_size)


def compile_forward(
    model: Model,
    params,
    *,
    batch_size: int = 1,
    image_size: Tuple[int, int] = (224, 224),
    dtype: torch.dtype = torch.float32,
    fold_bn: bool = True,
    impl: str = "auto",
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
                             fold_bn=fold_bn, impl=impl, device=device)
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
