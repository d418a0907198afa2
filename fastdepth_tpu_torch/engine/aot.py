"""Forward selection — counterpart of ``fastdepth_tpu/engine/aot.py``.

Only ``_pick_apply`` is ported so far; compilation, bundles and the deploy
runner come with ROADMAP item A8.
"""

from __future__ import annotations

from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.registry import Model

IMPLS = ("auto", "fused", "opt", "xla")


def _pick_apply(model: Model, params, impl: str, batch_size: int = 2):
    """The forward ``fn(params, x)`` an impl name selects.

    'fused' runs decoder levels 1-5 through K1; 'opt' the plain-PyTorch
    head-commute forward; 'xla' the straight plain-PyTorch forward (the
    JAX package's name for it).  'auto' takes 'fused' whenever K1 covers
    the architecture and the params are folded, at any batch size and on
    any device (on the CPU, K1's plain version runs, so CPU runs take the
    same dispatch).  Otherwise it follows the JAX package's rule: 'opt'
    when folded, batch > 1 and supported, else straight.  That rule rests
    on TPU measurements; an H100 benchmark will revisit both choices.
    Folded-ness is read off the params tree."""
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
