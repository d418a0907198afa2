"""Functional ops on tensors — counterpart of ``fastdepth_tpu/ops/blocks.py``.

Inside the port, activations are logical NCHW tensors stored
``torch.channels_last`` (NHWC memory, what cuDNN's fast convolutions and
the CUDA kernels read) and conv weights are OIHW.  The public forwards
keep the JAX package's NHWC layout at their edges (:func:`from_nhwc`,
:func:`to_nhwc`).  JAX left every op here to XLA; the port leaves them
to PyTorch (cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, used throughout the reference


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Public NHWC ``(N, H, W, C)`` -> the port's channels_last NCHW
    (a view when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Channels_last NCHW -> public NHWC (a view)."""
    return x.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: Optional[int] = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2-D convolution, OIHW weights.  ``padding=None`` means torch-style
    "same for odd kernels": p = (k - 1) // 2 on both sides."""
    k = w.shape[-1]
    return F.conv2d(x, w, bias, stride=stride,
                    padding=(k - 1) // 2 if padding is None else padding)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: Optional[int] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise conv: w is ``(C, 1, k, k)`` and groups == C."""
    k = w.shape[-1]
    return F.conv2d(x, w, bias, stride=stride,
                    padding=(k - 1) // 2 if padding is None else padding,
                    groups=x.shape[1])


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2, padding: int = 0,
                     output_padding: int = 0, groups: int = 1,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.ConvTranspose2d``'s transposed conv; ``w`` in its layout
    ``(Cin, Cout / groups, kh, kw)`` (the JAX package's HWOI ``(kh, kw,
    Cout / groups, Cin)`` through ``checkpoint.from_jax``).  Output size
    (H - 1) * stride - 2 * padding + k + output_padding (reference
    models.py:77-99, the deconv decoders)."""
    return F.conv_transpose2d(x, w, bias, stride=stride, padding=padding,
                              output_padding=output_padding, groups=groups)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def batch_norm(x: torch.Tensor, bn, *, eps: float = BN_EPS) -> torch.Tensor:
    """Inference-mode BatchNorm (running statistics); ``bn`` carries
    ``scale``, ``bias``, ``mean`` and ``var``."""
    inv = torch.rsqrt(bn.var + eps) * bn.scale
    return x * _per_channel(inv) + _per_channel(bn.bias - bn.mean * inv)


def batch_norm_train(x: torch.Tensor, bn, *, eps: float = BN_EPS, momentum: float = 0.1,
                     group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training-mode BatchNorm over (N, H, W); returns the output and the
    new running statistics ``{'mean', 'var'}`` (torch's convention: new =
    (1 - m) * old + m * batch, the variance unbiased), which the caller
    merges: ``bn``'s buffers are never written here, so a forward run
    twice (``torch.utils.checkpoint``) or a skipped step leaves them as
    they were.

    Without ``group``: one ``F.batch_norm`` call (cuDNN's on the card); a
    bf16 ``x`` with ``bn``'s f32 parameters takes PyTorch's
    mixed-precision path, which accumulates the moments in f32 and
    returns bf16.  It needs more than one value a channel (N * H * W > 1),
    as torch's BatchNorm2d does.

    With ``group`` (a data mesh's process group, every rank holding an
    equal share of the batch): the moments of the GLOBAL batch, as the
    JAX package's mesh step takes them (:class:`_GlobalBatchNorm`), in
    at least f32 (f64 stays f64), the unbiased factor from the global
    count."""
    if group is None:
        mean, var = bn.mean.clone(), bn.var.clone()
        y = F.batch_norm(x, mean, var, bn.scale, bn.bias, training=True, momentum=momentum,
                         eps=eps)
        return y, {"mean": mean, "var": var}
    y, mean, var = _GlobalBatchNorm.apply(x, bn.scale, bn.bias, bn.mean, bn.var, group, eps,
                                          momentum)
    return y, {"mean": mean, "var": var}


_CHANNELS = (0, 2, 3)  # the dims a channel's moments reduce over (NCHW)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm whose moments are the global batch's over
    ``group``, with two collectives: forward, an all-gather of each
    rank's own moments, merged exactly (a mean of means; the variances'
    mean plus the means' variance), so no large sum cancels; backward,
    one all-reduce of the two per-channel sums the input gradient needs.
    The scale's and bias's gradients stay this rank's share: the
    trainer's all-reduce of the flat gradient sums them.  Returns (y,
    new running mean, new running variance: torch's update, the variance
    unbiased by the global count); the running statistics passed in are
    not written, and the new ones take no gradient.

    On the card each side is PyTorch's fused kernels for this
    (``torch.batch_norm_stats`` / ``_gather_stats_with_counts`` /
    ``_elemt`` and their backward pair, what ``nn.SyncBatchNorm`` runs):
    the step is host-bound at small batches, and the same arithmetic as
    plain ops launches three times the kernels.  Those kernels have no
    CPU version, so on the CPU the same steps run as plain ops, in at
    least f32 (f64 stays f64)."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, group, eps, momentum):
        import torch.distributed as dist

        world = dist.get_world_size(group)
        count = x.numel() // x.shape[1]
        n = count * world
        new_mean, new_var = running_mean.clone(), running_var.clone()
        if x.is_cuda:
            mean_r, invstd_r = torch.batch_norm_stats(x, eps)
            local = torch.cat([mean_r, invstd_r, mean_r.new_full((1,), count)])
        else:
            var_r, mean_r = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)),
                                           dim=_CHANNELS, correction=0)
            local = torch.cat([mean_r, var_r])
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local, group=group)
        ranks = torch.stack(parts)  # (world, 2C [+ 1])
        c = x.shape[1]
        if x.is_cuda:
            # updates the running statistics it is given, in their dtype
            counts = ranks[:, 2 * c]
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, ranks[:, :c], ranks[:, c:2 * c], new_mean, new_var, momentum, eps, counts)
            y = torch.batch_norm_elemt(x, scale, bias, mean, invstd, eps)
            ctx.counts = counts.to(torch.int32)
        else:
            var_means, mean = torch.var_mean(ranks[:, :c], dim=0, correction=0)
            var = ranks[:, c:].mean(0) + var_means
            invstd = torch.rsqrt(var + eps)
            y = F.batch_norm(x, mean, var, scale, bias, training=False, eps=eps)
            new_mean.mul_(1 - momentum).add_(momentum * mean)
            new_var.mul_(1 - momentum).add_(momentum * var * n / max(n - 1, 1))
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        import torch.distributed as dist

        x, scale, mean, invstd = ctx.saved_tensors
        if x.is_cuda:
            dy = dy.contiguous(memory_format=torch.channels_last
                               if x.is_contiguous(memory_format=torch.channels_last)
                               else torch.contiguous_format)
            sum_dy, sum_dy_xmu, dscale, dbias = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, scale, True, True, True)
            total = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(total, group=ctx.group)
            c = x.shape[1]
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, scale, total[:c],
                                                 total[c:], ctx.counts)
            return dx, dscale, dbias, None, None, None, None, None
        xmu = x.to(mean.dtype) - _per_channel(mean)
        dy = dy.to(mean.dtype)
        local = torch.stack([dy.sum(dim=_CHANNELS), (dy * xmu).sum(dim=_CHANNELS)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        k = invstd * invstd * total[1] / ctx.n
        dx = (dy - _per_channel(total[0] / ctx.n) - xmu * _per_channel(k)) * _per_channel(
            scale.to(mean.dtype) * invstd)
        return (dx.to(x.dtype), (local[1] * invstd).to(scale.dtype), local[0].to(scale.dtype),
                None, None, None, None, None)


def fold_bn(w: torch.Tensor, bn, *, eps: float = BN_EPS,
            transpose: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into the preceding conv.  Returns
    (w', b') with conv(x, w') + b' == bn(conv(x, w)).

    An OIHW weight (dense or depthwise) scales along dim 0.  With
    ``transpose`` the weight is a transposed conv's ``(Cin, Cout / groups,
    kh, kw)``: a dense one ``(Cin, Cout, k, k)`` scales along dim 1, a
    depthwise one ``(C, 1, k, k)`` (groups == C) along dim 0; any other
    grouping is refused, as the JAX package refuses it."""
    inv = 1.0 / torch.sqrt(bn.var + eps) * bn.scale
    c = inv.shape[0]
    if transpose and w.shape[1] == c:  # dense transposed: Cout is dim 1
        per_out = (1, -1, 1, 1)
    elif not transpose or tuple(w.shape[:2]) == (c, 1):  # OIHW, or depthwise transposed
        per_out = (-1, 1, 1, 1)
    else:
        raise ValueError(f"transpose fold expects a dense (Cin, {c}, k, k) or a depthwise "
                         f"({c}, 1, k, k) weight; got w{tuple(w.shape)} vs bn[{c}]")
    return w * inv.reshape(per_out), bn.bias - bn.mean * inv


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (reference models.py:722-723): each pixel
    becomes a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_bilinear2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (``align_corners=False``,
    reference models.py:277-293), the convention of JAX's
    ``jax.image.resize(..., "linear")``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def unpool_zero(x: torch.Tensor) -> torch.Tensor:
    """Zero-insertion unpool: out[2i, 2j] = x[i, j], zeros elsewhere, size
    2H x 2W (the reference's grouped conv_transpose with kernel
    [[1, 0], [0, 0]], models.py:18-34)."""
    n, c, h, w = x.shape
    out = torch.zeros((n, h, 2, w, 2, c), dtype=x.dtype, device=x.device)
    out[:, :, 0, :, 0, :] = x.permute(0, 2, 3, 1)
    return out.reshape(n, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """``torch.pixel_shuffle`` on the logical NCHW tensor: input channel
    c * r^2 + i * r + j lands on output channel c at (i, j) of its r x r
    block (reference models.py:319-333, the ShuffleConv decoder)."""
    return F.pixel_shuffle(x, r).contiguous(memory_format=torch.channels_last)


def avg_pool(x: torch.Tensor, window: int, *, stride: Optional[int] = None) -> torch.Tensor:
    """Mean over window x window, no padding (reference
    imagenet/mobilenet.py:55 AvgPool2d(7))."""
    return F.avg_pool2d(x, window, stride or window)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, stride=2, padding=1)``, the ResNet stem's pool
    (the padding counts as -inf)."""
    return F.max_pool2d(x, 3, 2, 1)
