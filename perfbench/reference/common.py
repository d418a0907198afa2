"""What the plain references share: BatchNorm folding, the uint8
normalize, the depth metrics, the precisions a reference runs in, and
the seeded draw of a parameter tree from a family's schema.

Plain PyTorch only.  Nothing here imports the program under test: the
references take the same unfolded state dict the program is handed and
work everything out again from it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch.nn.BatchNorm2d's default, the published models'
METRIC_FIELDS = ("irmse", "imae", "mse", "rmse", "mae", "absrel", "lg10",
                 "delta1", "delta2", "delta3")
FRACTION_FIELDS = ("delta1", "delta2", "delta3")

Conv = Callable[..., torch.Tensor]


# ---- precisions -------------------------------------------------------------

@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """cuDNN's and cuBLAS's TF32 switches set to ``enabled`` inside the
    block and restored to what they were after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude onto e4m3's 448), then back in f32."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def conv2d(x, w, b=None, stride=1, padding=0, groups=1) -> torch.Tensor:
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def conv2d_bf16(x, w, b=None, stride=1, padding=0, groups=1) -> torch.Tensor:
    """A convolution in bfloat16 (input, weight, bias and output), back
    in f32."""
    return F.conv2d(x.bfloat16(), w.bfloat16(), None if b is None else b.bfloat16(),
                    stride=stride, padding=padding, groups=groups).float()


def conv2d_fp8(x, w, b=None, stride=1, padding=0, groups=1) -> torch.Tensor:
    """A convolution whose input and weight are rounded to float8 e4m3,
    accumulated in f32: what an fp8 tensor-core convolution computes."""
    return F.conv2d(fp8(x), fp8(w), b, stride=stride, padding=padding, groups=groups)


# the precisions a reference runs in: f32 (TF32 off) is the reference;
# tf32 and fp8 are the controls, each the step below a dtype a cell
# serves; bfloat16 a witness beside a bf16 program
PRECISIONS = {"float32": (False, conv2d), "tf32": (True, conv2d), "fp8": (False, conv2d_fp8),
              "bfloat16": (False, conv2d_bf16)}


# ---- parameters -------------------------------------------------------------

def fold(sd: Dict[str, torch.Tensor], key: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conv ``key``'s weight and bias with its BatchNorm folded in:
    w * s and bias - mean * s, s = scale / sqrt(var + eps) per output
    channel."""
    w = sd[f"{key}.w"].float()
    if f"{key}.bn.scale" not in sd:
        return w, sd[f"{key}.b"].float()
    s = sd[f"{key}.bn.scale"].float() / torch.sqrt(sd[f"{key}.bn.var"].float() + BN_EPS)
    return w * s.reshape(-1, 1, 1, 1), sd[f"{key}.bn.bias"].float() - sd[f"{key}.bn.mean"].float() * s


def conv_bn_leaf(key: str, shape: Sequence[int], *, fan_in: Optional[float] = None,
                 head: bool = False, damped: bool = False) -> List[tuple]:
    """Schema rows ``(name, shape, law, a, b)`` of a conv and its
    BatchNorm: a He-normal weight, std sqrt(2 / fan_in) (fan_in: the
    inputs each output sums, Cin / groups x k x k unless given), and
    BatchNorm statistics drawn around the identity.  ``damped``: the
    BatchNorm scale drawn small, as for the last BatchNorm of a residual
    branch.  ``head``: the model's last conv, drawn so that the depth it
    gives is positive: a non-negative weight, a non-positive mean and a
    bias of at least 0.5, so on non-negative inputs the output is at
    least 0.5 m."""
    cout = shape[0]
    fan_in = fan_in or shape[1] * shape[2] * shape[3]
    std = math.sqrt(2.0 / fan_in)
    return [
        (f"{key}.w", tuple(shape), "abs_normal" if head else "normal", 0.0, std),
        (f"{key}.bn.scale", (cout,), "uniform", *((0.05, 0.3) if damped else (0.5, 1.5))),
        (f"{key}.bn.bias", (cout,), "uniform", *((0.5, 1.0) if head else (-0.2, 0.2))),
        (f"{key}.bn.mean", (cout,), "uniform", *((-0.2, 0.0) if head else (-0.2, 0.2))),
        (f"{key}.bn.var", (cout,), "uniform", 0.5, 1.5),
    ]


def draw(schema: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict drawn from ``schema`` on ``device`` in f32, with a
    generator on that device seeded with ``seed``: one normal and one
    uniform draw for the whole tree, cut into its leaves."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = [r for r in schema if r[2] in ("normal", "abs_normal")]
    uniform = [r for r in schema if r[2] == "uniform"]
    z = torch.randn(sum(math.prod(r[1]) for r in normal), generator=g, device=device)
    u = torch.rand(sum(math.prod(r[1]) for r in uniform), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    for rows, flat in ((normal, z), (uniform, u)):
        at = 0
        for name, shape, law, a, b in rows:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            at += n
            if law == "uniform":
                out[name] = leaf.mul_(b - a).add_(a)
            else:
                out[name] = (leaf.abs_() if law == "abs_normal" else leaf).mul_(b).add_(a)
    return out


# ---- activations ------------------------------------------------------------

def to_input(x: torch.Tensor) -> torch.Tensor:
    """NHWC frames -> NCHW f32: uint8 [0, 255] divided by 255 in f32,
    f32 passed through."""
    if x.dtype == torch.uint8:
        x = x.float() / torch.tensor(255.0, device=x.device)
    return x.float().permute(0, 3, 1, 2)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def unpool_zero(x: torch.Tensor) -> torch.Tensor:
    """Each value to the top-left of a 2 x 2 block of zeros (Laina's
    unpooling)."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h, 2 * w))
    out[:, :, 0::2, 0::2] = x
    return out


def in_blocks(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              block: int) -> torch.Tensor:
    """``fn`` over ``x``'s rows, ``block`` at a time, concatenated."""
    return torch.cat([fn(x[i:i + block]) for i in range(0, x.shape[0], block)])


# ---- depth metrics ----------------------------------------------------------

def depth_metrics(pred: torch.Tensor, depth: torch.Tensor,
                  dtype: torch.dtype = torch.float64) -> np.ndarray:
    """The reference's ten metrics of each image, ``(10, N)`` in
    :data:`METRIC_FIELDS` order, computed one image at a time in
    ``dtype`` (f64 for the reference; bfloat16 for the control of a
    program that computes them in f32): valid pixels are those where
    the target or the prediction is above 0, depths in millimetres,
    delta_k the share of valid pixels whose ratio max(out / tgt, tgt /
    out) is under 1.25^k, iRMSE / iMAE on inverse depths."""
    rows = []
    for out, tgt in zip(pred.cpu().to(dtype), depth.cpu().to(dtype)):
        valid = (tgt > 0) | (out > 0)
        out, tgt = out[valid] * 1e3, tgt[valid] * 1e3
        err = (out - tgt).abs()
        ratio = torch.maximum(out / tgt, tgt / out)
        inv = (1 / out - 1 / tgt).abs()
        mse = (err ** 2).mean()
        row = {"irmse": (inv ** 2).mean().sqrt(), "imae": inv.mean(), "mse": mse,
               "rmse": mse.sqrt(), "mae": err.mean(), "absrel": (err / tgt).mean(),
               "lg10": (out.log10() - tgt.log10()).abs().mean(),
               **{f"delta{k}": (ratio < 1.25 ** k).to(dtype).mean() for k in (1, 2, 3)}}
        rows.append([float(row[f]) for f in METRIC_FIELDS])
    return np.asarray(rows, np.float64).T
