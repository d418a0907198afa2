"""Operation and byte counts the families share: a convolution's
multiply-adds from its shapes, and a fused decoder level's work."""

from __future__ import annotations

from typing import Dict


def out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def conv(name: str, cin: int, cout: int, k: int, h: int, w: int, *, stride: int = 1,
         padding: int = None, groups: int = 1) -> Dict[str, int]:
    """One conv of one frame: its output size and multiply-adds (every
    output, every tap, every input channel of its group)."""
    p = (k - 1) // 2 if padding is None else padding
    ho, wo = out_size(h, k, stride, p), out_size(w, k, stride, p)
    macs = ho * wo * cout * (cin // groups) * k * k
    return {"name": name, "cin": cin, "cout": cout, "k": k, "groups": groups, "h": h, "w": w,
            "hout": ho, "wout": wo, "macs": macs, "needed_macs": macs}


def stage_work(n: int, h: int, w: int, c: int, cout: int, skip: bool, elem_bytes: int):
    """(bytes, FLOPs) of one fused decoder level at input ``h`` x ``w``:
    dw 5 x 5 (+ bias) -> ReLU -> pw 1 x 1 (+ bias) -> ReLU -> nearest x2
    [-> + skip].  x, the weights and the skip read once, the output
    written once; 25 FMAs per input element for the depthwise, C x Cout
    FMAs per pixel for the pointwise, and the bias, ReLU and skip adds
    (the arithmetic of the port's ``engine/benchmark.stage_work``,
    copied)."""
    px = n * h * w
    nbytes = elem_bytes * (px * c + 27 * c + c * cout + cout
                           + (2 if skip else 1) * 4 * px * cout)
    dw = 2 * 25 * px * c + 2 * px * c
    pw = 2 * px * c * cout
    epilogue = 2 * px * cout + (4 * px * cout if skip else 0)
    return nbytes, dw + pw + epilogue
