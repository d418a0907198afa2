"""The attention products' share of the card's dense peak in the cell's
dtype, on their own device time: the FLOPs of a frame's attention
products (``perfbench/work``'s ``attention_flops``: q k^T and the scores
times v, 4 N^2 dim a block) times the span window's frames, over the
device seconds of the kernels launched inside the program's
``fastdepth.attention`` spans (``perfbench/spans.py``'s window), over
the published peak.  Nothing to read where no kernel fell under the
span, nor for a family without attention."""

from perfbench import peaks, spans

ATTENTION = "fastdepth.attention"


def read(run):
    t = spans.of(run)
    if t is None:
        return None
    n, device_s = t.kernels_in(ATTENTION)
    frames = t.counts.get("frames")
    flops = getattr(run.work, "attention_flops", None)
    if not n or device_s <= 0 or not frames or flops is None:
        return None
    return 100.0 * flops(run.ctx.config) * frames / device_s / peaks.FLOPS[
        run.ctx.workload["dtype"]]
