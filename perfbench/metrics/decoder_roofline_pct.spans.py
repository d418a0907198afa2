"""``decoder_roofline_pct``'s arithmetic on the kernels launched inside
the program's ``fastdepth::fused_decoder_stage`` spans, one around each
eager K1 level (``perfbench/spans.py``), in place of the Python calls
of the op's entry: the five levels' least time (bytes once at the
card's memory rate, or all FLOPs at the dtype's tensor-core peak, the
larger; ``perfbench/work``) per level times the spans, over those
kernels' device time.  Nothing to read where no kernel fell under the
span."""

from perfbench import peaks, spans


def read(run):
    t = spans.of(run)
    if t is None:
        return None
    launches, device_s = t.kernels_in(spans.K1)
    if not launches or device_s <= 0:
        return None
    cfg, wl = run.ctx.config, run.ctx.workload
    elem = 2 if wl["dtype"] in ("bfloat16", "float16") else 4
    levels = run.work.decoder_levels(cfg, wl["batch"], elem)
    least = sum(peaks.least_time_s(b, f, wl["dtype"]) for b, f in levels)
    return 100.0 * least * t.count(spans.K1) / len(levels) / device_s
