"""The whole step's share of the card's dense peak in the cell's dtype:
the FLOPs a frame needs (the benchmark's own count, ``perfbench/work``)
times the frames completed per second of the measured window, over the
published peak (``perfbench/peaks.py``)."""

from perfbench import peaks


def read(run):
    cfg, wl = run.ctx.config, run.ctx.workload
    rate = run.outcome.end_to_end["frames_per_s"]
    return 100.0 * run.work.step_flops(cfg) * rate / peaks.FLOPS[wl["dtype"]]
