"""Device microseconds of the evaluation step's metric sums a frame: the
device time of the kernels launched inside the program's
``fastdepth.metrics`` spans (``perfbench/spans.py``) over the span
window's frames.  Nothing to read where no kernel fell under the span."""

from perfbench import spans


def read(run):
    t = spans.of(run)
    if t is None:
        return None
    n, device_s = t.kernels_in(spans.METRICS)
    frames = t.counts.get("frames")
    if not n or not frames:
        return None
    return 1e6 * device_s / frames
