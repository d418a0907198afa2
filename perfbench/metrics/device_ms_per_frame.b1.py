"""Summed kernel time of the traced window over the frames completed in
it, in ms."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.counts.get("frames"):
        return None
    return 1e3 * t.kernel_s() / t.counts["frames"]
