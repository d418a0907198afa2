"""Share of the span window in which the host was inside the program's
forward (``fastdepth.step``, ``perfbench/spans.py``) and no operation
ran on the card: idle that falls while the program launches, not in the
caller's copies and waits, in a cell that reports ``latency_p95_ms``.
Nothing to read without the span."""

from perfbench import spans


def read(run):
    return spans.idle_pct_in(spans.of(run), spans.STEP)
