"""Share of the span window in which the host was inside the program's
step (``fastdepth.step``, ``perfbench/spans.py``) and no operation ran
on the card: idle that falls while the program enqueues, in a cell that
reports ``frames_per_s``.  Nothing to read without the span."""

from perfbench import spans


def read(run):
    return spans.idle_pct_in(spans.of(run), spans.STEP)
