"""Share of the program's forward calls (``fastdepth.step`` spans,
``perfbench/spans.py``) that replayed a CUDA graph (a
``fastdepth.graph`` span inside the step), in %, in a cell that reports
``latency_p95_ms``.  Nothing to read without the spans, nor where no
graph span opened: a program without the graph has no such span."""

from perfbench import spans

GRAPH = "fastdepth.graph"


def read(run):
    t = spans.of(run)
    if t is None or not t.count(GRAPH) or not t.count(spans.STEP):
        return None
    return 100.0 * t.count(GRAPH) / t.count(spans.STEP)
