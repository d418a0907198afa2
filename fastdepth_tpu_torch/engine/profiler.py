"""Profiling utilities — counterpart of ``fastdepth_tpu/engine/profiler.py``.

``torch.profiler`` traces around arbitrary callables: host ops, and the
card's kernels when CUDA is available (CUPTI).  The trace is written as
a Chrome trace (``trace.json``, viewable in Perfetto) and a table of
time by op (``ops.txt``).  Timing itself lives in ``engine/benchmark.py``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(out_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``out_dir``; a no-op when it is empty."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(out_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span in the trace around the block."""
    with torch.profiler.record_function(name):
        yield
