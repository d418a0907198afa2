"""What the harness hands an entry (:class:`Ctx`) and what the entry
hands back (:class:`Outcome`)."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_T_IMPORT = time.monotonic()


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (interpreter
    start-up and imports included); where that cannot be read, since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def setup_note(marks: List[tuple]) -> str:
    """A line of the set-up's phases: ``(phase, process_age())`` at the
    end of each."""
    return "set-up phases (s since the process started): " + ", ".join(
        f"{name} {age:.2f}" for name, age in marks)


@dataclass
class Ctx:
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    python_trace: bool = False  # a metric of the cell reads Python calls


@dataclass
class Outcome:
    """A run of an entry.  ``samples``: what the check compares, on the
    host or the device: ``params`` (the drawn state dict), ``inputs``
    (NHWC frames), ``outputs`` (the program's answers to them, NHWC),
    ``name`` (what the outputs' comparison is called), and for an
    evaluation also ``depth`` and ``metric_rows`` (``(10, N)`` in the
    reference's field order)."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    samples: dict
    memory_peak_bytes: int = 0
    counters: Dict[str, object] = field(default_factory=dict)
    trace: Optional[object] = None  # perfbench.trace.Trace: the card's activity
    python_trace: Optional[object] = None  # the same with the host's Python calls
    notes: List[str] = field(default_factory=list)  # lines for standard error
