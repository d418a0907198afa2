"""Profiling utilities — counterpart of ``fastdepth_tpu/engine/profiler.py``.

``torch.profiler`` traces around arbitrary callables: host ops, and the
card's kernels when CUDA is available (CUPTI).  The trace is written as
a Chrome trace (``trace.json``, viewable in Perfetto) and a table of
time by op (``ops.txt``).  Timing itself lives in ``engine/benchmark.py``.

The program marks its layers with :func:`annotate`, eight spans in all,
each a ``record_function`` range of its host thread in a
``torch.profiler`` trace, in which the kernels launched inside it are
found by their launches' correlation ids:

* :data:`STEP` (``fastdepth.step``): one call of ``Evaluator`` or of the
  forward ``engine/aot.compile_forward`` returns, from entry to return;
* :data:`ENCODER` (``fastdepth.encoder``): the encoder pass
  (``models/mobilenet.apply_encoder``, ``models/resnet.apply_resnet_encoder``,
  the ViT of ``models/dinov2_dpt.py`` with its normed taps);
* :data:`DECODER` (``fastdepth.decoder``): the rest of the forward: a
  ResNet's bridge 1x1, the decoder levels and the head (DPT's whole
  head);
* :data:`ATTENTION` (``fastdepth.attention``): one attention product of
  a ViT block, ``softmax(q k^T / sqrt(d)) v``, inside the encoder;
* :data:`METRICS` (``fastdepth.metrics``): an evaluation step's metric
  sums and their stack;
* :data:`K1` (``fastdepth::fused_decoder_stage``): one eager K1 level,
  under the name the op has in the dispatcher when a trace calls it;
* :data:`K7` (``fastdepth::conv_epilogue``): one eager K7 epilogue, the
  bias, residual and activation after a routed conv, under the name the
  op has in the dispatcher;
* :data:`GRAPH` (``fastdepth.graph``): one replay of the CUDA graph of
  ``compile_forward``'s forward, inside its step.  A replay runs the
  forward's kernels without its Python, so no encoder, decoder, K1 or
  K7 span opens inside it.

A span nests in the one open around it on the same thread; the step is
the root.  With no profiler running a span costs one flag read.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

STEP = "fastdepth.step"
ENCODER = "fastdepth.encoder"
DECODER = "fastdepth.decoder"
METRICS = "fastdepth.metrics"
ATTENTION = "fastdepth.attention"
K1 = "fastdepth::fused_decoder_stage"
K7 = "fastdepth::conv_epilogue"
GRAPH = "fastdepth.graph"

_OFF = contextlib.nullcontext()


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


def annotate(name: str) -> ContextManager:
    """A named span in the trace around the block while a profiler
    runs; otherwise a shared no-op, after one read of the flag that
    ``torch.profiler`` sets, and no call into the dispatcher."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
