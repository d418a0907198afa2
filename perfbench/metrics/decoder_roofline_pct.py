"""The five fused decoder levels' least time over the device time of
the kernels launched under ``fastdepth::fused_decoder_stage``.

An eager call of the op runs its implementation straight from its
Python entry, ``fastdepth_tpu_torch/ops/cuda/fused_decoder.py``'s
``fused_decoder_stage``, so the kernels are those whose launch the
trace finds inside a call of that function.  The least time of a level
is the larger of its bytes (x, weights and skip read once, the output
written once) at the card's memory rate and all its FLOPs at the dtype's
tensor-core peak (``perfbench/work``), so any kernel that implements the
op is held to the same work.  Nothing to read where no kernel was
found under the op."""

from perfbench import peaks

PYTHON_CALLS = True  # read from the traced window that records Python calls
OP_ENTRY = "ops/cuda/fused_decoder.py"
OP_FUNCTION = "fused_decoder_stage"


def read(run):
    t = run.python_trace
    if t is None:
        return None
    suffix = f": {OP_FUNCTION}"
    calls = [n for n, *_ in t.python if n.endswith(suffix) and OP_ENTRY in n]
    launches, device_s = t.kernels_under(suffix)
    if not calls or not launches or device_s <= 0:
        return None
    cfg, wl = run.ctx.config, run.ctx.workload
    elem = 2 if wl["dtype"] in ("bfloat16", "float16") else 4
    levels = run.work.decoder_levels(cfg, wl["batch"], elem)
    least = sum(peaks.least_time_s(b, f, wl["dtype"]) for b, f in levels)
    return 100.0 * least * len(calls) / len(levels) / device_s
