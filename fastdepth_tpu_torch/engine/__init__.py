"""The engine: evaluation, serving, training, deploy and profiling.

``Evaluator`` and ``validate`` load with their module on first use, so
that the models and the ops can import ``engine/profiler``'s spans
without importing the evaluator, which imports them."""


def __getattr__(name):
    if name in ("Evaluator", "validate"):
        from fastdepth_tpu_torch.engine import evaluator

        return getattr(evaluator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
