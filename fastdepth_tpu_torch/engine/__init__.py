from fastdepth_tpu_torch.engine.evaluator import Evaluator, validate  # noqa: F401
