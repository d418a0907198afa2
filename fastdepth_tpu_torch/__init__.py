"""fastdepth_tpu_torch — the PyTorch/CUDA port of fastdepth_tpu.

The same FastDepth models, metrics, evaluation and training as the JAX
package beside it, on NVIDIA GPUs (written for the H100; data-parallel
over several, one ``torch.distributed`` rank each): PyTorch for the
plain tensor code, cuDNN for the encoder's convolutions, and a kernel
written by hand in CUDA C++ for every kernel the JAX package wrote in
Pallas for the TPU (``ops/cuda/``).  Module paths mirror
``fastdepth_tpu``'s, so each counterpart sits under the same name.

The port stands alone: it imports neither ``jax`` nor anything of
``fastdepth_tpu``.  What it shares with the JAX package holds no JAX and
is kept here as its own copy — ``config``, the host data pipeline
``data`` (with the native preprocessing library, ``csrc/preprocess.cpp``),
the npz checkpoint format and ``.pth`` converter ``checkpoint.io`` /
``checkpoint.convert``, ``viz`` and the roofline formulas.  The tests
(tests/test_torch_*.py) hold each copy equal to its original.
"""

__version__ = "0.1.0"

from fastdepth_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    MOBILENET_V1_CHANNELS,
    PRUNED_ENCODER_CHANNELS,
    PRUNED_DECODER_CHANNELS,
)

# Lazy top-level re-exports (PEP 562), as in fastdepth_tpu/__init__.py:
# `import fastdepth_tpu_torch` stays cheap and pulls in no model code.
_EXPORTS = {
    "Model": "fastdepth_tpu_torch.models.registry",
    "build": "fastdepth_tpu_torch.models.registry",
    "from_name": "fastdepth_tpu_torch.models.registry",
    "fastdepth_pruned": "fastdepth_tpu_torch.models.registry",
    "fastdepth_unpruned": "fastdepth_tpu_torch.models.registry",
    "params_from_jax": "fastdepth_tpu_torch.checkpoint.from_jax",
    "params_to_jax": "fastdepth_tpu_torch.checkpoint.from_jax",
    "load_checkpoint": "fastdepth_tpu_torch.checkpoint.io",
    "save_checkpoint": "fastdepth_tpu_torch.checkpoint.io",
    "save_train_checkpoint": "fastdepth_tpu_torch.checkpoint.io",
    "load_train_checkpoint": "fastdepth_tpu_torch.checkpoint.io",
    "TrainConfig": "fastdepth_tpu_torch.config",
    "Trainer": "fastdepth_tpu_torch.train.trainer",
    "TrainState": "fastdepth_tpu_torch.train.trainer",
    "sgd_init": "fastdepth_tpu_torch.train.trainer",
    "train_step": "fastdepth_tpu_torch.train.trainer",
    "l1_loss": "fastdepth_tpu_torch.train.loss",
    "masked_l1_loss": "fastdepth_tpu_torch.train.loss",
    # the mesh (JAX's replicate / shard_batch / shard_activations are
    # sharding objects: a port tensor lives on its rank's device, and
    # put_replicated / put_sharded place it there)
    "make_mesh": "fastdepth_tpu_torch.parallel.mesh",
    "make_mesh_2d": "fastdepth_tpu_torch.parallel.mesh",
    "mesh_from_cli": "fastdepth_tpu_torch.parallel.mesh",
    "put_replicated": "fastdepth_tpu_torch.parallel.mesh",
    "put_sharded": "fastdepth_tpu_torch.parallel.mesh",
    "fetch_global": "fastdepth_tpu_torch.parallel.mesh",
    "NYUDataset": "fastdepth_tpu_torch.data.nyu",
    "BatchLoader": "fastdepth_tpu_torch.data.loader",
    "ValPipeline": "fastdepth_tpu_torch.data.pipeline",
    "RAW_SIZE": "fastdepth_tpu_torch.data.nyu",
    "OUTPUT_SIZE": "fastdepth_tpu_torch.data.nyu",
    "Evaluator": "fastdepth_tpu_torch.engine.evaluator",
    "compile_forward": "fastdepth_tpu_torch.engine.aot",
    "validate": "fastdepth_tpu_torch.engine.evaluator",
    "Result": "fastdepth_tpu_torch.metrics",
    "AverageMeter": "fastdepth_tpu_torch.metrics",
}


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
