"""Training: SGD with momentum and weight decay, train-mode BatchNorm, data
parallelism — counterpart of ``fastdepth_tpu/train/trainer.py``.

The reference release has no train loop (its main.py implements only
--evaluate); this rebuilds the FastDepth training recipe (BASELINE.json
config #5): masked L1 loss, SGD with momentum from the converted
pretrained MobileNet, step LR decay, and the {epoch, best_result, model}
checkpoint cycle with best-epoch tracking.

A step is eager PyTorch: the straight forward with train-mode BatchNorm
(cuDNN's convolutions on the card), ``torch.autograd`` for the
gradients, the SGD update over one flat buffer of every trainable leaf,
then the merge of the BatchNorm running statistics.  The JAX train step
runs no Pallas kernel (K1-K4 have no backward), so this one runs none of
the port's kernels either; they serve the validation between epochs.

Data parallelism (``mesh``, ``parallel/mesh.py``) is one rank per device,
each stepping on its rows of the global batch.  The JAX mesh step equals
the single-device step on the whole batch, because XLA reduces the
BatchNorm moments and the masked-L1 denominator over the global array;
so does this one, by explicit collectives: global BatchNorm moments
(``ops.blocks.batch_norm_train(group=)``), the global valid-pixel count,
then ONE all-reduce (SUM) of the flat gradient buffer, with the loss in
its last element, per step.  Not DistributedDataParallel: it averages
gradients, a factor of the world size off under the global loss, and
would bucket a second time beside the flat buffer.  Every rank then
applies the same update to the same state, so replicas stay bit-equal,
and a non-finite value on any rank reaches every rank through the sum, so
all skip the step alike.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.engine.staging import PinnedRing
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.models.registry import Model
from fastdepth_tpu_torch.parallel.mesh import SPACE_AXIS
from fastdepth_tpu_torch.train.loss import masked_l1_loss

SPACE_TRAIN_REFUSED = (
    "training does not support a 'space' mesh axis: the port's height-sharded "
    "forward (parallel/spatial.py) exchanges each conv's halo rows by hand and "
    "has no backward for those exchanges, so its gradients would miss the "
    "halo's terms. Use a 1-D 'data' mesh for training; 'space' is for "
    "inference/eval (Evaluator, serving).")


def _channels_last(t: torch.Tensor) -> bool:
    return t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
        memory_format=torch.channels_last)


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a 1-D tensor in its memory order (NHWC for a channels_last
    4-D tensor): a view where the strides allow, else a copy."""
    return t.permute(0, 2, 3, 1).reshape(-1) if _channels_last(t) else t.reshape(-1)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([_memory_order(t) for t in tensors])


def _views(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of the 1-D ``buf`` laid out as :func:`_flat` lays out
    ``like``: each with its tensor's shape and memory format."""
    out, off = [], 0
    for t in like:
        v = buf[off:off + t.numel()]
        off += t.numel()
        if _channels_last(t):
            n, c, h, w = t.shape
            out.append(v.view(n, h, w, c).permute(0, 3, 1, 2))
        else:
            out.append(v.view(t.shape))
    return out


class _Flat:
    """One buffer for the trainable leaves, one for their momentum and one
    for the BatchNorm running statistics; the tree's tensors are views of
    them, so the update and the statistics merge are a few whole-buffer
    operations instead of a few per leaf."""

    def __init__(self, params: nn.ModuleDict):
        names, self.leaves = zip(*params.named_parameters())
        running = [(k, b) for k, b in params.named_buffers()
                   if k.split(".")[-2:] in (["bn", "mean"], ["bn", "var"])]
        # (BatchNorm path, 'mean' | 'var') per running statistic, in buffer order
        self.running_keys = [(tuple(k.split(".")[:-1]), k.split(".")[-1]) for k, _ in running]
        buffers = [b for _, b in running]
        with torch.no_grad():
            self.params = _flat(self.leaves)
            for t, v in zip(self.leaves, _views(self.params, self.leaves)):
                t.data = v
            self.momentum = torch.zeros_like(self.params)
            self.running = _flat(buffers) if buffers else self.params.new_zeros(0)
            for t, v in zip(buffers, _views(self.running, buffers)):
                t.data = v
        self.momentum_views = dict(zip(names, _views(self.momentum, self.leaves)))
        spared = [k for k in names if not _is_decayed(k)]
        if spared:  # the update decays the whole buffer
            raise ValueError(f"trainable leaves outside weight decay: {spared}")

    def merge(self, stats: L.StatsDict) -> None:
        """Write the running statistics a train-mode forward recorded."""
        with torch.no_grad():
            self.running.copy_(torch.cat([stats[path][k].reshape(-1)
                                          for path, k in self.running_keys]))


@dataclasses.dataclass
class TrainState:
    """``params``: the f32 master tree, its parameters trainable;
    ``momentum``: one SGD buffer per state-dict key of ``params`` (those
    of the BatchNorm running statistics stay zero, as the JAX package's
    tree-wide ``zeros_like`` keeps them, so a checkpoint has the same
    leaves in both packages); ``step``: an int32 count.  A train step
    updates all three in place; ``flat`` holds the buffers the trainable
    leaves, their momentum and the running statistics are views of."""

    params: nn.ModuleDict
    momentum: Dict[str, torch.Tensor]
    step: torch.Tensor
    flat: _Flat


def sgd_init(params: nn.ModuleDict) -> TrainState:
    """Turn ``params``'s gradients on, lay its trainable leaves and running
    statistics out in flat buffers (both in place: the tree's tensors
    become views of them), and give it zero momentum and step 0, on its
    device."""
    params.requires_grad_(True)
    flat = _Flat(params)
    momentum = {k: flat.momentum_views[k] if k in flat.momentum_views else torch.zeros_like(v)
                for k, v in params.state_dict().items()}
    step = torch.zeros((), dtype=torch.int32, device=flat.params.device)
    return TrainState(params=params, momentum=momentum, step=step, flat=flat)


def _is_decayed(key: str) -> bool:
    """Weight decay covers every trainable leaf — conv weights, biases and
    BatchNorm scale/bias — because the reference-era recipe is
    ``torch.optim.SGD(model.parameters(), weight_decay=wd)``.  The running
    mean/var are buffers: never decayed.  ``key`` is a state-dict key."""
    parts = key.split(".")
    if len(parts) > 1 and parts[-2] == "bn":
        return parts[-1] in ("scale", "bias")
    return parts[-1] in ("w", "b")


def _cast_compute(params: nn.ModuleDict, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The compute-dtype view of the masters, for ``functional_call``:
    every floating parameter outside a ``bn`` subtree cast to ``dtype`` (a
    cast autograd carries back to the f32 master).  BatchNorm's scale and
    bias stay f32, and its moments are taken in f32
    (``ops.blocks.batch_norm_train``)."""
    return {k: p.to(dtype) for k, p in params.named_parameters()
            if "bn" not in k.split(".")[:-1] and p.is_floating_point()}


class _Forward(nn.ModuleDict):
    """The tree's subtrees (shared, not copied) under a module whose
    forward is the model's train-mode forward: what ``functional_call``
    runs on the compute-dtype view of the leaves."""

    def __init__(self, model: Model, params: nn.ModuleDict):
        super().__init__(dict(params.items()))
        self.model = model

    def forward(self, x: torch.Tensor, stats: L.StatsDict) -> torch.Tensor:
        return self.model.apply(self, x, train=True, stats=stats)


def sgd_update(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, lr, cfg: TrainConfig,
               finite: torch.Tensor, *, decayed: torch.Tensor = None):
    """One SGD step on flat buffers: ``m <- momentum * m + g`` and ``p <- p
    - lr * m``, returned as ``(p, m)``.  ``finite`` (a bool device scalar)
    gates the step: where it is false, ``p`` and ``m`` come back
    unchanged.  ``decayed`` (the parameters that take weight decay) adds
    ``weight_decay * decayed`` to ``g`` before the gate: on a skipped step
    the effective gradient is exactly zero, and the momentum does not
    absorb ``wd * p``."""
    lr = torch.where(finite, torch.as_tensor(lr, dtype=p.dtype, device=p.device), 0.0)
    if decayed is not None:
        g = g + cfg.weight_decay * decayed
    g = torch.where(finite, g, 0.0)
    m_new = torch.where(finite, cfg.momentum * m + g, m)
    return p - lr * m_new, m_new


def make_train_step(
    model: Model,
    cfg: TrainConfig,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = masked_l1_loss,
    *,
    remat: bool = False,
    compute_dtype: torch.dtype = None,
    accum_steps: int = 1,
    mesh=None,
    device_augment: bool = False,
):
    """Returns ``step(state, rgb, depth, lr) -> (state, loss)``: one SGD
    step on the NHWC batch, ``state`` updated in place; ``loss`` is an f32
    scalar on the device, not waited for.  With ``device_augment`` it
    returns ``aug_step(state, rgb_raw, depth_raw, flat, scale, tables,
    kinds, lr)``, which runs ``data/device_aug.apply_train_augment`` on the
    raw batch (``NYUDataset(device_augment=True)``'s items) and then the
    same step on the augmented batch, in the masters' dtype.

    ``remat``: recompute the forward during the backward
    (``torch.utils.checkpoint``), activation memory for FLOPs; the cast
    to ``compute_dtype`` sits inside, so it is recomputed too.
    ``accum_steps``: split the batch into that many equal microbatches,
    run one after another, and apply one update from the mean of their
    gradients.  Each microbatch normalises by its own moments, and the
    running statistics merge microbatch after microbatch (k sequential
    torch forwards); the loss is the microbatches' mean.
    A NaN/Inf loss or gradient skips the update on the device
    (``torch.where``, no host sync): parameters, momentum and running
    statistics stay bit-identical, and only the step counter moves.
    ``compute_dtype``: ``torch.bfloat16`` runs the forward and backward in
    bf16 on f32 masters; momentum, the optimiser's math, the BatchNorm
    moments and running statistics and the loss stay f32 (bf16 has f32's
    exponent range: no loss scaling).
    ``mesh``: a data mesh (``parallel.mesh.make_mesh``); ``rgb`` and
    ``depth`` are then this rank's rows of the global batch, and the
    step's loss and update are the global batch's (module docstring).
    With ``accum_steps`` the rows must be laid out as
    ``data.loader.shard_rows`` lays them: this rank's share of each
    microbatch, microbatch after microbatch, so that microbatch ``i`` is
    the global rows ``[i * mb, (i + 1) * mb)``, as in the JAX mesh step.
    A step built without a mesh refuses to run inside a process group of
    more than one rank: each rank would silently train its own replica.
    ``loss_fn`` takes ``group=`` under a mesh (``train.loss``)."""
    if mesh is not None and SPACE_AXIS in mesh.axis_names:
        raise ValueError(SPACE_TRAIN_REFUSED)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if compute_dtype == torch.float32:
        compute_dtype = None
    group = None if mesh is None else mesh.group

    def forward(params, rgb):
        # the statistics leave as outputs: under remat the forward runs
        # again in the backward (its BatchNorms all-reducing again, on
        # every rank alike), and what that second run records is dropped
        stats = L.TrainStats(group)
        if compute_dtype is None:
            pred = model.apply(params, rgb, train=True, stats=stats)
        else:
            pred = functional_call(_Forward(model, params), _cast_compute(params, compute_dtype),
                                   (rgb.to(compute_dtype), stats))
        return pred, stats

    def loss_and_grads(params, leaves, rgb, depth):
        with torch.enable_grad():
            if remat:
                pred, stats = checkpoint(forward, params, rgb, use_reentrant=False)
            else:
                pred, stats = forward(params, rgb)
            # the loss is always f32: the targets are f32 and the masked
            # reduction must not accumulate in bf16
            loss = (loss_fn(pred.float(), depth) if group is None
                    else loss_fn(pred.float(), depth, group=group))
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), stats, _flat(grads)

    def step(state: TrainState, rgb: torch.Tensor, depth: torch.Tensor, lr):
        if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                f"a train step built without a mesh inside a process group of "
                f"{dist.get_world_size()} ranks: each rank would train its own replica "
                "on its rows. Build it with make_train_step(mesh=make_mesh()) / "
                "Trainer(mesh=...)")
        flat = state.flat
        n = rgb.shape[0]
        if n % accum_steps:
            raise ValueError(
                f"batch size {n} is not divisible by accum_steps={accum_steps}: "
                "microbatches must be equal-sized (unequal BN moments and loss "
                "weights would silently skew the accumulated gradient)")
        mb = n // accum_steps
        before = flat.running.clone()
        grads = loss = None
        for i in range(accum_steps):
            rows = slice(i * mb, (i + 1) * mb)
            loss_i, stats_i, grads_i = loss_and_grads(state.params, flat.leaves, rgb[rows],
                                                      depth[rows])
            grads = grads_i if grads is None else grads + grads_i
            loss = loss_i if loss is None else loss + loss_i
            # merged now, so the next microbatch's statistics build on
            # these; the gate below puts them back on a skipped step
            flat.merge(stats_i)
        if accum_steps > 1:
            grads, loss = grads / accum_steps, loss / accum_steps
        if group is not None:
            # the global gradient and loss: every rank's shares, summed
            buf = torch.cat([grads, loss.reshape(1).to(grads.dtype)])
            dist.all_reduce(buf, group=group)
            grads, loss = buf[:-1], buf[-1].to(loss.dtype)
        with torch.no_grad():
            finite = torch.isfinite(loss) & torch.isfinite(grads).all()
            p_new, m_new = sgd_update(flat.params, flat.momentum, grads, lr, cfg, finite,
                                      decayed=flat.params if cfg.weight_decay else None)
            flat.params.copy_(p_new)
            flat.momentum.copy_(m_new)
            flat.running.copy_(torch.where(finite, flat.running, before))
            state.step += 1
        return state, loss

    if not device_augment:
        return step

    from fastdepth_tpu_torch.data.device_aug import apply_train_augment

    out_size = tuple(model.config.output_size)

    def aug_step(state: TrainState, rgb_raw, depth_raw, flat, scale, tables, kinds, lr):
        rgb, depth = apply_train_augment(rgb_raw, depth_raw, flat, scale, tables, kinds,
                                         out_size=out_size)
        dtype = state.flat.params.dtype
        return step(state, rgb.to(dtype), depth.to(dtype), lr)

    return aug_step


def train_step(model: Model, cfg: TrainConfig):
    """Back-compat alias returning the raw step function."""
    return make_train_step(model, cfg)


def step_lr(cfg: TrainConfig, epoch: int) -> float:
    """Step decay: lr * gamma^(epoch // step) (FastDepth recipe).  A
    non-positive ``lr_decay_step`` means "no decay"."""
    if cfg.lr_decay_step <= 0:
        return cfg.lr
    return cfg.lr * (cfg.lr_decay_gamma ** (epoch // cfg.lr_decay_step))


class Trainer:
    """Runs the training loop on one device, or on this rank's device of a
    data mesh: a copy of ``params`` there as the f32 masters, the step,
    and the epoch loop."""

    def __init__(
        self,
        model: Model,
        params: nn.ModuleDict,
        cfg: TrainConfig,
        mesh=None,
        loss_fn: Callable = masked_l1_loss,
        remat: bool = False,
        compute_dtype: torch.dtype = None,
        accum_steps: int = 1,
        device_augment: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        """``device``: 'cuda' unless given; under ``mesh``, the mesh's
        device (another one is refused).  A CUDA ``device`` must exist:
        there is no CPU fallback.  In f32 (``compute_dtype`` None or
        float32) f32 is true f32: ``engine.aot.strict_f32`` turns TF32 off,
        process-wide; bf16 leaves the flags as it finds them.  ``params``
        is copied, never moved; under a mesh every rank must pass the same
        values.  A mesh with a ``space`` axis is refused
        (:func:`make_train_step`): the halo exchanges have no backward."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but no CUDA device is available")
        if compute_dtype in (None, torch.float32):
            from fastdepth_tpu_torch.engine.aot import strict_f32

            strict_f32()
        self.model = model
        self.cfg = cfg
        self.state = sgd_init(copy.deepcopy(params).to(self.device))
        self._step = make_train_step(model, cfg, loss_fn, remat=remat,
                                     compute_dtype=compute_dtype, accum_steps=accum_steps,
                                     mesh=mesh, device_augment=device_augment)

    def restore(self, tree) -> None:
        """Resume from a saved training state (the tree
        ``checkpoint.io.load_train_checkpoint`` returns, in either
        package's layout): params, momentum and the step counter, copied
        bit for bit into the trainer's tensors."""
        from fastdepth_tpu_torch.checkpoint.from_jax import params_from_jax

        st = self.state
        st.params.load_state_dict(params_from_jax(tree["params"]), strict=True)
        momentum = params_from_jax(tree["momentum"])
        if momentum.keys() != st.momentum.keys():
            raise ValueError("the checkpoint's momentum leaves differ from the params': "
                             f"{sorted(momentum.keys() ^ st.momentum.keys())}")
        with torch.no_grad():
            for k, v in momentum.items():
                st.momentum[k].copy_(v)
            st.step.fill_(int(np.asarray(tree["step"])))

    def run_epoch(self, loader, epoch: int, log=print, print_freq: int = 50) -> float:
        """One pass over ``loader``, whose batches are ``(*arrays, count)``:
        ``(rgb, depth)`` or, with ``device_augment``, the six raw arrays.
        The arrays reach the device through a ring of page-locked buffers
        (``engine/staging.PinnedRing``), so the host loads the next batch
        while the card runs this one.  Under a mesh the arrays are this
        rank's rows and ``count`` is the global batch's; the returned loss
        is the global one."""
        lr = step_lr(self.cfg, epoch)
        # the loss sums on the device: a float(loss) each step would wait
        # for the device every step; the host reads it only at print_freq
        # and at the end of the epoch
        total = None
        n = 0
        ring = None
        ranks = 1 if self.mesh is None else self.mesh.size
        for i, (*arrays, count) in enumerate(loader):
            if count != arrays[0].shape[0] * ranks:
                raise ValueError(
                    f"run_epoch got a padded batch ({count} real rows in a global batch of "
                    f"{arrays[0].shape[0] * ranks}): the zero rows would enter the BN batch "
                    f"statistics "
                    f"and couple real-row gradients to padding. Build the train loader "
                    f"with drop_last=True, pad_last=False (cli.train does).")
            if ring is None:  # two batches in flight
                ring = PinnedRing(self.device, slots=2 * len(arrays))
            self.state, loss = self._step(self.state, *[ring.put(a) for a in arrays], lr)
            total = loss if total is None else total + loss
            n += 1
            if print_freq and (i + 1) % print_freq == 0:
                log(f"Epoch {epoch} [{i + 1}/{len(loader)}] "
                    f"loss={float(total) / n:.4f} lr={lr:.4g}")
        return float(total) / n if n else 0.0
