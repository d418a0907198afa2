"""Batched evaluation engine — counterpart of
``fastdepth_tpu/engine/evaluator.py``.

Reproduces ``validate()`` semantics (reference main.py:63-126): per-image
metrics averaged with AverageMeter, progress prints every ``print_freq``
images, a comparison PNG from every 50th of the first 400 images, and
the final report/CSV.  The model and the metrics run as one batch step on
the device; only the 10 metric scalars per image come back to the host,
in one stacked fetch per batch.  Over a data mesh (``parallel/mesh.py``)
each rank runs its rows of every batch through the same forward, and the
fetch all-gathers the ranks' metric stacks in rank order, so every rank
averages the global batch.  Over a ``space`` axis each rank also holds
its rows of every image: the forward is height-sharded
(``parallel/spatial.py``) and the per-image metric sums are all-reduced
over the space group before the divide (``metrics.evaluate_batch``).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from fastdepth_tpu_torch import viz
from fastdepth_tpu_torch import metrics as M
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.engine.aot import _prepare, normalize
from fastdepth_tpu_torch.engine.staging import PinnedRing
from fastdepth_tpu_torch.models.registry import Model
from fastdepth_tpu_torch.parallel.mesh import fetch_global, take_rows

CSV_FIELDNAMES = [
    "rmse", "mae", "delta1", "absrel", "lg10", "mse", "delta2", "delta3",
    "data_time", "gpu_time",
]  # reference main.py:20-21


class Evaluator:
    def __init__(
        self,
        model: Model,
        params,
        *,
        batch_size: int = 1,
        dtype: torch.dtype = torch.float32,
        fold_bn: bool = True,
        impl: str = "auto",
        tuning=None,
        val_pipeline=None,
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        """``params``: the tree from ``Model.load``.  ``impl``: 'auto'
        runs decoder levels 1-5 through K1 and the head through K4
        whenever the architecture allows and BN is folded; 'fused', 'opt'
        and 'xla' force the K1/K4, head-commute and straight forwards;
        'mixed' runs each decoder level on its autotuned winner from a
        ``tuning`` record path or winner map (engine/autotune.py) (all
        through engine/aot.py, which also folds in f32 before the cast to
        ``dtype``).  ``device``: 'cuda' unless given; under ``mesh``
        (a ``data``, ``space`` or 2-D mesh), the mesh's device, and the
        batches are this rank's rows (``batch_size`` stays the global
        batch, as the JAX package's dispatch reads it); :meth:`put` takes
        the rank's rows of the height under a ``space`` axis.  A CUDA ``device`` must exist: there is no CPU
        fallback.

        ``val_pipeline``: a ``data.pipeline.ValPipeline``.  The whole val
        resize/crop chain is one (rows, cols) gather, so with raw
        (480, 640) batches (``NYUDataset(raw_items=True)``) it runs on the
        device inside the step, with the host gather's values; host
        preprocessing drops to the h5 read.  Under a ``space`` axis each
        rank takes whole raw frames and gathers its rows of the index
        map."""
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
            device = mesh.device
        device = "cuda" if device is None else device
        self.model = model
        self.batch_size = batch_size
        self.dtype = dtype
        self.mesh = mesh
        self.device = torch.device(device)
        self._space = None if mesh is None else mesh.partition()
        self.params, self._apply = _prepare(model, params, batch_size=batch_size,
                                            dtype=dtype, fold_bn=fold_bn, impl=impl,
                                            device=device, space=self._space, tuning=tuning)
        # validate() keeps one batch in flight: two batches of (rgb, depth)
        self._ring = PinnedRing(self.device, slots=4)
        self._gather = None
        if val_pipeline is not None:
            rows, cols = (torch.as_tensor(np.asarray(a), dtype=torch.int64)
                          for a in (val_pipeline.rows, val_pipeline.cols))
            if self._space is not None:
                rows = take_rows(rows, self._space, 0)
            self._gather = (rows.to(self.device), cols.to(self.device))
            # the exact raw dims the gather indices were computed for: on
            # CUDA an index past a smaller (preprocessed) frame is a
            # device-side assert, and a larger frame passes any max-index
            # bound yet gathers with the wrong resize ratio, silently.
            # ValPipeline.create records raw_size; fall back to the
            # max-index bound for hand-built pipelines without it.
            self._exact = getattr(val_pipeline, "raw_size", None) is not None
            self._want_raw = val_pipeline.raw_size if self._exact else (
                int(np.max(val_pipeline.rows)) + 1, int(np.max(val_pipeline.cols)) + 1)

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` (under a mesh: this rank's rows) on the device, copied
        through page-locked memory on a card (``engine/staging.PinnedRing``).
        Under a ``space`` axis the rank's rows of the height (NHWC dim 1)
        go, or the whole raw frame with a ``val_pipeline``."""
        if self._space is not None and self._gather is None:
            arr = take_rows(torch.from_numpy(np.asarray(arr)), self._space, 1).numpy()
        return self._ring.put(arr)

    def fetch(self, t: torch.Tensor, dim: int = 0, space_dim=None) -> np.ndarray:
        """A per-row result as host numpy: under a mesh, every rank's rows
        along ``dim`` in rank order (``parallel.mesh.fetch_global``, a
        collective every rank calls), else this one's; ``space_dim``: the
        result's height dim, gathered over a ``space`` axis first (the
        prediction's 1; the metric stack has none)."""
        return fetch_global(t, self.mesh, dim, space_dim)

    def _check_raw(self, name: str, t: torch.Tensor) -> None:
        want = self._want_raw
        bad = (tuple(t.shape[1:3]) != tuple(want) if self._exact
               else (t.shape[1] < want[0] or t.shape[2] < want[1]))
        if bad:
            raise ValueError(
                f"val_pipeline gather was built for "
                f"{'exactly ' if self._exact else 'at least '}"
                f"{want[0]}x{want[1]} raw frames, "
                f"got {t.shape[1]}x{t.shape[2]} for {name} "
                f"— use NYUDataset(raw_items=True) with "
                f"matching frames, build the pipeline with "
                f"raw_size=({t.shape[1]}, {t.shape[2]}), or "
                f"drop val_pipeline for preprocessed items")

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, depth: torch.Tensor):
        """(pred (N, H, W, 1) f32, metrics (len(METRIC_FIELDS), N)), both on
        the device and not waited for.  Spans (``engine/profiler``): the
        call, and its metrics."""
        with P.annotate(P.STEP):
            if self._gather is not None:
                # both tensors are gathered: each must be a raw frame
                for name, t in (("rgb", rgb), ("depth", depth)):
                    self._check_raw(name, t)
                rows, cols = self._gather
                rgb = rgb.index_select(1, rows).index_select(2, cols)
                depth = depth.index_select(1, rows).index_select(2, cols)
            rgb = normalize(rgb, self.dtype) if rgb.dtype == torch.uint8 else rgb.to(self.dtype)
            pred = self._apply(self.params, rgb).float()
            with P.annotate(P.METRICS):
                metrics = M.evaluate_batch(
                    pred, depth, None if self._space is None else self.mesh.space_group)
                return pred, torch.stack([metrics[f] for f in M.METRIC_FIELDS])


def validate(
    loader,
    evaluator: Evaluator,
    *,
    epoch: int = 0,
    print_freq: int = 50,
    output_dir: Optional[str] = None,
    write_to_file: bool = False,
    csv_path: Optional[str] = None,
    make_images: bool = True,
    viz_transform=None,
    log=print,
) -> M.Result:
    """Full-dataset evaluation with reference-format reporting
    (main.py:63-126).  ``loader`` yields (rgb, depth, count) host batches,
    padded to a fixed size with ``count`` real rows (BatchLoader); under
    an evaluator's mesh, this rank's rows with the global ``count``, and
    every rank must call validate() (the metric fetch is a collective).
    ``viz_transform``: applied to the raw rgb and depth of the few
    comparison-strip images when the loader yields raw frames (device
    preprocessing): pass the host ``ValPipeline``."""
    meter = M.AverageMeter()
    img_merge = None
    img_saved = False
    seen = 0

    def submitted():
        """Enqueue each batch's device work (PyTorch returns before the
        device is done) and yield the in-flight results.  data_time is this
        thread's real blocking wait on the loader."""
        first = True
        it = iter(loader)
        while True:
            t_wait = time.time()
            item = next(it, None)
            if item is None:
                return
            data_time = time.time() - t_wait
            rgb, depth, count = item
            rgb_d = evaluator.put(rgb)
            depth_d = evaluator.put(depth)
            if first:
                # warm up outside the timed region: the first call pays
                # the kernel build, cuDNN's algorithm search and the
                # allocator's growth, which would poison avg.gpu_time
                evaluator(rgb_d, depth_d)[1].cpu()
                first = False
            t0 = time.time()
            pred, batch_metrics = evaluator(rgb_d, depth_d)
            yield rgb, depth, count, pred, batch_metrics, t0, data_time

    def one_ahead(gen):
        """Keep one batch in flight: batch k+1's copy + compute is enqueued
        before batch k is fetched, so the device does not idle on the
        host's metric handling."""
        prev = next(gen, None)
        while prev is not None:
            nxt = next(gen, None)
            yield prev
            prev = nxt

    for rgb, depth, count, pred, batch_metrics, t0, data_time in one_ahead(submitted()):
        # the fetch is the sync: it returns once the batch's work is done
        stacked = evaluator.fetch(batch_metrics, dim=1)  # (num_fields, N)
        valid = {f: stacked[i, :count] for i, f in enumerate(M.METRIC_FIELDS)}
        gpu_time = time.time() - t0
        meter.update_batch(valid, gpu_time=gpu_time / count, data_time=data_time / count)

        # comparison strip: every 50th of the first 8*50 images (main.py:85-98)
        if make_images and output_dir is not None:
            pred_np = None
            if any((seen + i) % 50 == 0 and (seen + i) < 8 * 50 for i in range(count)):
                pred_np = evaluator.fetch(pred, space_dim=1)
            for i in range(count):
                gi = seen + i
                if gi % 50 == 0 and gi < 8 * 50:
                    r_i, d_i = np.asarray(rgb[i]), np.asarray(depth[i])
                    if viz_transform is not None:
                        r_i, d_i = viz_transform(r_i), viz_transform(d_i)
                    row = viz.merge_into_row(r_i, d_i, pred_np[i])
                    img_merge = row if img_merge is None else viz.add_row(img_merge, row)
                elif gi == 8 * 50 and img_merge is not None and not img_saved:
                    viz.save_image(img_merge, os.path.join(output_dir, f"comparison_{epoch}.png"))
                    img_saved = True
        seen += count

        # print every `print_freq` images (reference main.py:100-108)
        if print_freq and (seen % print_freq) < count:
            avg = meter.average()
            last = {k: float(v[-1]) for k, v in valid.items()}
            log(
                f"Test: [{seen}/{len(loader.dataset)}]\t"
                f"t_GPU={gpu_time / count:.3f}({avg.gpu_time:.3f})\n\t"
                f"RMSE={last['rmse']:.2f}({avg.rmse:.2f}) "
                f"MAE={last['mae']:.2f}({avg.mae:.2f}) "
                f"Delta1={last['delta1']:.3f}({avg.delta1:.3f}) "
                f"REL={last['absrel']:.3f}({avg.absrel:.3f}) "
                f"Lg10={last['lg10']:.3f}({avg.lg10:.3f}) "
            )
    if seen == 0:
        raise ValueError(
            "validate(): the loader yielded no batches (empty split or "
            "dataset) — nothing to average")
    if make_images and output_dir is not None and img_merge is not None and not img_saved:
        viz.save_image(img_merge, os.path.join(output_dir, f"comparison_{epoch}.png"))
    avg = meter.average()
    log(
        "\n*\n"
        f"RMSE={avg.rmse:.3f}\n"
        f"MAE={avg.mae:.3f}\n"
        f"Delta1={avg.delta1:.3f}\n"
        f"REL={avg.absrel:.3f}\n"
        f"Lg10={avg.lg10:.3f}\n"
        f"t_GPU={avg.gpu_time:.3f}\n"
    )
    if write_to_file and csv_path:
        new = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_FIELDNAMES)
            if new:
                w.writeheader()
            w.writerow({
                "mse": avg.mse, "rmse": avg.rmse, "absrel": avg.absrel,
                "lg10": avg.lg10, "mae": avg.mae, "delta1": avg.delta1,
                "delta2": avg.delta2, "delta3": avg.delta3,
                "data_time": avg.data_time, "gpu_time": avg.gpu_time,
            })
    return avg
