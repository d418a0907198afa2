"""Batched evaluation engine — counterpart of
``fastdepth_tpu/engine/evaluator.py``.

Reproduces ``validate()`` semantics (reference main.py:63-126): per-image
metrics averaged with AverageMeter, progress prints every ``print_freq``
images, a comparison PNG from every 50th of the first 400 images, and
the final report/CSV.  The model and the metrics run as one batch step on
the device; only the 10 metric scalars per image come back to the host,
in one stacked fetch per batch.
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
from fastdepth_tpu_torch.engine.aot import _prepare, normalize
from fastdepth_tpu_torch.models.registry import Model

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
        device: Union[str, torch.device] = "cuda",
    ):
        """``params``: the tree from ``Model.load``.  ``impl``: 'auto'
        runs decoder levels 1-5 through K1 and the head through K4
        whenever the architecture allows and BN is folded; 'fused', 'opt'
        and 'xla' force the K1/K4, head-commute and straight forwards
        (engine/aot.py, which also folds in f32 before the cast to
        ``dtype``).  A CUDA ``device`` must exist: there is no CPU
        fallback."""
        self.model = model
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.params, self._apply = _prepare(model, params, batch_size=batch_size,
                                            dtype=dtype, fold_bn=fold_bn, impl=impl,
                                            device=device)

    def put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, depth: torch.Tensor):
        """(pred (N, H, W, 1) f32, metrics (len(METRIC_FIELDS), N)), both on
        the device and not waited for."""
        rgb = normalize(rgb, self.dtype) if rgb.dtype == torch.uint8 else rgb.to(self.dtype)
        pred = self._apply(self.params, rgb).float()
        metrics = M.evaluate_batch(pred, depth)
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
    log=print,
) -> M.Result:
    """Full-dataset evaluation with reference-format reporting
    (main.py:63-126).  ``loader`` yields (rgb, depth, count) host batches,
    padded to a fixed size with ``count`` real rows (BatchLoader)."""
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
        stacked = batch_metrics.cpu().numpy()  # (num_fields, N)
        valid = {f: stacked[i, :count] for i, f in enumerate(M.METRIC_FIELDS)}
        gpu_time = time.time() - t0
        meter.update_batch(valid, gpu_time=gpu_time / count, data_time=data_time / count)

        # comparison strip: every 50th of the first 8*50 images (main.py:85-98)
        if make_images and output_dir is not None:
            pred_np = None
            if any((seen + i) % 50 == 0 and (seen + i) < 8 * 50 for i in range(count)):
                pred_np = pred.cpu().numpy()
            for i in range(count):
                gi = seen + i
                if gi % 50 == 0 and gi < 8 * 50:
                    row = viz.merge_into_row(np.asarray(rgb[i]), np.asarray(depth[i]), pred_np[i])
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
