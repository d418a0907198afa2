"""NYU Depth v2 dataset.

Reference semantics (dataloaders/dataloader.py + dataloaders/nyu.py):

* items are ``*.h5`` files under class subdirectories of the split root,
  discovered with sorted directory walks (dataloader.py:31-44),
* h5 keys: 'rgb' (3, H, W) uint8 -> HWC, 'depth' (H, W) float
  (dataloader.py:8-13),
* split filter (nyu.py:13-24): val = all .h5; train = all except
  00001.h5 / 00201.h5; holdout = only those two,
* val transform = fused ValPipeline + /255 on RGB (nyu.py:48-59),
* train transform = TrainPipeline + ColorJitter(0.4, 0.4, 0.4) + /255
  (nyu.py:26-46, dataloader.py:46).

Output convention is NHWC float32: rgb (H, W, 3) in [0, 1], depth
(H, W, 1) in meters — the channels-last layout (the reference emits CHW,
dataloader.py:90-111).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from fastdepth_tpu_torch.data import transforms as T
from fastdepth_tpu_torch.data.pipeline import TrainPipeline, TrainSample, ValPipeline

RAW_SIZE = (480, 640)   # nyu.py:5
OUTPUT_SIZE = (224, 224)  # nyu.py:11


def h5_loader(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    from fastdepth_tpu_torch.data import native

    with h5py.File(path, "r") as f:
        rgb = native.chw_to_hwc_u8(np.asarray(f["rgb"], np.uint8))
        depth = np.array(f["depth"])
    return rgb, depth


class NYUDataset:
    modality_names = ["rgb"]

    def __init__(
        self,
        root: str,
        split: str,
        modality: str = "rgb",
        loader=h5_loader,
        seed: int = 0,
        device_normalize: bool = False,
        raw_items: bool = False,
        device_augment: bool = False,
    ):
        # device_normalize: emit uint8 RGB and let the device do the /255
        # (exactly the same math in f32) — quarters host->device transfer
        # and skips a host-side float conversion pass.
        # raw_items: emit the RAW (480, 640) uint8 rgb / f32 depth with NO
        # host geometry at all — the whole val resize/crop chain is a
        # fixed gather, so it runs on device inside the eval jit
        # (Evaluator(val_pipeline=...)); host work drops to the h5 read.
        # device_augment: emit RAW frames plus the per-item augmentation
        # PARAMETERS (composed gather map, depth scale, jitter plan) and
        # let the jitted train step run every pixel op on device
        # (data/device_aug.py) — host work drops to the h5 read + index
        # math.  Item = (rgb_raw u8 HWC, depth_raw f32 HW, flat i32,
        # scale f32, tables u8[3,256,256], kinds i32[3]).
        if device_augment and split != "train":
            raise ValueError(
                "device_augment targets train; eval's equivalent is "
                "raw_items + Evaluator(val_pipeline=...)")
        if raw_items and split == "train":
            raise ValueError(
                "raw_items targets eval; use device_augment for the "
                "train chain (raw frames + on-device augmentation)")
        if device_normalize and split == "train":
            raise ValueError(
                "device_normalize targets eval; train items are emitted "
                "as normalized float (the augmentation chain needs floats)")
        if split not in ("train", "holdout", "val"):
            raise RuntimeError(
                f"Invalid dataset split: {split}\n"
                "Supported dataset splits are: train, holdout, val"
            )
        if modality not in self.modality_names:
            raise RuntimeError(f"Invalid modality: {modality}")
        self.root = root
        self.split = split
        self.modality = modality
        self.loader = loader
        self.imgs = self._make_dataset(root, split)
        assert len(self.imgs) > 0, f"Found 0 images in subfolders of: {root}\n"
        self.val_pipeline = ValPipeline.create(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE)
        self.train_pipeline = TrainPipeline(raw_size=RAW_SIZE, output_size=OUTPUT_SIZE)
        self.color_jitter = T.ColorJitter(0.4, 0.4, 0.4)
        self.seed = seed
        self._epoch = 0
        self.device_normalize = device_normalize
        self.raw_items = raw_items
        self.device_augment = device_augment

    def set_epoch(self, epoch: int) -> None:
        """Vary the per-item augmentation streams across epochs (called
        by BatchLoader.set_epoch)."""
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.RandomState:
        """Deterministic per-(seed, epoch, item) augmentation stream.

        A single shared RandomState would be drawn from concurrently by
        BatchLoader's worker threads, making augmentations depend on
        thread scheduling; keying the stream on the item index instead
        makes every draw reproducible at any worker count."""
        return np.random.RandomState(
            (self.seed * 9176 + self._epoch * 2654435761 + index * 97)
            % (2 ** 32))

    @staticmethod
    def _is_image_file(filename: str, split: str) -> bool:
        if not filename.endswith(".h5"):
            return False
        held_out = "00001.h5" in filename or "00201.h5" in filename
        if split == "train":
            return not held_out
        if split == "holdout":
            return held_out
        return True  # val

    @classmethod
    def _make_dataset(cls, root: str, split: str) -> List[str]:
        root = os.path.expanduser(root)
        paths: List[str] = []
        for target in sorted(os.listdir(root)):
            d = os.path.join(root, target)
            if not os.path.isdir(d):
                continue
            for walk_root, _, fnames in sorted(os.walk(d)):
                for fname in sorted(fnames):
                    if cls._is_image_file(fname, split):
                        paths.append(os.path.join(walk_root, fname))
        return paths

    def __len__(self) -> int:
        return len(self.imgs)

    def take(self, n: int) -> "NYUDataset":
        """Shallow view over the first ``n`` items (bounded fidelity /
        parity runs — cli/fidelity.py --limit)."""
        import copy

        ds = copy.copy(self)
        ds.imgs = self.imgs[: int(n)]
        return ds

    def get_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.loader(self.imgs[index])

    def device_augment_item(self, index: int):
        """(rgb_raw, depth_raw, flat, scale, tables, kinds) for the
        on-device train pipeline (data/device_aug.py).  Draw order
        matches __getitem__'s host path exactly — TrainSample first,
        then the jitter plan from the SAME per-item stream — so host and
        device paths produce bit-identical augmented items for any
        (seed, epoch, index).  Each jitter op ships as a host-baked
        (256, 256) PIL-blend value grid; the device computes only
        integer row indices (no float enhance arithmetic on device —
        FMA contraction there flips truncations)."""
        rgb, depth = self.get_raw(index)
        rng = self._item_rng(index)
        sample = TrainSample.draw(rng)
        plan = self.color_jitter.draw_plan(rng)
        if any(kind == T.ColorJitter.HUE for kind, _ in plan):
            raise ValueError(
                "device_augment has no hue kernel (NYU jitter is "
                "(0.4, 0.4, 0.4) with hue=0, reference dataloader.py:46); "
                "keep hue-jitter datasets on the host pipeline")
        flat, mask = self.train_pipeline.composed_indices(sample)
        # fold the rotation pad into the map (-1), int32: raw planes are
        # 480*640 = 307200 << 2^31
        flat32 = np.where(mask, -1, flat).ravel().astype(np.int32)
        kinds = np.zeros(3, np.int32)
        tables = np.empty((3, 256, 256), np.uint8)
        for j, (kind, f) in enumerate(plan):
            kinds[j] = kind
            tables[j] = T.blend_grid(f)
        for j in range(len(plan), 3):  # unused slots pass through
            tables[j] = T.identity_grid()
        return (rgb, np.asarray(depth, np.float32), flat32,
                np.float32(sample.scale), tables, kinds)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.device_augment:
            return self.device_augment_item(index)
        rgb, depth = self.get_raw(index)
        if self.raw_items:
            return rgb, depth.astype(np.float32)[..., None]
        if self.split == "train":
            rng = self._item_rng(index)
            sample = TrainSample.draw(rng)
            rgb_np, depth_np = self.train_pipeline(
                rgb, depth, sample, color_jitter=self.color_jitter, rng=rng
            )
        else:
            from fastdepth_tpu_torch.data import native

            pipe = self.val_pipeline
            if self.device_normalize:
                rgb_np = np.ascontiguousarray(pipe(rgb))
            else:
                rgb_np = native.gather_rgb_f32(rgb, pipe.rows, pipe.cols)
            depth_np = native.gather_depth_f32(depth, pipe.rows, pipe.cols)
        return rgb_np, depth_np[..., None]
