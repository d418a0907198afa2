"""Fused geometric preprocessing pipelines.

Every geometric op in the NYU pipelines (reference dataloaders/nyu.py:26-59)
is a nearest-neighbor gather or a crop, so an entire pipeline composes into
ONE pair of (row, col) index vectors applied as a single fancy-index per
image — replacing the reference's per-item PIL/scipy chain (its hot spot,
SURVEY.md §3.2) with O(1) precomputation + one vectorized gather.  The
train pipeline only breaks at the rotation, which is applied at the small
250x333 intermediate exactly like the reference ("for computational
efficiency", nyu.py:34).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from fastdepth_tpu_torch.data import transforms as T


@dataclasses.dataclass(frozen=True)
class ValPipeline:
    """Fused val geometry: Resize(250/480) -> CenterCrop(228, 304) ->
    Resize(224, 224) (reference nyu.py:48-59)."""

    rows: np.ndarray
    cols: np.ndarray
    output_size: Tuple[int, int]
    # the exact raw frame dims the rows/cols were computed for: consumers
    # (Evaluator's trace-time guard) must reject any OTHER raw size — a
    # larger frame passes a max-index bound check but gathers with the
    # wrong resize ratio, silently skewing every metric
    raw_size: Optional[Tuple[int, int]] = None

    @classmethod
    def create(
        cls,
        raw_size: Tuple[int, int] = (480, 640),
        first_resize: float = 250.0 / 480.0,
        crop_size: Tuple[int, int] = (228, 304),
        output_size: Tuple[int, int] = (224, 224),
    ) -> "ValPipeline":
        h, w = raw_size
        h1, w1 = T.imresize_output_size(h, w, first_resize)
        rows1 = T.nearest_resize_indices(h, h1)
        cols1 = T.nearest_resize_indices(w, w1)
        th, tw = crop_size
        i0, j0 = T.center_crop_offsets(h1, w1, th, tw)
        rows2 = T.nearest_resize_indices(th, output_size[0])
        cols2 = T.nearest_resize_indices(tw, output_size[1])
        return cls(rows=rows1[i0 + rows2], cols=cols1[j0 + cols2],
                   output_size=output_size, raw_size=(h, w))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Apply to one HW or HWC image (any dtype; value-preserving)."""
        return img[self.rows][:, self.cols]

    def apply_batch(self, imgs: np.ndarray) -> np.ndarray:
        """Apply to an (N, H, W[, C]) stack in one gather."""
        return imgs[:, self.rows][:, :, self.cols]


@dataclasses.dataclass(frozen=True)
class TrainSample:
    """Random augmentation parameters for one train item
    (reference nyu.py:26-31): scale s ~ U[1, 1.5], rotation ~ U[-5, 5] deg,
    hflip ~ Bernoulli(0.5)."""

    scale: float
    angle: float
    do_flip: bool

    @classmethod
    def draw(cls, rng: np.random.RandomState) -> "TrainSample":
        return cls(
            scale=float(rng.uniform(1.0, 1.5)),
            angle=float(rng.uniform(-5.0, 5.0)),
            do_flip=bool(rng.uniform(0.0, 1.0) < 0.5),
        )


class TrainPipeline:
    """Train geometry: Resize(250/480) -> Rotate -> Resize(s) ->
    CenterCrop(228, 304) -> HFlip -> Resize(224) (reference nyu.py:33-41),
    with everything after the rotation fused into one gather."""

    def __init__(
        self,
        raw_size: Tuple[int, int] = (480, 640),
        first_resize: float = 250.0 / 480.0,
        crop_size: Tuple[int, int] = (228, 304),
        output_size: Tuple[int, int] = (224, 224),
    ):
        h, w = raw_size
        self.h1, self.w1 = T.imresize_output_size(h, w, first_resize)
        self.rows1 = T.nearest_resize_indices(h, self.h1)
        self.cols1 = T.nearest_resize_indices(w, self.w1)
        self.crop_size = crop_size
        self.output_size = output_size
        # the final-resize index vectors depend only on crop/output size:
        # precompute once (this runs per item per epoch on the host)
        th, tw = crop_size
        self._rows2 = T.nearest_resize_indices(th, output_size[0])
        self._cols2 = T.nearest_resize_indices(tw, output_size[1])
        self._cols2_flipped = (tw - 1) - self._cols2
        # flat map small->raw composing the first resize: the rotation's
        # index plane (order-0 picks source pixels value-independently)
        # chains through this to turn the whole geometry into one
        # raw->output gather (see composed_indices)
        self._small_to_raw = (
            self.rows1[:, None] * w + self.cols1[None, :]).ravel()

    def post_rotate_indices(self, s: TrainSample) -> Tuple[np.ndarray, np.ndarray]:
        hs, ws = T.imresize_output_size(self.h1, self.w1, s.scale)
        rows_s = T.nearest_resize_indices(self.h1, hs)
        cols_s = T.nearest_resize_indices(self.w1, ws)
        th, tw = self.crop_size
        i0, j0 = T.center_crop_offsets(hs, ws, th, tw)
        # flip the 304-wide crop before the final resize
        # (np.fliplr at nyu.py:39 via transforms.py:485-510)
        cols2 = self._cols2_flipped if s.do_flip else self._cols2
        return rows_s[i0 + self._rows2], cols_s[j0 + cols2]

    def composed_indices(
        self, s: TrainSample
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The WHOLE train geometry (first resize -> rotate -> scale
        resize -> crop -> flip -> final resize) as ONE flat raw->output
        index map plus the rotation's zero-pad mask.

        Order-0 rotation selects source pixels independently of their
        values, so a flat-index gather map with scipy's exact rotate
        semantics (reference transforms.py:306-308; -1 marks the
        constant-pad region) yields bit-identical pixel selection while
        computing ONE index plane instead of rotating four image
        channels — the rotate was ~60% of per-item host time
        (docs/kernel_notes.md, host-pipeline section)."""
        rot = T.rotate_nearest_indices(self.h1, self.w1, s.angle)
        rows, cols = self.post_rotate_indices(s)
        flat_small = rot[rows][:, cols]
        mask = flat_small < 0
        flat_raw = self._small_to_raw[np.where(mask, 0, flat_small)]
        return flat_raw, mask

    def __call__(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        sample: TrainSample,
        color_jitter: Optional[T.ColorJitter] = None,
        rng: Optional[np.random.RandomState] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (rgb_f32 in [0,1] HWC, depth_f32 HW) at output_size."""
        if color_jitter is not None and rng is None:
            raise ValueError(
                "color_jitter needs an explicit rng (ColorJitter draws "
                "its factors from it)")
        flat, mask = self.composed_indices(sample)
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        if rgb.dtype == np.uint8 and rgb.shape[-1] == 3:
            # fused native path (csrc fd_train_gather; the numpy fallback
            # inside native.train_gather is bit-identical) — gather+mask
            # +depth-scale in one GIL-releasing pass, jitter via the
            # PIL-exact enhance kernels, /255 LUT last
            from fastdepth_tpu_torch.data import native

            rgb_u8, depth_out = native.train_gather(
                rgb, depth, flat, mask, sample.scale)
            if color_jitter is not None:
                rgb_u8 = color_jitter(rgb_u8, rng)
            return native.u8_to_unit_f32(rgb_u8), depth_out
        # generic-dtype path (value-preserving for float inputs)
        if color_jitter is not None:
            # the jitter kernels are defined on uint8 only (PIL-exact
            # enhance LUTs; the reference jitters uint8 PIL images,
            # nyu.py:36) — calling them here would crash with an opaque
            # dtype error from deep inside PIL/the native lib
            raise ValueError(
                "color_jitter needs uint8 3-channel RGB frames; got "
                f"dtype={rgb.dtype} with shape {rgb.shape} — jitter "
                "before converting, or feed raw uint8 items")
        rgb_out = rgb.reshape(-1, rgb.shape[-1])[flat]
        rgb_out[mask] = 0  # the rotation's constant pad (cval=0)
        depth_out = depth.reshape(-1)[flat] / sample.scale  # nyu.py:28
        depth_out[mask] = 0.0
        return (
            np.asarray(rgb_out, dtype=np.float32) / 255.0,
            np.asarray(depth_out, dtype=np.float32),
        )
