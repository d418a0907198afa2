"""The port's copy of the host data pipeline (``fastdepth_tpu_torch/data``)
against the JAX package's ``fastdepth_tpu/data``: bit-equal batches from
``NYUDataset``/``BatchLoader`` (val and train) on a seeded h5 fixture,
every public transform bit-equal on seeded inputs, and the port's native
preprocessing library bit-equal to its numpy path."""

import shutil

import h5py
import numpy as np
import pytest

from fastdepth_tpu.data import loader as JL
from fastdepth_tpu.data import nyu as JN
from fastdepth_tpu.data import pipeline as JP
from fastdepth_tpu.data import transforms as JT
from fastdepth_tpu_torch.data import loader as TL
from fastdepth_tpu_torch.data import native as TNAT
from fastdepth_tpu_torch.data import nyu as TN
from fastdepth_tpu_torch.data import pipeline as TP
from fastdepth_tpu_torch.data import transforms as TT
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """Seeded raw NYU items (the h5 format of tests/test_eval_e2e.py) in
    two scenes; 00001.h5 is a holdout item, the rest train and val."""
    rng = np.random.RandomState(42)
    root = tmp_path_factory.mktemp("nyud") / "split"
    for scene, files in {"scene_a": ["00001.h5", "00007.h5"],
                         "scene_b": ["00050.h5", "00051.h5", "00052.h5"]}.items():
        d = root / scene
        d.mkdir(parents=True)
        for fname in files:
            with h5py.File(d / fname, "w") as f:
                f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
                f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    return str(root)


def _batches(N, L, root, split, **kw):
    ds = N.NYUDataset(root, split=split, seed=3, **kw)
    loader = L.BatchLoader(ds, batch_size=2, num_workers=2, shuffle=split == "train", seed=5,
                           pad_last=True)
    loader.set_epoch(1)
    return list(loader)


def _assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


@pytest.mark.parametrize("split,kw", [("val", {}), ("val", {"device_normalize": True}),
                                      ("val", {"raw_items": True}), ("train", {}),
                                      ("holdout", {})])
def test_loader_batches_are_bit_equal_to_the_jax_ones(nyu_root, split, kw):
    want = _batches(JN, JL, nyu_root, split, **kw)
    got = _batches(TN, TL, nyu_root, split, **kw)
    assert len(got) == len(want) > 0
    for (g_rgb, g_depth, g_n), (w_rgb, w_depth, w_n) in zip(got, want):
        assert g_n == w_n
        _assert_bit_equal(g_rgb, w_rgb)
        _assert_bit_equal(g_depth, w_depth)


def test_train_pipeline_and_device_augment_items_are_bit_equal(nyu_root):
    jds = JN.NYUDataset(nyu_root, split="train", seed=1, device_augment=True)
    tds = TN.NYUDataset(nyu_root, split="train", seed=1, device_augment=True)
    for i in range(len(jds)):
        for g, w in zip(tds[i], jds[i]):
            _assert_bit_equal(g, w)
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 10, (480, 640)).astype(np.float32)
    for seed in range(3):
        js, ts = (M.TrainSample.draw(np.random.RandomState(seed)) for M in (JP, TP))
        assert (ts.scale, ts.angle, ts.do_flip) == (js.scale, js.angle, js.do_flip)
        want = JP.TrainPipeline()(rgb, depth, js, color_jitter=JT.ColorJitter(0.4, 0.4, 0.4),
                                  rng=np.random.RandomState(seed))
        got = TP.TrainPipeline()(rgb, depth, ts, color_jitter=TT.ColorJitter(0.4, 0.4, 0.4),
                                 rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            _assert_bit_equal(g, w)
    jv, tv = JP.ValPipeline.create(), TP.ValPipeline.create()
    _assert_bit_equal(tv.rows, jv.rows)
    _assert_bit_equal(tv.cols, jv.cols)
    stack = rng.randint(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    _assert_bit_equal(tv.apply_batch(stack), jv.apply_batch(stack))


class _Inputs:
    def __init__(self):
        rng = np.random.RandomState(7)
        self.u8 = rng.randint(0, 256, (57, 76, 3), dtype=np.uint8)
        self.f32 = rng.uniform(0.5, 10, (57, 76)).astype(np.float32)
        self.rgbf = self.u8.astype(np.float32)


TRANSFORMS = {
    "nearest_resize_indices": lambda M, d: M.nearest_resize_indices(480, 224),
    "imresize_output_size": lambda M, d: np.array(M.imresize_output_size(480, 640, 0.52)),
    "resize_nearest": lambda M, d: M.resize_nearest(d.u8, 0.61),
    "resize_nearest:float_depth": lambda M, d: M.resize_nearest(d.f32, (40, 50)),
    "resize:bilinear": lambda M, d: M.resize(d.u8, (40, 50), interp="bilinear"),
    "resize:bicubic": lambda M, d: M.resize(d.u8, 1.3, interp="bicubic"),
    "resize:lanczos_mode_F": lambda M, d: M.resize(d.f32, (33, 47), interp="lanczos", mode="F"),
    "Resize": lambda M, d: M.Resize(0.5)(d.f32),
    "center_crop_offsets": lambda M, d: np.array(M.center_crop_offsets(57, 76, 40, 51)),
    "center_crop": lambda M, d: M.center_crop(d.u8, (40, 51)),
    "CenterCrop": lambda M, d: M.CenterCrop((41, 50))(d.f32),
    "bottom_crop": lambda M, d: M.bottom_crop(d.u8, (40, 51)),
    "BottomCrop": lambda M, d: M.BottomCrop(30)(d.f32),
    "crop": lambda M, d: M.crop(d.u8, 3, 5, 20, 30),
    "Crop": lambda M, d: M.Crop(3, 5, 20, 30)(d.f32),
    "horizontal_flip": lambda M, d: M.horizontal_flip(d.u8, True),
    "HorizontalFlip": lambda M, d: M.HorizontalFlip(True)(d.f32),
    "rotate": lambda M, d: M.rotate(d.f32, 3.7),
    "Rotate": lambda M, d: M.Rotate(-4.2)(d.u8),
    "rotate_nearest_indices": lambda M, d: M.rotate_nearest_indices(57, 76, 4.4),
    "to_nhwc_tensor": lambda M, d: M.to_nhwc_tensor(d.u8),
    "ToTensor": lambda M, d: M.ToTensor()(d.f32),
    "normalize": lambda M, d: M.normalize(d.rgbf, (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
    "NormalizeNumpyArray": lambda M, d: M.NormalizeNumpyArray((1.0, 2.0, 3.0),
                                                              (2.0, 3.0, 4.0))(d.rgbf),
    "NormalizeTensor": lambda M, d: M.NormalizeTensor((1.0, 2.0, 3.0), (2.0, 3.0, 4.0))(d.rgbf),
    "Compose:Lambda": lambda M, d: M.Compose([M.Lambda(lambda x: x * 2),
                                              M.CenterCrop((20, 30))])(d.f32),
    "adjust_gamma": lambda M, d: M.adjust_gamma(d.u8, 1.3, gain=0.9),
    "adjust_brightness": lambda M, d: M.adjust_brightness(d.u8, 1.27),
    "adjust_contrast": lambda M, d: M.adjust_contrast(d.u8, 0.71),
    "adjust_saturation": lambda M, d: M.adjust_saturation(d.u8, 1.33),
    "adjust_hue": lambda M, d: M.adjust_hue(d.u8, 0.13),
    "adjust_brightness_fast": lambda M, d: M.adjust_brightness_fast(d.u8, 1.27),
    "adjust_contrast_fast": lambda M, d: M.adjust_contrast_fast(d.u8, 0.71),
    "adjust_saturation_fast": lambda M, d: M.adjust_saturation_fast(d.u8, 1.33),
    "blend_grid": lambda M, d: M.blend_grid(0.83),
    "identity_grid": lambda M, d: M.identity_grid(),
    "ColorJitter": lambda M, d: M.ColorJitter(0.4, 0.4, 0.4, 0.1)(d.u8, np.random.RandomState(4)),
    "ColorJitter:no_hue": lambda M, d: np.array(
        M.ColorJitter(0.4, 0.4, 0.4)(d.u8, np.random.RandomState(9))),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_is_bit_equal_to_the_jax_one(name):
    d = _Inputs()
    _assert_bit_equal(TRANSFORMS[name](TT, d), TRANSFORMS[name](JT, d))


def test_every_public_transform_is_covered():
    public = {n for n, v in vars(JT).items()
              if not n.startswith("_") and callable(v) and getattr(v, "__module__", "") == JT.__name__}
    covered = {k.split(":")[0] for k in TRANSFORMS} | {"Lambda"}
    assert public <= covered


NATIVE = {
    "gather_rgb_f32": lambda N, d: N.gather_rgb_f32(d.u8, d.rows, d.cols),
    "gather_depth_f32": lambda N, d: N.gather_depth_f32(d.f32, d.rows, d.cols),
    "train_gather": lambda N, d: N.train_gather(d.u8, d.f32, d.flat, d.mask, 1.37),
    "lut_u8": lambda N, d: N.lut_u8(d.u8, d.lut),
    "l_mean_rounded": lambda N, d: np.array(N.l_mean_rounded(d.u8)),
    "blend_gray_u8": lambda N, d: N.blend_gray_u8(d.u8, 1.29),
    "u8_to_unit_f32": lambda N, d: N.u8_to_unit_f32(d.u8),
    "chw_to_hwc_u8": lambda N, d: N.chw_to_hwc_u8(np.ascontiguousarray(d.u8.transpose(2, 0, 1))),
}


class _NativeInputs(_Inputs):
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(11)
        self.rows = rng.randint(0, 57, 31)
        self.cols = rng.randint(0, 76, 43)
        self.flat = rng.randint(0, 57 * 76, (31, 43))
        self.mask = rng.rand(31, 43) < 0.1
        self.lut = rng.randint(0, 256, 256).astype(np.uint8)


@pytest.fixture
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native library cannot be built")
    TNAT._LIB, TNAT._TRIED = None, False
    assert TNAT.available(), "the native library did not build or load"
    return TNAT._LIB


@pytest.mark.parametrize("name", list(NATIVE))
def test_native_library_equals_its_numpy_path(native_lib, monkeypatch, name):
    d = _NativeInputs()
    got = NATIVE[name](TNAT, d)
    monkeypatch.setattr(TNAT, "_LIB", None)
    monkeypatch.setattr(TNAT, "_TRIED", True)
    assert not TNAT.available()
    want = NATIVE[name](TNAT, d)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _assert_bit_equal(g, w)


def test_native_blend_grid_equals_the_numpy_bake(native_lib, monkeypatch):
    for f in (0.0, 0.6, 0.83, 1.4):
        got = TNAT.blend_grid(f)
        monkeypatch.setattr(TNAT, "_LIB", None)
        monkeypatch.setattr(TNAT, "_TRIED", True)
        assert TNAT.blend_grid(f) is None
        _assert_bit_equal(got, TT.blend_grid(f))
        monkeypatch.undo()
