"""The port's train augmentation on the device (``fastdepth_tpu_torch/data/
device_aug.py``) and the device-augment train step, on the CPU: the
lookups and the whole item pipeline bit for bit against the JAX
package's gather forms and against the port's host train items, the
device-augment step bit for bit against the host-item step and against
JAX's device-augment step in f64, and ``cli.train --device-augment``."""

import copy
import dataclasses
import json
import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.config import ModelConfig as JaxModelConfig
from fastdepth_tpu.config import TrainConfig as JaxTrainConfig
from fastdepth_tpu.data import device_aug as JD
from fastdepth_tpu.data import transforms as JT
from fastdepth_tpu.data.nyu import NYUDataset as JaxNYUDataset
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.train import trainer as JTR

from fastdepth_tpu_torch.checkpoint import params_from_jax
from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.data import device_aug as TD
from fastdepth_tpu_torch.data import native
from fastdepth_tpu_torch.data.nyu import NYUDataset
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.train import sgd_init
from fastdepth_tpu_torch.train.trainer import make_train_step

from torch_port_config import to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
JCFG = JaxModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
MODEL = build(to_port(JCFG))


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """Three seeded raw 480x640 train items (tests/test_device_aug.py's
    tree)."""
    root = tmp_path_factory.mktemp("devaug") / "train" / "scene_a"
    root.mkdir(parents=True)
    rng = np.random.RandomState(5)
    # 00001.h5 would fall into the holdout filter
    for i in (2, 3, 4):
        with h5py.File(root / f"{i:05d}.h5", "w") as f:
            f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(480, 640) * 9 + 0.3).astype(np.float32)
    return str(root.parent)


def _stack(ds, idxs):
    items = [ds[i] for i in idxs]
    return [np.stack([it[j] for it in items]) for j in range(len(items[0]))]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- the lookups ----------------------------------------------------------

@pytest.mark.parametrize("kind", [TD.KIND_NONE, TD.KIND_BRIGHTNESS, TD.KIND_CONTRAST,
                                  TD.KIND_SATURATION])
def test_jitter_slot_is_bit_equal_to_the_jax_gather_form(kind):
    """One slot over a seeded uint8 batch, per kind, over PIL-blend grids at
    several factors (one factor per item) and the identity grid."""
    assert kind == getattr(JD, {0: "KIND_NONE", 1: "KIND_BRIGHTNESS", 2: "KIND_CONTRAST",
                                3: "KIND_SATURATION"}[kind])
    rng = np.random.RandomState(kind)
    factors = (0.6, 0.73, 1.0, 1.21, 1.4)
    img = rng.randint(0, 256, (len(factors) + 1, 64 * 64, 3), dtype=np.uint8)
    tables = np.stack([JT.blend_grid(f) for f in factors] + [JT.identity_grid()])
    kinds = np.full(len(tables), kind, np.int32)
    want = np.asarray(jax.jit(lambda *a: JD._jitter_slot(*a, lut_impl="gather"))(
        jnp.asarray(img), jnp.asarray(tables), jnp.asarray(kinds)))
    got = TD._jitter_slot(*_t([img, tables, kinds]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the identity grid passes its item through
    np.testing.assert_array_equal(got.numpy()[-1], img[-1])


def test_pil_l_and_the_contrast_gray_match_jax_at_the_extremes():
    """uint8 promoted before the multiplies: all-255 pixels reach the largest
    sum, 255 * 65536 + 32768, without wrapping."""
    img = np.full((1, 224 * 224, 3), 255, np.uint8)
    img[0, :7] = np.arange(21, dtype=np.uint8).reshape(7, 3)
    got = TD._pil_l(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JD._pil_l(jnp.asarray(img))))
    assert got.dtype == torch.int32 and int(got.max()) == 255


def test_u8_to_unit_is_bit_equal_to_jax_and_to_the_host_table():
    v = np.arange(256, dtype=np.uint8)
    got = TD._u8_to_unit(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, native.u8_to_unit_f32(v))
    np.testing.assert_array_equal(
        got, np.asarray(JD._u8_to_unit(jnp.asarray(v), lut_impl="gather")))
    assert got.dtype == np.float32


# --- the whole item pipeline ------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_apply_train_augment_equals_jax_and_the_host_items(train_root, epoch):
    """Every item of every listed epoch: the port's augmentation over its
    device-augment items equals the port's host train items and JAX's
    gather form on the same arrays, bit for bit (rgb and depth); the port's
    items equal JAX's."""
    host = NYUDataset(train_root, split="train", seed=11)
    dev = NYUDataset(train_root, split="train", seed=11, device_augment=True)
    jdev = JaxNYUDataset(train_root, split="train", seed=11, device_augment=True)
    for ds in (host, dev, jdev):
        ds.set_epoch(epoch)
    idxs = list(range(len(host)))
    batch = _stack(dev, idxs)
    for g, w in zip(batch, _stack(jdev, idxs)):
        np.testing.assert_array_equal(g, w)
    rgb, depth = TD.apply_train_augment(*_t(batch))
    assert rgb.shape == (3, 224, 224, 3) and depth.shape == (3, 224, 224, 1)
    assert rgb.dtype == depth.dtype == torch.float32
    j_rgb, j_depth = jax.jit(lambda *a: JD.apply_train_augment(*a, lut_impl="gather"))(
        *[jnp.asarray(a) for a in batch])
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(j_rgb))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(j_depth))
    for k, i in enumerate(idxs):
        h_rgb, h_depth = host[i]
        np.testing.assert_array_equal(rgb[k].numpy(), h_rgb, err_msg=f"rgb {i}")
        np.testing.assert_array_equal(depth[k].numpy(), h_depth, err_msg=f"depth {i}")


def test_the_rotation_pad_is_masked_before_the_gather():
    """-1 entries of the map give 0 in rgb and depth, and never index
    (on CUDA an out-of-range index would be a device-side assert)."""
    rng = np.random.RandomState(0)
    rgb = rng.randint(1, 256, (1, 4, 4, 3), dtype=np.uint8)
    depth = rng.uniform(1, 2, (1, 4, 4)).astype(np.float32)
    flat = np.array([[-1, 0, 15, -1]], np.int32)
    tables = np.stack([JT.identity_grid()] * 3)[None]
    got_rgb, got_depth = TD.apply_train_augment(
        *_t([rgb, depth, flat, np.ones(1, np.float32), tables, np.zeros((1, 3), np.int32)]),
        out_size=(2, 2))
    r = got_rgb.numpy().reshape(4, 3)
    d = got_depth.numpy().reshape(4)
    assert (r[[0, 3]] == 0).all() and (d[[0, 3]] == 0).all()
    np.testing.assert_array_equal(r[2], native.u8_to_unit_f32(rgb[0, 3, 3]))
    assert d[1] == depth[0, 0, 0]


# --- the device-augment train step -----------------------------------------

STEP_VARIANTS = {
    "plain": {},
    "remat": {"remat": True},
    "accum_steps_2": {"accum_steps": 2},
    "bf16": {"compute_dtype": torch.bfloat16},
}


@pytest.fixture(scope="module")
def step_batches(train_root):
    """Two items of the same draw: the host items and the raw arrays."""
    host = NYUDataset(train_root, split="train", seed=4)
    dev = NYUDataset(train_root, split="train", seed=4, device_augment=True)
    return _stack(host, [0, 1]), _stack(dev, [0, 1])


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_device_augment_step_equals_the_host_item_step(step_batches, variant):
    """The augmented tensors are bit-equal and the step is the same code:
    the loss, every parameter, running statistic and momentum buffer are
    equal after one step, with remat, accumulation and bf16 composed."""
    (rgb, depth), raw = step_batches
    tc = TrainConfig(lr=0.05, momentum=0.9, weight_decay=1e-4)
    params = MODEL.init(torch.Generator().manual_seed(0))
    kw = STEP_VARIANTS[variant]
    s_h, l_h = make_train_step(MODEL, tc, **kw)(sgd_init(copy.deepcopy(params)), *_t([rgb, depth]),
                                                tc.lr)
    s_d, l_d = make_train_step(MODEL, tc, device_augment=True, **kw)(
        sgd_init(copy.deepcopy(params)), *_t(raw), tc.lr)
    assert float(l_h) == float(l_d)
    for (k, a), b in zip(s_h.params.state_dict().items(), s_d.params.state_dict().values()):
        assert torch.equal(a, b), k
    for k in s_h.momentum:
        assert torch.equal(s_h.momentum[k], s_d.momentum[k]), k


def test_device_augment_step_matches_jax_in_f64(train_root):
    """The port's device-augment step against JAX's from one numpy tree and
    the same raw arrays, in f64 on both sides (tests/test_torch_train.py
    says why): the loss within rtol 1e-5, every parameter, momentum buffer
    and running statistic within 1e-4.  JAX's device-augment step hands
    the f32 augmented rgb to its convolutions as it is, which refuse f64
    weights beside it; the JAX side here is its augmentation, the cast to
    the masters' dtype the port's step makes, and its step."""
    from fastdepth_tpu.checkpoint.io import flatten_tree
    from fastdepth_tpu_torch.checkpoint import params_to_jax

    dev = NYUDataset(train_root, split="train", seed=4, device_augment=True)
    raw = _stack(dev, [0, 1])
    raw[1] = raw[1].astype(np.float64)  # depth and its scale in f64 on both sides
    raw[3] = raw[3].astype(np.float64)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax.jit(jax_build(JCFG).init)(jax.random.PRNGKey(0)))
    state = sgd_init(MODEL.load(params_from_jax(tree)).double())
    state, loss = make_train_step(MODEL, TrainConfig(lr=0.01), device_augment=True)(
        state, *_t(raw), 0.01)
    step = JTR.make_train_step(jax_build(JCFG), JaxTrainConfig(lr=0.01))

    @jax.jit
    def jstep(st, *args):
        *arrays, lr = args
        rgb, depth = JD.apply_train_augment(*arrays, lut_impl="gather")
        return step(st, rgb.astype(jnp.float64), depth.astype(jnp.float64), lr)

    with jax.enable_x64(True):
        jstate = JTR.sgd_init(jax.tree.map(jnp.asarray, tree))
        jstate, jloss = jstep(jstate, *[jnp.asarray(a) for a in raw], jnp.float64(0.01))
        want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
        want.update({"momentum/" + k: v for k, v in
                     flatten_tree(jax.tree.map(np.asarray, jstate.momentum)).items()})
        jloss = float(jloss)
    got = flatten_tree(params_to_jax(state.params.state_dict()))
    got.update({"momentum/" + k: v for k, v in
                flatten_tree(params_to_jax(state.momentum)).items()})
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)


def test_train_cli_device_augment_gives_the_host_runs_loss(tmp_path):
    """cli.train --device-augment --device cpu, one epoch on an h5 tree:
    the same train loss (train.csv) as the host-augment run."""
    from fastdepth_tpu_torch.cli import train as train_cli

    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("val", 2)):
        d = tmp_path / "nyudepthv2" / split / "scene"
        d.mkdir(parents=True)
        for i in range(2, 2 + n):
            with h5py.File(d / f"{i:05d}.h5", "w") as f:
                f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
                f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    arch = tmp_path / "tiny.json"
    arch.write_text(json.dumps(dataclasses.asdict(to_port(JCFG))))
    losses = {}
    for name, extra in (("host", []), ("device", ["--device-augment"])):
        out = tmp_path / name
        train_cli.main(["--data-root", str(tmp_path), "--arch-json", str(arch), "--epochs", "1",
                        "--batch-size", "2", "--eval-batch-size", "2", "--workers", "1",
                        "--print-freq", "0", "--output-dir", str(out), "--device", "cpu"]
                       + extra)
        losses[name] = (out / "train.csv").read_text().splitlines()[1]
        assert os.path.exists(out / "checkpoint.npz")
    assert losses["host"] == losses["device"]
