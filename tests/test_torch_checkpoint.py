"""The npz parameter tree <-> the port's state dict: bit-exact round trips
and a one-to-one key mapping."""

import os

import numpy as np
import pytest
import torch

import jax

from fastdepth_tpu.checkpoint.io import flatten_tree, load_checkpoint
from fastdepth_tpu.config import ModelConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_from_jax, params_to_jax
from fastdepth_tpu_torch.models import build as port_build
from torch_port_config import to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)


def build(cfg):
    """The port's model for a configuration built with the JAX class."""
    return port_build(to_port(cfg))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "docs", "rehearsal_model_r5.npz")
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)


def _tiny_trees():
    cfg = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return cfg, {"unfolded": to_np(params), "folded": to_np(model.fold(params))}


@pytest.fixture(scope="module")
def trees():
    """name -> (config, npz tree): the committed trained weights and a
    tiny JAX init, unfolded and folded."""
    tree, cfg, _ = load_checkpoint(WEIGHTS)
    cfg_t, tiny = _tiny_trees()
    return {"rehearsal": (cfg, tree),
            **{f"tiny-{k}": (cfg_t, v) for k, v in tiny.items()}}


def _assert_bit_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("which", ["rehearsal", "tiny-unfolded", "tiny-folded"])
def test_round_trip_is_bit_exact(trees, which):
    cfg, tree = trees[which]
    sd = params_from_jax(tree)
    _assert_bit_equal(params_to_jax(sd), tree)
    # and through the model's parameter tree (channels_last weights)
    _assert_bit_equal(params_to_jax(build(cfg).load(sd).state_dict()), tree)


@pytest.mark.parametrize("which", ["rehearsal", "tiny-unfolded", "tiny-folded"])
def test_every_npz_key_lands_on_exactly_one_state_dict_key(trees, which):
    cfg, tree = trees[which]
    flat = flatten_tree(tree)
    state = build(cfg).load(params_from_jax(tree)).state_dict()
    assert len(state) == len(flat)
    assert set(state) == {k.replace("/", ".") for k in flat}
    if which == "rehearsal":
        assert len(flat) == 190
        assert "encoder.conv3.dw.w" in state and "decoder.decode_conv2.pw.bn.scale" in state


def test_conv_weights_turn_hwio_into_oihw(trees):
    _, tree = trees["tiny-folded"]
    sd = params_from_jax(tree)
    dw = tree["encoder"]["conv1"]["dw"]["w"]          # (3, 3, 1, C) HWIO depthwise
    pw = tree["decoder"]["decode_conv2"]["pw"]["w"]   # (1, 1, C, Cout)
    stem = tree["encoder"]["conv0"]["w"]              # (3, 3, 3, C0)
    assert tuple(sd["encoder.conv1.dw.w"].shape) == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(sd["encoder.conv1.dw.w"][:, 0].numpy(),
                                  dw[:, :, 0].transpose(2, 0, 1))
    np.testing.assert_array_equal(sd["decoder.decode_conv2.pw.w"][:, :, 0, 0].numpy(),
                                  pw[0, 0].T)
    np.testing.assert_array_equal(sd["encoder.conv0.w"].numpy(), stem.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder.conv0.b"].numpy(), tree["encoder"]["conv0"]["b"])


def test_load_is_strict(trees):
    cfg, tree = trees["tiny-unfolded"]
    sd = params_from_jax(tree)
    model = build(cfg)
    with pytest.raises(RuntimeError, match="Missing"):
        model.load({k: v for k, v in sd.items() if k != "encoder.conv3.pw.w"})
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load(dict(sd, **{"decoder.extra.w": torch.zeros(1)}))
