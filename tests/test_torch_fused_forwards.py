"""The port's fused forwards (levels through K1, K2 or K3, the head
through K4; their plain versions on the CPU) against the JAX package's
fused forwards in interpret mode, on the same folded numpy parameters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.models import fused as JF
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth
from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER
from torch_port_config import to_jax
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)


@pytest.fixture(scope="module")
def folded():
    """(JAX folded params, the port's folded tree): one seeded numpy state
    dict of folded ``{'w','b'}`` leaves, He-scaled so activations stay
    O(1), handed to both."""
    rng = np.random.RandomState(0)
    sd = {}
    for key, v in make_fastdepth(CFG, folded=True).state_dict().items():
        scale = np.sqrt(2.0 / np.prod(v.shape[1:])) if v.dim() == 4 else 0.1
        sd[key] = torch.from_numpy((rng.randn(*v.shape) * scale).astype(np.float32))
    model = build(CFG)
    return jax.tree.map(jnp.asarray, params_to_jax(sd)), model.fold(model.load(sd))


FORWARDS = {
    "fused": (JF.apply_fastdepth_fused, F.apply_fastdepth_fused, "K1"),
    "v2": (JF.apply_fastdepth_fused_v2, F.apply_fastdepth_fused_v2, "K2"),
    "v3": (JF.apply_fastdepth_fused_v3, F.apply_fastdepth_fused_v3, "K3"),
}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_fused_forwards_match_jax(rng, folded, name):
    """batch 3: a ragged last image group at every level with B > 1."""
    jax_fwd, port_fwd, stage = FORWARDS[name]
    jfolded, tree = folded
    x = rng.rand(3, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_fwd(jfolded, jnp.asarray(x), to_jax(CFG), interpret=True))
    counts = (COUNTER[stage], COUNTER["K4"])
    with torch.no_grad():
        got = port_fwd(tree, torch.from_numpy(x), CFG)
    assert (COUNTER[stage], COUNTER["K4"]) == counts  # CPU: plain versions, no launch
    assert tuple(got.shape) == (3, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_v3_block_batches_argument(rng, folded):
    """Any per-level block batches give the same result (the ragged last
    group is masked), as the JAX forward's ``block_batches``."""
    _, tree = folded
    x = torch.from_numpy(rng.rand(3, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        want = F.apply_fastdepth_fused_v3(tree, x, CFG)
        got = F.apply_fastdepth_fused_v3(tree, x, CFG, block_batches={i: 8 for i in range(1, 6)})
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert F.V3_BLOCK_BATCHES == {1: 8, 2: 4, 3: 2, 4: 1, 5: 1}
    assert F.V2_BLOCK_BATCHES == {1: 8, 2: 8, 3: 4, 4: 2, 5: 1}


def test_fold_attaches_the_heads_weight(folded):
    _, tree = folded
    head = tree["decoder"]["decode_conv6"]
    assert tuple(head.k4_w.shape) == (TINY_DEC[-1],)
    torch.testing.assert_close(head.k4_w, head["pw"].w.reshape(-1))
    assert not any("k4_" in k for k in tree.state_dict())


@pytest.mark.parametrize("name", list(FORWARDS))
def test_fused_forwards_refuse_unfolded_trees(folded, name):
    _, tree = folded
    bare = build(CFG).load(tree.state_dict())
    with pytest.raises(ValueError, match="Model.fold"):
        FORWARDS[name][1](bare, torch.zeros(1, 32, 32, 3), CFG)
