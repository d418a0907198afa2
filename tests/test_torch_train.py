"""The port's training subsystem (``fastdepth_tpu_torch.train``): the
JAX package's ``tests/test_train.py`` cases that need no mesh, pointed at
the port, and the port's train step held against the JAX one from the
same numpy tree and batches.

How the two packages are compared, and why.  At random init this model's
gradient is ill-conditioned in f32: the BatchNorm chain amplifies
rounding, so the JAX package's own f32 first-step gradient differs from
its f64 one by up to 0.3% (32x32) and 5% (224x224) of a leaf's largest
entry, and the port's f32 one from JAX's by 2.5% at 64x64 b8.  No two f32
implementations can agree to 1e-4 on every momentum buffer there.  So
the elementwise 3-step comparison (loss rtol 1e-5; every parameter,
momentum buffer and running statistic atol 1e-4) runs in f64 on both
sides (``jax.enable_x64``; the port's tree in float64), where it holds
with a margin of 17x or more.  The f32 and bf16 steps are held against
JAX's in ``test_torch_train_cli.py``.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.checkpoint.io import flatten_tree
from fastdepth_tpu.config import ModelConfig as JaxModelConfig
from fastdepth_tpu.config import TrainConfig as JaxTrainConfig
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu.train import trainer as JT

from fastdepth_tpu_torch.checkpoint import params_from_jax, params_to_jax
from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.train import Trainer, masked_l1_loss, sgd_init
from fastdepth_tpu_torch.train import trainer as T
from fastdepth_tpu_torch.train.trainer import make_train_step, step_lr

from torch_port_config import to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC_ADD = (18, 14, 10, 6, 4)
JCFG = JaxModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC_ADD)
CFG = to_port(JCFG)
MODEL = build(CFG)


def _jax_init(seed):
    """The JAX package's random init of the tiny model as a numpy tree
    (jitted: its eager run compiles every op, about 19 s on the CPU)."""
    return jax.tree.map(np.asarray, jax.jit(jax_build(JCFG).init)(jax.random.PRNGKey(seed)))


def _data(rng, n=4, hw=32, dtype=np.float32):
    rgb = rng.rand(n, hw, hw, 3).astype(dtype)
    depth = (rng.rand(n, hw, hw, 1) * 5 + 0.5).astype(dtype)
    depth[0, :4, :4, 0] = 0.0  # holes must be masked
    return rgb, depth


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _init(seed=0):
    """The port's tiny model, random (its own init), trainable."""
    return MODEL.init(torch.Generator().manual_seed(seed))


def _flat_state(params, momentum=None):
    """The port's state as the JAX package's flat npz keys: copies (on the
    CPU, ``params_to_jax`` returns views of the tensors a step updates)."""
    flat = flatten_tree(params_to_jax(params.state_dict()))
    if momentum is not None:
        flat.update({"momentum/" + k: v for k, v in
                     flatten_tree(params_to_jax(momentum)).items()})
    return {k: v.copy() for k, v in flat.items()}


def _flat_jax_state(state):
    flat = flatten_tree(jax.tree.map(np.asarray, state.params))
    flat.update({"momentum/" + k: v for k, v in
                 flatten_tree(jax.tree.map(np.asarray, state.momentum)).items()})
    return flat


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's random init of the tiny model, as a numpy tree."""
    return _jax_init(0)


# --- the JAX tests/test_train.py cases, pointed at the port -----------------

def test_masked_l1_ignores_invalid():
    pred = torch.ones((1, 4, 4, 1)) * 2.0
    tgt = torch.zeros((1, 4, 4, 1))
    tgt[0, 0, 0, 0] = 3.0
    # only one valid pixel: |2 - 3| = 1
    np.testing.assert_allclose(float(masked_l1_loss(pred, tgt)), 1.0)
    assert float(masked_l1_loss(pred, torch.zeros_like(tgt))) == 0.0  # no valid pixel


def test_losses_equal_the_jax_ones(rng):
    from fastdepth_tpu.train import loss as jax_loss
    from fastdepth_tpu_torch.train import loss as port_loss

    pred = rng.rand(3, 8, 8, 1).astype(np.float32) * 4
    tgt = (rng.rand(3, 8, 8, 1) * 5).astype(np.float32)
    tgt[tgt < 1.5] = 0.0
    for name in ("l1_loss", "masked_l1_loss"):
        want = float(getattr(jax_loss, name)(jnp.asarray(pred), jnp.asarray(tgt)))
        got = float(getattr(port_loss, name)(*_t(pred, tgt)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_sgd_momentum_matches_torch(rng):
    """The port's SGD update == torch.optim.SGD(momentum, weight_decay) on
    a conv weight, three steps of a fixed gradient."""
    w0 = rng.randn(4, 2, 3, 3).astype(np.float32)
    g = rng.randn(4, 2, 3, 3).astype(np.float32)
    lr, mom, wd = 0.1, 0.9, 1e-2

    wt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.SGD([wt], lr=lr, momentum=mom, weight_decay=wd)
    for _ in range(3):
        opt.zero_grad()
        wt.grad = torch.from_numpy(g.copy())
        opt.step()

    cfg = TrainConfig(lr=lr, momentum=mom, weight_decay=wd)
    p = torch.from_numpy(w0.copy()).reshape(-1)
    m = torch.zeros_like(p)
    for _ in range(3):
        p, m = T.sgd_update(p, m, torch.from_numpy(g).reshape(-1), lr, cfg, torch.tensor(True),
                            decayed=p)
    np.testing.assert_allclose(wt.detach().numpy().reshape(-1), p.numpy(), atol=1e-6)


def test_train_step_decreases_loss(rng):
    step = make_train_step(MODEL, TrainConfig(lr=0.01, momentum=0.9, weight_decay=0.0))
    state = sgd_init(_init(0))
    rgb, depth = _t(*_data(rng))
    losses = []
    for _ in range(8):
        state, loss = step(state, rgb, depth, 0.01)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert int(state.step) == 8 and state.step.dtype == torch.int32


def test_training_converges_overfit(rng):
    """300 steps on a fixed batch whose depth is a learnable low-frequency
    function of the rgb: loss down >5x, and delta1 through the port's
    inference path (Evaluator: BN folded from the trained running
    statistics, K1 + K4's plain versions, the metrics) above 0.9."""
    from scipy.ndimage import uniform_filter

    from fastdepth_tpu_torch.engine import Evaluator
    from fastdepth_tpu_torch.metrics import METRIC_FIELDS

    step = make_train_step(MODEL, TrainConfig(lr=0.05, momentum=0.9, weight_decay=0.0))
    state = sgd_init(_init(3))
    rgb_np = rng.rand(4, 32, 32, 3).astype(np.float32)
    smooth = uniform_filter(rgb_np.mean(-1), size=(1, 11, 11), mode="nearest")
    rgb, depth = _t(rgb_np, (1.0 + 2.0 * smooth[..., None]).astype(np.float32))
    first = None
    for _ in range(300):
        state, loss = step(state, rgb, depth, 0.05)
        if first is None:
            first = float(loss)
    last = float(loss)
    assert last < first / 5, (first, last)
    # settle the running statistics at the final weights (lr=0 steps
    # update statistics only) so inference sees the trained statistics
    for _ in range(60):
        state, _ = step(state, rgb, depth, 0.0)
    ev = Evaluator(MODEL, state.params, batch_size=4, device="cpu")
    assert not any(p.requires_grad for p in ev.params.parameters())
    _, metrics = ev(rgb, depth)
    delta1 = float(metrics[METRIC_FIELDS.index("delta1")].mean())
    assert delta1 > 0.9, delta1


def test_train_step_updates_bn_stats(rng):
    step = make_train_step(MODEL, TrainConfig(weight_decay=0.0))
    state = sgd_init(_init(0))
    rgb, depth = _t(*_data(rng))
    before = state.params["encoder"]["conv0"].bn.mean.clone()
    state, _ = step(state, rgb, depth, 0.01)
    assert not torch.allclose(before, state.params["encoder"]["conv0"].bn.mean)


def test_weight_decay_covers_all_trainable_params():
    """torch.optim.SGD(model.parameters(), weight_decay=wd) decays EVERY
    parameter: conv weights, biases, BN scale/bias.  The running mean/var
    are buffers, never decayed, and never take a gradient."""
    params = sgd_init(_init(0)).params
    decayed, spared = set(), set()
    for key in params.state_dict():
        parent, leaf = key.split(".")[-2:]
        (decayed if T._is_decayed(key) else spared).add((parent, leaf))
    assert spared == {("bn", "mean"), ("bn", "var")}, spared
    assert ("bn", "scale") in decayed and ("bn", "bias") in decayed
    assert any(leaf == "w" for _, leaf in decayed)
    trainable = {k for k, p in params.named_parameters() if p.requires_grad}
    assert trainable == {k for k in params.state_dict() if T._is_decayed(k)}


def test_run_epoch_rejects_padded_batches():
    """A padded final batch would feed zero rows into the BN batch
    statistics; run_epoch refuses it with instructions."""
    t = Trainer(MODEL, _init(0), TrainConfig(lr=0.01), device="cpu")

    class _PaddedLoader:
        def __iter__(self):
            yield (np.zeros((4, 32, 32, 3), np.float32), np.ones((4, 32, 32, 1), np.float32),
                   3)  # 3 real rows in a batch of 4

        def __len__(self):
            return 1

    with pytest.raises(ValueError, match="padded"):
        t.run_epoch(_PaddedLoader(), 0, log=lambda *a: None)


def test_run_epoch_averages_the_losses_and_logs_at_print_freq(rng):
    batches = [(*_data(rng), 4) for _ in range(3)]
    t = Trainer(MODEL, _init(0), TrainConfig(lr=0.01, lr_decay_step=1, lr_decay_gamma=0.5),
                device="cpu")
    want_t = Trainer(MODEL, _init(0), TrainConfig(lr=0.01), device="cpu")
    logs = []
    got = t.run_epoch(batches, 1, log=logs.append, print_freq=2)
    losses = [float(want_t._step(want_t.state, *_t(r, d), 0.005)[1]) for r, d, _ in batches]
    np.testing.assert_allclose(got, np.mean(losses), rtol=1e-6)
    assert len(logs) == 1 and logs[0].startswith("Epoch 1 [2/3] loss=") and "lr=0.005" in logs[0]


def test_step_lr_schedule():
    tc = TrainConfig(lr=0.01, lr_decay_step=5, lr_decay_gamma=0.2)
    assert step_lr(tc, 0) == 0.01
    assert abs(step_lr(tc, 5) - 0.002) < 1e-12
    assert abs(step_lr(tc, 10) - 0.0004) < 1e-12
    # non-positive step = "no decay", not ZeroDivisionError
    assert step_lr(TrainConfig(lr=0.01, lr_decay_step=0), 7) == 0.01
    for e in range(12):
        jtc = JaxTrainConfig(lr=0.01, lr_decay_step=5, lr_decay_gamma=0.2)
        assert step_lr(tc, e) == JT.step_lr(jtc, e)


def _two_states(seed):
    p = _init(seed)
    return sgd_init(copy.deepcopy(p)), sgd_init(copy.deepcopy(p))


def test_remat_step_matches_plain(rng):
    """torch.utils.checkpoint changes memory, not math; and the running
    statistics merge once although the forward runs twice."""
    tc = TrainConfig(lr=0.01, weight_decay=0.0)
    rgb, depth = _t(*_data(rng))
    s1, s2 = _two_states(2)
    s1, l1 = make_train_step(MODEL, tc)(s1, rgb, depth, 0.01)
    s2, l2 = make_train_step(MODEL, tc, remat=True)(s2, rgb, depth, 0.01)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    a, b = _flat_state(s1.params, s1.momentum), _flat_state(s2.params, s2.momentum)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)


def test_bf16_mixed_precision_step(rng):
    """bf16 compute on f32 masters: every leaf of the state stays f32, the
    loss tracks the f32 step's, the running statistics move and stay
    finite, and 8 steps in each precision land within 5%."""
    tc = TrainConfig(lr=0.01, momentum=0.9, weight_decay=1e-4)
    rgb, depth = _t(*_data(rng))
    step32 = make_train_step(MODEL, tc)
    step16 = make_train_step(MODEL, tc, compute_dtype=torch.bfloat16)
    s32, s16 = _two_states(4)
    m0 = s16.params["encoder"]["conv0"].bn.mean.clone()
    s32, l32 = step32(s32, rgb, depth, 0.01)
    s16, l16 = step16(s16, rgb, depth, 0.01)
    for t in [*s16.params.state_dict().values(), *s16.momentum.values()]:
        assert t.dtype == torch.float32
    np.testing.assert_allclose(float(l16), float(l32), rtol=3e-2)
    m1 = s16.params["encoder"]["conv0"].bn.mean
    assert not torch.allclose(m0, m1) and torch.isfinite(m1).all()

    s32, s16 = _two_states(4)
    l32s, l16s = [], []
    for _ in range(8):
        s32, a = step32(s32, rgb, depth, 0.01)
        s16, b = step16(s16, rgb, depth, 0.01)
        l32s.append(float(a))
        l16s.append(float(b))
    assert l16s[-1] < l16s[0]
    np.testing.assert_allclose(l16s[-1], l32s[-1], rtol=5e-2)


def test_bf16_remat_matches_plain(rng):
    """The cast sits inside the checkpointed forward: the recompute is
    bf16 too, and the result equals the non-remat bf16 step."""
    tc = TrainConfig(lr=0.01, weight_decay=0.0)
    rgb, depth = _t(*_data(rng))
    s1, s2 = _two_states(5)
    s1, l1 = make_train_step(MODEL, tc, compute_dtype=torch.bfloat16)(s1, rgb, depth, 0.01)
    s2, l2 = make_train_step(MODEL, tc, remat=True, compute_dtype=torch.bfloat16)(
        s2, rgb, depth, 0.01)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(s1.params["encoder"]["conv0"].w.detach().numpy(),
                               s2.params["encoder"]["conv0"].w.detach().numpy(), atol=1e-5)


def test_nonfinite_batch_skipped(rng):
    """A NaN batch leaves the ENTIRE state bit-identical: weights, running
    statistics (their merge is gated) and momentum (which must not absorb
    the weight-decay term on a skipped step); the step counter advances."""
    step = make_train_step(MODEL, TrainConfig(lr=0.05, weight_decay=1e-3))
    state = sgd_init(_init(3))
    rgb, depth = _data(rng)
    state, _ = step(state, *_t(rgb, depth), 0.05)  # a non-zero momentum first
    before = _flat_state(state.params, state.momentum)
    bad = rgb.copy()
    bad[0, 0, 0, 0] = np.nan
    state, loss = step(state, *_t(bad, depth), 0.05)
    assert not np.isfinite(float(loss))
    after = _flat_state(state.params, state.momentum)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    state, loss2 = step(state, *_t(rgb, depth), 0.05)
    assert np.isfinite(float(loss2))
    assert not np.allclose(_flat_state(state.params)["encoder/conv0/w"],
                           before["encoder/conv0/w"])


def test_resume_bit_exact(rng, tmp_path):
    """Params after (2 steps, save, 1 step) == params after (load, restore,
    1 step): momentum and step counter survive the round trip, bit for bit."""
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint, save_train_checkpoint

    tc = TrainConfig(lr=0.05, momentum=0.9, weight_decay=1e-4)
    rgb, depth = _t(*_data(rng))
    t1 = Trainer(MODEL, _init(0), tc, device="cpu")
    for _ in range(2):
        t1.state, _ = t1._step(t1.state, rgb, depth, 0.05)
    path = str(tmp_path / "ck.npz")
    save_train_checkpoint(path, t1.state, CFG, epoch=3, best_result={"rmse": 1.25},
                          extra={"best_epoch": 2})
    saved = _flat_state(t1.state.params, t1.state.momentum)
    t1.state, _ = t1._step(t1.state, rgb, depth, 0.05)

    tree, cfg2, meta = load_train_checkpoint(path)
    assert cfg2 == CFG
    assert meta["epoch"] == 3 and meta["best_result"] == {"rmse": 1.25}
    assert meta["extra"] == {"best_epoch": 2, "train_state": True}
    t2 = Trainer(MODEL, _init(7), tc, device="cpu")  # another init: restore overwrites all
    t2.restore(tree)
    assert int(t2.state.step) == 2
    restored = _flat_state(t2.state.params, t2.state.momentum)
    for k in saved:
        np.testing.assert_array_equal(saved[k], restored[k], err_msg=k)
    t2.state, _ = t2._step(t2.state, rgb, depth, 0.05)
    a, b = _flat_state(t1.state.params), _flat_state(t2.state.params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_params_only_checkpoint_rejected_for_resume(tmp_path):
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint, save_checkpoint

    path = str(tmp_path / "p.npz")
    save_checkpoint(path, {"a": np.ones(2, np.float32)}, CFG, epoch=0)
    with pytest.raises(ValueError, match="params-only"):
        load_train_checkpoint(path)


def test_accum_step_matches_manual_microbatch_average(rng):
    """accum_steps=k == one update from the MEAN of k per-microbatch
    gradients, the running statistics merged microbatch after microbatch;
    re-derived with an explicit loop and compared leaf by leaf."""
    from fastdepth_tpu_torch.models import layers as L

    tc = TrainConfig(lr=0.02, weight_decay=0.0)
    rgb, depth = _t(*_data(rng, n=4))
    k, mb, lr = 2, 2, 0.02
    params = sgd_init(_init(4)).params
    manual = copy.deepcopy(params)
    names, leaves = zip(*manual.named_parameters())
    gsum = [torch.zeros_like(p) for p in leaves]
    lsum = 0.0
    for i in range(k):
        stats = {}
        loss = masked_l1_loss(MODEL.apply(manual, rgb[i * mb:(i + 1) * mb], train=True,
                                          stats=stats), depth[i * mb:(i + 1) * mb])
        grads = torch.autograd.grad(loss, leaves)
        L.merge_stats(manual, stats)  # the sequential running-statistics thread
        gsum = [a + b for a, b in zip(gsum, grads)]
        lsum += float(loss.detach())
    gavg = dict(zip(names, [g / k for g in gsum]))
    with torch.no_grad():
        for name, p in zip(names, leaves):
            p -= lr * gavg[name]

    state = sgd_init(copy.deepcopy(params))
    state, loss = make_train_step(MODEL, tc, accum_steps=k)(state, rgb, depth, lr)
    np.testing.assert_allclose(float(loss), lsum / k, rtol=1e-6)
    want, got = _flat_state(manual), _flat_state(state.params)
    for key in want:
        np.testing.assert_allclose(want[key], got[key], rtol=1e-5, atol=1e-6, err_msg=key)
    for name, m in state.momentum.items():  # the buffer holds the averaged gradient
        want_m = gavg[name] if name in gavg else torch.zeros_like(m)
        np.testing.assert_allclose(want_m.detach().numpy(), m.numpy(), rtol=1e-5, atol=1e-6)


def test_accum_rejects_indivisible_batch(rng):
    step = make_train_step(MODEL, TrainConfig(lr=0.01), accum_steps=3)
    with pytest.raises(ValueError, match="divisible"):
        step(sgd_init(_init(0)), *_t(*_data(rng, n=4)), 0.01)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(MODEL, TrainConfig(), accum_steps=0)


def test_accum_nonfinite_microbatch_skips_update(rng):
    """A NaN in the LAST microbatch poisons the accumulated loss: the
    whole update is skipped, the running statistics included, although
    the first microbatch's had already merged."""
    step = make_train_step(MODEL, TrainConfig(lr=0.05, weight_decay=1e-3), accum_steps=2)
    state = sgd_init(_init(3))
    rgb, depth = _data(rng, n=4)
    bad = rgb.copy()
    bad[3, 0, 0, 0] = np.nan
    before = _flat_state(state.params, state.momentum)
    state, loss = step(state, *_t(bad, depth), 0.05)
    assert not np.isfinite(float(loss))
    after = _flat_state(state.params, state.momentum)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    state, loss2 = step(state, *_t(rgb, depth), 0.05)
    assert np.isfinite(float(loss2))


def test_accum_composes_with_remat_and_bf16(rng):
    step = make_train_step(MODEL, TrainConfig(lr=0.02, weight_decay=0.0), remat=True,
                           compute_dtype=torch.bfloat16, accum_steps=2)
    state = sgd_init(_init(5))
    rgb, depth = _t(*_data(rng, n=4))
    losses = []
    for _ in range(6):
        state, loss = step(state, rgb, depth, 0.02)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert state.params["encoder"]["conv0"].w.dtype == torch.float32


# --- the port's own surface ---------------------------------------------------

def test_trainer_refuses_cuda_without_a_card_and_copies_its_params():
    params = _init(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(MODEL, params, TrainConfig())
    t = Trainer(MODEL, params, TrainConfig(), device="cpu")
    assert t.state.params is not params
    assert not any(p.requires_grad for p in params.parameters())  # the caller's tree
    assert all(p.requires_grad for p in t.state.params.parameters())
    assert set(t.state.momentum) == set(params.state_dict())


def test_model_apply_defaults_stay_the_inference_forward(rng):
    """Model.apply(train=False) is the eval forward; train=True records a
    statistics entry per BatchNorm under the JAX package's paths."""
    params = _init(1)
    x = _t(_data(rng)[0])[0]
    stats = {}
    y_train = MODEL.apply(params, x, train=True, stats=stats)
    jax_stats = {}
    jm = jax_build(JCFG)
    jax.eval_shape(lambda p, x: jm.apply(p, x, train=True, stats=jax_stats),
                   jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                   jnp.asarray(x.numpy()))  # traces, runs nothing
    assert set(stats) == set(jax_stats)
    assert all(set(v) == {"mean", "var"} for v in stats.values())
    assert y_train.shape == MODEL.apply(params, x).shape == (4, 32, 32, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(rng, dtype):
    """Output and new running statistics against the JAX batch_norm_train:
    f32 within 1e-5; bf16 input within one bf16 rounding of the output,
    its moments f32 on both sides."""
    from fastdepth_tpu.ops import blocks as JB
    from fastdepth_tpu_torch.models.layers import BatchNorm
    from fastdepth_tpu_torch.ops import blocks as B

    x = rng.randn(3, 5, 6, 7).astype(np.float32) * 2 + 0.5  # NHWC
    p = {"scale": rng.rand(7).astype(np.float32) + 0.5, "bias": rng.randn(7).astype(np.float32),
         "mean": rng.randn(7).astype(np.float32), "var": rng.rand(7).astype(np.float32) + 0.5}
    jdt = getattr(jnp, dtype)
    y_j, st_j = JB.batch_norm_train(jnp.asarray(x).astype(jdt),
                                    {k: jnp.asarray(v) for k, v in p.items()})
    bn = BatchNorm(7)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xt = B.from_nhwc(torch.from_numpy(x)).to(getattr(torch, dtype))
    y_t, st_t = B.batch_norm_train(xt, bn)
    assert y_t.dtype == xt.dtype and st_t["mean"].dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * float(np.abs(np.asarray(y_j, np.float32)).max())
    np.testing.assert_allclose(B.to_nhwc(y_t).float().numpy(), np.asarray(y_j, np.float32),
                               atol=tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]), atol=1e-5, err_msg=k)
    assert not st_t["mean"].requires_grad
    # the buffers are left alone: the trainer merges
    np.testing.assert_array_equal(bn.mean.numpy(), p["mean"])


# --- the train step against the JAX one, from one numpy tree ----------------

VARIANTS = {
    "plain": ({}, 0.0),
    "weight_decay": ({}, 1e-3),
    "remat": ({"remat": True}, 0.0),
    "accum_steps_2": ({"accum_steps": 2}, 0.0),
}


@pytest.fixture(scope="module")
def jax_f64_steps(jax_tree):
    """The JAX package's jitted train steps under x64, one per variant,
    shared by the tests of this module.  XLA's compile of each (~15 s on
    the CPU, twice that on a loaded test machine) is most of this
    module's time, so the first use compiles all four at once, one
    thread a variant, by calling each on the 3-step test's arguments."""
    steps = {}
    for variant, (kw, wd) in VARIANTS.items():
        steps[variant] = jax.jit(JT.make_train_step(
            jax_build(JCFG), JaxTrainConfig(lr=0.01, weight_decay=wd), **kw))
    rgb, depth = _data(np.random.RandomState(0), n=8, hw=64, dtype=np.float64)

    def compile_by_calling(step):
        with jax.enable_x64(True):
            state = JT.sgd_init(jax.tree.map(jnp.asarray, _f64(jax_tree)))
            jax.block_until_ready(step(state, jnp.asarray(rgb), jnp.asarray(depth),
                                       jnp.float64(0.01)))

    with ThreadPoolExecutor(len(steps)) as pool:
        list(pool.map(compile_by_calling, steps.values()))
    return steps.__getitem__


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _assert_states_close(jax_flat, port_flat):
    assert jax_flat.keys() == port_flat.keys()
    for k in jax_flat:
        assert jax_flat[k].shape == port_flat[k].shape, k
        np.testing.assert_allclose(port_flat[k], jax_flat[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax_over_three_steps(variant, jax_tree, jax_f64_steps):
    """3 steps of the port's make_train_step against the JAX one from the
    same tree and batches (64x64, batch 8), in f64 on both sides (see the
    module docstring): loss within rtol 1e-5 each step; every parameter,
    momentum buffer and running statistic within 1e-4 after."""
    kw, wd = VARIANTS[variant]
    rgb, depth = _data(np.random.RandomState(0), n=8, hw=64, dtype=np.float64)
    tree = _f64(jax_tree)
    step = make_train_step(MODEL, TrainConfig(lr=0.01, weight_decay=wd), **kw)
    state = sgd_init(MODEL.load(params_from_jax(tree)).double())
    with jax.enable_x64(True):
        jstep = jax_f64_steps(variant)
        jstate = JT.sgd_init(jax.tree.map(jnp.asarray, tree))
        for _ in range(3):
            jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(0.01))
            state, loss = step(state, *_t(rgb, depth), 0.01)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jflat = _flat_jax_state(jstate)
    assert int(state.step) == int(jstate.step) == 3
    _assert_states_close(jflat, _flat_state(state.params, state.momentum))


# --- checkpoints across the two packages ------------------------------------

def test_jax_checkpoint_resumes_in_the_port(jax_tree, jax_f64_steps, tmp_path):
    """A checkpoint.npz written by the JAX save_train_checkpoint restores
    bit for bit into the port's Trainer, and the next step matches JAX's
    next step (f64 on both sides, the bounds of the 3-step comparison)."""
    from fastdepth_tpu.checkpoint.io import save_train_checkpoint as jax_save
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint

    rgb, depth = _data(np.random.RandomState(1), n=8, hw=64, dtype=np.float64)
    path = str(tmp_path / "checkpoint.npz")
    with jax.enable_x64(True):
        jstep = jax_f64_steps("plain")
        jstate = JT.sgd_init(jax.tree.map(jnp.asarray, _f64(jax_tree)))
        for _ in range(2):
            jstate, _ = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(0.01))
        jax_save(path, jstate, JCFG, epoch=4, extra={"best_epoch": 3})
        saved = _flat_jax_state(jstate)
        jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float64(0.01))
        jflat = _flat_jax_state(jstate)

    tree, cfg, meta = load_train_checkpoint(path)
    assert cfg == CFG and meta["epoch"] == 4 and meta["extra"]["train_state"]
    t = Trainer(build(cfg), _init(9).double(), TrainConfig(lr=0.01, weight_decay=0.0),
                device="cpu")
    t.restore(tree)
    assert int(t.state.step) == 2
    restored = _flat_state(t.state.params, t.state.momentum)
    assert restored.keys() == saved.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    t.state, loss = t._step(t.state, *_t(rgb, depth), 0.01)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_states_close(jflat, _flat_state(t.state.params, t.state.momentum))


def test_port_checkpoint_resumes_in_jax(jax_tree, jax_f64_steps, tmp_path):
    """A checkpoint written by the port loads in the JAX
    load_train_checkpoint with the JAX tree's keys, shapes and step, the
    zero momentum of the running statistics included, and resumes there:
    JAX's next step matches the port's."""
    from fastdepth_tpu.checkpoint.io import load_train_checkpoint as jax_load
    from fastdepth_tpu_torch.checkpoint.io import save_train_checkpoint

    rgb, depth = _data(np.random.RandomState(2), n=8, hw=64, dtype=np.float64)
    step = make_train_step(MODEL, TrainConfig(lr=0.01, weight_decay=0.0))
    state = sgd_init(MODEL.load(params_from_jax(_f64(jax_tree))).double())
    for _ in range(2):
        state, _ = step(state, *_t(rgb, depth), 0.01)
    path = str(tmp_path / "checkpoint.npz")
    save_train_checkpoint(path, state, CFG, epoch=1)
    saved = _flat_state(state.params, state.momentum)
    state, loss = step(state, *_t(rgb, depth), 0.01)

    tree, cfg, meta = jax_load(path)
    assert cfg == JCFG and meta["extra"]["train_state"]
    assert np.asarray(tree["step"]).dtype == np.int32 and int(tree["step"]) == 2
    want_keys = flatten_tree(jax_tree).keys()
    assert flatten_tree(tree["params"]).keys() == want_keys
    assert flatten_tree(tree["momentum"]).keys() == want_keys
    for k, v in flatten_tree(tree["momentum"]).items():
        if k.endswith(("/mean", "/var")):
            assert not v.any(), k
    with jax.enable_x64(True):
        jstate = JT.TrainState(params=jax.tree.map(jnp.asarray, tree["params"]),
                               momentum=jax.tree.map(jnp.asarray, tree["momentum"]),
                               step=jnp.asarray(tree["step"]))
        loaded = _flat_jax_state(jstate)
        for k in saved:
            np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
        jstate, jloss = jax_f64_steps("plain")(jstate, jnp.asarray(rgb), jnp.asarray(depth),
                                               jnp.float64(0.01))
        jflat = _flat_jax_state(jstate)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_states_close(jflat, _flat_state(state.params, state.momentum))


# --- f32 is true f32 -------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", [None, torch.float32, torch.bfloat16])
def test_trainer_in_f32_turns_tf32_off_and_bf16_leaves_it(compute_dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    Trainer(MODEL, _init(0), TrainConfig(), compute_dtype=compute_dtype, device="cpu")
    want = (True, True) if compute_dtype == torch.bfloat16 else (False, False)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == want
