"""The port's training CLI (``fastdepth_tpu_torch.cli.train``) on the CPU,
on an h5 tree built as ``tests/test_cli_tools.py`` builds it, against the
JAX training CLI; and the port's f32 and bf16 train steps against the JAX
package's.

At random init this model's gradient is ill-conditioned in f32
(``test_torch_train.py``'s docstring has the measurements): the
elementwise comparisons in f32 are of what a forward determines (the
loss of the first step, the running statistics) and of parameters moved
by a small lr; the CLIs are compared at ``--lr 1e-5``, where one epoch's
updates stay below the bound.
"""

import csv
import json

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
from fastdepth_tpu_torch.cli import train as train_cli
from fastdepth_tpu_torch.config import TrainConfig
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.train import sgd_init
from fastdepth_tpu_torch.train.trainer import make_train_step

from test_cli_tools import _make_nyu_tree
from torch_port_config import to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
JCFG = JaxModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
CFG = to_port(JCFG)
MODEL = build(CFG)
OUTPUTS = ("train.csv", "test.csv", "model_best.npz", "checkpoint.npz")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """DIR/nyudepthv2/{train,val} of raw 480x640 h5 frames (4 train, 2
    val), and DIR/tiny.json, the tiny architecture for --arch-json."""
    root = tmp_path_factory.mktemp("nyu")
    rng = np.random.RandomState(0)
    _make_nyu_tree(str(root / "nyudepthv2" / "train"), rng, n=4)
    _make_nyu_tree(str(root / "nyudepthv2" / "val"), rng, n=2)
    (root / "tiny.json").write_text(json.dumps(
        {"encoder_channels": list(TINY_ENC), "decoder_channels": list(TINY_DEC)}))
    return root


def _argv(root, out, *extra):
    return ["--data-root", str(root), "--batch-size", "2", "--eval-batch-size", "2",
            "--workers", "2", "--print-freq", "1", "--output-dir", str(out), *extra]


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on, as a process may find them; monkeypatch
    restores them afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def _losses(path):
    with open(path) as f:
        return {int(r["epoch"]): float(r["loss"]) for r in csv.DictReader(f)}


def test_train_cli_one_epoch_bf16_accum_writes_the_four_files(data_root, tmp_path, capsys,
                                                               tf32_on):
    """One epoch with --bf16 --accum-steps 2: the four outputs, the log
    lines, a finite best RMSE; bf16 leaves the TF32 flags as it found
    them (validation's f32 Evaluator turns them off only for itself)."""
    out = tmp_path / "out"
    best = train_cli.main(_argv(data_root, out, "--arch-json", str(data_root / "tiny.json"),
                                "--epochs", "1", "--bf16", "--accum-steps", "2",
                                "--device", "cpu"))
    log = capsys.readouterr().out
    for name in OUTPUTS:
        assert (out / name).exists(), name
    assert "=> epoch 0: train loss" in log and "=> new best (epoch 0)" in log
    assert np.isfinite(best.rmse)
    assert list(_losses(out / "train.csv")) == [0]
    assert _tf32() == (True, True)


def test_train_cli_resume_starts_at_epoch_1_and_turns_tf32_off(data_root, tmp_path, capsys,
                                                                tf32_on):
    out = tmp_path / "out"
    train_cli.main(_argv(data_root, out, "--arch-json", str(data_root / "tiny.json"),
                         "--epochs", "1", "--device", "cpu"))
    assert _tf32() == (False, False)  # f32 is true f32
    capsys.readouterr()
    best = train_cli.main(_argv(data_root, out, "--epochs", "2", "--device", "cpu",
                                "--resume", str(out / "checkpoint.npz")))
    log = capsys.readouterr().out
    assert "=> resumed at epoch 1" in log
    assert "epoch 1: train loss" in log and "epoch 0: train loss" not in log
    assert list(_losses(out / "train.csv")) == [0, 1]
    assert np.isfinite(best.rmse)


def test_jax_checkpoint_resumes_alike_in_both_clis(data_root, tmp_path, capsys):
    """From one checkpoint.npz written by the JAX package, --resume for one
    epoch in the JAX CLI and in the port's: the same shuffled, augmented
    batches (the port's data pipeline is the JAX one's copy, bit for bit),
    so train.csv's losses agree within rtol 1e-4 and checkpoint.npz's
    parameters within 1e-4, at --lr 1e-5 (module docstring)."""
    from fastdepth_tpu.checkpoint.io import save_train_checkpoint as jax_save
    from fastdepth_tpu.cli import train as jax_cli

    rng = np.random.RandomState(3)
    params = jax.tree.map(jnp.asarray, _jax_init(0))
    state = JT.TrainState(
        params=params,
        momentum=jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape) * 0.01, jnp.float32),
                              params),
        step=jnp.asarray(5, jnp.int32))
    ckpt = str(tmp_path / "checkpoint.npz")
    jax_save(ckpt, state, JCFG, epoch=0, best_result={"rmse": 9.0e9},
             extra={"best_epoch": 0})
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", train_cli.main, ["--device", "cpu"])):
        outs[name] = tmp_path / name
        main(_argv(data_root, outs[name], "--epochs", "2", "--lr", "1e-5", "--resume", ckpt,
                   *extra))
        log = capsys.readouterr().out
        assert "=> resumed at epoch 1" in log, name
    want, got = _losses(outs["jax"] / "train.csv"), _losses(outs["port"] / "train.csv")
    assert list(want) == list(got) == [1]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    from fastdepth_tpu_torch.checkpoint.io import load_train_checkpoint

    jtree, _, jmeta = load_train_checkpoint(str(outs["jax"] / "checkpoint.npz"))
    ptree, _, pmeta = load_train_checkpoint(str(outs["port"] / "checkpoint.npz"))
    assert jmeta["epoch"] == pmeta["epoch"] == 1
    assert int(jtree["step"]) == int(ptree["step"]) == 7
    want, got = flatten_tree(jtree["params"]), flatten_tree(ptree["params"])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    for name in OUTPUTS[:2]:
        assert (outs["port"] / name).exists()


def test_load_pretrained_encoder(tmp_path, data_root, monkeypatch):
    """An ImageNet torch checkpoint -> the encoder tree, as the JAX CLI
    converts it; main puts it into the model it trains."""
    from fastdepth_tpu.cli.train import load_pretrained_encoder as jax_load
    from torch_oracle import TorchMobileNetClassifier, randomize_bn_stats

    gen = torch.Generator().manual_seed(5)
    tm = TorchMobileNetClassifier(TINY_ENC, classes=10, pool=2).eval()
    randomize_bn_stats(tm, gen)
    sd = {"module." + k: v for k, v in tm.state_dict().items()}
    path = str(tmp_path / "imagenet.pth.tar")
    torch.save({"epoch": 9, "best_prec1": 70.0, "state_dict": sd}, path)

    enc = train_cli.load_pretrained_encoder(path)
    assert enc["conv0"]["w"].shape == (3, 3, 3, TINY_ENC[0])
    assert enc["conv13"]["pw"]["w"].shape == (1, 1, TINY_ENC[12], TINY_ENC[13])
    want = flatten_tree(jax_load(path))
    assert flatten_tree(enc).keys() == want.keys()
    for k, v in flatten_tree(enc).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    seen = {}
    monkeypatch.setattr(train_cli, "train_loop", lambda args, model, params, *a, **kw:
                        seen.update(params=params))
    train_cli.main(_argv(data_root, tmp_path / "out", "--arch-json",
                         str(data_root / "tiny.json"), "--pretrained-encoder", path,
                         "--device", "cpu"))
    trained = flatten_tree(params_to_jax(seen["params"].state_dict()))
    for k, v in flatten_tree({"encoder": enc}).items():
        np.testing.assert_array_equal(trained[k], v, err_msg=k)


@pytest.mark.parametrize("flags, message", [
    (["--pretrained-encoder", "enc.npz"], "--resume and --pretrained-encoder conflict"),
    (["--arch-json", "a.json"], "--resume and --arch-json conflict"),
    (["--accum-steps", "3"], "must divide by --accum-steps 3"),
])
def test_conflicting_flags_exit(flags, message, data_root, tmp_path):
    argv = _argv(data_root, tmp_path / "out", "--device", "cpu", *flags)
    if "--accum-steps" not in flags:
        argv += ["--resume", str(tmp_path / "checkpoint.npz")]
    with pytest.raises(SystemExit, match=message):
        train_cli.main(argv)


def test_train_cli_defaults_to_the_card_and_refuses_without_one(data_root, tmp_path):
    assert train_cli.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a host without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(_argv(data_root, tmp_path / "out"))


# --- the f32 and bf16 steps against JAX's ------------------------------------

@pytest.fixture(scope="module")
def jax_tree():
    return _jax_init(0)


def _jax_init(seed):
    """The JAX package's random init of the tiny model as a numpy tree
    (jitted: its eager run compiles every op, about 19 s on the CPU)."""
    return jax.tree.map(np.asarray, jax.jit(jax_build(JCFG).init)(jax.random.PRNGKey(seed)))


def _data(seed, n=8, hw=64):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(n, hw, hw, 3).astype(np.float32)
    depth = (rng.rand(n, hw, hw, 1) * 5 + 0.5).astype(np.float32)
    depth[0, :4, :4, 0] = 0.0
    return rgb, depth


def test_f32_train_step_matches_jax(jax_tree):
    """One f32 step from the same f32 tree and batch, lr 1e-4: the loss
    within rtol 1e-5, every parameter and running statistic within 1e-4;
    then two more steps keep every leaf f32 and finite on both sides."""
    rgb, depth = _data(0)
    tc = dict(lr=1e-4, weight_decay=1e-4)
    step = make_train_step(MODEL, TrainConfig(**tc))
    state = sgd_init(MODEL.load(params_from_jax(jax_tree)))
    jstep = jax.jit(JT.make_train_step(jax_build(JCFG), JaxTrainConfig(**tc)))
    jstate = JT.sgd_init(jax.tree.map(jnp.asarray, jax_tree))
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float32(1e-4))
        state, loss = step(state, torch.from_numpy(rgb), torch.from_numpy(depth), 1e-4)
        if i == 0:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
            got = flatten_tree(params_to_jax(state.params.state_dict()))
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    for t in [*state.params.state_dict().values(), *state.momentum.values()]:
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert np.isfinite(float(loss)) and np.isfinite(float(jloss))


def test_bf16_loss_trajectory_matches_jax(jax_tree):
    """bf16 compute on f32 masters against the JAX bf16 step, from one
    tree, 5 steps on one batch: each step's loss within 5e-2 relative;
    masters, momentum and running statistics f32."""
    rgb, depth = _data(1)
    tc = dict(lr=0.01, weight_decay=1e-4)
    step = make_train_step(MODEL, TrainConfig(**tc), compute_dtype=torch.bfloat16)
    state = sgd_init(MODEL.load(params_from_jax(jax_tree)))
    jstep = jax.jit(JT.make_train_step(jax_build(JCFG), JaxTrainConfig(**tc),
                                       compute_dtype=jnp.bfloat16))
    jstate = JT.sgd_init(jax.tree.map(jnp.asarray, jax_tree))
    for _ in range(5):
        jstate, jloss = jstep(jstate, jnp.asarray(rgb), jnp.asarray(depth), jnp.float32(0.01))
        state, loss = step(state, torch.from_numpy(rgb), torch.from_numpy(depth), 0.01)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-2)
    for t in [*state.params.state_dict().values(), *state.momentum.values()]:
        assert t.dtype == torch.float32
