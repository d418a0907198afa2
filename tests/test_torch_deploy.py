"""The port's deploy runner and what it stands on (compile_forward,
flops_estimate, the timing helpers, the profiler), on the CPU with the
kernels' plain versions, held against the JAX deploy runner."""

import os

import numpy as np
import pytest
import torch

from test_cli_tools import REF_RGB, tiny_ckpt  # noqa: F401  (shared fixture)
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)


@pytest.fixture
def rgb_npy(tmp_path):
    path = str(tmp_path / "rgb.npy")
    np.save(path, np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    return path


def test_deploy_cli_matches_jax_deploy_cli(tiny_ckpt, rgb_npy, tmp_path, capsys):  # noqa: F811
    from fastdepth_tpu.cli import deploy as jax_cli
    from fastdepth_tpu_torch.cli import deploy as port_cli
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import head as K4

    common = ["--model", tiny_ckpt, "--input-fp", rgb_npy, "--warmup", "1", "--run", "2",
              "--randomized-input-timing"]
    jax_out, port_out = str(tmp_path / "jax.npy"), str(tmp_path / "port.npy")
    jax_cli.main(common + ["--output-fp", jax_out])
    capsys.readouterr()
    counts = (K1.LAUNCHES, K4.LAUNCHES)
    stats = port_cli.main(common + ["--output-fp", port_out, "--device", "cpu"])
    out = capsys.readouterr().out
    assert (K1.LAUNCHES, K4.LAUNCHES) == counts  # the CPU runs the plain versions
    for line in ("=> loading model", "=> compiling for (1, 64, 64, 3) (float32, cpu)",
                 "GFLOP/frame", "=> saved prediction", "=> [timed] mean=", "=> [randomized] mean="):
        assert line in out, line
    assert stats["median_s"] > 0
    got, want = np.load(port_out), np.load(jax_out)
    assert got.shape == want.shape == (1, 1, 64, 64)  # NCHW like the reference's pred.npy
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_deploy_cli_bf16_and_input_layouts(tiny_ckpt, rgb_npy, tmp_path, capsys):  # noqa: F811
    """A CHW input (the reference's 1x3xHxW) predicts as its HWC twin; the
    bf16 forward stays finite and near f32."""
    from fastdepth_tpu_torch.cli import deploy

    chw = str(tmp_path / "chw.npy")
    np.save(chw, np.load(rgb_npy).transpose(2, 0, 1)[None])
    run = ["--model", tiny_ckpt, "--warmup", "0", "--run", "1", "--device", "cpu"]
    outs = {}
    for name, inp, extra in (("hwc", rgb_npy, []), ("chw", chw, []), ("bf16", rgb_npy, ["--bf16"])):
        outs[name] = str(tmp_path / f"{name}_pred.npy")
        deploy.main(run + ["--input-fp", inp, "--output-fp", outs[name]] + extra)
    assert "(bfloat16, cpu)" in capsys.readouterr().out
    f32 = np.load(outs["hwc"])
    np.testing.assert_array_equal(np.load(outs["chw"]), f32)
    bf16 = np.load(outs["bf16"])
    assert np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, f32, atol=0.05 * max(1.0, float(np.abs(f32).max())))


@pytest.fixture(scope="module")
def saved_bundle(tiny_ckpt, tmp_path_factory):  # noqa: F811
    """(bundle prefix, its 64x64 rgb npy, the saving run's prediction):
    one ``--save-bundle`` run of the port's deploy CLI on the CPU."""
    root = tmp_path_factory.mktemp("bundle")
    rgb = str(root / "rgb.npy")
    np.save(rgb, np.random.RandomState(0).rand(64, 64, 3).astype(np.float32))
    prefix, pred = str(root / "bundle"), str(root / "pred.npy")
    from fastdepth_tpu_torch.cli import deploy

    deploy.main(["--model", tiny_ckpt, "--input-fp", rgb, "--output-fp", pred, "--warmup", "0",
                 "--run", "1", "--device", "cpu", "--save-bundle", prefix])
    return prefix, rgb, pred


def test_deploy_cli_refusals(tiny_ckpt, rgb_npy, saved_bundle, tmp_path):  # noqa: F811
    """The JAX CLI's refusals and messages: a missing checkpoint or
    bundle; --bf16, --impl/--tuning and --save-bundle with --load-bundle
    (each before the bundle loads); an input of another shape than the
    bundle's; mixed without a record; cuda without a card."""
    from fastdepth_tpu_torch.cli import deploy

    with pytest.raises(SystemExit, match="no model found"):
        deploy.main(["--model", str(tmp_path / "absent.npz"), "--input-fp", rgb_npy,
                     "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"=> no bundle found at '.*absent\.pt2'"):
        deploy.main(["--load-bundle", str(tmp_path / "absent"), "--input-fp", rgb_npy,
                     "--device", "cpu"])
    prefix, rgb, _ = saved_bundle
    for flags, message in ((["--bf16"], "--bf16 has no effect on a prebuilt bundle"),
                           (["--impl", "opt"], "--impl/--tuning have no effect"),
                           (["--tuning", "t.json"], "--impl/--tuning have no effect"),
                           (["--save-bundle", str(tmp_path / "b")],
                            "--save-bundle requires --model")):
        with pytest.raises(SystemExit, match=message):
            deploy.main(["--load-bundle", prefix, "--input-fp", rgb, "--device", "cpu"] + flags)
    small = str(tmp_path / "small.npy")
    np.save(small, np.zeros((32, 32, 3), np.float32))
    with pytest.raises(SystemExit, match=r"=> bundle expects input \(1, 64, 64, 3\) "
                                         r"\(float32 compute\), got \(1, 32, 32, 3\)"):
        deploy.main(["--load-bundle", prefix, "--input-fp", small, "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs a tuning record"):  # mixed needs --tuning
        deploy.main(["--model", tiny_ckpt, "--input-fp", rgb_npy, "--impl", "mixed",
                     "--device", "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        deploy.main(["--model", tiny_ckpt, "--input-fp", rgb_npy, "--device", "cuda"])


def test_deploy_cli_bundle_round_trip(tiny_ckpt, saved_bundle, tmp_path, capsys):  # noqa: F811
    """--save-bundle, then --load-bundle (timing, randomized timing and
    the profiler on the loaded bundle): the same prediction as the
    compile-from-checkpoint run, which is the JAX deploy CLI's within
    1e-4."""
    from fastdepth_tpu.cli import deploy as jax_cli
    from fastdepth_tpu_torch.cli import deploy

    prefix, rgb, saved = saved_bundle
    assert os.path.isfile(prefix + ".pt2") and os.path.isfile(prefix + ".npz")
    loaded, prof = str(tmp_path / "loaded.npy"), tmp_path / "prof"
    stats = deploy.main(["--load-bundle", prefix, "--input-fp", rgb, "--output-fp", loaded,
                         "--warmup", "1", "--run", "2", "--randomized-input-timing",
                         "--device", "cpu", "--profile", str(prof)])
    out = capsys.readouterr().out
    for line in ("=> loading bundle", "=> saved prediction", "=> [timed] mean=",
                 "=> [randomized] mean="):
        assert line in out, line
    assert "GFLOP/frame" not in out and stats["median_s"] > 0  # as the JAX CLI's bundle branch
    assert (prof / "trace.json").stat().st_size > 0
    np.testing.assert_array_equal(np.load(loaded), np.load(saved))
    jax_pred = str(tmp_path / "jax.npy")
    jax_cli.main(["--model", tiny_ckpt, "--input-fp", rgb, "--output-fp", jax_pred,
                  "--warmup", "0", "--run", "1"])
    np.testing.assert_allclose(np.load(loaded), np.load(jax_pred), atol=1e-4)


@pytest.mark.skipif(not os.path.exists(REF_RGB), reason="reference golden data absent")
def test_deploy_cli_golden_bundle_round_trip(tiny_ckpt, tmp_path):  # noqa: F811
    """The reference's own deploy/data/rgb.npy (1x3x224x224 NCHW) through
    --save-bundle and --load-bundle: the same finite, non-negative
    prediction both ways."""
    from fastdepth_tpu_torch.cli import deploy

    prefix = str(tmp_path / "golden")
    preds = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]
    deploy.main(["--model", tiny_ckpt, "--input-fp", REF_RGB, "--output-fp", preds[0],
                 "--warmup", "0", "--run", "1", "--device", "cpu", "--save-bundle", prefix])
    deploy.main(["--load-bundle", prefix, "--input-fp", REF_RGB, "--output-fp", preds[1],
                 "--warmup", "0", "--run", "1", "--device", "cpu"])
    a, b = np.load(preds[0]), np.load(preds[1])
    assert a.shape == (1, 1, 224, 224) and np.isfinite(a).all() and a.min() >= 0
    np.testing.assert_array_equal(a, b)


def test_deploy_cli_profile_writes_a_trace(tiny_ckpt, rgb_npy, tmp_path):  # noqa: F811
    from fastdepth_tpu_torch.cli import deploy

    prof = tmp_path / "prof"
    deploy.main(["--model", tiny_ckpt, "--input-fp", rgb_npy, "--warmup", "0", "--run", "1",
                 "--device", "cpu", "--output-fp", str(tmp_path / "p.npy"),
                 "--profile", str(prof)])
    assert (prof / "trace.json").stat().st_size > 0
    assert "conv" in (prof / "ops.txt").read_text()


# --- engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    from fastdepth_tpu_torch.config import ModelConfig
    from fastdepth_tpu_torch.models import build
    from fastdepth_tpu_torch.models.fastdepth import make_fastdepth

    cfg = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
    rng = np.random.RandomState(1)
    sd = {}
    for key, v in make_fastdepth(cfg, folded=False).state_dict().items():
        a = rng.randn(*v.shape) * (np.sqrt(2.0 / np.prod(v.shape[1:])) if v.dim() == 4 else 0.1)
        if key.endswith(".var"):
            a = np.abs(a) + 0.5
        sd[key] = torch.from_numpy(a.astype(np.float32))
    model = build(cfg)
    return model, model.load(sd)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_compile_forward_matches_the_eager_forward(tiny_model, impl):
    from fastdepth_tpu_torch.engine.aot import _pick_apply, compile_forward
    from fastdepth_tpu_torch.models import fused as F

    model, params = tiny_model
    fn, prepared = compile_forward(model, params, batch_size=2, image_size=(32, 64),
                                   impl=impl, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 32, 64, 3).astype(np.float32))
    folded = model.fold(params)
    with torch.no_grad():
        want = _pick_apply(model, folded, impl, 2)(folded, x)
    got = fn(prepared, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 64, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert prepared is not params and F.tree_has_bn(params)  # the caller's tree is not folded
    with pytest.raises(ValueError, match="compiled for input"):
        fn(prepared, x[:1])


def test_compile_forward_on_cuda_without_a_card_raises(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from fastdepth_tpu_torch.engine.aot import compile_forward

    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_forward(*tiny_model, device="cuda")


def test_flops_estimate_counts_the_convolutions(tiny_model):
    from fastdepth_tpu_torch.engine.aot import flops_estimate

    model, params = tiny_model
    one = flops_estimate(model, model.fold(params), batch_size=1, image_size=(32, 32))
    two = flops_estimate(model, model.fold(params), batch_size=2, image_size=(32, 32))
    # the stem alone: 2 * (16x16 outputs) * 4 channels * 27 taps
    assert one > 2 * 16 * 16 * 4 * 27 and two == 2 * one


def test_timing_helpers_on_the_cpu():
    from fastdepth_tpu_torch.engine import benchmark as BM

    calls = []
    stats = BM.time_fn(lambda a: calls.append(a), (1,), warmup=2, repeats=3, device="cpu")
    assert len(calls) == 5 and set(stats) == {"mean_s", "median_s", "std_s", "min_s"}
    seen = []
    BM.time_randomized(seen.append, lambda i: i, warmup=1, repeats=2, device="cpu")
    assert seen == [0, 1, 2]  # a fresh input for every call
    piped = BM.time_pipelined(lambda: None, warmup=0, calls=4, device="cpu")
    assert piped["calls"] == 4.0 and piped["total_s"] >= 0
    with pytest.raises(ValueError, match="cannot time"):
        BM.time_fn(lambda: None, device="meta")


def test_cold_copies_and_the_graph_timers_arguments():
    from fastdepth_tpu_torch.engine import benchmark as BM

    assert BM.COLD_BYTES == 100 * 2 ** 20  # twice the H100's 50 MB L2
    assert BM.cold_copies(BM.COLD_BYTES) == 1 and BM.cold_copies(2 * BM.COLD_BYTES) == 1
    assert BM.cold_copies(BM.COLD_BYTES // 3) == 4 and BM.cold_copies(0) > 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BM.time_graph(lambda: None, [()])


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_stage_work_and_its_bound(skip, bf16):
    """One decoder level's bytes (x, weights and skip read once, the
    output written once) and FLOPs, and the bound on the published rates:
    the pruned 7^2 level is bound by its arithmetic in f32 at b128, every
    level by its bytes in bf16."""
    from fastdepth_tpu_torch.engine import benchmark as BM

    elem = 2 if bf16 else 4
    n, h, c, cout = 128, 7, 512, 200
    nbytes, core, tensor = BM.stage_work(n, h, h, c, cout, skip, elem, tensor_cores=bf16)
    px = n * h * h
    assert nbytes == elem * (px * c + 27 * c + c * cout + cout
                             + (2 if skip else 1) * 4 * px * cout)
    assert core + tensor == 52 * px * c + 2 * px * c * cout + 2 * px * cout + (
        4 * px * cout if skip else 0)
    assert (tensor > 0) == bf16
    us, by = BM.bound_us(nbytes, core, tensor)
    assert by == ("bytes" if bf16 else "operations")
    rates = BM.RATES
    assert rates == {"hbm_bps": 3.35e12, "f32_flops": 67e12, "bf16_tensor_flops": 989e12}
    want = max(nbytes / rates["hbm_bps"], core / rates["f32_flops"],
               tensor / rates["bf16_tensor_flops"]) * 1e6
    assert us == pytest.approx(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_of_a_kernel_against_its_plain_version(dtype):
    """f32: 1e-4 * max(1, max|plain|); bf16: 2^-7 * max|plain|, from the
    plain result's own dtype."""
    from fastdepth_tpu_torch.engine import benchmark as BM

    small = torch.tensor([0.25, -0.5]).to(dtype)
    large = torch.tensor([3.0, -8.0]).to(dtype)
    if dtype == torch.float32:
        assert BM.tolerance(small) == 1e-4 and BM.tolerance(large) == pytest.approx(8e-4)
    else:
        assert BM.tolerance(small) == 2.0 ** -8 and BM.tolerance(large) == 2.0 ** -4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BM.compare_and_time(torch.neg, torch.neg, [(small,)])


def test_profiler_trace_is_a_no_op_without_a_directory(tmp_path):
    from fastdepth_tpu_torch.engine.profiler import annotate, trace

    with trace(None), annotate("step"):
        pass
    with trace(str(tmp_path / "t")), annotate("step"):
        torch.ones(4).sum()
    assert "step" in (tmp_path / "t" / "trace.json").read_text()


# --- f32 is true f32: the entry points turn TF32 off -----------------------

def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on, as a process may find them (PyTorch turns
    cuDNN's on by default); monkeypatch restores them afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


@pytest.fixture
def val_root(tmp_path):
    """Two raw NYU val frames (480x640 h5) under DIR/nyudepthv2/val."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path / "data" / "nyudepthv2" / "val" / "scene"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(2):
        with h5py.File(str(root / f"{i:05d}.h5"), "w") as f:
            f["rgb"] = (rng.rand(3, 480, 640) * 255).astype(np.uint8)
            f["depth"] = (rng.rand(480, 640) * 9 + 0.5).astype(np.float32)
    return str(tmp_path / "data")


def test_deploy_cli_in_f32_turns_tf32_off(tiny_ckpt, rgb_npy, tmp_path, tf32_on):  # noqa: F811
    from fastdepth_tpu_torch.cli import deploy

    deploy.main(["--model", tiny_ckpt, "--input-fp", rgb_npy, "--warmup", "1", "--run", "1",
                 "--output-fp", str(tmp_path / "p.npy"), "--device", "cpu"])
    assert _tf32() == (False, False)


def test_evaluate_cli_in_f32_turns_tf32_off(tiny_ckpt, val_root, tf32_on):  # noqa: F811
    from fastdepth_tpu_torch.cli import evaluate

    avg = evaluate.main(["--evaluate", tiny_ckpt, "--data-root", val_root, "--batch-size", "2",
                         "--device", "cpu", "--no-images", "--workers", "1",
                         "--print-freq", "0"])
    assert np.isfinite(avg.rmse)
    assert _tf32() == (False, False)


@pytest.mark.parametrize("cli", ["evaluate", "deploy"])
def test_clis_in_bf16_leave_tf32_as_found(cli, tiny_ckpt, rgb_npy, val_root, tmp_path,  # noqa: F811
                                          tf32_on):
    from fastdepth_tpu_torch.cli import deploy, evaluate

    if cli == "deploy":
        deploy.main(["--model", tiny_ckpt, "--input-fp", rgb_npy, "--warmup", "1", "--run", "1",
                     "--output-fp", str(tmp_path / "p.npy"), "--device", "cpu", "--bf16"])
    else:
        evaluate.main(["--evaluate", tiny_ckpt, "--data-root", val_root, "--batch-size", "2",
                       "--device", "cpu", "--no-images", "--workers", "1", "--print-freq", "0",
                       "--bf16"])
    assert _tf32() == (True, True)


def test_evaluator_and_compile_forward_in_f32_turn_tf32_off(tiny_model, monkeypatch):
    from fastdepth_tpu_torch.engine import Evaluator
    from fastdepth_tpu_torch.engine.aot import compile_forward

    model, params = tiny_model
    for make in (lambda: Evaluator(model, params, batch_size=2, dtype=torch.float32,
                                   device="cpu"),
                 lambda: compile_forward(model, params, batch_size=1, image_size=(32, 32),
                                         device="cpu")):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        make()
        assert _tf32() == (False, False)


@pytest.mark.parametrize("found", [True, False])
def test_bf16_prepare_leaves_tf32_as_found(tiny_model, found, monkeypatch):
    from fastdepth_tpu_torch.engine.aot import _prepare

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", found)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", found)
    model, params = tiny_model
    _prepare(model, params, batch_size=2, dtype=torch.bfloat16, fold_bn=True, impl="auto",
             device="cpu")
    assert _tf32() == (found, found)
