"""The port's tuned dispatch (``engine/autotune.py``, ``cli/autotune.py``,
``models/fused.apply_fastdepth_mixed``, ``impl='mixed'`` / ``tuning=``
through ``engine/aot``, the Evaluator and the CLIs) on the CPU, held
against the JAX package's on the same numpy inputs and parameters; on
the CPU K1's and K4's plain versions run, JAX's Pallas stage in interpret
mode."""

import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.cli import autotune as jax_autotune_cli
from fastdepth_tpu.engine import autotune as JA
from fastdepth_tpu.models import fused as JF
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.cli import autotune as autotune_cli
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import autotune as A
from fastdepth_tpu_torch.engine.aot import _pick_apply
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
from fastdepth_tpu_torch.ops.cuda import head as K4
from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER
from torch_port_config import to_jax, to_port
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
HW = 32
ALL_XLA = {i: "xla" for i in range(1, 6)}
ALL_PALLAS = {i: "pallas" for i in range(1, 6)}
ALTERNATING = {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "pallas"}
MAPS = {"all_xla": ALL_XLA, "all_pallas": ALL_PALLAS, "alternating": ALTERNATING}
COMMITTED_JAX = sorted(glob.glob(os.path.join(REPO, "tuning", "tpuv5lite.*.json")))
COMMITTED_H100 = sorted(glob.glob(os.path.join(REPO, "tuning", "h100.*.json")))


def write_record(path, winners_by_dtype) -> str:
    """A tuning record in the JAX format with the given winners:
    ``{dtype name: {stage: impl}}``."""
    records = [{"stage": s, "dtype": d, "winner": w}
               for d, winners in winners_by_dtype.items() for s, w in winners.items()]
    with open(path, "w") as f:
        json.dump({"config": {}, "device": "x", "records": records}, f)
    return str(path)


@pytest.fixture(scope="module")
def state_dict():
    """A seeded unfolded tree (He-scaled convs, BatchNorm statistics away
    from their defaults) as a flat state dict, for both packages; the
    BatchNorm biases and the head's weight non-negative, or the ReLUs
    leave the output 0 nearly everywhere."""
    rng = np.random.RandomState(0)
    sd = {}
    for key, v in make_fastdepth(CFG, folded=False).state_dict().items():
        a = rng.randn(*v.shape) * (np.sqrt(2.0 / np.prod(v.shape[1:])) if v.dim() == 4 else 0.1)
        if key.endswith((".var", ".bn.bias", "decode_conv6.pw.w")):
            a = np.abs(a) + (0.5 if key.endswith(".var") else 0.0)
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def trees(state_dict):
    """(port model, port unfolded tree, port folded tree, JAX model, JAX
    folded tree), from ``state_dict``."""
    from fastdepth_tpu.models import build as jax_build

    model = build(CFG)
    params = model.load(state_dict)
    jmodel = jax_build(to_jax(CFG))
    jfolded = jmodel.fold(jax.tree.map(jnp.asarray, params_to_jax(state_dict)))
    return model, params, model.fold(params), jmodel, jfolded


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """A record whose f32 and bf16 winners differ: f32 alternates, bf16
    is all plain but level 2."""
    return write_record(tmp_path_factory.mktemp("rec") / "t.json",
                        {"float32": ALTERNATING, "bfloat16": {**ALL_XLA, 2: "pallas"}})


# --- shapes, configs and records ---------------------------------------------

SHAPE_CFGS = {name: None for name in autotune_cli.MODEL_CONFIGS}
SHAPE_CFGS["tiny-concat"] = dataclasses.replace(CFG, skip="concat")


@pytest.mark.parametrize("fn", ["_stage_shapes", "_encoder_op_shapes"])
@pytest.mark.parametrize("name", list(SHAPE_CFGS))
def test_shapes_equal_jax(fn, name):
    cfg = SHAPE_CFGS[name] or autotune_cli.config_for(name)
    assert getattr(A, fn)(cfg) == getattr(JA, fn)(to_jax(cfg))


@pytest.mark.parametrize("name", list(autotune_cli.MODEL_CONFIGS))
def test_config_for_equals_jax(name):
    assert autotune_cli.MODEL_CONFIGS == jax_autotune_cli.MODEL_CONFIGS
    assert autotune_cli.config_for(name) == to_port(jax_autotune_cli.config_for(name))


# (the port's dtype argument, JAX's): names, None, dtype objects
DTYPES = [(None, None), ("bfloat16", "bfloat16"), ("float32", "float32"),
          (np.float32, np.float32), (torch.float32, np.float32),
          (torch.bfloat16, jnp.bfloat16)]


def test_the_committed_jax_records_are_there():
    assert len(COMMITTED_JAX) == 4, COMMITTED_JAX


@pytest.mark.parametrize("dtype, jax_dtype", DTYPES, ids=lambda d: str(d))
@pytest.mark.parametrize("path", COMMITTED_JAX, ids=os.path.basename)
def test_load_tuning_equals_jax_on_the_committed_records(path, dtype, jax_dtype):
    assert A.load_tuning(path, dtype) == JA.load_tuning(path, jax_dtype)


@pytest.mark.parametrize("winners, want", [
    # bf16 preferred by default, an f32-only stage fills the gap
    ({"float32": {1: "xla", 2: "xla"}, "bfloat16": {1: "pallas"}},
     {None: {1: "pallas", 2: "xla"}, "float32": {1: "xla", 2: "xla"}}),
    # selection by dtype, gaps filled from the other dtype
    ({"float32": {1: "xla"}, "bfloat16": {1: "pallas", 2: "pallas"}},
     {"float32": {1: "xla", 2: "pallas"}, "bfloat16": {1: "pallas", 2: "pallas"}}),
], ids=["prefers_bf16", "selects_by_dtype"])
def test_load_tuning_equals_jax_on_written_records(tmp_path, winners, want):
    path = write_record(tmp_path / "t.json", winners)
    for dtype, jax_dtype in DTYPES:
        assert A.load_tuning(path, dtype) == JA.load_tuning(path, jax_dtype)
    for dtype, w in want.items():
        assert A.load_tuning(path, dtype) == w


def test_device_tag():
    assert A.device_tag("NVIDIA H100 80GB HBM3") == "h100"
    assert A.device_tag("TPU v5 lite") == "tpuv5lite"  # the JAX package's rule
    assert A.device_tag("cpu") == "cpu"


def test_the_committed_h100_records_load_and_cover_every_stage():
    """The card's records for the four released models (written by
    chip_smoke.py's tuned phase on an H100) parse through load_tuning
    with a winner for every decoder stage at both dtypes, carry encoder
    records for every conv op, and say the encoder half is
    informational (tests/test_autotune.py's checks)."""
    assert [os.path.basename(f) for f in COMMITTED_H100] == sorted(
        f"h100.{name}.json" for name in autotune_cli.MODEL_CONFIGS)
    for f in COMMITTED_H100:
        with open(f) as fh:
            rec = json.load(fh)
        assert "H100" in rec["device"], f
        for dtype in ("bfloat16", "float32"):
            winners = A.load_tuning(f, dtype)
            assert set(winners) == {1, 2, 3, 4, 5}, (f, winners)
            assert set(winners.values()) <= {"xla", "pallas"}
        assert {(r["stage"], r["dtype"]) for r in rec["records"] if r["winner"]} == {
            (s, d) for s in range(1, 6) for d in ("bfloat16", "float32")}, f
        assert len(rec["encoder_records"]) == 27 * 2, f
        assert all(r["xla_ms"] is not None for r in rec["encoder_records"]), f
        assert rec["encoder_records_note"].startswith("informational"), f
        if "nnconv5dw" not in f:  # the dense decoder has no K1 candidate
            assert set(A.load_tuning(f).values()) == {"xla"}


# --- the mixed forward ---------------------------------------------------------

@pytest.mark.parametrize("name", list(MAPS))
def test_mixed_matches_jax(trees, rng, name):
    """The port's mixed forward (K1's plain version on 'pallas' levels)
    against JAX's apply_fastdepth_mixed in interpret mode, f32, 1e-4."""
    _, _, folded, _, jfolded = trees
    x = rng.rand(2, HW, HW, 3).astype(np.float32)
    want = np.asarray(JF.apply_fastdepth_mixed(jfolded, jnp.asarray(x), to_jax(CFG), MAPS[name],
                                               interpret=True))
    counts = (COUNTER["K1"], COUNTER["K4"])
    with torch.no_grad():
        got = F.apply_fastdepth_mixed(folded, torch.from_numpy(x), CFG, MAPS[name])
    assert (COUNTER["K1"], COUNTER["K4"]) == counts  # CPU: plain versions, no launch
    assert tuple(got.shape) == (2, HW, HW, 1) and got.std() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_mixed_equals_fused_and_opt_in_f64(trees, rng, monkeypatch):
    """In f64 (K1's and K4's plain versions: the wrappers take f32 and
    bf16) all 'pallas' is the fused forward, all 'xla' the head-commute
    forward, and the alternating map lies between them, to 1e-9."""
    monkeypatch.setattr(F, "fused_decoder_stage", K1.fused_decoder_stage_reference)
    monkeypatch.setattr(F, "pointwise_head", K4.pointwise_head_reference)
    _, _, folded, _, _ = trees
    tree = copy.deepcopy(folded).to(torch.float64)
    x = torch.from_numpy(rng.rand(2, HW, HW, 3))
    with torch.no_grad():
        fused = F.apply_fastdepth_fused(tree, x, CFG)
        opt = F.apply_fastdepth_opt(tree, x, CFG)
        for winners, want in ((ALL_PALLAS, fused), (ALL_XLA, opt), (ALTERNATING, fused), ({}, opt)):
            got = F.apply_fastdepth_mixed(tree, x, CFG, winners)
            assert got.dtype == torch.float64
            torch.testing.assert_close(got, want, rtol=0, atol=1e-9)


def test_mixed_levels_keep_the_channels_last_layout(trees, monkeypatch):
    """Every level, K1 or plain, hands the next one channels_last NCHW
    (K1 and K4 take no other layout: a plain level that returned another
    would cost a transpose or fail)."""
    seen = []
    for impl, stage in list(F.MIXED_STAGES.items()):
        def record(i, y, p, skip, level, stage=stage, impl=impl):
            out = stage(i, y, p, skip, level)
            seen.append((i, impl, out.is_contiguous(memory_format=torch.channels_last)))
            return out
        monkeypatch.setitem(F.MIXED_STAGES, impl, record)
    with torch.no_grad():
        F.apply_fastdepth_mixed(trees[2], torch.rand(2, HW, HW, 3), CFG, ALTERNATING)
    assert seen == [(i, ALTERNATING[i], True) for i in range(1, 6)]


def test_mixed_refuses_unknown_implementations(trees):
    with pytest.raises(ValueError, match="unknown implementations"):
        F.apply_fastdepth_mixed(trees[2], torch.rand(1, HW, HW, 3), CFG, {1: "palas"})


# --- _pick_apply('mixed') -------------------------------------------------------

@pytest.mark.parametrize("case, message", [
    ("unfolded", "BN-folded"),
    ("concat", "skip-add"),
    ("plain_mobilenet", "skip-add"),
    ("no_record", "needs a tuning record"),
    ("missing_record", "no tuning record at"),
    ("record_without_mixed", "applies to impl='mixed' only"),
])
def test_pick_apply_mixed_refusals(trees, record, case, message):
    model, params, folded, _, _ = trees
    kw = {"impl": "mixed", "tuning": record}
    if case == "unfolded":
        folded = params
    elif case in ("concat", "plain_mobilenet"):
        cfg = (dataclasses.replace(CFG, skip="concat") if case == "concat"
               else ModelConfig(decoder="nnconv5dw", skip=None, encoder_channels=TINY_ENC,
                                decoder_channels=TINY_DEC))
        model = build(cfg)
        folded = model.fold(model.init(torch.Generator().manual_seed(0)))
    elif case == "no_record":
        kw["tuning"] = None
    elif case == "missing_record":
        kw["tuning"] = "tuning/h100.json"
    else:
        kw["impl"] = "auto"
    with pytest.raises(ValueError, match=message):
        _pick_apply(model, folded, kw["impl"], 2, tuning=kw["tuning"])


def test_pick_apply_mixed_dispatches_the_winner_map_by_dtype(trees, record, monkeypatch):
    """From a record path both maps load once, and each call runs its
    input's dtype's map: f32 the alternating one (K1's plain version on
    levels 1, 3, 5), bf16 the plain stage but at level 2; any other
    dtype the bf16 map (f64 here, through K1's and K4's plain versions,
    which take it).  A winner map given as a dict runs as it is."""
    monkeypatch.setattr(F, "fused_decoder_stage", K1.fused_decoder_stage_reference)
    monkeypatch.setattr(F, "pointwise_head", K4.pointwise_head_reference)
    model, _, folded, _, _ = trees
    calls = []
    for impl, stage in list(F.MIXED_STAGES.items()):
        monkeypatch.setitem(F.MIXED_STAGES, impl, lambda *a, stage=stage, impl=impl: (
            calls.append((a[0], impl)), stage(*a))[1])
    fwd = _pick_apply(model, folded, "mixed", 2, tuning=record)
    x = torch.rand(1, HW, HW, 3)
    with torch.no_grad():
        for dtype, want in ((torch.float32, ALTERNATING),
                            (torch.bfloat16, {**ALL_XLA, 2: "pallas"}),
                            (torch.float64, {**ALL_XLA, 2: "pallas"})):
            calls.clear()
            fwd(copy.deepcopy(folded).to(dtype), x.to(dtype))
            assert calls == sorted(want.items()), dtype
        calls.clear()
        _pick_apply(model, folded, "mixed", 2, tuning=ALL_PALLAS)(folded, x)
        assert calls == sorted(ALL_PALLAS.items())


def test_evaluator_mixed_rows_equal_jax(trees, state_dict, record, rng):
    """Evaluator(impl='mixed', tuning=<record>) against the JAX
    Evaluator's, same record, params and batch: metric rows rtol 1e-5."""
    from fastdepth_tpu.engine import Evaluator as JaxEvaluator
    from fastdepth_tpu_torch.engine import Evaluator

    model, params, _, jmodel, _ = trees
    x = rng.rand(2, HW, HW, 3).astype(np.float32)
    d = rng.uniform(0.5, 9.5, (2, HW, HW, 1)).astype(np.float32)
    jev = JaxEvaluator(jmodel, jax.tree.map(jnp.asarray, params_to_jax(state_dict)),
                       batch_size=2, impl="mixed", tuning=record)
    want = np.asarray(jev(jnp.asarray(x), jnp.asarray(d))[1])
    ev = Evaluator(model, params, batch_size=2, impl="mixed", tuning=record, device="cpu")
    got = ev(ev.put(x), ev.put(d))[1].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- the autotune CLI and tune_decoder ------------------------------------------

def test_autotune_cli_unknown_model_fails_before_tuning(tmp_path, monkeypatch):
    monkeypatch.setattr(A, "tune_model", lambda *a, **k: pytest.fail("tuned"))
    with pytest.raises(SystemExit, match="unknown model"):
        autotune_cli.main(["--models", "nope", "--out", str(tmp_path), "--device", "cpu"])


def test_autotune_cli_on_the_cpu_writes_a_record_in_the_jax_format(tmp_path):
    """cli.autotune on the pruned flagship, batch 1, one call, on the CPU
    (CPU times of the plain versions: the record's shape only): every key
    of the committed JAX record and of each of its records, stages 1-5
    at both dtypes, winners in {xla, pallas}."""
    name = "mobilenet-nnconv5dw-skipadd-pruned"
    paths = autotune_cli.main(["--models", name, "--out", str(tmp_path), "--batch-enc", "1",
                               "--batch-dec", "1", "--calls", "1", "--device", "cpu"])
    assert paths == [str(tmp_path / f"cpu.{name}.json")]
    with open(paths[0]) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "tuning", f"tpuv5lite.{name}.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert got["config"] == want["config"] and got["device"] == "cpu"
    # the committed record predates the JAX package's skip_mode / tap keys,
    # and its Pallas compile failed at two levels (pallas_error)
    assert all({k for k in w if not k.endswith("_error")} <= set(g)
               for g, w in zip(got["records"], want["records"], strict=True))
    assert not any(k.endswith("_error") for r in got["records"] for k in r)
    assert {(r["stage"], r["dtype"]) for r in got["records"]} == {
        (s, d) for s in range(1, 6) for d in ("bfloat16", "float32")}
    assert {r["winner"] for r in got["records"]} <= {"xla", "pallas"}
    assert [set(r) for r in got["encoder_records"]] == [set(r) for r in want["encoder_records"]]


def test_tune_decoder_times_k1_where_jax_times_pallas():
    """'pallas' is timed at 5x5 depthwise levels that do not concat, as
    in the JAX package: not for a dense decoder, not at a concat level."""
    dense = ModelConfig(decoder="nnconv5", skip=None, encoder_channels=TINY_ENC,
                        decoder_channels=TINY_DEC)
    concat = dataclasses.replace(CFG, skip="concat")
    for cfg, timed in ((CFG, [1, 2, 3, 4, 5]), (dense, []), (concat, [1, 5])):
        rec = A.tune_decoder(cfg, batch=1, dtypes=("float32",), warmup=0, calls=1,
                             device="cpu")
        assert [r["stage"] for r in rec["records"] if "pallas_ms" in r] == timed


def test_tune_decoder_times_the_stages_the_mixed_forward_runs(monkeypatch):
    """At the levels apply_fastdepth_mixed runs, each timed impl is its own
    stage function (MIXED_STAGES) on a folded level with K1's layouts, at
    the level's input and skip shapes; no level times another copy."""
    seen = []

    def recorder(impl, stage):
        def run(i, y, p, skip, level):
            seen.append((impl, i, tuple(y.shape), skip is not None, hasattr(p, "k1_dw"),
                         level))
            return stage(i, y, p, skip, level)
        return run

    for impl, stage in list(F.MIXED_STAGES.items()):
        monkeypatch.setitem(F.MIXED_STAGES, impl, recorder(impl, stage))
    rec = A.tune_decoder(CFG, batch=1, dtypes=("float32",), warmup=0, calls=1, device="cpu")
    shapes = {s["stage"]: s for s in A._stage_shapes(CFG)}
    assert {(impl, i) for impl, i, *_ in seen} == {
        (impl, i) for impl in ("xla", "pallas") for i in range(1, 6)}
    for impl, i, shape, has_skip, folded, level in seen:
        s = shapes[i]
        assert shape == (1, s["cin"], s["h"], s["w"])
        assert has_skip == s["skip"] and folded and level is None
    assert all(r["winner"] in ("xla", "pallas") for r in rec["records"])
