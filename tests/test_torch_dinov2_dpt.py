"""Depth Anything V2 (DINOv2 ViT + DPT head, ``models/dinov2_dpt.py``)
in the port, held against the benchmark's plain reference
(``perfbench/reference/dinov2_dpt.py``) on the CPU at ViT-S/14's
published widths on 56 x 56 frames: straight, through ``Evaluator`` and
through ``compile_forward``; the reference's keys load strictly; the
published ViT-L/14 tree, built on the meta device, has the published
shapes; a planted fault in the port fails the comparison; and the family
inits as DINOv2 does and refuses what it does not run, naming itself.

Tolerances: the port and the reference do the same f32 arithmetic in
nearly the same order, and agree to ~5e-7 of the depth's norm; 1e-5
leaves room for a BLAS's other blocking, and the smallest planted fault
(tanh GELU) reads 5e-5."""

import dataclasses
import math
import types

import pytest
import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.engine.aot import _pick_apply, compile_forward
from fastdepth_tpu_torch.engine.evaluator import Evaluator
from fastdepth_tpu_torch.models import build, dinov2_dpt as DD, from_name
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.parallel import spatial as S
from perfbench import harness, program
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

CONFIG = "depth-anything-v2-vitl-518"
HW = 56
TOL = 1e-5
SEED = 2 ** 31 + 5
# DA-V2's 'vits': DINOv2 ViT-S/14 and its DPT head
VITS = dict(embed_dim=384, depth=12, num_heads=6, mlp_dim=1536, taps=[2, 5, 8, 11], features=64,
            decoder_channels=[48, 96, 192, 384],
            port_model={"encoder": "dinov2_vits14", "decoder": "dpt", "skip": None})


def small_cfg():
    cfg = harness.config(CONFIG)
    cfg.update(VITS, image_size=[HW, HW])
    return cfg


@pytest.fixture(scope="module")
def case():
    """(cfg, state dict, model, tree, uint8 frames, the reference's depth)."""
    cfg = small_cfg()
    sd = program.draw_params(cfg, SEED, "cpu")
    model, params = program.load(cfg, sd, "cpu")
    x = torch.randint(0, 256, (2, HW, HW, 3), generator=torch.Generator().manual_seed(1),
                      dtype=torch.uint8)
    with torch.no_grad():
        want = program.reference(cfg).forward(sd, x, cfg)
    return cfg, sd, model, params, x, want


def rel(got, want):
    return float((got - want).norm() / want.norm())


def straight(model, params, x):
    with torch.no_grad():
        return model.apply(model.fold(params), x.float() / 255)


def test_the_reference_depth_is_in_range(case):
    want = case[-1]
    assert want.shape == (2, HW, HW, 1)
    assert 0.95 <= float(want.min()) and float(want.max()) < 20.0


def test_the_straight_forward_is_the_reference(case):
    cfg, sd, model, params, x, want = case
    assert rel(straight(model, params, x), want) < TOL
    f = torch.rand((2, HW, HW, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.apply(model.fold(params), f)
        ref = program.reference(cfg).forward(sd, f, cfg)
    assert rel(got, ref) < TOL


def test_the_evaluator_runs_it_straight_and_scores_its_depth(case):
    from fastdepth_tpu_torch import metrics as M

    _, _, model, params, x, want = case
    ev = Evaluator(model, params, batch_size=2, dtype=torch.float32, impl="auto", device="cpu")
    assert ev._apply == model.apply
    depth = torch.rand((2, HW, HW, 1), generator=torch.Generator().manual_seed(3)) * 9.5 + 0.5
    pred, rows = ev(x, depth)
    assert rel(pred, want) < TOL
    ref = M.evaluate_batch(want, depth)
    for i, f in enumerate(M.METRIC_FIELDS):
        assert torch.allclose(rows[i], ref[f], rtol=1e-4), f


def test_compile_forward_runs_it(case):
    _, _, model, params, x, want = case
    fn, prepared = compile_forward(model, params, batch_size=2, image_size=(HW, HW),
                                   device="cpu")
    assert rel(fn(prepared, x.float() / 255), want) < TOL
    with pytest.raises(ValueError, match="compiled for input"):
        fn(prepared, torch.zeros(1, HW, HW, 3))


@pytest.mark.parametrize("limit,calls", [(2 * 32 * HW * HW, 2), (100, 10)])
def test_a_resize_past_the_kernels_limit_is_written_in_slices(case, monkeypatch, limit, calls):
    """Outputs of RESIZE_LIMIT elements or more (the CUDA kernel's INT_MAX)
    go in batch slices, bit for bit the whole call: at the limit of the
    last resize's two frames (32 channels at 56 x 56) that resize alone
    goes a frame at a time; under every resize's, all five do."""
    _, _, model, params, x, _ = case
    whole = straight(model, params, x)
    sliced = []
    resize = torch.ops.aten.upsample_bilinear2d.out
    monkeypatch.setattr(DD, "RESIZE_LIMIT", limit)
    monkeypatch.setattr(torch.ops.aten.upsample_bilinear2d, "out",
                        lambda a, *r, **k: sliced.append(a.shape[0]) or resize(a, *r, **k))
    assert torch.equal(straight(model, params, x), whole)
    assert sliced == [1] * calls


def test_the_bf16_evaluator_is_near_the_reference(case):
    """bf16 keeps 8 bits of mantissa (0.4% a rounding) through 12 blocks
    and the head: within 3% of the f32 depth (0.6% read here)."""
    _, _, model, params, x, want = case
    ev = Evaluator(model, params, batch_size=2, dtype=torch.bfloat16, device="cpu")
    pred, _ = ev(x, torch.full((2, HW, HW, 1), 2.0))
    assert pred.dtype == torch.float32 and rel(pred, want) < 0.03


def test_the_reference_keys_load_strictly(case):
    cfg, sd, model, _, _, _ = case
    tree = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tree.state_dict().items()} == {
        r[0]: tuple(r[1]) for r in program.reference(cfg).schema(cfg)}
    model.load(sd)
    for broken in ({k: v for k, v in sd.items() if k != "encoder.block0.ls1.gamma"},
                   dict(sd, **{"decoder.refine4.rcu1.conv1.w": torch.zeros(64, 64, 3, 3)})):
        with pytest.raises(RuntimeError):
            model.load(broken)


def test_the_published_tree_has_the_published_shapes():
    """DA-V2 Large's tree at 518 x 518 on the meta device: every leaf's
    shape is the reference schema's of the benchmark's configuration,
    and the count is the published 335.3M less the two leaves the port
    leaves out (``parameters`` in the configuration file)."""
    cfg = harness.config(CONFIG)
    model = from_name("dinov2_vitl14-dpt")
    assert model.config == ModelConfig(**cfg["port_model"],
                                       decoder_channels=tuple(cfg["decoder_channels"]),
                                       output_size=tuple(cfg["image_size"]))
    with torch.device("meta"):
        tree = DD.make_dinov2_dpt(model.config)
    shapes = {k: tuple(v.shape) for k, v in tree.state_dict().items()}
    assert shapes == {r[0]: tuple(r[1]) for r in program.reference(cfg).schema(cfg)}
    assert shapes["encoder.tokens.pos"] == (1, 1370, 1024)
    assert shapes["encoder.block23.fc1.w"] == (1024, 4096)
    assert shapes["decoder.resize1.w"] == (256, 256, 4, 4)
    count = sum(math.prod(s) for s in shapes.values())
    assert count == cfg["parameters"]["tree"] == 334_134_465
    # + refinenet4.resConfUnit1 (2 x (256 x 256 x 9 + 256)) + mask_token (1024)
    assert round((count + 2 * (256 * 256 * 9 + 256) + 1024) / 1e5) / 10 == 335.3


def test_the_config_file_holds_the_ports_preset():
    cfg, pre = harness.config(CONFIG), DD.PRESETS["dinov2_vitl14"]
    assert (cfg["embed_dim"], cfg["depth"], cfg["num_heads"], cfg["mlp_dim"]) == (
        pre.dim, pre.depth, pre.heads, pre.mlp)
    assert tuple(cfg["taps"]) == pre.taps and cfg["features"] == pre.features
    assert tuple(cfg["decoder_channels"]) == pre.out_channels
    assert cfg["max_depth"] == pre.max_depth and cfg["image_size"] == [pre.image_size] * 2
    assert (cfg["patch_size"], cfg["ln_eps"], cfg["head_hidden"]) == (
        DD.PATCH, DD.LN_EPS, DD.HEAD_HIDDEN)
    assert tuple(cfg["mean"]) == DD.MEAN and tuple(cfg["std"]) == DD.STD
    small = small_cfg()
    vits = DD.PRESETS["dinov2_vits14"]
    assert (small["embed_dim"], small["depth"], small["mlp_dim"], tuple(small["taps"]),
            small["features"], tuple(small["decoder_channels"])) == (
        vits.dim, vits.depth, vits.mlp, vits.taps, vits.features, vits.out_channels)


class _Functional(types.SimpleNamespace):
    """``torch.nn.functional`` with some functions replaced."""

    def __getattr__(self, name):
        return getattr(F, name)


FAULTS = {
    "no_scale": {"scaled_dot_product_attention":
                 lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=1.0)},
    "align_corners_false": {"interpolate": lambda *a, **k: F.interpolate(
        *a, **dict(k, align_corners=False))},
    "tanh_gelu": {"gelu": lambda h: F.gelu(h, approximate="tanh")},
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["no_layerscale", "wrong_taps"])
def test_a_planted_fault_fails_the_comparison(case, monkeypatch, fault):
    _, _, model, params, x, want = case
    if fault in FAULTS:
        monkeypatch.setattr(DD, "F", _Functional(**FAULTS[fault]))
    elif fault == "wrong_taps":  # one block off at each of the first three taps
        pre = DD.PRESETS["dinov2_vits14"]
        monkeypatch.setitem(DD.PRESETS, "dinov2_vits14", pre._replace(taps=(3, 6, 9, 11)))
    else:  # every LayerScale left out: gamma 1
        params = model.fold(params)
        for m in params.modules():
            if isinstance(m, L.LayerScale):
                m.gamma.data.fill_(1.0)
    assert rel(straight(model, params, x), want) > 4 * TOL


def test_init_is_dinov2s_and_is_not_refused():
    model = build(dataclasses.replace(DD.config("dinov2_vits14"), output_size=(HW, HW)))
    tree = model.init(torch.Generator().manual_seed(0))
    enc, dec = tree["encoder"], tree["decoder"]
    blk = enc["block3"]
    for lin in ("qkv", "proj", "fc1", "fc2"):
        w = blk[lin].w
        assert 0.018 < float(w.std()) < 0.022 and float(w.abs().max()) <= 2.0
        assert not blk[lin].b.any()
    assert torch.equal(blk["ls1"].gamma, torch.ones(384))
    assert torch.equal(enc["norm"].scale, torch.ones(384)) and not enc["norm"].bias.any()
    assert 0.018 < float(enc["tokens"].pos.std()) < 0.022
    assert 0 < float(enc["tokens"].cls.abs().max()) < 1e-5
    w = dec["refine1"]["rcu2"]["conv1"].w
    assert abs(float(w.std()) / math.sqrt(2 / (9 * 64)) - 1) < 0.05
    assert dec["layer1_rn"].b is None and dec["layer1_rn"].bn is None
    a = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a.state_dict()[k], v) for k, v in tree.state_dict().items())


def test_from_name_builds_the_presets():
    for enc, pre in DD.PRESETS.items():
        cfg = from_name(f"{enc}-dpt").config
        assert (cfg.encoder, cfg.decoder, cfg.skip) == (enc, "dpt", None)
        assert cfg.decoder_channels == pre.out_channels and cfg.output_size == (518, 518)
    with pytest.raises(ValueError, match="dinov2_dpt family"):
        from_name("dinov2_vitl14-nnconv5")


def test_fold_leaves_the_tree_alone(case):
    _, sd, model, params, _, _ = case
    folded = model.fold(params)
    assert folded is not params
    assert all(torch.equal(folded.state_dict()[k], v) for k, v in sd.items())
    assert isinstance(folded["encoder"]["block0"]["norm1"], L.LayerNorm)


def test_the_family_refuses_what_it_does_not_run(case):
    cfg, _, model, params, x, _ = case
    folded = model.fold(params)
    family = "dinov2_dpt family"
    bad = [ModelConfig(encoder="dinov2_vits14", decoder="dpt", skip=None,
                       decoder_channels=(48, 96, 192, 192), output_size=(HW, HW)),
           ModelConfig(encoder="dinov2_vits14", decoder="dpt", skip=None,
                       decoder_channels=(48, 96, 192, 384), output_size=(HW, HW + 1)),
           ModelConfig(encoder="dinov2_vits14", decoder="nnconv5", skip=None,
                       decoder_channels=(48, 96, 192, 384), output_size=(HW, HW))]
    for c in bad:
        with pytest.raises(ValueError, match=family):
            build(c)
    for impl, tuning in (("fused", None), ("opt", None), ("mixed", {1: "pallas"})):
        with pytest.raises(ValueError, match=family):
            _pick_apply(model, folded, impl, 2, tuning=tuning)
    assert _pick_apply(model, folded, "xla", 2) == model.apply
    part = S.Partition(size=2, rank=0)
    with pytest.raises(ValueError, match="mesh axis shards"):
        S.check_model(model.config)
    with pytest.raises(ValueError, match=family):
        _pick_apply(model, folded, "auto", 2, space=part)
    with pytest.raises(ValueError, match=family):
        model.apply(folded, x.float() / 255, space=part)
    with pytest.raises(ValueError, match=family):
        model.apply(folded, x.float() / 255, train=True)


def test_the_forward_opens_its_spans(case):
    _, _, model, params, x, _ = case
    fn, prepared = compile_forward(model, params, batch_size=2, image_size=(HW, HW),
                                   device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(prepared, x.float() / 255)
    events = [e for e in prof.events() if e.name.startswith("fastdepth.")]
    names = [e.name for e in events]
    assert names.count(P.STEP) == names.count(P.ENCODER) == names.count(P.DECODER) == 1
    assert names.count(P.ATTENTION) == DD.PRESETS["dinov2_vits14"].depth
    enc = next(e for e in events if e.name == P.ENCODER).time_range
    for e in events:
        if e.name == P.ATTENTION:
            assert enc.start <= e.time_range.start and e.time_range.end <= enc.end


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_graph_of_compile_forward_replays_it_on_the_card(dtype):
    """On the card: compile_forward captures the ViT-S forward (SDPA
    inside) in its CUDA graph; a replay equals the eager forward bit for
    bit and, in f32 (TF32 off), the reference to 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastdepth_tpu_torch.engine import aot
    from perfbench.reference import common as C

    cfg = small_cfg()
    sd = program.draw_params(cfg, SEED, "cuda")
    model, params = program.load(cfg, sd, "cuda")
    x = torch.rand((1, HW, HW, 3), generator=torch.Generator().manual_seed(4)).cuda()
    fn, prepared = compile_forward(model, params, image_size=(HW, HW),
                                   dtype=getattr(torch, dtype), device="cuda")
    before = aot.GRAPH_REPLAYS
    got = fn(prepared, x)
    assert aot.GRAPH_REPLAYS == before + 1
    with torch.inference_mode():
        eager = model.apply(prepared, x.to(getattr(torch, dtype))).float()
    assert torch.equal(got, eager)
    if dtype == "float32":
        with torch.no_grad(), C.tf32(False):
            want = program.reference(cfg).forward(sd, x, cfg)
        assert rel(got, want) < TOL
