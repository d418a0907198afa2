"""The port's deploy bundle (``engine/aot.save_bundle`` / ``load_bundle``:
a ``torch.export`` program with K1 and K4 as the custom ops
``fastdepth::fused_decoder_stage`` and ``fastdepth::pointwise_head``,
plus the JAX package's npz) on the CPU, where the ops run their kernels'
plain versions, held against the JAX package's bundle on the same numpy
params."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.checkpoint.io import flatten_tree, load_checkpoint as jax_load_checkpoint
from fastdepth_tpu.engine import aot as JA
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import aot as A
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.models.fastdepth import make_fastdepth
from fastdepth_tpu_torch.ops.cuda import epilogue as K7
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
from fastdepth_tpu_torch.ops.cuda import head as K4
from fastdepth_tpu_torch.ops.cuda.kernel import COUNTER
from torch_port_config import to_jax, to_port
from torch_zoo import port_model, random_tree
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
HW = (64, 64)


def _unfolded_state_dict(seed):
    """A seeded unfolded state dict of the tiny flagship (BatchNorm with
    random statistics), as numpy-made CPU tensors."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, v in make_fastdepth(CFG, folded=False).state_dict().items():
        a = rng.randn(*v.shape) * (np.sqrt(2.0 / np.prod(v.shape[1:])) if v.dim() == 4 else 0.1)
        if key.endswith(".var"):
            a = np.abs(a) + 0.5
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def tiny():
    """(port model, port params, JAX model, JAX params): one unfolded
    numpy tree handed to both packages."""
    sd = _unfolded_state_dict(1)
    model = build(CFG)
    return (model, model.load(sd), jax_build(to_jax(CFG)),
            jax.tree.map(jnp.asarray, params_to_jax(sd)))


@pytest.fixture(scope="module")
def bundles(tiny, tmp_path_factory):
    """Both packages' bundles of the tiny flagship at b1 64x64, f32 and
    bf16: {dtype name: (port prefix, JAX prefix)}."""
    model, params, jmodel, jparams = tiny
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, dtype, jdtype in (("float32", torch.float32, jnp.float32),
                                ("bfloat16", torch.bfloat16, jnp.bfloat16)):
        port, jax_prefix = str(root / f"port_{name}"), str(root / f"jax_{name}")
        A.save_bundle(port, model, params, image_size=HW, dtype=dtype, device="cpu")
        JA.save_bundle(jax_prefix, jmodel, jparams, image_size=HW, dtype=jdtype)
        out[name] = port, jax_prefix
    return out


def _rgb(seed=0):
    return np.random.RandomState(seed).rand(1, *HW, 3).astype(np.float32)


def _op_nodes(exported):
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    return (targets.count("fastdepth.fused_decoder_stage.default"),
            targets.count("fastdepth.pointwise_head.default"))


def test_f32_round_trip_matches_jax_and_compile_forward(tiny, bundles):
    model, params, _, _ = tiny
    port, jax_prefix = bundles["float32"]
    assert os.path.isfile(port + ".pt2") and os.path.isfile(port + ".npz")
    call, loaded, config, spec = A.load_bundle(port, device="cpu")
    jcall, jloaded, jconfig, jspec = JA.load_bundle(jax_prefix)
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig) == dataclasses.asdict(CFG)
    assert spec == jspec == {"bundle": True, "batch_size": 1, "image_size": list(HW),
                             "dtype": "float32"}
    x = _rgb()
    counts = (COUNTER["K1"], COUNTER["K4"])
    got = call(loaded, torch.from_numpy(x))
    assert (COUNTER["K1"], COUNTER["K4"]) == counts  # CPU: the plain versions, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, *HW, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcall(jloaded, jnp.asarray(x))),
                               atol=1e-4)
    fn, prepared = A.compile_forward(model, params, image_size=HW, device="cpu")
    torch.testing.assert_close(got, fn(prepared, torch.from_numpy(x)), rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"bundle expects input \(1, 64, 64, 3\)"):
        call(loaded, torch.zeros(1, 32, 32, 3))


def test_bf16_round_trip_keeps_bf16_and_matches_jax(bundles):
    port, jax_prefix = bundles["bfloat16"]
    call, loaded, _, spec = A.load_bundle(port, device="cpu")
    jcall, jloaded, _, _ = JA.load_bundle(jax_prefix)
    assert spec["dtype"] == "bfloat16"
    assert {t.dtype for t in A.param_tensors(loaded).values()} == {torch.bfloat16}
    x = _rgb(1)
    got = call(loaded, torch.from_numpy(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jcall(jloaded, jnp.asarray(x))),
                               atol=2e-2)  # tests/test_aot.py's bf16 bound


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_npz_is_the_file_jax_writes(bundles, name):
    """Same keys, dtypes (bf16 keeps its tag) and extra as JAX's bundle
    npz; f32 values within 1e-6 (both fold in f32), bf16 within one
    bf16 ulp of the fold's rounding; JAX's load_checkpoint reads it."""
    port, jax_prefix = bundles[name]
    got, got_cfg, meta = jax_load_checkpoint(port + ".npz")
    want, want_cfg, jmeta = jax_load_checkpoint(jax_prefix + ".npz")
    assert got_cfg == want_cfg
    assert meta["extra"] == jmeta["extra"]
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        a, b = g[k].astype(np.float32), w[k].astype(np.float32)
        tol = 1e-6 if name == "float32" else 2.0 ** -7 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=k)
    with np.load(port + ".npz") as a, np.load(jax_prefix + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_params_are_an_input_of_the_program(tiny, bundles):
    """A bundle called with another tree (its kernel weight layouts
    included) runs every layer on it: equal to compile_forward on that
    tree, bit for bit, so no weight was baked into the .pt2."""
    model, _, _, _ = tiny
    call, loaded, _, _ = A.load_bundle(bundles["float32"][0], device="cpu")
    other = model.load(_unfolded_state_dict(2))
    fn, prepared = A.compile_forward(model, other, image_size=HW, device="cpu")
    x = torch.from_numpy(_rgb(2))
    want = fn(prepared, x)
    torch.testing.assert_close(call(prepared, x), want, rtol=0, atol=0)
    assert not torch.equal(call(loaded, x), want)
    with torch.no_grad():  # only the kernels' layout changes: K1 reads it, nothing else
        prepared["decoder"]["decode_conv3"].k1_pw.mul_(0.5)
    assert not torch.equal(call(prepared, x), want)


def test_a_tree_of_another_dtype_or_shape_is_refused(tiny, bundles):
    model, params, _, _ = tiny
    call, loaded, _, _ = A.load_bundle(bundles["float32"][0], device="cpu")
    x = torch.from_numpy(_rgb())
    with pytest.raises(ValueError, match="the bundle was saved with"):
        call(loaded.to(torch.bfloat16), x)
    wide = build(dataclasses.replace(CFG, decoder_channels=(20, 14, 10, 6, 4)))
    with pytest.raises(ValueError, match="the bundle was saved with"):
        call(wide.fold(wide.init(torch.Generator().manual_seed(0))), x)


def test_a_tensor_captured_as_a_constant_is_refused(tiny, tmp_path, monkeypatch):
    model, params, _, _ = tiny
    shift = torch.ones(())
    pick = A._pick_apply
    monkeypatch.setattr(A, "_pick_apply", lambda *a, **k: (
        lambda p, x, f=pick(*a, **k): f(p, x) + shift))
    with pytest.raises(RuntimeError, match="holds tensors as constants"):
        A.save_bundle(str(tmp_path / "b"), model, params, image_size=(32, 32), device="cpu")


ZOO_CFG = ModelConfig(encoder="resnet18", decoder="upproj", skip=None, decoder_channels=TINY_DEC)


@pytest.mark.parametrize("case,nodes", [
    ("fused", (5, 1)), ("mixed", (3, 1)), ("opt", (0, 0)), ("xla", (0, 0)), ("zoo", (0, 0))])
def test_exported_graph_holds_the_op_nodes_and_round_trips(tiny, tmp_path, case, nodes):
    """K1 and K4 nodes: one K1 a level and one K4 for the fused forward,
    one K1 a 'pallas' level for a mixed map, none for opt, xla and a
    zoo model (ResNet-18 + upproj); every bundle equals compile_forward."""
    model, params, _, _ = tiny
    impl, tuning, hw = case, None, (32, 32)
    if case == "mixed":
        tuning = {1: "pallas", 2: "xla", 3: "pallas", 4: "xla", 5: "pallas"}
    if case == "zoo":
        model, params = port_model(to_jax(ZOO_CFG), random_tree(to_jax(ZOO_CFG), 3))
        impl = "auto"
    prefix = str(tmp_path / case)
    exported = A.save_bundle(prefix, model, params, image_size=hw, impl=impl, tuning=tuning,
                             device="cpu")
    assert _op_nodes(exported) == nodes
    assert _op_nodes(torch.export.load(prefix + ".pt2")) == nodes
    call, loaded, _, _ = A.load_bundle(prefix, device="cpu")
    fn, prepared = A.compile_forward(model, params, image_size=hw, impl=impl, tuning=tuning,
                                     device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).rand(1, *hw, 3).astype(np.float32))
    torch.testing.assert_close(call(loaded, x), fn(prepared, x), rtol=0, atol=0)


def _k1_operands(skip, window):
    rng = np.random.RandomState(5)

    def t(*shape, cl=False):
        v = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return v.contiguous(memory_format=torch.channels_last) if cl else v

    x = t(2, 12, 6, 5, cl=True)
    rows = 12 if window is None else window[3] - window[2]
    sk = t(2, 8, rows, 10, cl=True) if skip else None
    return (x, t(25, 12), t(12), t(12, 8), t(8), sk, window)


@pytest.mark.parametrize("op,args", [
    ("K1", dict(skip=True, window=None)),
    ("K1", dict(skip=False, window=None)),
    ("K1", dict(skip=True, window=[0, 8, 2, 8])),  # rows 2-7 of a 16-row output
    ("K4", {}),
    ("K7", {}),
], ids=["k1_skip", "k1_no_skip", "k1_window", "k4", "k7"])
def test_opcheck_on_cpu_tensors(op, args):
    if op == "K1":
        a = _k1_operands(**args)
        # the window's tile holds image rows 0-5 of 8, all that output rows 2-7 read
        torch.library.opcheck(K1.STAGE_OP.overload, a)
        torch.testing.assert_close(K1.STAGE_OP.overload(*a),
                                   K1.fused_decoder_stage_reference(*a), rtol=0, atol=0)
    elif op == "K4":
        x = torch.randn(2, 12, 6, 5).contiguous(memory_format=torch.channels_last)
        a = (x, torch.randn(12), torch.randn(1))
        torch.library.opcheck(K4.HEAD_OP.overload, a)
        torch.testing.assert_close(K4.HEAD_OP.overload(*a),
                                   K4.pointwise_head_reference(*a), rtol=0, atol=0)
    else:
        y, r = (torch.randn(2, 12, 6, 5).contiguous(memory_format=torch.channels_last)
                for _ in range(2))
        a = (y, torch.randn(12), r, K7.RELU6)
        torch.library.opcheck(K7.EPILOGUE_OP.overload, a)
        torch.testing.assert_close(K7.EPILOGUE_OP.overload(*a),
                                   K7.conv_epilogue_reference(*a), rtol=0, atol=0)


def test_the_ops_fakes_give_the_kernels_output_strides():
    """Shape, dtype and channels_last strides as the kernels allocate
    them (for K4's one channel too), so the trace sees the layout the
    card produces."""
    x, dw, db, pw, pb, sk, _ = _k1_operands(True, None)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        out = K1.STAGE_OP.overload(fx, *(mode.from_tensor(t) for t in (dw, db, pw, pb, sk)),
                                   None)
        head = K4.HEAD_OP.overload(out, mode.from_tensor(torch.zeros(8)),
                                   mode.from_tensor(torch.zeros(1)))
    assert tuple(out.shape) == (2, 8, 12, 10) and out.dtype == torch.float32
    assert out.stride() == torch.empty(2, 8, 12, 10).contiguous(
        memory_format=torch.channels_last).stride()
    assert tuple(head.shape) == (2, 1, 12, 10) and head.stride() == (120, 1, 10, 1)


def test_load_bundle_on_cuda_without_a_card_raises(bundles):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.load_bundle(bundles["float32"][0], device="cuda")


def test_config_round_trips_through_the_bundle_as_a_port_config(bundles):
    _, _, config, _ = A.load_bundle(bundles["float32"][0], device="cpu")
    assert isinstance(config, ModelConfig) and to_port(to_jax(config)) == config
