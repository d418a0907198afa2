"""K7, the conv epilogue (``ops/cuda/epilogue.py``), and the routing of
``models/layers.apply_conv_bn`` through it.

On the CPU: the plain version is ATen's unfused sequence (the broadcast
bias ``add_``, ``+ residual``, ``relu`` / ``clamp(0, 6)``) bit for bit;
the CPU's own convs keep their bias; with the CPU among
``layers.K7_DEVICES``, folded inference convs go through the op and
every other conv keeps the separate ops, each benchmark model's forward
makes one epilogue a routed conv, and an activation that is not
channels_last is refused.  On a CUDA device (``cuda``-marked, skipped here): K7 against its
plain version bit for bit at every epilogue of the benchmark's cells and
past 2^31 elements, its launches a forward, the routed forwards against
the unrouted ones, and ``compile_forward``'s graph against the eager
forward.  No JAX, so the card's tests run alone:
    python -m pytest --noconftest tests/test_torch_conv_epilogue.py -m cuda
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from fastdepth_tpu_torch.engine.aot import compile_forward
from fastdepth_tpu_torch.models import layers as L
from fastdepth_tpu_torch.ops import blocks as B
from fastdepth_tpu_torch.ops.cuda import epilogue as E
from perfbench import harness, program
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

CL = torch.channels_last
ACTS = {E.NONE: None, E.RELU: B.relu, E.RELU6: B.relu6}
SEED = 2 ** 31 + 11

# routed convs a forward: the flagship's stem and 13 dw / pw pairs (its
# decoder is K1 and K4); ResNet-50's stem, 16 bottlenecks of three, 4
# downsamples, the bridge 1x1, UpProj's 5 levels of three and its final
# 1x1; DA-V2's patch embedding, 4 projections, 3 resamples (layer3 has
# none), refine4's one unit and refine1-3's two (two convs each), the
# four refines' out 1x1s and the three output convs (layer*_rn: no bias)
ROUTED = {"fastdepth-pruned-224": 27, "resnet50-upproj-224": 70,
          "depth-anything-v2-vitl-518": 29}
# the cells at their batch and dtype; deploy-b1 runs the flagship in f32
CELLS = [("fastdepth-pruned-224", 128, torch.bfloat16), ("fastdepth-pruned-224", 1, torch.float32),
         ("resnet50-upproj-224", 128, torch.bfloat16),
         ("depth-anything-v2-vitl-518", 64, torch.bfloat16)]


def _operands(n, c, h, w, dtype, residual, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(n, c, h, w, generator=g) * 4).to(dtype).contiguous(memory_format=CL)
    b = torch.randn(c, generator=g).to(dtype)
    r = ((torch.randn(n, c, h, w, generator=g) * 4).to(dtype).contiguous(memory_format=CL)
         if residual else None)
    return [t.to(device) if t is not None else None for t in (y, b, r)]


def _aten_sequence(y, b, residual, act):
    """The ops K7 replaces, as the unrouted path runs them on the card:
    ATen's in-place broadcast bias add after cuDNN's conv, then the
    residual add and the activation."""
    z = y.clone()
    z.add_(b.reshape(1, -1, 1, 1))
    if residual is not None:
        z = z + residual
    return z if act == E.NONE else ACTS[act](z)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest --noconftest "
                    "tests/test_torch_conv_epilogue.py -m cuda)")


@pytest.mark.parametrize("c", [1, 16, 56, 408, 2048])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [E.NONE, E.RELU, E.RELU6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_version_is_the_unfused_sequence_bit_for_bit(dtype, act, residual, c):
    y, b, r = _operands(2, c, 3, 5, dtype, residual)
    want = _aten_sequence(y, b, r, act)
    before = y.clone()
    for got in (E.conv_epilogue_reference(y, b, r, act), E.conv_epilogue(y, b, r, act)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(y, before)  # the plain version writes nothing


def test_the_wrapper_refuses_what_k7_does_not_take():
    y, b, r = _operands(1, 8, 3, 3, torch.float32, True)
    with pytest.raises(ValueError, match="b must be"):
        E.conv_epilogue(y, b[:4])
    with pytest.raises(ValueError, match="residual must be"):
        E.conv_epilogue(y, b, r[:, :4])
    with pytest.raises(ValueError, match="act must be"):
        E.conv_epilogue(y, b, None, 3)
    with pytest.raises(ValueError, match="one dtype"):
        E.conv_epilogue(y, b.double())
    with pytest.raises(ValueError, match="channels_last"):
        E.conv_epilogue(y.contiguous(), b)


def test_the_op_under_a_trace_is_one_node():
    """torch.export records the epilogue as the custom op, as a deploy
    bundle holds it, and the exported program gives the plain version."""
    y, b, r = _operands(2, 16, 5, 7, torch.float32, True)

    class M(torch.nn.Module):
        def forward(self, y, b, r):
            return E.conv_epilogue(y, b, r, E.RELU6)

    ep = torch.export.export(M(), (y, b, r))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert E.EPILOGUE_OP in targets
    assert torch.equal(ep.module()(y, b, r), _aten_sequence(y, b, r, E.RELU6))


@pytest.fixture
def cpu_calls(monkeypatch):
    """The CPU implementation's calls, as (y's shape, residual given, act)."""
    seen = []

    def counted(y, b, residual, act):
        seen.append((tuple(y.shape), residual is not None, act))
        return E.conv_epilogue_reference(y, b, residual, act)

    monkeypatch.setattr(E, "_epilogue_cpu", counted)
    return seen


@pytest.fixture
def calls(cpu_calls, monkeypatch):
    """:func:`cpu_calls`, with the CPU's folded convs routed as the
    card's are, so the routing runs here."""
    monkeypatch.setattr(L, "K7_DEVICES", ("cpu", "cuda"))
    return cpu_calls


# (Cin, Cout, k, stride, depthwise, transpose)
CONVS = [(3, 16, 3, 2, False, False), (16, 16, 3, 1, True, False), (16, 56, 1, 1, False, False),
         (32, 1, 1, 1, False, False), (8, 8, 3, 2, False, True), (5, 7, 5, 1, False, False)]


def _leaf(cin, cout, k, dw, tr, dtype, g):
    shape = ((cin, 1 if dw else cout, k, k) if tr else (cout, 1 if dw else cin, k, k))
    return L.ConvBN(torch.randn(shape, generator=g).to(dtype),
                    b=torch.randn(cout, generator=g).to(dtype), transpose=tr)


def _conv_kw(stride, dw, tr):
    return dict(stride=stride, padding=1, output_padding=1) if tr else dict(
        stride=stride, depthwise=dw)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", [E.NONE, E.RELU, E.RELU6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", CONVS)
def test_a_folded_inference_conv_goes_through_the_op(calls, conv, dtype, act, residual):
    """One epilogue a conv, with the act and residual given; its output
    is the conv without bias through the plain version, and in f32 also
    the unrouted path (the bias in the conv; on the CPU bf16 rounds the
    conv's sum with its bias once there, twice in ATen's card sequence)."""
    cin, cout, k, stride, dw, tr = conv
    g = torch.Generator().manual_seed(1)
    leaf = _leaf(cin, cout, k, dw, tr, dtype, g)
    x = torch.randn(2, cin, 9, 11, generator=g).to(dtype).contiguous(memory_format=CL)
    kw = _conv_kw(stride, dw, tr)

    def conv(bias):
        if tr:
            return F.conv_transpose2d(x, leaf.w, bias, stride=stride, padding=1, output_padding=1)
        return F.conv2d(x, leaf.w, bias, stride=stride, padding=(k - 1) // 2,
                        groups=cin if dw else 1)

    bare = conv(None)
    r = torch.randn(bare.shape, generator=g).to(dtype).contiguous(memory_format=CL) if residual \
        else None
    got = L.apply_conv_bn(x, leaf, act=ACTS[act], residual=r, **kw)
    assert calls == [(tuple(bare.shape), residual, act)]
    assert torch.equal(got, E.conv_epilogue_reference(bare, leaf.b, r, act))
    if dtype == torch.float32:
        old = conv(leaf.b) + r if residual else conv(leaf.b)
        assert torch.equal(got, old if act == E.NONE else ACTS[act](old))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_the_cpu_a_folded_conv_keeps_its_bias_in_the_conv(cpu_calls, dtype, residual):
    """The CPU's conv adds its bias inside, in one rounding: the CPU's
    convs take no K7 and give what they gave before it."""
    g = torch.Generator().manual_seed(5)
    leaf = _leaf(16, 56, 1, False, False, dtype, g)
    x = torch.randn(2, 16, 7, 9, generator=g).to(dtype).contiguous(memory_format=CL)
    r = torch.randn(2, 56, 7, 9, generator=g).to(dtype).contiguous(memory_format=CL) \
        if residual else None
    got = L.apply_conv_bn(x, leaf, act=B.relu6, residual=r)
    want = F.conv2d(x, leaf.w, leaf.b)
    assert cpu_calls == []
    assert torch.equal(got, B.relu6(want + r if residual else want))


@pytest.mark.parametrize("operand", ["y", "residual", "input"])
def test_k7_refuses_activations_that_are_not_channels_last(calls, operand):
    """A routed conv whose output or residual is not NHWC memory raises
    instead of taking the separate ops: the ops' activations are
    channels_last, and a layout fault upstream shows."""
    g = torch.Generator().manual_seed(6)
    y, b, r = _operands(2, 16, 5, 7, torch.float32, True)
    if operand == "input":  # an NCHW input and weight give cuDNN an NCHW output
        leaf = L.ConvBN(torch.randn(16, 8, 3, 3, generator=g), b=b)
        x = torch.randn(2, 8, 5, 7, generator=g)
        with pytest.raises(ValueError, match="channels_last"):
            L.apply_conv_bn(x, leaf, act=B.relu, residual=r)
    else:
        y, r = (y.contiguous(), r) if operand == "y" else (y, r.contiguous())
        with pytest.raises(ValueError, match="channels_last"):
            E.launch(y, b, r, E.RELU)
    assert calls == []


def _unrouted_cases():
    g = torch.Generator().manual_seed(2)
    w = torch.randn(8, 4, 3, 3, generator=g)
    folded = L.ConvBN(w.clone(), b=torch.randn(8, generator=g))
    bn = L.BatchNorm(8)
    bn.var.data = torch.rand(8, generator=g) + 0.5
    grad = L.ConvBN(w.clone(), b=torch.randn(8, generator=g))
    grad.w.requires_grad_(True)
    return {
        "train": (folded, dict(train=True)),
        "unfolded BatchNorm": (L.ConvBN(w.clone(), bn=bn), {}),
        "grad-requiring weight": (grad, {}),
        "plain leaf": (L.ConvBN(w.clone(), plain=True), {}),
        "other activation": (folded, dict(act=torch.sigmoid)),
        "f64": (L.ConvBN(w.double(), b=folded.b.double()), dict(dtype=torch.float64)),
        "grad-requiring input": (folded, dict(x_grad=True)),
    }


@pytest.mark.parametrize("case", list(_unrouted_cases()))
def test_other_convs_keep_the_separate_ops(calls, case):
    leaf, kw = _unrouted_cases()[case]
    kw = dict(kw)
    dtype, x_grad = kw.pop("dtype", torch.float32), kw.pop("x_grad", False)
    x = torch.randn(2, 4, 6, 6, generator=torch.Generator().manual_seed(3), dtype=dtype)
    x = x.contiguous(memory_format=CL).requires_grad_(x_grad)
    y = L.apply_conv_bn(x, leaf, residual=torch.ones(2, 8, 6, 6, dtype=dtype), **kw)
    assert calls == []
    assert y.shape == (2, 8, 6, 6)


def test_a_height_sharded_conv_keeps_the_bias_in_its_conv(calls, monkeypatch):
    seen = []

    def sharded(x, w, b, level, stride=1, padding=None, groups=1):
        seen.append(b)
        return B.conv2d(x, w, stride=stride, padding=padding, bias=b)

    monkeypatch.setattr(L.S, "conv2d", sharded)
    leaf = L.ConvBN(torch.randn(8, 4, 3, 3), b=torch.randn(8))
    x = torch.randn(2, 4, 6, 6).contiguous(memory_format=CL)
    y = L.apply_conv_bn(x, leaf, act=B.relu6, space=object())
    assert calls == [] and len(seen) == 1 and seen[0] is leaf.b
    assert torch.equal(y, B.relu6(B.conv2d(x, leaf.w, bias=leaf.b)))


def _small_cfg(name):
    """The configuration at a CPU test's size: the flagship and ResNet-50
    at 64 x 64, DA-V2 at ViT-S/14 on 56 x 56 frames."""
    if name == "depth-anything-v2-vitl-518":
        from test_torch_dinov2_dpt import small_cfg

        return small_cfg()
    return dict(harness.config(name), image_size=[64, 64])


def _forward(cfg, batch, dtype, device, seed=SEED):
    """(compile_forward's forward, its prepared tree, f32 frames)."""
    model, params = program.load(cfg, program.draw_params(cfg, seed, device), device)
    h, w = cfg["image_size"]
    fn, prepared = compile_forward(model, params, batch_size=batch, image_size=(h, w),
                                   dtype=dtype, device=device)
    x = torch.rand((batch, h, w, 3), generator=torch.Generator().manual_seed(seed % 997))
    return fn, prepared, x.to(device)


@pytest.mark.parametrize("name", list(ROUTED))
def test_each_benchmark_model_routes_every_folded_conv(calls, name):
    fn, prepared, x = _forward(_small_cfg(name), 1, torch.float32, "cpu")
    calls.clear()  # the compile's warm run
    fn(prepared, x)
    assert len(calls) == ROUTED[name]
    assert sum(res for _, res, _ in calls) == {"fastdepth-pruned-224": 0,
                                               "resnet50-upproj-224": 16 + 5,
                                               "depth-anything-v2-vitl-518": 7}[name]


# -- on the card ----------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,dtype", CELLS)
def test_k7_is_its_plain_version_at_every_epilogue_of_the_cells(monkeypatch, name, batch, dtype):
    """One forward of the cell's model at its batch and dtype: every
    epilogue K7 runs equals the plain version on the same operands bit
    for bit, one launch each; the forward equals the unrouted one (the
    bias in cuDNN's conv, then ATen's ops) bit for bit."""
    _need_cuda()
    fn, prepared, x = _forward(harness.config(name), batch, dtype, "cuda")
    seen = []
    launch = E.launch

    def checked(y, b, residual, act):
        want = E.conv_epilogue_reference(y, b, residual, act)
        got = launch(y, b, residual, act)
        seen.append((tuple(y.shape), residual is not None, act, torch.equal(got, want)))
        return got

    monkeypatch.setattr(E, "launch", checked)  # after the graph's capture
    before = E.LAUNCHES
    with torch.inference_mode():
        eager = fn(copy.copy(prepared), x)  # another tree object: the eager forward
    torch.cuda.synchronize()
    assert len(seen) == ROUTED[name] and E.LAUNCHES - before == ROUTED[name]
    assert all(ok for *_, ok in seen), [s for s in seen if not s[-1]]
    monkeypatch.setattr(L, "_k7_act", lambda *a: None)
    with torch.inference_mode():
        unrouted = fn(copy.copy(prepared), x)
    assert E.LAUNCHES - before == ROUTED[name]
    assert torch.equal(eager, unrouted)


@pytest.mark.cuda
@pytest.mark.parametrize("c,residual,act", [(1, True, E.RELU), (56, True, E.RELU6),
                                             (2048, False, E.NONE), (3, False, E.RELU)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_is_its_plain_version_on_the_vector_and_scalar_paths(dtype, c, residual, act):
    _need_cuda()
    y, b, r = _operands(3, c, 17, 9, dtype, residual, "cuda")
    want = E.conv_epilogue_reference(y, b, r, act)
    before = E.LAUNCHES
    got = E.conv_epilogue(y, b, r, act)
    assert got.data_ptr() == y.data_ptr() and E.LAUNCHES == before + 1
    assert torch.equal(got, want)
    out = E.EPILOGUE_OP(want.clone(), b, r, act)  # the op's CUDA kernel: a new output
    assert torch.equal(out, E.conv_epilogue_reference(want, b, r, act))


@pytest.mark.cuda
def test_k7_past_two_to_the_31_elements():
    """DA-V2's b64 head resizes to (64, 128, 518, 518) bf16: 2.2e9
    elements, 4.4 GB; K7 on that tensor (64-bit offsets) is its plain
    version bit for bit."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    y = torch.randn((64, 128, 518, 518), generator=g, device="cuda", dtype=torch.bfloat16)
    y = y.contiguous(memory_format=CL)
    b = torch.randn(128, generator=g, device="cuda", dtype=torch.bfloat16)
    assert y.numel() > 2 ** 31
    want = E.conv_epilogue_reference(y, b, None, E.RELU)
    got = E.conv_epilogue(y, b, None, E.RELU)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("fastdepth-pruned-224", torch.float32),
                                        ("resnet50-upproj-224", torch.bfloat16),
                                        ("depth-anything-v2-vitl-518", torch.bfloat16)])
def test_compile_forwards_graph_replays_k7_bit_for_bit(name, dtype):
    """b1: the graph's replay against the eager forward on the same
    frame; the replay runs K7 without its Python (no launch counted)."""
    _need_cuda()
    from fastdepth_tpu_torch.engine import aot

    fn, prepared, x = _forward(harness.config(name), 1, dtype, "cuda")
    before, replays = E.LAUNCHES, aot.GRAPH_REPLAYS
    replayed = fn(prepared, x)
    assert aot.GRAPH_REPLAYS == replays + 1 and E.LAUNCHES == before
    eager = fn(copy.copy(prepared), x)
    assert E.LAUNCHES == before + ROUTED[name]
    assert torch.equal(replayed, eager)
