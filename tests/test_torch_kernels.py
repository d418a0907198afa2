"""K1, the port's fused decoder stage, against the JAX package's Pallas
kernel (interpret mode on the CPU), and the CPU-side logic around it:
operand checks and the nvcc build; the one launch path every kernel
takes (``ops/cuda/kernel.py``: the device rule, the custom ops under a
trace, the launch and its count), for K1-K8; on a card also the
``space`` axis's halo rules through cuDNN (``parallel/halo_check.py``).

JAX is imported inside the one test that needs it, so that on a GPU host
without JAX the card's tests run alone:
    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from fastdepth_tpu_torch import metrics as M
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda import epilogue as K7
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K
from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3
from fastdepth_tpu_torch.ops.cuda import head as K4
from fastdepth_tpu_torch.ops.cuda import kernel
from fastdepth_tpu_torch.ops.cuda import probes as KP
from fastdepth_tpu_torch.parallel import halo_check as H
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)


def _jax_operands(rng, N, H, W, C, Cout, has_skip):
    """Seeded stage operands in the JAX layout (NHWC, HWIO)."""
    f = np.float32
    return (
        rng.randn(N, H, W, C).astype(f),
        (rng.randn(5, 5, 1, C) * 0.2).astype(f),
        (rng.randn(C) * 0.1).astype(f),
        (rng.randn(1, 1, C, Cout) * 0.2).astype(f),
        (rng.randn(Cout) * 0.1).astype(f),
        rng.randn(N, 2 * H, 2 * W, Cout).astype(f) if has_skip else None,
    )


def _port_operands(x, dw_w, dw_b, pw_w, pw_b, skip):
    """The same operands as the port holds them: channels_last NCHW
    activations, K1's weight layout derived from OIHW weights."""
    t = torch.from_numpy
    k_dw, k_pw = K.kernel_weights(t(dw_w.transpose(3, 2, 0, 1)),
                                  t(pw_w.transpose(3, 2, 0, 1)))
    return (TB.from_nhwc(t(x)), k_dw, t(dw_b), k_pw, t(pw_b),
            TB.from_nhwc(t(skip)) if skip is not None else None)


SHAPES = [(2, 7, 7, 12, 6), (1, 6, 9, 40, 70), (2, 2, 2, 4, 3)]


@pytest.mark.parametrize("has_skip", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_kernel(rng, shape, has_skip):
    import jax.numpy as jnp

    from fastdepth_tpu.ops.pallas.fused_decoder import fused_decoder_stage as jax_stage

    ops = _jax_operands(rng, *shape, has_skip)
    want = jax_stage(*[jnp.asarray(a) if a is not None else None for a in ops],
                     interpret=True)
    got = K.fused_decoder_stage_reference(*_port_operands(*ops))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(TB.to_nhwc(got).numpy(), np.asarray(want), atol=1e-4)


def test_kernel_weights_layout_is_the_tpu_kernels(rng):
    """K1's (25, C) tap-major depthwise layout is the TPU kernel's
    (5, 5, C) flattened; its (C, Cout) pointwise layout is HWIO's."""
    _, dw_w, _, pw_w, _, _ = _jax_operands(rng, 1, 3, 3, 8, 5, False)
    k_dw, k_pw = K.kernel_weights(torch.from_numpy(dw_w.transpose(3, 2, 0, 1)),
                                  torch.from_numpy(pw_w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(k_dw.numpy(), dw_w.reshape(25, 8))
    np.testing.assert_array_equal(k_pw.numpy(), pw_w.reshape(8, 5))
    with pytest.raises(ValueError, match="5x5"):
        K.kernel_weights(torch.zeros(8, 1, 3, 3), torch.zeros(5, 8, 1, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_the_plain_version(rng, dtype):
    ops = [t.to(dtype) if t is not None else None
           for t in _port_operands(*_jax_operands(rng, 2, 7, 7, 12, 6, True))]
    ops[0] = ops[0].contiguous(memory_format=torch.channels_last)
    ops[5] = ops[5].contiguous(memory_format=torch.channels_last)
    before = kernel.COUNTER["K1"]
    got = K.fused_decoder_stage(*ops)
    assert kernel.COUNTER["K1"] == before
    assert got.dtype == dtype and tuple(got.shape) == (2, 6, 14, 14)
    assert torch.equal(got, K.fused_decoder_stage_reference(*ops))


# each kernel's wrapper on tiny operands: label -> (the module that holds
# its plain version, that function's name, the operands' shapes (a "cl"
# shape stored channels_last), the wrapper called on them, the index of
# its output's pointer among the C entry's arguments)
WRAPPERS = {
    "K1": (K, "fused_decoder_stage_reference",
           [("cl", 2, 12, 7, 7), (25, 12), (12,), (12, 6), (6,), ("cl", 2, 6, 14, 14)],
           K.fused_decoder_stage, 6),
    "K2": (K2, "fused_decoder_stage_reference",
           [("cl", 2, 12, 7, 7), (25, 12), (12,), (12, 6), (6,), ("cl", 2, 6, 14, 14)],
           lambda *a: K2.fused_decoder_stage_hwbc(*a, block_batch=2), 6),
    "K3": (K3, "fused_decoder_stage_reference",
           [("cl", 2, 12, 7, 7), (25, 12), (12,), (12, 6), (6,), ("cl", 2, 6, 14, 14)],
           lambda *a: K3.fused_decoder_stage_v3(*a, block_batch=2), 6),
    "K4": (K4, "pointwise_head_reference", [("cl", 2, 12, 5, 5), (12,), (1,)],
           K4.pointwise_head, 3),
    "K5": (KP, "staged_copy_reference", [(3, 5, 4, 8)],
           lambda x: KP.staged_copy(x, chunk_bytes=64), 1),
    "K6": (KP, "staged_compute_reference", [(2, 4, 3, 6), (6, 5)],
           lambda x, w: KP.staged_compute(x, w, "matmul"), 2),
    "K7": (K7, "conv_epilogue_reference", [("cl", 2, 16, 5, 7), (16,), ("cl", 2, 16, 5, 7)],
           lambda y, b, r: K7.conv_epilogue(y, b, r, K7.RELU6), 1),
    "K8": (M, "metric_sums_reference", [(2, 5, 7, 1), (2, 5, 7, 1)], M.metric_sums, 3),
}


def _wrapper_operands(label, device):
    """The wrapper's operands on ``device``: seeded on the CPU, empty on
    any other device.  K8's depths are not negative: a negative one makes
    a NaN sum, which ``torch.equal`` never holds equal."""
    torch.manual_seed(0)
    out = []
    for shape in WRAPPERS[label][2]:
        cl = shape[0] == "cl"
        fmt = torch.channels_last if cl else torch.contiguous_format
        shape = shape[1:] if cl else shape
        out.append(torch.randn(*shape).contiguous(memory_format=fmt) if device == "cpu"
                   else torch.empty(*shape, device=device, memory_format=fmt))
    return [t.abs() for t in out] if label == "K8" and device == "cpu" else out


def _plain(label, ops):
    """The wrapper's result by its plain version."""
    mod, name, _, _, _ = WRAPPERS[label]
    extra = {"K5": (2.0, False), "K6": ("matmul",), "K7": (K7.RELU6,)}.get(label, ())
    return getattr(mod, name)(*ops, *extra)


@pytest.mark.parametrize("label", list(WRAPPERS))
def test_wrapper_on_a_cuda_tensor_without_a_card_raises(label, monkeypatch):
    """The device rule every wrapper keeps (``kernel.use_plain_version``):
    a CPU tensor takes the plain version and launches nothing; a tensor
    of any other device but CUDA is refused; a CUDA tensor launches the
    kernel or raises: with no card (and no nvcc) the wrapper must raise,
    never fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from torch._subclasses.fake_tensor import FakeTensorMode

    mod, plain, _, wrapper, _ = WRAPPERS[label]
    before = kernel.COUNTER[label]
    ops = _wrapper_operands(label, "cpu")
    assert torch.equal(wrapper(*ops), _plain(label, ops))
    with pytest.raises(ValueError, match="CUDA devices"):
        wrapper(*_wrapper_operands(label, "meta"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(mod, plain, no_fallback)
    with FakeTensorMode():
        ops = _wrapper_operands(label, "cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            wrapper(*ops)
    assert kernel.COUNTER[label] == before


@pytest.fixture
def fake_entries(monkeypatch):
    """Every wrapper on CPU tensors takes its kernel's path, whose C entry
    is a stand-in that records its call and returns ``code[0]``: the
    library, the device and the stream are the card's stand-ins too."""
    calls, code = [], [0]

    def function(name, argtypes):
        def entry(*args):
            calls.append((name, argtypes, args))
            return code[0]
        return entry

    monkeypatch.setattr(kernel, "use_plain_version", lambda label, x: False)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: -1, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 4242, raising=False)
    return calls, code


ENTRIES = {"K1": "fd_fused_decoder_stage", "K2": "fd_fused_decoder_stage_hwbc",
           "K3": "fd_fused_decoder_stage_v3", "K4": "fd_pointwise_head",
           "K5": "fd_staged_copy", "K6": "fd_staged_compute", "K7": "fd_conv_epilogue",
           "K8": "fd_metric_sums"}


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "cuda_error"])
@pytest.mark.parametrize("label", list(WRAPPERS))
def test_each_kernel_launches_through_the_one_launch_path(label, fails, fake_entries):
    """``kernel.launch`` for every wrapper: one call of the kernel's C
    entry with as many arguments as its C types, the operands' pointers
    first (the output's among them), the stream last; the launch counted
    once under the kernel's label.  A non-zero CUDA error raises with the
    label and counts nothing."""
    calls, code = fake_entries
    code[0] = 700 if fails else 0
    ops = _wrapper_operands(label, "cpu")
    before = kernel.COUNTER[label]
    if fails:
        with pytest.raises(RuntimeError, match=f"^{label} launch failed: CUDA error 700$"):
            WRAPPERS[label][3](*ops)
    else:
        out = WRAPPERS[label][3](*ops)
        assert calls[0][2][WRAPPERS[label][4]] == out.data_ptr()
    (name, argtypes, args), = calls
    assert name == ENTRIES[label] and len(args) == len(argtypes)
    assert args[0] == ops[0].data_ptr() and args[-1] == 4242
    assert kernel.COUNTER[label] == before + (0 if fails else 1)


# the registered ops: label -> the op
OPS = {"K1": K.STAGE_OP.overload, "K4": K4.HEAD_OP.overload,
       "K7": K7.EPILOGUE_OP.overload, "K8": M.METRIC_SUMS_OP.overload}


@pytest.mark.parametrize("label", list(OPS))
def test_the_op_under_a_trace_is_one_node(label):
    """torch.export records each registered op's eager entry as the custom
    op, one node, as a deploy bundle holds it; the node's fake output has
    the eager output's shape, dtype and strides, and the exported program
    gives the plain version."""
    wrapper = WRAPPERS[label][3]
    ops = _wrapper_operands(label, "cpu")

    class M(torch.nn.Module):
        def forward(self, *args):
            return wrapper(*args)

    ep = torch.export.export(M(), tuple(ops))
    nodes = [n for n in ep.graph.nodes if n.op == "call_function" and n.target == OPS[label]]
    assert len(nodes) == 1
    fake, eager = nodes[0].meta["val"], wrapper(*ops)

    def layout(t):  # a dim of one element has no stride that matters
        return t.shape, t.dtype, [st for st, n in zip(t.stride(), t.shape) if n > 1]
    assert layout(fake) == layout(eager)
    assert torch.equal(ep.module()(*ops), _plain(label, ops))


class _Flag:
    """A stand-in for ``torch.autograd.profiler`` whose profiler flag is
    ``on`` and counts its reads."""

    def __init__(self, on):
        self.on, self.reads = on, 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return self.on


@pytest.mark.parametrize("on", [False, True], ids=["no_profiler", "profiler"])
@pytest.mark.parametrize("label", list(OPS))
def test_an_eager_op_call_opens_its_span_only_under_a_profiler(label, on, monkeypatch):
    """The eager dispatch (``kernel.Op``) reads the profiler's flag once a
    call: with no profiler running it opens no span; with one running it
    opens one span of the op's name (``engine/profiler``) around the
    implementation.  The output is the plain version's either way."""
    opened = []

    def record_function(name):
        opened.append(name)
        return contextlib.nullcontext()

    flag = _Flag(on)
    monkeypatch.setattr(kernel, "_autograd_profiler", flag)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    ops = _wrapper_operands(label, "cpu")
    assert torch.equal(WRAPPERS[label][3](*ops), _plain(label, ops))
    assert flag.reads == 1
    assert opened == ([{"K1": P.K1, "K4": P.K4, "K7": P.K7, "K8": P.K8}[label]] if on else [])


def test_wrapper_rejects_what_k1_does_not_take(rng):
    x, dw_w, dw_b, pw_w, pw_b, skip = _port_operands(
        *_jax_operands(rng, 2, 7, 7, 12, 6, True))
    bad = [
        ((x.contiguous(), dw_w, dw_b, pw_w, pw_b, skip), "channels_last"),
        ((x, dw_w, dw_b, pw_w, pw_b, skip.contiguous()), "channels_last"),
        ((x.double(), dw_w, dw_b, pw_w, pw_b, skip), "float32 or bfloat16"),
        ((x, dw_w.bfloat16(), dw_b, pw_w, pw_b, skip), "one dtype"),
        ((x, dw_w[:24], dw_b, pw_w, pw_b, skip), "dw_w"),
        ((x, dw_w, dw_b, pw_w[:11], pw_b, skip), "pw_w"),
        ((x, dw_w, dw_b, pw_w, pw_b[:5], skip), "pw_b"),
        ((x, dw_w, dw_b, pw_w, pw_b, skip[:, :, :13]), "skip"),
        ((x, dw_w, dw_b, pw_w.t().contiguous().t(), pw_b, skip), "contiguous"),
        ((x, dw_w, dw_b, pw_w.clone().requires_grad_(), pw_b, skip), "inference-only"),
        ((x.to("meta"), *(t.to("meta") for t in (dw_w, dw_b, pw_w, pw_b, skip))),
         "CUDA devices"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            K.fused_decoder_stage(*args)


def _fake_nvcc(path, log):
    """A stand-in compiler: writes its output file and logs each call."""
    with open(path, "w") as f:
        f.write(
            "#!/usr/bin/env python3\nimport sys\n"
            f"open({log!r}, 'a').write('call\\n')\n"
            "if any('broken' in open(a).read() for a in sys.argv if a.endswith('.cu')):\n"
            "    sys.stderr.write('error: broken source'); sys.exit(2)\n"
            "out = sys.argv[sys.argv.index('-o') + 1]\n"
            "open(out, 'w').write('lib')\n")
    os.chmod(path, 0o755)


def _fake_tree(tmp_path, monkeypatch):
    """A csrc/ of two sources and a shared header, a build dir, and a fake
    nvcc; returns (csrc, build dir, nvcc, number of nvcc calls so far)."""
    csrc, build_dir = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// v1\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// h1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    nvcc, log = str(tmp_path / "nvcc"), str(tmp_path / "calls")
    _fake_nvcc(nvcc, log)

    def calls():
        return open(log).read().count("call") if os.path.exists(log) else 0

    return csrc, build_dir, nvcc, calls


def test_build_caches_by_source_hash_and_reports_failures(tmp_path, monkeypatch):
    """One nvcc per source (started together), then one link."""
    csrc, build_dir, nvcc, calls = _fake_tree(tmp_path, monkeypatch)
    first, _ = _build.build(nvcc)
    assert os.path.exists(first) and calls() == 3
    assert _build.build(nvcc)[0] == first and calls() == 3  # unchanged: no rebuild
    (csrc / "a.cu").write_text("// v2\n")
    second, _ = _build.build(nvcc)
    assert second != first and calls() == 6
    (csrc / "a.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build(nvcc)
    # a failed build leaves no library, object or temporary file behind
    assert sorted(os.listdir(build_dir)) == sorted(
        os.path.basename(p) for p in (first, second))


def test_build_rebuilds_when_a_shared_header_changes(tmp_path, monkeypatch):
    """A header under csrc/ joins the hash: editing it must not load a
    library built from the old header."""
    csrc, _, nvcc, calls = _fake_tree(tmp_path, monkeypatch)
    first, _ = _build.build(nvcc)
    (csrc / "common.cuh").write_text("// h2\n")
    second, _ = _build.build(nvcc)
    assert second != first and calls() == 6


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


# (N, H, W, C, Cout, skip) on the card: the pruned flagship's five levels
# and the unpruned model's first at batch 2 and batch 1, the other skip
# choice at 14^2, batch 1 / 8 / 128 at the two largest levels, and ragged
# shapes
CARD_CASES = [
    (2, 7, 7, 512, 200, False), (2, 14, 14, 200, 256, True), (2, 14, 14, 200, 256, False),
    (2, 28, 28, 256, 120, True), (2, 56, 56, 120, 56, True), (2, 112, 112, 56, 16, False),
    (2, 7, 7, 1024, 512, False), (2, 7, 7, 1024, 512, True),
    *[(1, h, h, c, cout, skip) for h, c, cout, skip in (
        (7, 512, 200, False), (14, 200, 256, True), (28, 256, 120, True),
        (7, 1024, 512, False))],  # the deploy path's batch at the other levels
    *[(n, 56, 56, 120, 56, True) for n in (1, 8, 128)],
    *[(n, 112, 112, 56, 16, False) for n in (1, 8, 128)],
    (2, 9, 9, 33, 13, True), (2, 9, 9, 33, 8, True), (2, 9, 9, 33, 200, False),
    (3, 9, 9, 33, 200, True),
    *[(*shape, True) for shape in SHAPES], *[(*shape, False) for shape in SHAPES],
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_CASES)
def test_k1_matches_plain_version_on_the_card(shape, dtype, monkeypatch):
    """On a CUDA device: K1 against its plain version (f32 bound
    1e-4 * max(1, max|plain|), TF32 off; bf16 2^-7 * max|plain|: one
    rounding of the depthwise result entering the tensor cores and one of
    the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # true f32 convs
    *dims, has_skip = shape
    rng = np.random.RandomState(0)
    ops = [t.to("cuda", dtype) if t is not None else None
           for t in _port_operands(*_jax_operands(rng, *dims, has_skip))]
    ops[0] = ops[0].contiguous(memory_format=torch.channels_last)
    if has_skip:
        ops[5] = ops[5].contiguous(memory_format=torch.channels_last)
    before = kernel.COUNTER["K1"]
    got = K.fused_decoder_stage(*ops)
    assert kernel.COUNTER["K1"] == before + 1
    want = K.fused_decoder_stage_reference(*ops).float()
    scale = float(want.abs().max())
    bound = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert float((got.float() - want).abs().max()) <= bound


@pytest.mark.cuda
def test_k1_outputs_equal_the_recorded_digests_bit_for_bit():
    """On a CUDA device: K1's outputs at the flagship's levels (batch 8
    and 1, f32 and bf16; ``cli.bench_decoder.digests``) hash to what K1
    gave on the same inputs at commit d7adecb, before it took its leaf
    device pieces from stage_tile.cuh
    (``fastdepth_tpu_torch/measurements/k1_digests_d7adecb.json``, written
    on an H100 by ``bench_decoder --digests`` run against that tree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    import json
    import os

    from fastdepth_tpu_torch.cli.bench_decoder import digests

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fastdepth_tpu_torch", "measurements", "k1_digests_d7adecb.json")
    with open(path) as f:
        want = json.load(f)["k1_sha256"]
    got = digests()
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []



# the flagship's b1 deploy shapes through the custom ops: (N, H, W, C, Cout,
# skip, window) for K1 (level 1 without a skip, level 2 with one, level 4
# as rank 1 of a space axis of 2: its tile holds image rows 26-55 of 56 and
# it writes output rows 56-111), then K4 on the 224^2 head
OP_CASES = {"k1_no_skip": (1, 7, 7, 512, 200, False, None),
            "k1_skip": (1, 14, 14, 200, 256, True, None),
            "k1_window": (1, 56, 56, 120, 56, True, (26, 56, 56, 112))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*OP_CASES, "k4"])
def test_custom_ops_launch_their_kernels_and_pass_opcheck_on_the_card(case):
    """On a CUDA device: one call of fastdepth::fused_decoder_stage or
    fastdepth::pointwise_head launches K1 or K4 once (``kernel.COUNTER``), and
    ``torch.library.opcheck`` passes on the CUDA tensors (schema, fake
    against real output metadata, strides included, and the op under
    AOT dispatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    rng = np.random.RandomState(0)
    if case == "k4":
        x = torch.from_numpy(rng.rand(1, 224, 224, 16).astype(np.float32)).cuda()
        args, label, op = (TB.from_nhwc(x), torch.randn(16, device="cuda"),
                           torch.randn(1, device="cuda")), "K4", K4.HEAD_OP.overload
    else:
        n, h, w, c, cout, has_skip, window = OP_CASES[case]
        ops = [t.cuda() if t is not None else None
               for t in _port_operands(*_jax_operands(rng, n, h, w, c, cout, has_skip))]
        if window is not None:
            r0, _, o0, o1 = window
            ops[0] = ops[0][:, :, r0:].contiguous(memory_format=torch.channels_last)
            ops[5] = ops[5][:, :, o0:o1].contiguous(memory_format=torch.channels_last)
        args, label, op = ((*ops, None if window is None else list(window)), "K1",
                           K.STAGE_OP.overload)
    before = kernel.COUNTER[label]
    out = op(*args)
    torch.cuda.synchronize()
    assert kernel.COUNTER[label] == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(op, args)

@pytest.mark.cuda
@pytest.mark.parametrize("world", H.WORLDS)
@pytest.mark.parametrize("case", H.OP_CASES, ids=[c[0] for c in H.OP_CASES])
def test_halo_rules_hold_through_the_cards_convolutions(world, case, monkeypatch):
    """On a CUDA device: each rank's tile of a sharded op of the ``space``
    axis (one process, the exchange replaced by slices of the whole
    input: ``parallel/halo_check.py``), through the card's convolutions
    (cuDNN), against the unsharded op on the card sliced to the rank's
    rows: f32 within 1e-4 * max(1, max|unsharded|), the order of sums of
    a cropped tile (TF32 off).  ``chip_smoke.space_phase`` runs the same
    cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # true f32 convs
    row = H.check_case(case, world, "cuda", torch.float32)
    assert row["ok"], row


LEVELS = [(7, 512, 200), (14, 200, 256), (28, 256, 120), (56, 120, 56), (112, 56, 16),
          (7, 1024, 512), (9, 33, 13), (9, 33, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 128])
@pytest.mark.parametrize("level", LEVELS)
def test_launch_geometry_covers_every_output_once(level, n, dtype):
    """The launch K1 gets: every (image, pixel, output channel) in exactly
    one block; at most 227 KB of shared memory; a block shape the kernel
    takes; and at least one block per SM (132) wherever the level's
    outputs fill two of the smallest blocks per SM (32 threads x 32
    outputs each)."""
    H, C, Cout = level
    g = K.launch_geometry(n, H, H, C, Cout, dtype)
    bf16 = dtype == torch.bfloat16
    p = g.tile_h * g.tile_w
    # the kernel's block shapes (fd_fused_decoder_stage's check)
    assert g.threads in (32, 64, 128, 256) and g.tile_w in (4, 8, 16, 32)
    assert g.groups in (1, 2, 4, 8) and g.groups * g.threads <= 256
    assert g.groups <= -(-C // g.chunk)  # every group has a chunk of C
    assert p * g.cout_tile == 32 * g.threads
    assert g.cout_tile <= 256 and g.cout_tile & (g.cout_tile - 1) == 0
    assert g.cout_tile >= (32 if bf16 else 8) and p >= (32 if bf16 else 8)
    assert g.chunk in ((16, 32) if bf16 else (8, 16, 32))
    if Cout <= 256:
        # Cout splits only where a smaller split leaves SMs idle
        assert g.cout_tile >= Cout or g.blocks >= K.SMS or g.threads == 32
    assert g.smem == K.smem_bytes(g.tile_h, g.tile_w, g.cout_tile, g.chunk, bf16, g.groups)
    assert g.smem <= K.MAX_SMEM
    tiles_w = -(-H // g.tile_w)
    tiles = -(-H // g.tile_h) * tiles_w
    assert g.grid == (n * tiles, -(-Cout // g.cout_tile))
    # every output exactly once: count each block's (image, pixel, Cout)
    hits = np.zeros((n, H, H, Cout), np.int32)
    for bx in range(g.grid[0]):
        img, tile = divmod(bx, tiles)
        h0, w0 = (tile // tiles_w) * g.tile_h, (tile % tiles_w) * g.tile_w
        for by in range(g.grid[1]):
            c0 = by * g.cout_tile
            hits[img, h0:h0 + g.tile_h, w0:w0 + g.tile_w, c0:c0 + g.cout_tile] += 1
    assert (hits == 1).all()
    if n * H * H * Cout >= K.SMS * 2 * 32 * 32:
        assert g.blocks >= K.SMS


def test_launch_geometry_is_fixed_by_the_shapes():
    """A closed-form function of (N, H, W, C, Cout, dtype): no state, no
    knob; the largest blocks at b128, smaller ones where the batch is
    small; the unpruned 512-wide level takes two Cout tiles."""
    a = K.launch_geometry(128, 28, 28, 256, 120, torch.float32)
    assert a == K.launch_geometry(128, 28, 28, 256, 120, torch.float32)
    assert a.threads == 256 and a.cout_tile == 128  # all of Cout in one tile
    assert K.launch_geometry(8, 7, 7, 512, 200, torch.float32).threads == 32
    assert K.launch_geometry(128, 7, 7, 1024, 512, torch.float32).grid[1] == 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.launch_geometry(1, 7, 7, 8, 8, torch.float16)
