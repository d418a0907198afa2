"""K8, the depth metrics' masked sums (``ops/cuda/metric_sums.py``), and
``metrics.metric_sums``'s route through it.

On the CPU: ``metrics.metric_sums`` is its plain version bit for bit
(the JAX pins stay in ``tests/test_torch_metrics.py``); an ``Evaluator``
step calls ``fastdepth::metric_sums`` once, and on the kernel's route
(the CUDA implementation on CPU tensors, its launch a stand-in that
computes the plain version) launches K8 once with a workspace of a wave's
rows; the op's fake output; the shapes ``metrics.metric_sums`` refuses.
On a CUDA device (``cuda``-marked, skipped here): the grid the kernel
picks at the benchmark cells' shapes; K8 against its plain version at
the cells' shapes and at odd, sliced and misaligned ones, its counts and
delta sums exact, its float sums within 1e-5 of the float64 sums of the
plain version's per-pixel terms, the same bits from launch to launch,
and one launch an ``Evaluator`` step.  No JAX, so the card's tests run
alone:
    python -m pytest --noconftest tests/test_torch_metric_sums.py -m cuda
"""

import pytest
import torch

from fastdepth_tpu_torch import metrics as M
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine.evaluator import Evaluator
from fastdepth_tpu_torch.models import build
from fastdepth_tpu_torch.ops.cuda import kernel
from fastdepth_tpu_torch.ops.cuda import metric_sums as K8
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

# the rows of the stack that hold integers: delta1-3 and the count
EXACT = [M.SUM_FIELDS.index(f) for f in ("delta1", "delta2", "delta3")] + [len(M.SUM_FIELDS)]
FLOAT = [i for i in range(K8.FIELDS) if i not in EXACT]
TINY = ModelConfig(encoder_channels=(4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24),
                   decoder_channels=(18, 14, 10, 6, 4), output_size=(64, 64))


def _maps(n, h, w, seed=0, device="cpu"):
    """Seeded (prediction, target) in metres, (n, h, w, 1) f32, with
    zeros in both, negative predictions, and (from n = 3 on) an image
    whose target is all zero and one with no valid pixel."""
    g = torch.Generator().manual_seed(seed)
    out = torch.rand((n, h, w, 1), generator=g) * 7.8 + 0.2
    tgt = torch.rand((n, h, w, 1), generator=g) * 8.5 + 0.5
    out[torch.rand(out.shape, generator=g) < 0.2] = 0.0
    out[torch.rand(out.shape, generator=g) < 0.05] *= -1.0
    tgt[torch.rand(tgt.shape, generator=g) < 0.3] = 0.0
    if n >= 3:
        tgt[1] = 0.0
        out[2] = 0.0
        tgt[2] = 0.0
    return out.to(device), tgt.to(device)


def _same(a, b):
    """Equal to the bit (NaNs included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 16), (3, 17, 23), (1, 9, 5)])
def test_on_the_cpu_metric_sums_is_its_plain_version_bit_for_bit(shape, dtype):
    out, tgt = _maps(*shape, seed=1)
    before = kernel.COUNTER["K8"]
    got = M.metric_sums(out.to(dtype), tgt)
    assert _same(got, M.metric_sums_reference(out.to(dtype), tgt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (K8.FIELDS, shape[0])
    assert kernel.COUNTER["K8"] == before
    assert K8.FIELDS == len(M.SUM_FIELDS) + 1


def _evaluator_step(seed=2):
    model = build(TINY)
    ev = Evaluator(model, model.init(torch.Generator().manual_seed(0)), batch_size=2,
                   device="cpu")
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8)
    depth = torch.rand((2, 64, 64, 1), generator=g) * 9.5 + 0.5
    return ev, rgb, depth


@pytest.fixture
def calls(monkeypatch):
    """The op's CPU implementation's calls, as (output's shape, target's
    shape): an eager call runs the implementation ``kernel.Op`` holds."""
    seen = []

    def counted(output, target):
        seen.append((tuple(output.shape), tuple(target.shape)))
        return M.metric_sums_reference(output, target)

    monkeypatch.setattr(M.METRIC_SUMS_OP, "cpu", counted)
    return seen


def test_an_evaluator_step_goes_through_the_op_once(calls):
    ev, rgb, depth = _evaluator_step()
    pred, rows = ev(rgb, depth)
    assert calls == [((2, 64, 64, 1), (2, 64, 64, 1))]
    want = M.finish(M.metric_sums_reference(pred, depth))
    assert torch.equal(rows, torch.stack([want[f] for f in M.METRIC_FIELDS]))


def test_an_evaluator_step_on_the_kernels_route_launches_k8_once(monkeypatch):
    """The op's CUDA implementation on CPU tensors, its one launch a
    stand-in that writes the plain version's stack into the output: the
    entry, the operands (contiguous f32 maps, a workspace of a wave's
    rows, the ``(10, N)`` output) and the workspace's rows, from which
    the kernel picks its grid; the step's metric rows are the plain
    route's bit for bit."""
    ev, rgb, depth = _evaluator_step()
    _, want = ev(rgb, depth)
    launches = []

    def launch(label, entry, argtypes, tensors, *scalars):
        launches.append((label, entry, len(argtypes), [tuple(t.shape) for t in tensors], scalars))
        out, tgt, _, sums = tensors
        sums.copy_(M.metric_sums_reference(out, tgt))

    monkeypatch.setattr(M.METRIC_SUMS_OP, "cpu", K8.metric_sums_cuda)
    monkeypatch.setattr(kernel, "launch", launch)
    _, got = ev(rgb, depth.double())  # the kernel's route casts to f32
    rows = K8.WAVE_ROWS
    assert launches == [("K8", "fd_metric_sums", 8,
                         [(2, 64, 64, 1), (2, 64, 64, 1), (rows * K8.FIELDS,),
                          (K8.FIELDS, 2)], (2, 64 * 64, rows))]
    assert torch.equal(got, want)


def test_the_fake_gives_ten_rows_of_f32_an_image():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = torch.empty((5, 7, 3, 1), dtype=torch.bfloat16)
        got = M.METRIC_SUMS_OP.overload(out, torch.empty((5, 7, 3, 1)))
        assert tuple(got.shape) == (K8.FIELDS, 5) and got.dtype == torch.float32


def test_the_op_passes_opcheck_on_the_cpu():
    out, tgt = _maps(3, 6, 5)
    torch.library.opcheck(M.METRIC_SUMS_OP.overload, (out, tgt))


@pytest.mark.parametrize("case", ["channels", "mismatch", "rank", "device"])
def test_the_wrapper_refuses_what_k8_does_not_take(case):
    out, tgt = _maps(2, 4, 5)
    args, match = {
        "channels": ((out.expand(2, 4, 5, 3), tgt.expand(2, 4, 5, 3)), r"\(N, H, W, 1\)"),
        "mismatch": ((out, tgt[:, :3]), "target must be"),
        "rank": ((out[..., 0], tgt[..., 0]), r"\(N, H, W, 1\)"),
        "device": ((out, tgt.to("meta")), "one device"),
    }[case]
    before = kernel.COUNTER["K8"]
    with pytest.raises(ValueError, match=match):
        M.metric_sums(*args)
    assert kernel.COUNTER["K8"] == before


# -- on the card ----------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest --noconftest "
                    "tests/test_torch_metric_sums.py -m cuda)")


# (images, H = W) of the metric sums in the benchmark's cells: the
# flagship's and UpProj's b128 at 224^2, DA-V2's b64 at 518^2, and
# metrics.evaluate's one 224^2 pair (deploy's check)
CELL_SHAPES = [(128, 224), (64, 518), (1, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("images,hw", CELL_SHAPES)
def test_the_grid_fills_every_sm_at_least_twice_at_the_cells_shapes(images, hw):
    """The chunks an image the kernel picks (``fd_metric_sums_chunks``):
    every SM takes two blocks or more, the grid fits the workspace, and
    no chunk is under 128 pixels."""
    _need_cuda()
    out, tgt = (torch.zeros((images, hw, hw, 1), device="cuda") for _ in range(2))
    chunks = K8.chunks(out, tgt)
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    assert images * chunks >= 2 * sms
    assert images * chunks <= max(images, K8.WAVE_ROWS)
    assert chunks * 128 <= max(hw * hw, 128)


def _f64_sums(output, target):
    """The plain version's per-pixel terms (f32, rounded as it rounds
    them), each image's masked sums taken in float64: (10, N)."""
    output, target = output.float(), target.float()
    mask = (target > 0) | (output > 0)
    out_mm, tgt_mm = 1e3 * output, 1e3 * target
    abs_diff = (out_mm - tgt_mm).abs()
    safe_out, safe_tgt = torch.where(mask, out_mm, 1.0), torch.where(mask, tgt_mm, 1.0)
    max_ratio = torch.maximum(safe_out / safe_tgt, safe_tgt / safe_out)
    inv_diff = (1.0 / safe_out - 1.0 / safe_tgt).abs()
    terms = [abs_diff * abs_diff, abs_diff,
             (torch.log10(safe_out) - torch.log10(safe_tgt)).abs(), abs_diff / safe_tgt,
             *((max_ratio < 1.25 ** k).float() for k in (1, 2, 3)),
             inv_diff * inv_diff, inv_diff, torch.ones_like(output)]
    return torch.stack([torch.where(mask, x, 0.0).double().sum(dim=(1, 2, 3)) for x in terms])


def _sliced(n, h, w, rows):
    """A ``space`` rank's rows ``rows`` of every image: a non-contiguous
    (n, rows, w, 1) slice."""
    out, tgt = _maps(n, h, w, seed=5, device="cuda")
    return out[:, rows], tgt[:, rows]


def _misaligned(n, h, w):
    """Maps whose data starts 4 bytes past a 16-byte boundary."""
    out, tgt = _maps(n, h, w, seed=6)
    return tuple(torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape).copy_(x)
                 for x in (out, tgt))


CARD_CASES = {
    "b128_224": lambda: _maps(128, 224, 224, seed=7, device="cuda"),
    "b64_518": lambda: _maps(64, 518, 518, seed=8, device="cuda"),
    "b1_224": lambda: _maps(1, 224, 224, seed=9, device="cuda"),
    "b3_17x23": lambda: _maps(3, 17, 23, seed=10, device="cuda"),
    "space_rows": lambda: _sliced(4, 29, 31, slice(11, 22)),
    "misaligned": lambda: _misaligned(3, 8, 12),
    "bf16_prediction": lambda: tuple(x.to(dt) for x, dt in zip(
        _maps(5, 40, 36, seed=11, device="cuda"), (torch.bfloat16, torch.float32))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_k8_is_its_plain_version_on_the_card(case):
    _need_cuda()
    out, tgt = CARD_CASES[case]()
    before = kernel.COUNTER["K8"]
    got = M.metric_sums(out, tgt)
    again = M.metric_sums(out, tgt)
    torch.cuda.synchronize()
    assert kernel.COUNTER["K8"] == before + 2
    assert _same(got, again)  # the same bits from launch to launch
    plain = M.metric_sums_reference(out, tgt)
    assert got.dtype == torch.float32 and got.shape == plain.shape
    assert torch.equal(got[EXACT], plain[EXACT])
    want = _f64_sums(out, tgt)
    torch.testing.assert_close(got[FLOAT].double(), want[FLOAT], rtol=1e-5, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(plain[FLOAT].double(), want[FLOAT], rtol=1e-5, atol=0,
                               equal_nan=True)
    finished, plain_finished = M.finish(got), M.finish(plain)
    if out.shape[0] >= 3:  # no valid pixel: NaN, as the plain version gives
        assert all(torch.isnan(finished[f][2]) for f in M.METRIC_FIELDS)
        assert all(torch.isnan(plain_finished[f][2]) for f in M.METRIC_FIELDS)


@pytest.mark.cuda
def test_an_evaluator_step_on_the_card_launches_k8_once():
    _need_cuda()
    model = build(TINY)
    ev = Evaluator(model, model.init(torch.Generator().manual_seed(0)), batch_size=2,
                   device="cuda")
    g = torch.Generator().manual_seed(3)
    rgb = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8).cuda()
    depth = (torch.rand((2, 64, 64, 1), generator=g) * 9.5 + 0.5).cuda()
    ev(rgb, depth)
    before = kernel.COUNTER["K8"]
    pred, rows = ev(rgb, depth)
    torch.cuda.synchronize()
    assert kernel.COUNTER["K8"] == before + 1
    want = M.finish(M.metric_sums_reference(pred, depth))
    torch.testing.assert_close(rows, torch.stack([want[f] for f in M.METRIC_FIELDS]),
                               rtol=1e-5, atol=0)
