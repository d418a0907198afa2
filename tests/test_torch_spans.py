"""The program's profiler spans (``engine/profiler``): free with no
profiler running, and under one the seven names, nested as the layers
are, around the forwards ``engine/aot._pick_apply`` picks for FastDepth
and ResNet-UpProj and around an ``Evaluator`` step, with the outputs
bit for bit those of an unprofiled run.  On the CPU: the kernels' plain
versions run under the same spans."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.engine import profiler as P
from fastdepth_tpu_torch.engine.aot import compile_forward
from fastdepth_tpu_torch.engine.evaluator import Evaluator
from fastdepth_tpu_torch.models import build
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
FLAGSHIP = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC,
                       output_size=(64, 64))
UPPROJ = ModelConfig(encoder="resnet18", decoder="upproj", skip=None,
                     decoder_channels=(64, 32, 16, 8, 4), output_size=(64, 64))
SPANS = (P.STEP, P.ENCODER, P.DECODER, P.METRICS, P.K1, P.K4, P.GRAPH)
# span -> the span it nests in
PARENT = {P.ENCODER: P.STEP, P.DECODER: P.STEP, P.METRICS: P.STEP, P.K1: P.DECODER,
          P.K4: P.DECODER, P.GRAPH: P.STEP}
# (config, impl, tuning) of every forward _pick_apply returns for the two families
FORWARDS = {
    "flagship-auto": (FLAGSHIP, "auto", None),
    "flagship-opt": (FLAGSHIP, "opt", None),
    "flagship-xla": (FLAGSHIP, "xla", None),
    "flagship-mixed": (FLAGSHIP, "mixed", {1: "pallas", 2: "xla", 3: "pallas"}),
    "upproj-auto": (UPPROJ, "auto", None),
}
K1_LEVELS = {"flagship-auto": 5, "flagship-mixed": 2}
K4_HEADS = {"flagship-auto": 1, "flagship-mixed": 1}


def model_and_params(cfg, seed=0):
    model = build(cfg)
    return model, model.init(torch.Generator().manual_seed(seed))


def spans_of(prof):
    """[(name, parent name or None)] of the seven spans the profile
    recorded, in start order: a span's parent is the innermost of them
    open around it on its thread."""
    events = sorted((e for e in prof.events() if e.name in SPANS),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    out = []
    for i, e in enumerate(events):
        around = [o for o in events[:i] if o.thread == e.thread
                  and o.time_range.start <= e.time_range.start
                  and e.time_range.end <= o.time_range.end]
        out.append((e.name, around[-1].name if around else None))
    return out


class _Flag:
    """A stand-in for ``torch.autograd.profiler`` that counts the reads
    of its profiler flag."""

    def __init__(self, value):
        self.value, self.reads = value, 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return self.value


def test_annotate_is_one_flag_read_and_no_profiler_op_when_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler op was called with no profiler running")

    for op in ("_record_function_enter_new", "_record_function_enter",
               "_record_function_exit"):
        monkeypatch.setattr(torch.ops.profiler, op, refuse, raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    flag = _Flag(False)
    monkeypatch.setattr(P, "_autograd_profiler", flag)
    for name in SPANS:
        with P.annotate(name):
            pass
    assert flag.reads == len(SPANS)
    assert P.annotate(P.STEP) is P.annotate(P.K1)  # one shared no-op


def test_annotate_opens_a_record_function_span_when_on(monkeypatch):
    opened = []
    monkeypatch.setattr(P, "_autograd_profiler", _Flag(True))
    monkeypatch.setattr(torch.profiler, "record_function", opened.append)
    P.annotate(P.DECODER)
    assert opened == [P.DECODER]


def test_the_flag_follows_the_profiler():
    from torch.autograd import profiler as autograd_profiler

    assert not autograd_profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled
        with P.annotate(P.STEP):
            torch.ones(3).sum()
    assert not autograd_profiler._is_profiler_enabled
    assert [e.name for e in prof.events() if e.name == P.STEP] == [P.STEP]


@pytest.mark.parametrize("name", list(FORWARDS))
def test_a_forward_records_its_spans_and_the_same_output(name):
    cfg, impl, tuning = FORWARDS[name]
    model, params = model_and_params(cfg)
    fn, prepared = compile_forward(model, params, batch_size=2, image_size=(64, 64),
                                   impl=impl, tuning=tuning, device="cpu")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    off = fn(prepared, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = fn(prepared, x)
    assert torch.equal(off, on)
    assert torch.equal(off, fn(prepared, x))
    k1, k4 = K1_LEVELS.get(name, 0), K4_HEADS.get(name, 0)
    assert spans_of(prof) == ([(P.STEP, None), (P.ENCODER, P.STEP), (P.DECODER, P.STEP)]
                              + [(P.K1, P.DECODER)] * k1 + [(P.K4, P.DECODER)] * k4)


@pytest.mark.parametrize("cfg", [FLAGSHIP, UPPROJ], ids=["flagship", "upproj"])
def test_an_evaluator_step_records_its_spans_and_the_same_outputs(cfg):
    model, params = model_and_params(cfg)
    ev = Evaluator(model, params, batch_size=2, device="cpu")
    g = torch.Generator().manual_seed(2)
    rgb = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8)
    depth = torch.rand((2, 64, 64, 1), generator=g) * 9.5 + 0.5
    off = ev(rgb, depth)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = ev(rgb, depth)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    found = spans_of(prof)
    assert found == ([(P.STEP, None), (P.ENCODER, P.STEP), (P.DECODER, P.STEP)]
                     + [(P.K1, P.DECODER)] * (5 if cfg is FLAGSHIP else 0)
                     + [(P.K4, P.DECODER)] * (1 if cfg is FLAGSHIP else 0)
                     + [(P.METRICS, P.STEP)])
    assert all(PARENT.get(n) == p for n, p in found)


def test_a_training_forward_records_the_model_spans_and_no_step():
    """The model's spans come with the forward wherever it runs: a
    train-mode forward records the encoder and the decoder, and no step."""
    model, params = model_and_params(FLAGSHIP)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = model.apply(params, x, train=True, stats={})
    assert np.isfinite(y.detach().numpy()).all()
    assert spans_of(prof) == [(P.ENCODER, None), (P.DECODER, None)]
