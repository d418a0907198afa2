"""K2 (image-group stage), K3 (persistent double-buffered stage) and K4
(the 1x1 head): their plain versions against the JAX package's Pallas
kernels in interpret mode on the CPU, the wrappers' dispatch and checks,
and, on a card, each kernel against its plain version.

JAX is imported inside the tests that need it, so that on a GPU host
without JAX the card's tests run alone:
    python -m pytest --noconftest tests/test_torch_kernel_family.py -m cuda
"""

import numpy as np
import pytest
import torch

from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3
from fastdepth_tpu_torch.ops.cuda import head as K4
from fastdepth_tpu_torch.ops.cuda.fused_decoder import kernel_weights

STAGES = {"K2": (K2, K2.fused_decoder_stage_hwbc), "K3": (K3, K3.fused_decoder_stage_v3)}


def _jax_operands(rng, N, H, W, C, Cout, has_skip):
    """Seeded stage operands in the JAX layout (NHWC, HWIO), as
    tests/test_pallas.py makes them."""
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
    t = torch.from_numpy
    k_dw, k_pw = kernel_weights(t(dw_w.transpose(3, 2, 0, 1)), t(pw_w.transpose(3, 2, 0, 1)))
    return (TB.from_nhwc(t(x)), k_dw, t(dw_b), k_pw, t(pw_b),
            TB.from_nhwc(t(skip)) if skip is not None else None)


def _jax(ops):
    import jax.numpy as jnp

    return [jnp.asarray(a) if a is not None else None for a in ops]


# --- plain versions against the Pallas kernels (interpret mode) ----------

@pytest.mark.parametrize("has_skip", [False, True])
def test_k2_matches_jax_hwbc_kernel(rng, has_skip):
    from fastdepth_tpu.ops.pallas.fused_decoder import fused_decoder_stage_hwbc

    ops = _jax_operands(rng, 4, 7, 7, 12, 6, has_skip)
    want = fused_decoder_stage_hwbc(*_jax(ops), block_batch=2, interpret=True)
    got = K2.fused_decoder_stage_hwbc(*_port_operands(*ops), block_batch=2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(TB.to_nhwc(got).numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("has_skip", [False, True])
@pytest.mark.parametrize("block_batch", [1, 2])
def test_k3_matches_jax_v3_kernel(rng, has_skip, block_batch):
    from fastdepth_tpu.ops.pallas.fused_decoder import fused_decoder_stage_v3

    ops = _jax_operands(rng, 4, 7, 7, 12, 6, has_skip)
    want = fused_decoder_stage_v3(*_jax(ops), block_batch=block_batch, interpret=True)
    got = K3.fused_decoder_stage_v3(*_port_operands(*ops), block_batch=block_batch)
    np.testing.assert_allclose(TB.to_nhwc(got).numpy(), np.asarray(want), atol=1e-4)


def test_k4_matches_jax_head_kernel(rng):
    from fastdepth_tpu.ops.pallas.fused_decoder import fused_pointwise_head

    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    w = rng.randn(1, 1, 8, 1).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    want = fused_pointwise_head(*_jax((x, w, b)), interpret=True)
    got = K4.pointwise_head(TB.from_nhwc(torch.from_numpy(x)), torch.from_numpy(w.reshape(8)),
                            torch.from_numpy(b))
    assert tuple(got.shape) == (2, 1, 6, 6)
    np.testing.assert_allclose(TB.to_nhwc(got).numpy(), np.asarray(want), atol=1e-5)


# --- dispatch and checks on the CPU --------------------------------------

@pytest.mark.parametrize("name", list(STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_wrappers_on_cpu_take_the_plain_version(rng, name, dtype):
    mod, stage = STAGES[name]
    ops = [t.to(dtype) if t is not None else None
           for t in _port_operands(*_jax_operands(rng, 3, 7, 7, 12, 6, True))]
    ops[0] = ops[0].contiguous(memory_format=torch.channels_last)
    ops[5] = ops[5].contiguous(memory_format=torch.channels_last)
    before = mod.LAUNCHES
    got = stage(*ops, block_batch=2)
    assert mod.LAUNCHES == before
    assert got.dtype == dtype and tuple(got.shape) == (3, 6, 14, 14)
    assert torch.equal(got, mod.fused_decoder_stage_reference(*ops))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_wrapper_on_cpu_takes_the_plain_version(rng, dtype):
    x = TB.from_nhwc(torch.from_numpy(rng.randn(2, 5, 5, 16).astype(np.float32))).to(dtype)
    w, b = torch.randn(16, dtype=dtype), torch.randn(1, dtype=dtype)
    before = K4.LAUNCHES
    got = K4.pointwise_head(x, w, b)
    assert K4.LAUNCHES == before
    assert got.dtype == dtype and tuple(got.shape) == (2, 1, 5, 5)
    assert torch.equal(got, K4.pointwise_head_reference(x, w, b))


def test_block_batch_rounding():
    kbb = K2.kernel_block_batch
    assert [kbb(b, 8) for b in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert kbb(8, 2) == 2 and kbb(8, 3) == 4 and kbb(4, 1) == 1
    for bad in (0, 9):
        with pytest.raises(ValueError, match="block_batch"):
            kbb(bad, 8)


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_wrappers_reject_what_the_kernels_do_not_take(rng, name):
    _, stage = STAGES[name]
    x, dw_w, dw_b, pw_w, pw_b, skip = _port_operands(*_jax_operands(rng, 2, 7, 7, 12, 6, True))
    bad = [
        ((x.contiguous(), dw_w, dw_b, pw_w, pw_b, skip), {}, "channels_last"),
        ((x.double(), dw_w, dw_b, pw_w, pw_b, skip), {}, "float32 or bfloat16"),
        ((x, dw_w, dw_b, pw_w[:11], pw_b, skip), {}, "pw_w"),
        ((x, dw_w, dw_b, pw_w, pw_b, skip[:, :, :13]), {}, "skip"),
        ((x, dw_w, dw_b, pw_w.clone().requires_grad_(), pw_b, skip), {}, "inference-only"),
        ((x, dw_w, dw_b, pw_w, pw_b, skip), {"block_batch": 16}, "block_batch"),
        ((x.to("meta"), *(t.to("meta") for t in (dw_w, dw_b, pw_w, pw_b, skip))), {},
         "CUDA devices"),
    ]
    if name == "K3":
        bad.append(((x, dw_w, dw_b, pw_w, pw_b, skip), {"blocks": 0}, "blocks"))
    for args, kwargs, match in bad:
        with pytest.raises(ValueError, match=match):
            stage(*args, **kwargs)


def test_head_wrapper_rejects_what_k4_does_not_take():
    x = torch.zeros(2, 16, 5, 5).contiguous(memory_format=torch.channels_last)
    w, b = torch.zeros(16), torch.zeros(1)
    for args, match in [
        ((x.contiguous(), w, b), "channels_last"),
        ((x, w[:15], b), "w must be"),
        ((x, w, torch.zeros(2)), "b must be"),
        ((x, w.bfloat16(), b), "one dtype"),
        ((x[0], w, b), r"\(N, C, H, W\)"),
        ((x, w.clone().requires_grad_(), b), "inference-only"),
        ((x.to("meta"), w.to("meta"), b.to("meta")), "CUDA devices"),
    ]:
        with pytest.raises(ValueError, match=match):
            K4.pointwise_head(*args)


def test_wrappers_on_a_cuda_tensor_without_a_card_raise(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no card (and no
    nvcc) every wrapper raises, never falls back to its plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    for mod in (K2, K3):
        monkeypatch.setattr(mod, "fused_decoder_stage_reference", no_fallback)
    monkeypatch.setattr(K4, "pointwise_head_reference", no_fallback)
    counts = [m.LAUNCHES for m in (K2, K3, K4)]
    with FakeTensorMode():
        x = torch.empty(2, 12, 7, 7, device="cuda", memory_format=torch.channels_last)
        w = [torch.empty(s, device="cuda") for s in ((25, 12), (12,), (12, 6), (6,))]
        for _, stage in STAGES.values():
            with pytest.raises(RuntimeError):
                stage(x, *w)
        with pytest.raises(RuntimeError):
            K4.pointwise_head(x, torch.empty(12, device="cuda"), torch.empty(1, device="cuda"))
    assert [m.LAUNCHES for m in (K2, K3, K4)] == counts


# --- on the card ---------------------------------------------------------

def _on_card(dtype, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernel_family.py -m cuda)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # true f32 convs


def _bound(want, dtype):
    """f32: summation order only, 1e-4 relative; bf16: one rounding of the
    output, 2^-7 relative."""
    scale = float(want.abs().max())
    return 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale


# (N, H, W, C, Cout): the test widths (C=12 and Cout=6 take K3's element
# loads), a ragged group (N=3), and a flagship-like aligned shape
CARD_SHAPES = [(2, 7, 7, 12, 6), (3, 6, 9, 40, 70), (4, 14, 14, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("name", list(STAGES))
@pytest.mark.parametrize("block_batch", [1, 2, 8])
def test_stage_kernels_match_plain_version_on_the_card(name, shape, dtype, block_batch,
                                                       monkeypatch):
    _on_card(dtype, monkeypatch)
    mod, stage = STAGES[name]
    rng = np.random.RandomState(0)
    ops = [t.to("cuda", dtype) if t is not None else None
           for t in _port_operands(*_jax_operands(rng, *shape, True))]
    ops[0] = ops[0].contiguous(memory_format=torch.channels_last)
    ops[5] = ops[5].contiguous(memory_format=torch.channels_last)
    want = mod.fused_decoder_stage_reference(*ops).float()
    before = mod.LAUNCHES
    got = stage(*ops, block_batch=block_batch)
    assert mod.LAUNCHES == before + 1
    assert float((got.float() - want).abs().max()) <= _bound(want, dtype)
    if name == "K3":  # a grid of 1 and 3 blocks: each block walks many items
        for blocks in (1, 3):
            got = stage(*ops, block_batch=block_batch, blocks=blocks)
            assert float((got.float() - want).abs().max()) <= _bound(want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 12, 5])
def test_head_kernel_matches_plain_version_on_the_card(C, dtype, monkeypatch):
    _on_card(dtype, monkeypatch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, C, 17, 19, generator=g).to("cuda", dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w, b = torch.randn(C, generator=g).to("cuda", dtype), torch.randn(1, generator=g).to("cuda", dtype)
    want = K4.pointwise_head_reference(x, w, b).float()
    before = K4.LAUNCHES
    got = K4.pointwise_head(x, w, b)
    assert K4.LAUNCHES == before + 1 and tuple(got.shape) == (3, 1, 17, 19)
    assert float((got.float() - want).abs().max()) <= _bound(want, dtype)
