"""K1, the port's fused decoder stage, against the JAX package's Pallas
kernel (interpret mode on the CPU), and the CPU-side logic around it:
dispatch, operand checks, launch counting and the nvcc build.

JAX is imported inside the one test that needs it, so that on a GPU host
without JAX the card's tests run alone:
    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import _build
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K


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
    before = K.LAUNCHES
    got = K.fused_decoder_stage(*ops)
    assert K.LAUNCHES == before
    assert got.dtype == dtype and tuple(got.shape) == (2, 6, 14, 14)
    assert torch.equal(got, K.fused_decoder_stage_reference(*ops))


def test_wrapper_on_a_cuda_tensor_without_a_card_raises(rng, monkeypatch):
    """A CUDA tensor launches K1 or raises: with no card (and no nvcc)
    the wrapper must raise, never fall back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(K, "fused_decoder_stage_reference", no_fallback)
    before = K.LAUNCHES
    with FakeTensorMode():
        x = torch.empty(2, 12, 7, 7, device="cuda", memory_format=torch.channels_last)
        w = [torch.empty(s, device="cuda") for s in ((25, 12), (12,), (12, 6), (6,))]
        with pytest.raises(RuntimeError):
            K.fused_decoder_stage(x, *w)
    assert K.LAUNCHES == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_matches_plain_version_on_the_card(shape, dtype, monkeypatch):
    """On a CUDA device: K1 against its plain version (f32 bound 1e-4
    relative; bf16 one output rounding, 2^-7 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # true f32 convs
    rng = np.random.RandomState(0)
    ops = [t.to("cuda", dtype) if t is not None else None
           for t in _port_operands(*_jax_operands(rng, *shape, True))]
    ops[0] = ops[0].contiguous(memory_format=torch.channels_last)
    ops[5] = ops[5].contiguous(memory_format=torch.channels_last)
    before = K.LAUNCHES
    got = K.fused_decoder_stage(*ops)
    assert K.LAUNCHES == before + 1
    want = K.fused_decoder_stage_reference(*ops).float()
    scale = float(want.abs().max())
    bound = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0 ** -7 * scale
    assert float((got.float() - want).abs().max()) <= bound
