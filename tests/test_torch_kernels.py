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
    before = K.LAUNCHES
    got = K.fused_decoder_stage(*ops)
    assert K.LAUNCHES == before + 1
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
