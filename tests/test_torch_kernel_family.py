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

from fastdepth_tpu_torch.models import fused as F
from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
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


# (level, H=W, C, Cout): the pruned flagship's five levels
PRUNED_LEVELS = [(1, 7, 512, 200), (2, 14, 200, 256), (3, 28, 256, 120), (4, 56, 120, 56),
                 (5, 112, 56, 16)]
BLOCK_BATCHES = {"K2": F.V2_BLOCK_BATCHES, "K3": F.V3_BLOCK_BATCHES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 128])
@pytest.mark.parametrize("level", PRUNED_LEVELS)
@pytest.mark.parametrize("name", list(STAGES))
def test_launch_geometry_of_k2_and_k3(name, level, n, dtype):
    """The launch K2 / K3 get at their forwards' images per block: a block
    shape the kernels take (fd_fused_decoder_stage_hwbc / _v3's check),
    all of Cout <= 256 in one tile wherever a grid with it could still
    cover the 132 SMs, shared memory within a block's 227 KB and the
    blocks an SM holds within its 228 KB (and its registers), and every
    (image, pixel, output channel) in exactly one work item."""
    index, H, C, Cout = level
    mod = STAGES[name][0]
    g = mod.launch_geometry(n, H, H, C, Cout, dtype, BLOCK_BATCHES[name][index])
    bf16 = dtype == torch.bfloat16
    B = K2.kernel_block_batch(BLOCK_BATCHES[name][index], n)
    p = g.tile_h * g.tile_w
    assert g.images == B
    # the kernels' block shapes
    assert g.threads in (32, 64, 128, 256) and g.tile_w in (4, 8, 16, 32)
    assert g.tile_h & (g.tile_h - 1) == 0 and p >= 4
    assert g.groups in (1, 2, 4, 8) and g.groups * g.threads <= 256
    assert g.groups <= -(-C // g.chunk)  # every group has a chunk of C
    assert B * p * g.cout_tile == 32 * g.threads  # the register tiles cover the GEMM
    assert B * p >= (32 if bf16 else 8) and g.cout_tile >= (32 if bf16 else 8)
    assert g.cout_tile <= 256 and g.cout_tile & (g.cout_tile - 1) == 0
    assert g.chunk in ((16, 32) if bf16 else (8, 16, 32))
    # Cout splits only where no grid with all of it covers the SMs: with
    # the least rows a block (32 threads, or the dtype's floor) and the
    # least per-image tile
    nc_all = min(256, max(32 if bf16 else 8, 1 << (Cout - 1).bit_length()))
    if g.cout_tile < nc_all:
        rows = max(32 * 32 // nc_all, 32 if bf16 else 8, 4 * B)
        th, tw = K1.TILES[rows // B]
        assert -(-n // B) * -(-H // th) * -(-H // tw) < K1.SMS
    # shared memory and residency
    assert g.smem == K1.smem_bytes(g.tile_h, g.tile_w, g.cout_tile, g.chunk, bf16, g.groups,
                                   B, persistent=name == "K3")
    assert g.smem <= K1.MAX_SMEM
    assert g.per_sm >= 1 and g.per_sm * (g.smem + 1024) <= K1.SMEM_PER_SM
    assert g.per_sm * g.threads * g.groups <= K1.REG_THREADS_PER_SM
    if name == "K3":
        assert K3.resident_blocks(g) == K1.SMS * g.per_sm
    # the work items: (image group, tile) x Cout tiles, each output once
    tiles_w, tiles = -(-H // g.tile_w), -(-H // g.tile_h) * -(-H // g.tile_w)
    assert g.grid == (-(-n // B) * tiles, -(-Cout // g.cout_tile))
    if n <= 8:
        hits = np.zeros((n, H, H, Cout), np.int32)
        for bx in range(g.grid[0]):
            grp, tile = divmod(bx, tiles)
            h0, w0 = (tile // tiles_w) * g.tile_h, (tile % tiles_w) * g.tile_w
            for by in range(g.grid[1]):
                c0 = by * g.cout_tile
                hits[grp * B:(grp + 1) * B, h0:h0 + g.tile_h, w0:w0 + g.tile_w,
                     c0:c0 + g.cout_tile] += 1
        assert (hits == 1).all()


def test_k2_and_k3_geometry_is_k1s_for_one_image():
    """One image a block is K1's launch: K2's exactly, K3's with the same
    blocks, tiles and work items (its groups and chunk may differ: its
    epilogue stages beside the ring)."""
    for n, H, C, Cout in ((8, 28, 256, 120), (1, 7, 512, 200), (128, 112, 56, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            g1 = K1.launch_geometry(n, H, H, C, Cout, dtype)
            assert K2.launch_geometry(n, H, H, C, Cout, dtype, 1) == g1
            g3 = K3.launch_geometry(n, H, H, C, Cout, dtype, 1)
            assert (g3.threads, g3.tile_h, g3.tile_w, g3.cout_tile, g3.grid) == (
                g1.threads, g1.tile_h, g1.tile_w, g1.cout_tile, g1.grid)


def test_image_groups_split_cout_only_as_far_as_it_pays():
    """K1's rule (the largest block whose grid covers the SMs) is the
    least block an image group takes; a larger one wins where its
    estimated serial work is less: at 14^2 with 8 images a block, K1's
    rule covers the SMs with 64-thread groups but in two waves of one
    block an SM, and 128 threads (Cout in two tiles) do it in one."""
    f32 = torch.float32
    g = K2.launch_geometry(8, 14, 14, 200, 256, f32, 8)
    assert g.threads == 128 and g.cout_tile == 128 and g.blocks < K1.SMS * g.per_sm
    # at batch 128 every rule takes all of Cout
    for H, C, Cout in ((7, 512, 200), (14, 200, 256), (28, 256, 120)):
        for name in STAGES:
            g = STAGES[name][0].launch_geometry(128, H, H, C, Cout, f32, 8)
            assert g.cout_tile >= Cout and g.threads == 256


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


# (N, H, W, C, Cout): the test widths (C=12 and Cout=6 take the element
# loads), a ragged group (N=3), a flagship-like aligned shape, an aligned
# ragged group with partial tiles (N=5), and the flagship's levels at
# batch 8 (the pruned five and the unpruned first)
CARD_SHAPES = [(2, 7, 7, 12, 6), (3, 6, 9, 40, 70), (4, 14, 14, 64, 32), (5, 10, 12, 48, 24),
               *[(8, h, h, c, cout) for _, h, c, cout in PRUNED_LEVELS], (8, 7, 7, 1024, 512)]


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
