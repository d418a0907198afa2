"""K5 (staged copy) and K6 (staged compute), the probe catalogue and the
probe CLI: each probe's plain version against the JAX package's probe
kernel itself, in TPU interpret mode on the CPU; the wrappers' dispatch
and checks; and, on a card, each kernel against its plain version.

The scripts run everything at import, so only their kernel definitions
are loaded: :func:`_load_script` keeps a script's imports, constant
assignments and the named ``def``s and executes them.  Where the script
called ``pl.pallas_call`` in a helper that returned nothing (``run``,
``run_e``), the test makes the same call with the same specs.  JAX is
imported inside the tests that need it, so that on a GPU host without
JAX the card's tests run alone:
    python -m pytest --noconftest tests/test_torch_probes.py -m cuda
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from fastdepth_tpu_torch.cli import probe as probe_cli
from fastdepth_tpu_torch.engine import benchmark as BM
from fastdepth_tpu_torch.engine import probes as P
from fastdepth_tpu_torch.ops import blocks as TB
from fastdepth_tpu_torch.ops.cuda import kernel
from fastdepth_tpu_torch.ops.cuda import probes as KP
from fastdepth_tpu_torch.ops.cuda.fused_decoder_v3 import fused_decoder_stage_v3
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the JAX probes, loaded from the scripts --------------------------------

def _load_script(script, names):
    """Execute a script's imports, constant assignments and the named
    ``def``s only (the scripts compile and run probes at import)."""
    path = os.path.join(REPO, script)
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.Assign):
            try:
                ast.literal_eval(node.value)
            except ValueError:
                continue
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in names:
            keep.append(node)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


class _Feed:
    """Stands in for a script's global ``rng``: ``rand`` hands out the
    given draws in order."""

    def __init__(self, *arrays):
        self.arrays = list(arrays)

    def rand(self, *shape):
        a = self.arrays.pop(0)
        assert a.shape == shape, (a.shape, shape)
        return a


def _interpret(fn):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


def _call(kernel, args, in_spaces, out_shape, scratch):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    return pl.pallas_call(
        kernel, grid=(),
        in_specs=[pl.BlockSpec(memory_space=s) for s in in_spaces],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        scratch_shapes=scratch,
    )(*[jnp.asarray(a) for a in args])


def _jax_bisect_v3(tag, a):
    """bisect_v3.py's k_a..k_e with ``run``'s / ``run_e``'s specs."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    ns = _load_script("scripts/bisect_v3.py", {"k_a", "k_b", "k_c", "k_d", "k_e"})
    N, H, W, C = ns["N"], ns["H"], ns["W"], ns["C"]
    f32, dma, vmem = jnp.float32, pltpu.SemaphoreType.DMA, pltpu.VMEM
    specs = {
        "A_static_dma": ("k_a", [vmem((N, H, W, C), f32)] * 2 + [dma(())] * 2),
        "B_loop_static_slot": ("k_b", [vmem((1, H, W, C), f32)] * 2 + [dma(())] * 2),
        "C_dynamic_slot": ("k_c", [vmem((2, 1, H, W, C), f32)] * 2 + [dma((2,))] * 2),
        "D_double_buffer": ("k_d", [vmem((2, 1, H, W, C), f32)] * 2 + [dma((2,))] * 2),
        "E_full_compute": ("k_e", [vmem((2, 1, H, W, C), f32), vmem((2, 1, 2 * H, 2 * W, C), f32),
                                   vmem((1, H + 4, W + 4, C), f32)] + [dma((2,))] * 2),
    }
    name, scratch = specs[tag]
    out = (N, 2 * H, 2 * W, C) if tag == "E_full_compute" else (N, H, W, C)
    return _interpret(lambda: _call(ns[name], [a["x"]], [pl.ANY], out, scratch))


def _jax_bisect_v3c(tag, a):
    """bisect_v3c.py's make_kernel with ``run``'s specs."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    ns = _load_script("scripts/bisect_v3c.py", {"make_kernel"})
    N, H, W = ns["N"], ns["H"], ns["W"]
    mode = tag.rsplit("_", 1)[0]
    C, Cout = a["w"].shape
    hw = 2 * H if mode in ("matmul_up", "up_only") else H
    f32, vmem = jnp.float32, pltpu.VMEM
    scratch = [vmem((1, H, W, C), f32), vmem((1, hw, hw, Cout), f32),
               vmem((1, H + 4, W + 4, C), f32), pltpu.SemaphoreType.DMA(()),
               pltpu.SemaphoreType.DMA(())]
    return _interpret(lambda: _call(ns["make_kernel"](C, Cout, mode), [a["x"], a["w"]],
                                    [pl.ANY, vmem], (N, hw, hw, Cout), scratch))


def _raw_draws(tag):
    """The probe's draws of the script's stream, unscaled float64, as the
    script's own ``rng.rand`` calls return them."""
    probe = P.PROBES[tag]
    rng = np.random.RandomState(0)
    rng.set_state(P._states(probe.script)[probe.group])
    return [rng.rand(*shape) for g, _, shape, _ in P.STREAMS[probe.script] if g == probe.group]


def _jax_fed(tag, fn_name, *fn_args):
    """A script function that draws its own inputs from its global rng:
    feed it the probe's draws, so it scales and casts them itself."""
    ns = _load_script(P.PROBES[tag].script, {fn_name})
    ns["rng"] = _Feed(*_raw_draws(tag))
    return _interpret(lambda: ns[fn_name](*fn_args))


def _jax_s4like(a, skip):
    """bisect_v3e.py's XLA stage at the s4-like shape (``fn_x``, the plain
    side the script timed v3 against), in f32 on the bf16-rounded inputs."""
    import jax.numpy as jnp

    from fastdepth_tpu.ops import blocks as B

    r = {k: jnp.asarray(torch.from_numpy(v).bfloat16().float().numpy()) for k, v in a.items()}
    y = B.relu(B.conv2d(B.relu(B.depthwise_conv2d(r["x"], r["dw_w"], bias=r["dw_b"])),
                        r["pw_w"], bias=r["pw_b"]))
    y = B.upsample_nearest2x(y)
    return np.asarray(y + r["skip"] if skip else y)


def _jax_reference(tag, a):
    """The JAX probe's output on the catalogue's arrays ``a``."""
    script = P.PROBES[tag].script
    if script == "scripts/bisect_v3.py":
        return _jax_bisect_v3(tag, a)
    if script == "scripts/bisect_v3c.py":
        return _jax_bisect_v3c(tag, a)
    if script == "scripts/bisect_v3d.py":
        if tag.startswith("matmul"):
            return _jax_fed(tag, "dma_matmul", *a["w"].shape)
        if tag.startswith("flat_dma"):
            n, h, w, c = a["x"].shape
            return _jax_fed(tag, "flat_dma", c, h, w).reshape(n, h, w, c)
        if tag.startswith("vmem_autocopy"):
            return _jax_fed(tag, "vmem_autocopy_small_lane")
        return _jax_fed(tag, "dma_2d_small_lane")
    if script == "scripts/bisect_v3e.py":
        if tag.startswith("v3_s4like"):
            return _jax_s4like(a, skip=tag.endswith("_skip"))
        if tag == "onchip_parity":
            import jax.numpy as jnp

            from fastdepth_tpu.ops.pallas.fused_decoder import fused_decoder_stage_v3

            ops = [jnp.asarray(a[k]) for k in ("x", "dw_w", "dw_b", "pw_w", "pw_b", "skip")]
            return _interpret(lambda: fused_decoder_stage_v3(*ops))
        return _jax_fed(tag, tag.rsplit("_7168", 1)[0])
    # probe_xla_opts.py dma_copy only timed its copy: the reference is the input
    return a["x"]


@pytest.mark.parametrize("tag", list(P.PROBES))
def test_plain_version_matches_the_jax_probe(tag):
    probe = P.PROBES[tag]
    a = P.script_arrays(probe.script, probe.group)
    got = P.run_plain(tag, "cpu").float().numpy()
    want = _jax_reference(tag, a)
    assert got.shape == want.shape
    if probe.exact and probe.mode != "taps":  # copies, x2 and nearest x2
        np.testing.assert_array_equal(got, want)
    elif probe.dtype == torch.bfloat16:  # one bf16 rounding of the output
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 * np.abs(want).max())
    else:  # f32 matmul, taps (XLA rounds its tap sum 1 ulp apart) and stages
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # on the CPU the kernel call is the plain version
    assert torch.equal(P.run(tag, "cpu"), P.run_plain(tag, "cpu"))


@pytest.mark.parametrize("tag", [t for t, p in P.PROBES.items() if p.library is not None])
def test_library_call_computes_the_probes_function(tag):
    """The one-call yardstick (K5: torch.mul / torch.add; K6: torch.matmul,
    the depthwise F.conv2d, F.interpolate) gives the plain version's
    values on the same inputs: taps up to the order of its sums (the
    probe's tolerance), up_only bit for bit and as an NHWC view (no copy)."""
    args = P.inputs(tag, "cpu")
    want = P.run_plain(tag, "cpu", args)
    got = P.PROBES[tag].library(*args)
    mode = P.PROBES[tag].mode
    if mode == "up_only":
        assert got.is_contiguous() and got.shape == want.shape
        assert torch.equal(got, want)
    elif mode == "taps":
        assert got.shape == want.shape
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    else:
        np.testing.assert_allclose(got.float().reshape(want.shape).numpy(),
                                   want.float().numpy(), rtol=1e-6, atol=1e-6)


def test_every_k6_mode_but_matmul_up_has_a_one_call_yardstick():
    assert {m for m, f in P.LIBRARY.items() if f is None} == {"matmul_up"}
    k6 = [p for p in P.PROBES.values() if p.kernel_name == "K6"]
    assert sum(p.library is not None for p in k6) == len(k6) - 1 == 8


@pytest.mark.parametrize("tag", list(P.PROBES))
def test_work_counts_the_operands_and_the_arithmetic(tag):
    args = P.inputs(tag, "cpu")
    out = P.run_plain(tag, "cpu", args)
    nbytes, core, tensor = P.work(tag, args, out)
    operands = sum(a.numel() * a.element_size() for a in args if a is not None)
    assert nbytes == operands + out.numel() * out.element_size()
    p = P.PROBES[tag]
    if p.mode in ("matmul", "matmul_up"):
        assert core == 2 * args[0].numel() * args[1].shape[1] and tensor == 0
    elif p.mode == "stage" and p.dtype == torch.bfloat16:
        assert tensor > 0 and core > 0
    us, by = BM.bound_us(nbytes, core, tensor)
    assert us > 0 and by in ("bytes", "operations")


# --- the catalogue's inputs and cut -----------------------------------------

def test_inputs_replay_the_scripts_stream():
    rng = np.random.RandomState(0)
    draws = [rng.rand(4, 8, 8, 192), rng.rand(192, 192) * 0.1, rng.rand(4, 8, 8, 256),
             rng.rand(256, 120) * 0.1, rng.rand(4, 8, 8, 64), rng.rand(4, 8, 8, 56),
             rng.rand(4, 14, 14, 200), rng.rand(4, 8, 8, 64), rng.rand(4, 64, 64)]
    got = P.script_arrays("scripts/bisect_v3d.py", "matmul_256to120")
    np.testing.assert_array_equal(got["x"], draws[2].astype(np.float32))
    np.testing.assert_array_equal(got["w"], draws[3].astype(np.float32))
    got = P.script_arrays("scripts/bisect_v3d.py", "dma_2d_C64")
    np.testing.assert_array_equal(got["x"], draws[8].astype(np.float32))
    # the same for long skips, drawn piece by piece
    x = P.script_arrays("scripts/bisect_v3e.py", "rank3_folded_dma_7168")["x"]
    rng = np.random.RandomState(0)
    for _, _, shape, _ in P.STREAMS["scripts/bisect_v3e.py"][:12]:
        rng.rand(*shape)
    np.testing.assert_array_equal(x, rng.rand(4, 56, 7168).astype(np.float32))


def test_every_scripts_pallas_probe_is_in_the_catalogue():
    tags = set(P.PROBES)
    assert {"A_static_dma", "B_loop_static_slot", "C_dynamic_slot", "D_double_buffer",
            "E_full_compute", "value_reshape_split", "rank3_folded_dma_7168",
            "flat_dma_C200_hw14_39200", "v3_s4like_C128_skip"} <= tags
    assert {p.kernel_name for p in P.PROBES.values()} == {"K3", "K5", "K6"}
    for p in P.PROBES.values():
        path, line = p.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].strip(), p.replaces


@pytest.mark.parametrize("shape,kw,want", [
    # (rows, row_len, chunk, bcast_c)
    ((4, 8, 8, 128), {"depth": 1, "prefetch": False}, (4, 8192, 1024, 0)),
    ((1, 8192 * 1024), {"chunk_bytes": 112 << 10}, (1, 8388608, 28672, 0)),
    ((4, 39200), {"chunk_bytes": 30000}, (4, 39200, 7500, 0)),
    ((4, 39200), {"chunk_bytes": 30001}, (4, 39200, 7500, 0)),
    ((4, 56, 56, 128), {"depth": 1, "prefetch": False, "bcast_c0": True},
     (4, 401408, 1024, 128)),
    ((3, 7, 5), {"chunk_bytes": 48, "bcast_c0": True}, (3, 35, 10, 5)),
    ((2, 3), {"chunk_bytes": 4}, (2, 3, 1, 0)),
])
def test_copy_plan_cuts_rows_into_aligned_chunks(shape, kw, want):
    assert tuple(KP.plan_copy(shape, 4, **kw)) == want


@pytest.mark.parametrize("depth,prefetch", [(1, False), (2, False), (2, True)])
@pytest.mark.parametrize("shape,itemsize", [((4, 56, 7168), 4), ((4, 56, 56, 128), 4),
                                            ((8, 56, 7168), 2), ((1, 8 << 20), 4)])
def test_copy_plan_gives_every_resident_block_two_items(shape, itemsize, depth, prefetch):
    """The default cut, on arrays of 6.4-32 MB: at least two chunks for
    every block the default grid holds, chunks of at least 4 KB."""
    plan = KP.plan_copy(shape, itemsize, depth=depth, prefetch=prefetch)
    items = plan.rows * -(-plan.row_len // plan.chunk)
    assert items >= 2 * KP.resident_copy_blocks(depth, plan.chunk * itemsize)
    assert plan.chunk * itemsize >= KP.MIN_CHUNK_BYTES
    assert plan.chunk * itemsize <= KP.SMEM_BYTES // depth and plan.chunk % (16 // itemsize) == 0


@pytest.mark.parametrize("shape,itemsize,want_bytes", [
    ((4, 8, 8, 128), 4, 4096),      # 128 KB: the 4 KB floor, not 1 KB chunks
    ((4, 8, 8, 128), 2, 4096),      # the same in bf16
    ((4, 8, 8, 56), 4, 4096),
    ((4, 500), 4, 2000),            # a row below the floor stays whole
    ((1, 32 << 20), 4, KP.SMEM_BYTES // 2),  # 128 MB: whole slots give two a block
])
def test_copy_plan_default_chunk_lies_between_4kb_and_a_slot(shape, itemsize, want_bytes):
    plan = KP.plan_copy(shape, itemsize)
    assert plan.chunk * itemsize == want_bytes


@pytest.mark.parametrize("chunk_bytes", [8 << 10, 32 << 10, 64 << 10, 112 << 10])
def test_copy_plan_keeps_an_explicit_chunk(chunk_bytes):
    plan = KP.plan_copy((1, 8 << 20), 4, chunk_bytes=chunk_bytes, depth=2, prefetch=False)
    assert plan.chunk * 4 == chunk_bytes


@pytest.mark.parametrize("shape", [(4, 56, 56, 128), (4, 14, 14, 200), (3, 7, 5),
                                   (2, 4, 1500), (2, 64, 56)])
def test_copy_plan_never_splits_a_pixel_from_its_channel_0(shape):
    plan = KP.plan_copy(shape, 4, depth=1, prefetch=False, bcast_c0=True)
    assert plan.bcast_c == shape[-1]
    assert plan.chunk % plan.bcast_c == 0 and plan.row_len % plan.bcast_c == 0


def test_no_catalogue_tag_pins_k5s_grid(monkeypatch):
    """Every copy probe runs on the default grid, the whole card."""
    seen = []
    real = KP.staged_copy

    def spy(x, **kw):
        seen.append(kw)
        return real(x, **kw)

    monkeypatch.setattr(KP, "staged_copy", spy)
    tags = [t for t, p in P.PROBES.items() if p.kernel_name == "K5"]
    for tag in tags:
        P.run(tag, "cpu")
    assert len(seen) == len(tags) == 15
    assert all(kw.get("blocks") is None for kw in seen)


def test_copy_plan_rejects_what_k5_does_not_take():
    for shape, kw, match in [
        ((8,), {}, "at least 2 dims"),
        ((2, 8), {"depth": 3, "prefetch": False}, "depth"),
        ((2, 8), {"depth": 1, "prefetch": True}, "prefetch"),
        ((2, 1 << 20), {"chunk_bytes": 200 << 10}, "chunk_bytes"),
        ((2, 4, 128), {"chunk_bytes": 256, "bcast_c0": True}, "whole pixel"),
    ]:
        with pytest.raises(ValueError, match=match):
            KP.plan_copy(shape, 4, **kw)


def test_sweep_chunks_fit_two_slots_and_the_sweep_needs_a_card():
    assert list(P.SWEEP_CHUNKS) == [64, 256, 1024, 4096]
    assert all(2 * b <= KP.SMEM_BYTES for b in P.SWEEP_CHUNKS.values())
    assert sorted(P.SWEEP_CHUNKS.values()) == list(P.SWEEP_CHUNKS.values())
    with pytest.raises(ValueError, match="CUDA"):
        P.copy_sweep("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        P.compute_sweep("cpu")


@pytest.mark.parametrize("mode,shape,cout", P.SCALE_ROWS)
def test_scale_rows_are_bound_well_above_a_launch(mode, shape, cout):
    """Each K6 scale row's bound (published rates) is at least 15 us, far
    above the few microseconds any launch costs; the matmul modes are
    bound by their 1.28 GFLOP."""
    x = torch.empty(shape, device="meta")
    w = torch.empty(shape[-1], cout, device="meta") if mode.startswith("matmul") else None
    hw = 2 if mode in ("matmul_up", "up_only") else 1
    out = torch.empty(shape[0], hw * shape[1], hw * shape[2], cout, device="meta")
    nbytes, core, tensor = P.mode_work(mode, (x, w), out)
    us, by = BM.bound_us(nbytes, core, tensor)
    assert us >= 15
    assert by == ("operations" if mode.startswith("matmul") else "bytes")
    if mode.startswith("matmul"):
        assert core == 2 * 128 * 49 * 512 * 200


# --- dispatch and checks on the CPU -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bcast", [False, True])
def test_staged_copy_on_cpu_takes_the_plain_version(dtype, bcast):
    x = torch.randn(3, 5, 4, 8, generator=torch.Generator().manual_seed(0)).to(dtype)
    before = kernel.COUNTER["K5"]
    got = KP.staged_copy(x, scale=2.0, chunk_bytes=64, bcast_c0=bcast)
    assert kernel.COUNTER["K5"] == before and got.dtype == dtype and got.shape == x.shape
    want = x.float() * 2 + (x[..., :1].float() if bcast else 0)
    assert torch.equal(got, want.to(dtype))


@pytest.mark.parametrize("mode", KP.MODES)
def test_staged_compute_on_cpu_takes_the_plain_version(mode):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 4, 3, 6, generator=g)
    w = torch.rand(6, 5, generator=g) if mode.startswith("matmul") else None
    before = kernel.COUNTER["K6"]
    got = KP.staged_compute(x, w, mode)
    assert kernel.COUNTER["K6"] == before
    assert torch.equal(got, KP.staged_compute_reference(x, w, mode))
    hw = (8, 6) if mode in ("matmul_up", "up_only") else (4, 3)
    assert tuple(got.shape) == (2, *hw, 5 if w is not None else 6)


def test_staged_compute_on_cpu_takes_images_larger_than_shared_memory():
    """Nothing stages a whole image any more: a 32x32x64 image (256 KB,
    above a block's 227 KB) is taken, and its geometry fits."""
    x = torch.rand(1, 32, 32, 64, generator=torch.Generator().manual_seed(0))
    assert x[0].numel() * 4 > KP.SMEM_BYTES
    for mode in KP.MODES:
        w = torch.rand(64, 24) if mode.startswith("matmul") else None
        got = KP.staged_compute(x, w, mode)
        assert torch.equal(got, KP.staged_compute_reference(x, w, mode))
        assert KP.stage_geometry(mode, 1, 32, 32, 64, 24 if w is not None else 64).smem \
            <= KP.SMEM_BYTES


@pytest.mark.parametrize("mode,N,H,W,C,Cout", [
    ("matmul", 4, 8, 8, 128, 64), ("matmul", 4, 8, 8, 128, 256), ("matmul", 4, 8, 8, 120, 56),
    ("matmul_up", 4, 8, 8, 128, 64), ("matmul", 128, 7, 7, 512, 200),
    ("matmul_up", 128, 7, 7, 512, 200), ("matmul", 3, 7, 5, 6, 5), ("matmul", 1, 1, 1, 4, 4),
    ("taps", 4, 8, 8, 120, 120), ("taps", 128, 28, 28, 256, 256), ("taps", 3, 7, 5, 6, 6),
    ("taps", 1, 2, 2000, 4, 4), ("up_only", 4, 8, 8, 64, 64), ("up_only", 3, 7, 5, 5, 5),
    ("up_only", 128, 28, 28, 256, 256)])
def test_stage_geometry_covers_every_output_once(mode, N, H, W, C, Cout):
    """K6's tiles are powers of two, cover every output of the mode, fit
    in shared memory, and fill the SMs where the shapes allow."""
    g = KP.stage_geometry(mode, N, H, W, C, Cout)
    assert 32 <= g.threads <= 256 and g.threads % 32 == 0 and g.smem <= KP.SMEM_BYTES
    if mode.startswith("matmul"):
        tm = {(bm, bn): tm for bm, bn, tm in KP.GEMM_TILES}[g.tile_m, g.tile_n]
        assert g.threads == g.tile_m * g.tile_n // (4 * tm)
        M = N * H * W
        assert g.grid == (-(-M // g.tile_m), -(-Cout // g.tile_n))
        most = max(-(-M // bm) * -(-Cout // bn) for bm, bn, _ in KP.GEMM_TILES)
        assert g.blocks >= 132 or g.blocks == most
    elif mode == "taps":
        ct = g.tile_n
        assert ct & (ct - 1) == 0 and ct % 4 == 0 and g.tile_m in KP.TAP_BANDS
        assert g.grid == (N * -(-H // g.tile_m), -(-C // ct))
        assert g.smem == (g.tile_m + 4) * W * ct * 4
        assert g.threads >= min(256, g.tile_m // min(4, g.tile_m) * W * ct // 4)
    else:
        assert g.grid[0] * g.threads >= N * H * W * -(-C // 4)


def test_stage_geometry_at_the_probes_and_the_scale_rows():
    # the probes' 256 pixels: the smallest tile, the most blocks
    assert KP.stage_geometry("matmul", 4, 8, 8, 128, 64)[:4] == ((8, 4), 32, 32, 16)
    # the scale row: a covering tile of >= 128 threads, Cout 200 padded to 224
    assert KP.stage_geometry("matmul", 128, 7, 7, 512, 200)[:4] == ((49, 7), 128, 128, 32)
    # a tie in padding goes to the first (largest) tile
    assert KP.stage_geometry("matmul", 128, 14, 14, 200, 256)[:4] == ((196, 8), 128, 128, 32)
    assert KP.stage_geometry("taps", 128, 28, 28, 256, 256)[:4] == ((512, 8), 256, 8, 32)
    assert KP.stage_geometry("taps", 4, 8, 8, 120, 120)[:4] == ((32, 4), 64, 1, 32)
    with pytest.raises(ValueError, match="shared memory"):
        KP.stage_geometry("taps", 1, 4, 1 << 20, 4, 4)
    with pytest.raises(ValueError, match="mode"):
        KP.stage_geometry("conv", 1, 4, 4, 4, 4)


def test_staged_compute_taps_pad_each_image_alone():
    """taps zero-pads the image's own tile: a corner sums its 3x3 in-image
    neighbours, never a neighbouring image's pixels."""
    x = torch.ones(2, 8, 8, 1)
    x[1] = 100.0
    got = KP.staged_compute(x, None, "taps")
    assert torch.allclose(got[0, 0, 0, 0], torch.tensor(9 * 0.04))
    assert torch.allclose(got[0, 4, 4, 0], torch.tensor(25 * 0.04))


def test_probe_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, 8, 6)
    w = torch.zeros(6, 5)
    for fn, match in [
        (lambda: KP.staged_copy(x.double()), "float32 or bfloat16"),
        (lambda: KP.staged_copy(x.transpose(1, 2)), "contiguous"),
        (lambda: KP.staged_copy(x, blocks=0), "blocks"),
        (lambda: KP.staged_copy(x.to("meta")), "CUDA devices"),
        (lambda: KP.staged_compute(x, w, "conv"), "mode"),
        (lambda: KP.staged_compute(x, w[:5], "matmul"), "w must be"),
        (lambda: KP.staged_compute(x, w, "taps"), "takes no weight"),
        (lambda: KP.staged_compute(x.bfloat16(), w.bfloat16(), "matmul"), "float32"),
        (lambda: KP.staged_compute(x[0], w, "matmul"), "NHWC"),
        (lambda: KP.staged_compute(x.to("meta"), w.to("meta"), "matmul"), "CUDA devices"),
    ]:
        with pytest.raises(ValueError, match=match):
            fn()


# --- the CLI ------------------------------------------------------------------

def test_probe_cli_on_cpu_checks_and_writes_json(tmp_path, capsys):
    out = tmp_path / "probes.json"
    tags = ["A_static_dma", "D_double_buffer", "taps_120", "value_reshape_split"]
    assert probe_cli.main(["--tags", *tags, "--device", "cpu", "--calls", "1",
                           "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "A_static_dma: OK (" in text and "sum=32594.3" in text
    rows = json.loads(out.read_text())["probes"]
    assert [r["tag"] for r in rows] == tags
    assert all(r["ok"] and "cpu_us" in r and "device_us" not in r for r in rows)


@pytest.mark.parametrize("library_us,want", [(40.0, "kernel/library 1.25x"),
                                              (None, "library none (two calls)")])
def test_scale_row_prints_its_check_ratio_and_share_of_bound(library_us, want):
    row = {"mode": "matmul", "shape": [128, 7, 7, 512], "Cout": 200, "ok": True,
           "max_abs_err": 0.0, "tol": 1.5e-3, "device_us": 50.0, "plain_device_us": 43.0,
           "bound_us": 19.17, "bound_by": "operations", "share_of_bound": 19.17 / 50.0}
    if library_us is not None:
        row["library_device_us"] = library_us
    text = probe_cli.format_scale_row(row)
    assert text.startswith("K6 matmul x (128, 7, 7, 512) -> Cout 200: OK")
    assert want in text and "38.3% of it" in text


def test_probe_cli_exits_non_zero_when_a_kernel_disagrees(monkeypatch, capsys):
    import dataclasses

    bad = dataclasses.replace(P.PROBES["B_loop_static_slot"],
                              plain=lambda x: KP.staged_copy_reference(x) + 1)
    monkeypatch.setitem(P.PROBES, "B_loop_static_slot", bad)
    assert probe_cli.main(["--tags", "B_loop_static_slot", "--device", "cpu",
                           "--calls", "0"]) == 1
    assert "B_loop_static_slot: FAIL" in capsys.readouterr().out


# --- on the card --------------------------------------------------------------

def _on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU host: python -m pytest "
                    "--noconftest tests/test_torch_probes.py -m cuda)")
    # true f32 in the plain versions' matmuls and cuDNN convolutions
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


# (shape, ring): the table's shapes, flat rows cut inside the row with a
# ragged tail, and widths that do not fill 16-byte words (element loads)
COPY_CASES = [
    ((4, 8, 8, 128), {"depth": 1, "prefetch": False}),
    ((4, 39200), {"chunk_bytes": 30000, "depth": 2, "prefetch": True}),
    ((4, 3584), {"chunk_bytes": 4096, "depth": 2, "prefetch": False}),
    ((4, 56, 56, 128), {"chunk_bytes": 96 << 10, "bcast_c0": True}),
    ((3, 7, 5), {"chunk_bytes": 40, "bcast_c0": True, "depth": 1, "prefetch": False}),
    ((5, 1001), {"chunk_bytes": 1000}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(COPY_CASES)))
@pytest.mark.parametrize("blocks", [1, 3, None])
def test_staged_copy_matches_plain_version_on_the_card(case, dtype, blocks, monkeypatch):
    _on_card(monkeypatch)
    shape, kw = COPY_CASES[case]
    x = torch.rand(shape, generator=torch.Generator().manual_seed(case)).to("cuda", dtype)
    want = KP.staged_copy_reference(x, 2.0, kw.get("bcast_c0", False))
    before = kernel.COUNTER["K5"]
    got = KP.staged_copy(x, scale=2.0, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert kernel.COUNTER["K5"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,nhw,C,Cout", [
    # the probes' shapes, and widths that fill no 16-byte word
    ("matmul", (4, 8, 8), 128, 64), ("matmul", (4, 8, 8), 192, 192),
    ("matmul", (4, 8, 8), 256, 120), ("matmul", (4, 8, 8), 6, 5),
    ("matmul_up", (4, 8, 8), 128, 64), ("matmul_up", (4, 8, 8), 7, 3),
    ("taps", (4, 8, 8), 120, 120), ("taps", (4, 8, 8), 6, 6),
    ("up_only", (4, 8, 8), 64, 64), ("up_only", (4, 8, 8), 5, 5),
    # the scale rows (engine/probes.SCALE_ROWS)
    ("matmul", (128, 7, 7), 512, 200), ("matmul_up", (128, 7, 7), 512, 200),
    ("taps", (128, 28, 28), 256, 256), ("up_only", (128, 28, 28), 256, 256),
    # a Cout that fills no tile
    ("matmul", (4, 8, 8), 128, 200), ("matmul", (4, 8, 8), 120, 56),
    ("matmul_up", (4, 8, 8), 64, 5), ("matmul", (16, 8, 8), 96, 200),
    # a pixel count that fills no tile, images taller than a taps band
    ("matmul", (3, 7, 5), 128, 64), ("matmul_up", (3, 7, 5), 64, 56),
    ("taps", (3, 7, 5), 64, 64), ("taps", (2, 19, 13), 36, 36), ("taps", (1, 56, 56), 128, 128),
    ("up_only", (3, 7, 5), 12, 12)])
def test_staged_compute_matches_plain_version_on_the_card(mode, nhw, C, Cout, monkeypatch):
    _on_card(monkeypatch)
    g = torch.Generator().manual_seed(C)
    x = torch.rand(*nhw, C, generator=g).cuda()
    w = (torch.rand(C, Cout, generator=g) * 0.1).cuda() if mode.startswith("matmul") else None
    want = KP.staged_compute_reference(x, w, mode)
    before = kernel.COUNTER["K6"]
    got = KP.staged_compute(x, w, mode)
    torch.cuda.synchronize()
    assert kernel.COUNTER["K6"] == before + 1
    if mode in ("taps", "up_only"):  # the plain version's own roundings, in its order
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3])
def test_e_full_compute_through_k3_on_small_grids(blocks, monkeypatch):
    """E's four 8x8 images are few items for K3's persistent grid: on a
    grid of 1 or 3 blocks each block walks several through its ring."""
    _on_card(monkeypatch)
    args = P.inputs("E_full_compute", "cuda")
    want = P.run_plain("E_full_compute", "cuda", args)
    with torch.inference_mode():
        got = TB.to_nhwc(fused_decoder_stage_v3(*args, block_batch=1, blocks=blocks))
    assert float((got - want).abs().max()) <= P.bound("E_full_compute", want)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(P.PROBES))
def test_catalogue_kernels_match_plain_versions_on_the_card(tag, monkeypatch):
    _on_card(monkeypatch)
    args = P.inputs(tag, "cuda")
    got, want = P.run(tag, "cuda", args), P.run_plain(tag, "cuda", args)
    assert float((got.float() - want.float()).abs().max()) <= P.bound(tag, want)
