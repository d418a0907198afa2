"""The fused decoder level's kernels (K1; K2 and K3 with ``--kernel``) on
the card, level by level, with the L2 cold, beside their plain version
and their bound; then the forwards that run K1 (the fused eval step, the
deploy runner's batch-1 forward).

For each kernel, dtype, batch and decoder level of the pruned flagship
(and the unpruned model's first level) it checks the kernel against
``fused_decoder_stage_reference`` on the same inputs and times both with
``engine.benchmark.time_graph``: a CUDA graph that cycles through enough
distinct copies of the operands that one replay touches more than twice
the L2 (``cold_copies``), so each call reads device memory as the main
path does.  K2 and K3 run at their forwards' images per block
(``models.fused.V2_BLOCK_BATCHES`` / ``V3_BLOCK_BATCHES``).  Beside each
time stands the bound (``stage_work`` over the published H100 rates, the
bf16 pointwise product on the tensor cores, where all three run it) with
the term that binds, and the launch geometry the kernel's host function
picked.  ``chip_smoke.py`` checks and times K1-K3 through
:func:`level_row` too.

``--digests OUT`` writes, instead, a SHA-256 of K1's output at each of
the flagship's levels (batch 8 and 1, f32 and bf16, inputs from a seeded
numpy stream): the same command on two trees says whether K1's results
moved, bit for bit (``tests/test_torch_kernels.py`` holds K1 to the
digests in ``fastdepth_tpu_torch/measurements/k1_digests_d7adecb.json``).  It imports nothing but K1's
wrapper, so it runs against an older tree's package too (put that tree
first on ``PYTHONPATH`` and run this file by its path).

``--e2e`` adds, on the committed trained weights
(``docs/rehearsal_model_r5.npz``): the fused eval step (``Evaluator``,
impl auto) at batch 8 and 128, median of 5 runs of 10 pipelined steps
(CUDA events), and the batch-1 deploy forward (``compile_forward``), the
median of 5 runs' medians of 100 single calls after 10 warm-up calls, as
``cli.deploy`` times it.

Usage:
    python -m fastdepth_tpu_torch.cli.bench_decoder [--kernel K1 K2 K3]
        [--batches 1 8 128] [--dtypes f32 bf16] [--e2e] [--json OUT]
    python -m fastdepth_tpu_torch.cli.bench_decoder --digests OUT
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

from fastdepth_tpu_torch.engine import benchmark as B

# (level, H=W, C, Cout, skip): the pruned flagship's five, then the
# unpruned model's first
LEVELS = [("pruned1", 7, 512, 200, False), ("pruned2", 14, 200, 256, True),
          ("pruned3", 28, 256, 120, True), ("pruned4", 56, 120, 56, True),
          ("pruned5", 112, 56, 16, False), ("unpruned1", 7, 1024, 512, False)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "rehearsal_model_r5.npz")


KERNELS = ("K1", "K2", "K3")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="K1-K3 per decoder level, L2 cold, on the card")
    p.add_argument("--kernel", nargs="+", default=["K1"], choices=KERNELS,
                   help="the stage kernels to run (K2 and K3 at their forwards' images "
                        "per block)")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8, 128])
    p.add_argument("--dtypes", nargs="+", default=list(DTYPES), choices=list(DTYPES))
    p.add_argument("--e2e", action="store_true",
                   help="also time the fused eval step (b8, b128) and deploy b1")
    p.add_argument("--json", default=None, help="write the rows to this JSON file")
    p.add_argument("--digests", default=None, metavar="OUT",
                   help="only write SHA-256 digests of K1's outputs at the flagship's "
                        "levels to OUT")
    return p.parse_args(argv)


def stage_kernel(label):
    """(module, wrapper, images per block by level or None) of K1-K3."""
    from fastdepth_tpu_torch.models import fused as F
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_hwbc as K2
    from fastdepth_tpu_torch.ops.cuda import fused_decoder_v3 as K3

    return {"K1": (K1, K1.fused_decoder_stage, None),
            "K2": (K2, K2.fused_decoder_stage_hwbc, F.V2_BLOCK_BATCHES),
            "K3": (K3, K3.fused_decoder_stage_v3, F.V3_BLOCK_BATCHES)}[label]


def level_block_batch(label, level):
    """The images per block K2 / K3 run ``level`` (``"pruned3"``) at in
    their forwards; None for K1."""
    bbs = stage_kernel(label)[2]
    return None if bbs is None else bbs[int(level[-1])]


def geometry(label, n, h, c, cout, dtype_name, block_batch=None):
    """The launch geometry K1-K3's host function picks for one level, as
    a dict (K3 adds its persistent grid, the blocks the card holds); None
    where the kernel has no host-side geometry (an older tree's K2 / K3,
    when this file runs against that tree's package)."""
    mod = stage_kernel(label)[0]
    if not hasattr(mod, "launch_geometry"):
        return None
    dtype = DTYPES[dtype_name]
    if label == "K1":
        g = mod.launch_geometry(n, h, h, c, cout, dtype)
    else:
        g = mod.launch_geometry(n, h, h, c, cout, dtype, block_batch)
    out = {"images": getattr(g, "images", 1), "threads": g.threads, "groups": g.groups,
           "tile": [g.tile_h, g.tile_w], "cout_tile": g.cout_tile, "chunk": g.chunk,
           "grid": list(g.grid), "smem": g.smem, "per_sm": getattr(g, "per_sm", None)}
    if label == "K3":
        out["persistent_grid"] = min(g.blocks, mod.resident_blocks(g))
    return out


def format_geometry(g) -> str:
    if g is None:
        return "no host-side geometry"
    return (f"B={g['images']} {g['groups']}x{g['threads']} threads, tile "
            f"{g['tile'][0]}x{g['tile'][1]}, Cout tile {g['cout_tile']}, chunk {g['chunk']}, "
            f"grid {g['grid'][0]}x{g['grid'][1]}"
            + (f" items on {g['persistent_grid']} blocks" if "persistent_grid" in g else "")
            + f", {g['smem']} B shared"
            + (f", {g['per_sm']} an SM" if g["per_sm"] is not None else ""))


def stage_sets(n, h, c, cout, skip, dtype, copies, seed=0):
    """``copies`` distinct seeded operand sets of one level on the card:
    x and skip channels_last, the weights in K1's layout, scaled so the
    activations stay O(1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, cl=False):
        t = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    weights = (rnd(25, c, scale=0.2), rnd(c, scale=0.1), rnd(c, cout, scale=c ** -0.5),
               rnd(cout, scale=0.1))
    sets = []
    for _ in range(copies):
        x = rnd(n, c, h, h, cl=True)
        sk = rnd(n, cout, 2 * h, 2 * h, cl=True) if skip else None
        sets.append((x, *weights, sk))
    return sets


def level_row(name, n, h, c, cout, skip, dtype_name, kernel=None, **kwargs):
    """One level at batch ``n``: K1 (or ``kernel``, a ``(module, wrapper)``
    of the stage family, called with ``kwargs``) against
    ``fused_decoder_stage_reference`` on the same inputs, both timed with
    the L2 cold (:func:`engine.benchmark.compare_and_time`), beside the
    level's bound on the published rates."""
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1

    mod, fn = kernel or (K1, K1.fused_decoder_stage)
    dtype = DTYPES[dtype_name]
    elem = torch.finfo(dtype).bits // 8
    # K1-K3 put bf16's pointwise product on the tensor cores
    nbytes, core, tensor = B.stage_work(n, h, h, c, cout, skip, elem,
                                        tensor_cores=dtype == torch.bfloat16)
    # the weights are shared by the copies: only x, skip and out cycle
    act_bytes = elem * n * h * h * (c + (2 if skip else 1) * 4 * cout)
    sets = stage_sets(n, h, c, cout, skip, dtype, B.cold_copies(act_bytes))
    row = {"level": name, "dtype": dtype_name, "batch": n, "H": h, "C": c, "Cout": cout,
           "skip": skip, "bytes": nbytes, "core_flops": core, "tensor_flops": tensor,
           **B.compare_and_time(lambda *a: fn(*a, **kwargs),
                                K1.fused_decoder_stage_reference, sets, counter=mod)}
    row["bound_us"], row["bound_by"] = B.bound_us(nbytes, core, tensor)
    row["share_of_bound"] = row["bound_us"] / row["us"]
    return row


def digests():
    """SHA-256 of K1's output at each of the flagship's levels, batch 8
    and 1, f32 and bf16, on operands from a seeded numpy stream; keyed
    ``"<level> <dtype> b<n>"``."""
    import numpy as np
    from fastdepth_tpu_torch.ops.cuda import fused_decoder as K1

    out = {}
    for dtype_name, dtype in DTYPES.items():
        for n in (8, 1):
            for name, h, c, cout, skip in LEVELS:
                rng = np.random.RandomState(0)

                def t(*shape, scale=1.0):
                    a = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
                    return a.to("cuda", dtype)

                x = t(n, c, h, h).contiguous(memory_format=torch.channels_last)
                w = (t(25, c, scale=0.2), t(c, scale=0.1), t(c, cout, scale=c ** -0.5),
                     t(cout, scale=0.1))
                sk = (t(n, cout, 2 * h, 2 * h).contiguous(memory_format=torch.channels_last)
                      if skip else None)
                y = K1.fused_decoder_stage(x, *w, sk).contiguous()
                raw = y.view(torch.int16) if dtype == torch.bfloat16 else y.view(torch.int32)
                out[f"{name} {dtype_name} b{n}"] = hashlib.sha256(
                    raw.cpu().numpy().tobytes()).hexdigest()
    return out


def e2e_rows():
    from fastdepth_tpu_torch import Evaluator, build, compile_forward, load_checkpoint
    from fastdepth_tpu_torch import params_from_jax

    tree, cfg, _ = load_checkpoint(WEIGHTS)
    model = build(cfg)
    params = model.load(params_from_jax(tree))
    rng = np.random.RandomState(0)
    rows = []
    for dtype_name, dtype in DTYPES.items():
        for n in (8, 128):
            ev = Evaluator(model, params, batch_size=n, dtype=dtype, impl="auto",
                           device="cuda")
            x = ev.put(rng.rand(n, 224, 224, 3).astype(np.float32))
            d = ev.put(rng.uniform(0.5, 10, (n, 224, 224, 1)).astype(np.float32))
            ms = [B.time_pipelined(ev, (x, d), calls=10)["mean_s"] * 1e3 for _ in range(5)]
            rows.append({"path": "eval_step", "dtype": dtype_name, "batch": n,
                         "median_ms": float(np.median(ms)),
                         "fps": n / float(np.median(ms)) * 1e3})
        fwd, p = compile_forward(model, params, batch_size=1, dtype=dtype, impl="auto",
                                 device="cuda")
        x1 = torch.from_numpy(rng.rand(1, 224, 224, 3).astype(np.float32)).cuda()
        # the host's clock drives this path: the median of 5 runs' medians
        ms = [B.time_fn(fwd, (p, x1), warmup=10, repeats=100)["median_s"] * 1e3
              for _ in range(5)]
        rows.append({"path": "deploy_b1", "dtype": dtype_name, "batch": 1,
                     "median_ms": float(np.median(ms)), "run_medians_ms": ms})
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    card = B.card_info()  # raises without a card
    print(card["nvidia_smi"])
    if args.digests:
        with open(args.digests, "w") as f:
            json.dump({"card": card, "k1_sha256": digests()}, f, indent=1)
        print(f"K1 output digests written to {args.digests}")
        return 0
    from fastdepth_tpu_torch.engine.aot import strict_f32

    strict_f32()
    rows = []
    for dtype_name in args.dtypes:
        for n in args.batches:
            for label in args.kernel:
                mod, fn, _ = stage_kernel(label)
                for name, h, c, cout, skip in LEVELS:
                    bb = level_block_batch(label, name)
                    kwargs = {} if bb is None else {"block_batch": bb}
                    r = level_row(name, n, h, c, cout, skip, dtype_name, kernel=(mod, fn),
                                  **kwargs)
                    r["kernel"] = label
                    r["geometry"] = geometry(label, n, h, c, cout, dtype_name, bb)
                    rows.append(r)
                    print(f"{label} {dtype_name} b{n} {name} {h}x{h} {c}->{cout}"
                          f"{' +skip' if skip else ''}: {r['us']:.2f} us (plain "
                          f"{r['plain_us']:.2f}), bound {r['bound_us']:.2f} us "
                          f"({r['bound_by']}), {100 * r['share_of_bound']:.0f}% of the bound; "
                          f"max|diff| {r['max_abs_err']:.2e} "
                          f"(tol {r['tol']:.2e}){'' if r['ok'] else ' FAIL'}; "
                          f"{r['copies']} copies; {format_geometry(r['geometry'])}", flush=True)
            for label in args.kernel:
                five = [r for r in rows if r["kernel"] == label and r["dtype"] == dtype_name
                        and r["batch"] == n and r["level"].startswith("pruned")]
                if len(five) == 5:
                    print(f"{label} {dtype_name} b{n} five pruned levels: "
                          f"{sum(r['us'] for r in five):.2f} us (plain "
                          f"{sum(r['plain_us'] for r in five):.2f}), bound "
                          f"{sum(r['bound_us'] for r in five):.2f} us", flush=True)
    out = {"card": card, "levels": rows}
    if args.e2e:
        out["e2e"] = e2e_rows()
        for r in out["e2e"]:
            print(f"{r['path']} {r['dtype']} b{r['batch']}: median {r['median_ms']:.4f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
