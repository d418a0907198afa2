"""K1 (the fused decoder level) on the card, level by level, with the L2
cold, beside its plain version and its bound; then the forwards that run
it (the fused eval step, the deploy runner's batch-1 forward).

For each dtype, batch and decoder level of the pruned flagship (and the
unpruned model's first level) it checks K1 against
``fused_decoder_stage_reference`` on the same inputs and times both with
``engine.benchmark.time_graph``: a CUDA graph that cycles through enough
distinct copies of the operands that one replay touches more than twice
the L2 (``cold_copies``), so each call reads device memory as the main
path does.  Beside each time stands the bound (``stage_work`` over the
published H100 rates) with the term that binds.  ``chip_smoke.py``
checks and times K1-K3 through :func:`level_row` too.

``--e2e`` adds, on the committed trained weights
(``docs/rehearsal_model_r5.npz``): the fused eval step (``Evaluator``,
impl auto) at batch 8 and 128, median of 5 runs of 10 pipelined steps
(CUDA events), and the batch-1 deploy forward (``compile_forward``), the
median of 5 runs' medians of 100 single calls after 10 warm-up calls, as
``cli.deploy`` times it.

Usage:
    python -m fastdepth_tpu_torch.cli.bench_decoder [--batches 1 8 128]
        [--dtypes f32 bf16] [--e2e] [--json OUT]
"""

from __future__ import annotations

import argparse
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="K1 per decoder level, L2 cold, on the card")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8, 128])
    p.add_argument("--dtypes", nargs="+", default=list(DTYPES), choices=list(DTYPES))
    p.add_argument("--e2e", action="store_true",
                   help="also time the fused eval step (b8, b128) and deploy b1")
    p.add_argument("--json", default=None, help="write the rows to this JSON file")
    return p.parse_args(argv)


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
    # K1 puts bf16's pointwise product on the tensor cores; K2/K3 do not
    nbytes, core, tensor = B.stage_work(
        n, h, h, c, cout, skip, elem,
        tensor_cores=dtype == torch.bfloat16 and fn is K1.fused_decoder_stage)
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dtype_name in args.dtypes:
        for n in args.batches:
            for name, h, c, cout, skip in LEVELS:
                r = level_row(name, n, h, c, cout, skip, dtype_name)
                rows.append(r)
                print(f"K1 {dtype_name} b{n} {name} {h}x{h} {c}->{cout}"
                      f"{' +skip' if skip else ''}: {r['us']:.2f} us (plain "
                      f"{r['plain_us']:.2f}), bound {r['bound_us']:.2f} us ({r['bound_by']}), "
                      f"{100 * r['share_of_bound']:.0f}% of the bound; max|diff| "
                      f"{r['max_abs_err']:.2e} "
                      f"(tol {r['tol']:.2e}){'' if r['ok'] else ' FAIL'}; "
                      f"{r['copies']} copies", flush=True)
            five = [r for r in rows if r["dtype"] == dtype_name and r["batch"] == n
                    and r["level"].startswith("pruned")]
            if len(five) == 5:
                print(f"K1 {dtype_name} b{n} five pruned levels: "
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
