"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have, and so does the control: the
reference in the precision below the cell's in the program's place.
On the CPU, at a size a test run holds, with the look for a card
skipped.  The TF32 control of the f32 cell needs the card
(``test_pb_card.py``)."""

from __future__ import annotations

import pytest
import torch

from perfbench import check, harness, run

SEED = 2 ** 31 + 77


def broken(fault):
    """A ``_prepare`` whose forward has ``fault``."""
    from fastdepth_tpu_torch.engine import aot

    original = aot._prepare

    def prepare(*args, **kw):
        params, apply = original(*args, **kw)
        last = []

        def faulty(p, x):
            out = apply(p, x).clone()
            n = out.shape[0]
            if fault == "altered":  # one answer altered where it is produced
                out[0] = out[0] * 1.1
            elif fault == "half_batch":  # the second half left out
                out[n // 2:] = out[:n // 2].mean(dim=0) if n > 1 else 0
            elif fault == "stale":  # the previous answer returned again
                prev = last[0] if last else out
                last[:] = [out]
                out = prev
            return out
        return params, faulty
    return prepare


MODULES = {"batch": "fastdepth_tpu_torch.engine.evaluator._prepare",
           "deploy": "fastdepth_tpu_torch.engine.aot._prepare",
           "serve_socket": "fastdepth_tpu_torch.engine.server._prepare"}
FAULTS = [("fastdepth.batch-b512", "half_batch"), ("fastdepth.batch-b512", "altered"),
          ("fastdepth.deploy-b1", "altered"), ("fastdepth.deploy-b1", "stale"),
          ("fastdepth.serve-socket", "altered"), ("fastdepth.serve-socket", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(root, monkeypatch, cell, fault):
    import fastdepth_tpu_torch.engine.evaluator  # noqa: F401
    import fastdepth_tpu_torch.engine.server  # noqa: F401

    wl = harness.workload(cell, root)
    monkeypatch.setattr(MODULES[wl["entry"]], broken(fault))
    if cell == "fastdepth.serve-socket" and fault == "half_batch":
        # enough load that packed batches hold more than one frame
        path = f"{root}/perfbench/workloads/{cell}.json"
        import json

        with open(path, "w") as f:
            json.dump(dict(wl, rate=400), f)
    r = run.measure(cell, SEED, 0.5, False, root=root, device="cpu", check_device=False)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("cell", ["fastdepth.batch-b512", "fastdepth.deploy-b1",
                                  "fastdepth.serve-socket"])
def test_an_unbroken_path_is_correct(root, cell):
    r = run.measure(cell, SEED, 0.5, False, root=root, device="cpu", check_device=False)
    assert r["correct"] is True


@pytest.mark.parametrize("cell", ["fastdepth.batch-b512", "resnet50-upproj.batch-b128",
                                  "fastdepth.serve-socket"])
def test_the_fp8_control_is_not_correct(root, cell):
    wl = harness.workload(cell, root)
    cfg = harness.config(wl["config"], root)
    assert check.CONTROLS[wl["dtype"]] == "fp8"
    from perfbench import program

    sd = program.draw_params(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 256, (4, *cfg["image_size"], 3), generator=g, dtype=torch.uint8)
    samples = {"name": "answer_rel_l2" if "serve" in cell else "pred_rel_l2", "params": sd,
               "inputs": x,
               "outputs": torch.zeros((4, *cfg["image_size"], 1),
                                      dtype=torch.float16 if "serve" in cell else torch.float32)}
    if wl["entry"] == "batch":
        samples["depth"] = torch.rand((4, *cfg["image_size"], 1), generator=g) * 9.5 + 0.5
    values = check.numbers(samples, cfg, "cpu", control="fp8", witness=check.witness(wl))
    limits = {k: v for k, v in wl["limits"].items() if k in values}
    assert not check.correct(check.judge(values, limits), 0)


def test_the_witness_in_the_programs_place_reads_one(root):
    wl = harness.workload("fastdepth.serve-socket", root)
    cfg = harness.config(wl["config"], root)
    from perfbench import program

    sd = program.draw_params(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 256, (3, *cfg["image_size"], 3), generator=g, dtype=torch.uint8)
    out = check.reference_outputs(cfg, sd, x, wl["dtype"], "cpu").half()
    values = check.numbers({"name": "answer_rel_l2", "params": sd, "inputs": x, "outputs": out},
                           cfg, "cpu", witness=check.witness(wl))
    assert values["answer_rel_l2_over_witness"] == pytest.approx(1.0)
    assert check.correct(check.judge(values, {"answer_rel_l2_over_witness": 3.5}), 0)
