"""On the card: every cell runs through the command the driver runs
and comes out correct, and the TF32 control of the f32 cell comes out
not correct (on the CPU TF32 does not exist).  Skips without a card.

    python -m pytest perfbench/tests/test_pb_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness

pytestmark = pytest.mark.cuda


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", harness.cells())
def test_a_cell_runs_correct_on_the_card(cell):
    need_card()
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell,
                           "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_the_tf32_control_of_the_f32_cell_is_not_correct():
    need_card()
    import torch

    from perfbench import check, program

    wl = harness.workload("fastdepth.deploy-b1")
    cfg = harness.config(wl["config"])
    assert check.CONTROLS[wl["dtype"]] == "tf32"
    sd = program.draw_params(cfg, 2 ** 31 + 5, "cuda")
    x = torch.rand((4, *cfg["image_size"], 3), device="cuda")
    samples = {"name": "pred_rel_l2", "params": sd, "inputs": x,
               "outputs": torch.zeros((4, *cfg["image_size"], 1))}
    values = check.numbers(samples, cfg, "cuda", control="tf32")
    assert not check.correct(check.judge(values, wl["limits"]), 0)
