"""What the benchmark imports and reads: nothing of JAX or the JAX
package anywhere; nothing of the program in the references and the
traffic; no process-wide switch of torch's backends left set."""

from __future__ import annotations

import ast
import glob
import os

import pytest

from perfbench import harness

PKG = os.path.join(harness.ROOT, "perfbench")
SOURCES = sorted(os.path.relpath(p, harness.ROOT)
                 for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True))
FORBIDDEN = {"jax", "jaxlib", "flax", "fastdepth_tpu"}


def imported(path: str) -> set:
    """Top-level names of every module a source imports."""
    with open(os.path.join(harness.ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_sees_every_part():
    for part in ("run.py", "harness.py", "check.py", "trace.py", "reference/common.py",
                 "traffic/client.py", "entries/serve_socket.py", "metrics/mfu_pct.py"):
        assert os.path.join("perfbench", part) in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_and_no_jax_package(path):
    # compared whole: fastdepth_tpu_torch begins with fastdepth_tpu
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.split(os.sep)[1] in ("reference", "traffic")])
def test_references_and_traffic_import_nothing_of_the_program(path):
    assert "fastdepth_tpu_torch" not in imported(path)


@pytest.mark.parametrize("path", [p for p in SOURCES if p.split(os.sep)[1] != "tests"])
def test_no_source_names_the_jax_packages_files(path):
    with open(os.path.join(harness.ROOT, path)) as f:
        strings = [n.value for n in ast.walk(ast.parse(f.read()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for s in strings:
        assert "BENCH_" not in s and not s.startswith("fastdepth_tpu/") and s != "bench.py"


@pytest.mark.parametrize("path", SOURCES)
def test_backend_switches_are_set_only_where_they_are_restored(path):
    with open(os.path.join(harness.ROOT, path)) as f:
        tree = ast.parse(f.read())
    sets = [n for n in ast.walk(tree) if isinstance(n, (ast.Assign, ast.AugAssign))
            and "torch.backends" in ast.unparse(n.targets[0] if isinstance(n, ast.Assign)
                                                else n.target)]
    if path == os.path.join("perfbench", "reference", "common.py"):
        assert sets  # tf32(): set inside the block, restored after it
    else:
        assert not sets


def test_tf32_block_restores_the_switches():
    import torch

    from perfbench.reference import common as C

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with C.tf32(not before[0]):
        assert torch.backends.cudnn.allow_tf32 == (not before[0])
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_a_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from perfbench import run

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "fastdepth_tpu_torch_like", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]
