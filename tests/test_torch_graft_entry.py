"""The port's graft entry points (``fastdepth_tpu_torch/graft_entry.py``)
against the root ``__graft_entry__.py``, on the CPU: ``entry``'s forward
against JAX's ``entry()`` forward on the same parameters, the multi-device
dry run over four gloo ranks, and the refusals without a card."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fastdepth_tpu.models as jax_models

from fastdepth_tpu_torch import graft_entry as G
from fastdepth_tpu_torch.checkpoint import params_from_jax
from fastdepth_tpu_torch.models import fastdepth_pruned

from torch_threads import child_env  # torch's CPU threads: a share per xdist worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_S = 300


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_forward_matches_the_jax_entry_forward(monkeypatch):
    """JAX's ``entry()`` with its ``model.init(PRNGKey(0))`` jitted (eager,
    it compiles every op: ~19 s), that unfolded tree carried across with
    ``params_from_jax`` and folded by the port; both forwards at b2 on
    the same seeded frames, atol 1e-3 / rtol 1e-4 (28 f32 conv layers
    summed in another order, tests/test_torch_models.py's bound)."""
    trees = []
    real = jax_models.fastdepth_pruned

    def jitted_init():
        model = real()

        def init(key):
            trees.append(jax.jit(model.init)(key))
            return trees[-1]
        return dataclasses.replace(model, init=init)

    monkeypatch.setattr(jax_models, "fastdepth_pruned", jitted_init)
    jfwd, (jparams, jzeros) = _jax_graft_entry().entry()
    assert jzeros.shape == (8, 224, 224, 3) and jzeros.dtype == jnp.float32
    x = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    want = np.asarray(jax.jit(jfwd)(jparams, jnp.asarray(x)))

    fwd, (params, zeros) = G.entry(device="cpu")
    assert tuple(zeros.shape) == (8, 224, 224, 3) and zeros.dtype == torch.float32
    assert not zeros.any()
    model = fastdepth_pruned()
    port = model.fold(model.load(params_from_jax(jax.tree.map(np.asarray, trees[0]))))
    got = fwd(port, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 224, 224, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
    # entry's own params: the port's seeded init, folded, a finite forward
    own = fwd(params, zeros)
    assert tuple(own.shape) == (8, 224, 224, 1) and torch.isfinite(own).all()


def test_dryrun_multichip_over_four_gloo_ranks():
    """``python -m fastdepth_tpu_torch.graft_entry multichip 4 --device
    cpu``: the DP train steps, the DP Evaluator and the 1 x 4 (data,
    space) Evaluator equal to one device's, the device-augment step; its
    ``ok`` line."""
    proc = subprocess.run([sys.executable, "-m", "fastdepth_tpu_torch.graft_entry", "multichip",
                           "4", "--device", "cpu"], cwd=REPO, env=child_env(PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=DRYRUN_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ok = [s for s in proc.stdout.splitlines() if s.startswith("dryrun_multichip(4) ok:")]
    assert len(ok) == 1, proc.stdout
    assert "FASTDEPTH_PRUNED@224 b8" in ok[0]
    assert "across 10 metrics x 8 images" in ok[0]
    assert "spatial eval == single-device over a 1x4 (data, space) mesh too" in ok[0]
    assert "device-augment train step sharded over 'data' ok" in ok[0]


def test_dryrun_multichip_refuses_without_the_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two CUDA devices")
    with pytest.raises(SystemExit, match=f"need 2 devices for the mesh, have "
                                         f"{torch.cuda.device_count()}"):
        G.dryrun_multichip(2)


def test_entry_cli_refuses_without_a_card_and_runs_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cmd = [sys.executable, "-m", "fastdepth_tpu_torch.graft_entry"]
    env = child_env(PYTHONPATH=REPO)
    refused = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=DRYRUN_S)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr
    ran = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=DRYRUN_S)
    assert ran.returncode == 0, ran.stderr[-3000:]
    assert ran.stdout.strip().splitlines()[-1] == "entry ok: (8, 224, 224, 1) float32"
