"""The port's per-layer profile CLI (``cli/profile.py``) on the CPU at the
tiny widths of tests/test_pallas.py: the JAX tool's 20 attribution
points, its prefix and marginal forwards (held against the JAX ones on
the same parameters), and the table's JSON schema."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastdepth_tpu.cli import profile as JP
from fastdepth_tpu.models import build as jax_build
from fastdepth_tpu_torch.checkpoint import params_to_jax
from fastdepth_tpu_torch.cli import profile as TP
from fastdepth_tpu_torch.config import ModelConfig
from fastdepth_tpu_torch.models import build
from torch_port_config import to_jax
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)

TINY_ENC = (4, 6, 8, 10, 12, 14, 16, 16, 16, 16, 16, 16, 20, 24)
TINY_DEC = (18, 14, 10, 6, 4)
CFG = ModelConfig(encoder_channels=TINY_ENC, decoder_channels=TINY_DEC)
JCFG = to_jax(CFG)


@pytest.fixture
def tiny_model(monkeypatch):
    """The CLI's model at the tiny widths (whichever --model is named)."""
    monkeypatch.setattr(TP, "_model", lambda name: build(CFG))


@pytest.fixture(scope="module")
def same_params():
    """One folded tiny parameter tree in both packages (drawn by the
    port's init, handed to JAX as its npz tree), and an input."""
    model = build(CFG)
    params = model.fold(model.init(torch.Generator().manual_seed(0)))
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params.state_dict()))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    return jax_build(JCFG), jparams, model, params, x


def test_points_are_the_jax_tools():
    assert TP.prefix_points(CFG) == JP.prefix_points(JCFG)
    assert len(TP.prefix_points(CFG)) == 20


@pytest.mark.parametrize("upto", [1, 6, 14, 16, 19, 20])
def test_prefix_forward_matches_the_jax_one(same_params, upto):
    jm, jparams, model, params, x = same_params
    want = float(jax.jit(JP.make_prefix_fn(jm, JCFG, upto))(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = float(TP.make_prefix_fn(model, CFG, upto)(params, torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("dup", [None, 1, 5, 15, 20])
def test_marginal_forward_at_eps_zero_is_the_full_forward(same_params, dup):
    jm, jparams, model, params, x = same_params
    eps = torch.tensor(0.0)
    with torch.inference_mode():
        full = float(TP.make_prefix_fn(model, CFG, 20)(params, torch.from_numpy(x)))
        got = float(TP.make_marginal_fn(model, CFG, dup)(params, torch.from_numpy(x), eps))
    want = float(jax.jit(JP.make_marginal_fn(jm, JCFG, dup))(jparams, jnp.asarray(x),
                                                            jnp.float32(0.0)))
    assert got == full
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("mode", ["prefix", "marginal"])
def test_profile_cli_on_cpu_prints_the_20_rows_and_writes_the_schema(tmp_path, capsys, mode,
                                                                    tiny_model):
    out = tmp_path / "profile.json"
    payload = TP.main(["--device", "cpu", "--batch", "2", "--image-size", "64", "--calls", "1",
                       "--mode", mode, "--json", str(out)])
    text = capsys.readouterr().out
    assert "full forward:" in text and "cpu us" in text and "sum of bounds:" in text
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(payload))
    assert set(saved) == {"batch", "dtype", "model", "mode", "device", "full_us", "fps",
                          "sum_bounds_us", "layer_sum_us", "layers", "peaks"}
    assert saved["device"] == {"type": "cpu"} and saved["mode"] == mode
    assert [r["layer"] for r in saved["layers"]] == [p for p, _ in JP.prefix_points(JCFG)]
    for r in saved["layers"]:
        assert set(r) == {"layer", "measured_us", "bound_us", "x_bound", "macs", "hbm_bytes"}
        assert r["bound_us"] > 0 and r["macs"] > 0 and r["hbm_bytes"] > 0
    assert saved["sum_bounds_us"] == pytest.approx(sum(r["bound_us"] for r in saved["layers"]))
    assert "H100" in saved["peaks"]["card"]


def test_layer_roofline_rows_scale_with_batch():
    ceil = TP.RL.load_ceilings(4)
    one = TP.layer_roofline(CFG, 1, 64, 4, ceil)
    many = TP.layer_roofline(CFG, 8, 64, 4, ceil)
    assert [r[0] for r in one] == [p for p, _ in TP.prefix_points(CFG)]
    for (_, m1, b1, s1), (_, m8, b8, s8) in zip(one, many):
        assert (m8, b8) == (8 * m1, 8 * b1) and s8 == pytest.approx(8 * s1)


def test_profile_cli_rejects_a_cuda_run_without_a_card(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.main(["--device", "cuda", "--batch", "1", "--image-size", "64"])
