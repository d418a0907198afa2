"""The port's metrics against the JAX package's on the same predictions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastdepth_tpu import metrics as JM
from fastdepth_tpu_torch import metrics as TM
import torch_threads  # noqa: F401  (torch's CPU threads: a share per xdist worker)


def _batch(rng, n=4, size=16):
    """Predictions and targets with zeros in both, an image whose target is
    all zero, and an image with no valid pixel at all (0/0 means)."""
    out = rng.uniform(0.2, 8.0, (n, size, size, 1)).astype(np.float32)
    tgt = rng.uniform(0.5, 9.0, (n, size, size, 1)).astype(np.float32)
    out[rng.rand(*out.shape) < 0.2] = 0.0
    tgt[rng.rand(*tgt.shape) < 0.3] = 0.0
    tgt[1] = 0.0
    out[2] = 0.0
    tgt[2] = 0.0
    return out, tgt


def test_evaluate_batch_matches_jax(rng):
    out, tgt = _batch(rng)
    want = JM.evaluate_batch(jnp.asarray(out), jnp.asarray(tgt))
    got = TM.evaluate_batch(torch.from_numpy(out), torch.from_numpy(tgt))
    assert set(got) == set(want) == set(TM.METRIC_FIELDS) == set(JM.METRIC_FIELDS)
    for f in TM.METRIC_FIELDS:
        assert got[f].dtype == torch.float32 and tuple(got[f].shape) == (4,)
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=1e-6,
                                   equal_nan=True, err_msg=f)
    assert np.isnan(got["rmse"][2].item())  # no valid pixel: NaN, as in JAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_evaluate_batch_takes_low_precision_predictions(rng, dtype):
    out, tgt = _batch(rng)
    out = torch.from_numpy(out).to(dtype)
    got = TM.evaluate_batch(out, torch.from_numpy(tgt))
    want = JM.evaluate_batch(jnp.asarray(out.float().numpy()), jnp.asarray(tgt))
    for f in TM.METRIC_FIELDS:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), rtol=1e-6,
                                   equal_nan=True, err_msg=f)


def test_average_meter_and_result_match_jax(rng):
    jm, tm = JM.AverageMeter(), TM.AverageMeter()
    for i in range(3):
        out, tgt = _batch(rng, n=3)
        out[:] = np.maximum(out, 0.3)  # keep every image's mean finite
        vals = {k: np.asarray(v) for k, v in
                TM.evaluate_batch(torch.from_numpy(out), torch.from_numpy(tgt)).items()}
        jm.update_batch(vals, gpu_time=0.01 * i, data_time=0.002)
        tm.update_batch(vals, gpu_time=0.01 * i, data_time=0.002)
    single = JM.Result(**{f: float(vals[f][0]) for f in JM.METRIC_FIELDS})
    jm.update(single, gpu_time=0.5, n=2)
    tm.update(TM.Result(**single.as_dict()), gpu_time=0.5, n=2)
    assert jm.average().as_dict() == tm.average().as_dict()
    assert TM.Result().set_to_worst().as_dict() == JM.Result().set_to_worst().as_dict()
