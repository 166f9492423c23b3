"""Slice criterion 3: each of the four families at full scale, the port
against the JAX package's DepthEstimator on the CPU, on the same random
hub-keyed weights and the same small frame, within the package's accuracy
gate (max abs-rel < 1e-3, BASELINE.md:23). The ``full`` tier: run with
``--full``; it builds full-size models in both packages."""

import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict


@pytest.mark.full
@pytest.mark.parametrize("name", ["DPT_Large", "DPT_Hybrid", "MiDaS_small", "MiDaS"])
def test_full_scale_port_holds_jax_within_the_gate(name):
    with torch.device("meta"):
        model = treg.get_entry(name).make_model()
    sd = random_state_dict(model, seed=0)
    port = DepthEstimator(name, params=sd, verbose=False, device="cpu")
    ref = JaxEstimator(name, params=jreg.get_entry(name).convert({k: v.numpy() for k, v in sd.items()}),
                       verbose=False)
    img = np.random.default_rng(0).integers(0, 256, (96, 128, 3), np.uint8)
    want, got = ref.predict(img), port.predict(img)
    assert got.shape == want.shape == (96, 128) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) / scale < 1e-3
