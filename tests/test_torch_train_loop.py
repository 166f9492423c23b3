"""The port's fit loop and data pipeline on the CPU: it learns from JAX's
initial weights, resumes bitwise, evaluates periodically, restarts its data,
and its data helpers give the JAX package's arrays."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu.train import data as jdata
from depth_estimation_tpu.train import loop as jloop
from depth_estimation_tpu_torch.config import PreprocessConfig
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.train import data as tdata
from depth_estimation_tpu_torch.train.loop import fit, synthetic_depth_dataset
from depth_estimation_tpu_torch.utils.checkpoint import load_train_state
from depth_estimation_tpu_torch.utils.convert import f2t_conv
from tests.oracles import midas_v21_torch as v21_oracle
from tests.test_torch_dpt import TINY as DPT_TINY
from tests.test_torch_midas_v21 import JAX_TINY as JAX_V21_TINY
from tests.test_torch_midas_v21 import TINY as V21_TINY
from tests.test_train_loop import _SmallDepthNet


class SmallDepthNet(nn.Module):
    """tests/test_train_loop.py's net on NHWC float batches: two 3×3 SAME
    convs with ReLU, a 1×1 to one channel."""

    def __init__(self):
        super().__init__()
        self.conv0, self.conv1, self.conv2 = nn.Conv2d(3, 16, 3, padding=1), nn.Conv2d(16, 16, 3, padding=1), \
            nn.Conv2d(16, 1, 1)

    def forward(self, x):
        h = F.relu(self.conv1(F.relu(self.conv0(x.permute(0, 3, 1, 2)))))
        return self.conv2(h)[:, 0]


def _small_nets(data):
    """JAX's net initialized from PRNGKey(0), and the port's with the same weights."""
    jmodel = _SmallDepthNet()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), data[0][0])
    net = SmallDepthNet()
    sd = {}
    for i in range(3):
        p = params["params"][f"Conv_{i}"]
        sd[f"conv{i}.weight"] = torch.from_numpy(f2t_conv(np.asarray(p["kernel"])).copy())
        sd[f"conv{i}.bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())
    net.load_state_dict(sd)
    return jmodel, params, net


def test_fit_learns_on_synthetic_depth():
    """tests/test_train_loop.py:21 on the port, from the same initial weights
    and data: the loss falls below 0.7 of its first logged value, and the
    first logged loss (after 10 AdamW steps) is JAX's."""
    data = synthetic_depth_dataset(batch=4, hw=(32, 32), n_batches=4)
    jmodel, params, net = _small_nets(data)
    _, jhist = jloop.fit(jmodel.apply, params, jloop.synthetic_depth_dataset(batch=4, hw=(32, 32), n_batches=4),
                         steps=10, lr=3e-3, alpha=0.0, verbose=False)
    _, hist = fit(net, data, steps=60, lr=3e-3, alpha=0.0, verbose=False, device="cpu")
    first, last = hist[0][1], hist[-1][1]
    np.testing.assert_allclose(first, jhist[0][1], rtol=1e-3)
    assert np.isfinite(last)
    assert last < first * 0.7, (first, last)


def test_fit_checkpoint_resume_is_bitwise(tmp_path):
    """10 steps with checkpoints every 5, then a resumed run to 20: the same
    losses and the same tensors, bit for bit, as 20 straight steps; the
    checkpoint restores the saved tensors exactly."""
    data = synthetic_depth_dataset(batch=2, hw=(16, 16), n_batches=2)
    torch.manual_seed(0)
    init = SmallDepthNet().state_dict()

    def net():
        n = SmallDepthNet()
        n.load_state_dict(init)
        return n

    state_a, hist_a = fit(net(), data, steps=20, lr=1e-3, alpha=0.0, log_every=1, verbose=False, device="cpu")
    ck = tmp_path / "run"
    state_h, _ = fit(net(), data, steps=10, lr=1e-3, alpha=0.0, ckpt_dir=str(ck), ckpt_every=5, verbose=False,
                     device="cpu")
    probe = fit(net(), data, steps=10, lr=1e-3, ckpt_dir=str(ck), verbose=False, device="cpu")[0]
    assert probe.step == 10
    for k, v in state_h.model.state_dict().items():
        assert torch.equal(probe.model.state_dict()[k], v), k
    state_b, hist_b = fit(net(), data, steps=20, lr=1e-3, alpha=0.0, ckpt_dir=str(ck), ckpt_every=5,
                          log_every=1, verbose=False, device="cpu")
    assert state_b.step == 20
    assert [l for _, l in hist_b] == [l for s, l in hist_a if s > 10]
    for k, v in state_a.model.state_dict().items():
        assert torch.equal(state_b.model.state_dict()[k], v), k
    # the file holds the step-20 state now, optimizer moments included
    restored = load_train_state(ck / "state", fit(net(), data, steps=0, verbose=False, device="cpu")[0])
    assert restored.step == 20
    for pa, pb in zip(state_a.optimizer.state.values(), restored.optimizer.state.values()):
        assert torch.equal(pa["exp_avg_sq"], pb["exp_avg_sq"])


def test_fit_with_periodic_eval():
    data = synthetic_depth_dataset(batch=4, hw=(32, 32), n_batches=4)
    eval_data = synthetic_depth_dataset(batch=4, hw=(32, 32), n_batches=2, seed=9)
    torch.manual_seed(0)
    state, hist = fit(SmallDepthNet(), data, steps=40, lr=3e-3, alpha=0.0, verbose=False, eval_data=eval_data,
                      eval_every=20, device="cpu")
    evals = [h for h in hist if len(h) == 3]
    assert [s for s, _, _ in evals] == [20, 40]
    for _, _, m in evals:
        assert set(m) >= {"abs_rel", "rmse", "d1"}
        assert np.isfinite(m["abs_rel"]) and 0.0 <= m["d1"] <= 1.0
    assert evals[-1][2]["abs_rel"] <= evals[0][2]["abs_rel"] * 1.5


def test_fit_midas_v21_tiny_learns():
    """tests/test_train_loop.py::test_fit_midas_v21_tiny on the port, on the
    JAX package's tiny config with the hub-keyed oracle's random weights (K4
    and the frozen batch norms' four tensors trained): the SSI loss falls
    below 0.9 of its first logged value."""
    data = synthetic_depth_dataset(batch=2, hw=(64, 64), n_batches=2)
    model = MidasV21(V21_TINY)
    model.load_state_dict(v21_oracle.make_random_state_dict(JAX_V21_TINY, seed=7))

    class NHWC(nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, x):
            return self.m(x.permute(0, 3, 1, 2).contiguous())

    _, hist = fit(NHWC(model), data, steps=30, lr=3e-3, alpha=0.0, verbose=False, device="cpu")
    assert np.isfinite(hist[-1][1]) and hist[-1][1] < hist[0][1] * 0.9, hist


def test_fit_from_raw_u8_batches_restarts_the_dataset():
    """u8 batches → device_prefetch → fit with TrainingApply (K2, a tiny DPT,
    K3 on their plain versions); 5 steps over a 2-batch epoch restart it
    twice; a bare generator fails loudly on restart. (fit(mesh=) and
    device_prefetch(mesh=): tests/test_torch_parallel_train.py.)"""
    model = DPT(DPT_TINY)
    pre = PreprocessConfig(target_height=64, target_width=64, keep_aspect_ratio=False, ensure_multiple_of=32)
    apply = tdata.TrainingApply(model, pre, net_hw=(64, 64))
    data = tdata.device_prefetch(tdata.batches(tdata.synthetic_pairs(4, 48, 64, seed=2), 2), device="cpu")
    state, hist = fit(apply, data, steps=5, verbose=False, log_every=1, device="cpu")
    assert state.step == 5 and len(hist) == 5 and all(np.isfinite(l) for _, l in hist)

    def one_shot():
        yield from iter(tdata.batches(tdata.synthetic_pairs(4, 48, 64, seed=2), 2))

    with pytest.raises(ValueError, match="re-iterable"):
        fit(apply, one_shot(), steps=5, verbose=False, device="cpu")


# -- data helpers: the JAX package's arrays ------------------------------------

def _assert_same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u = u.numpy() if isinstance(u, torch.Tensor) else u
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def test_data_helpers_give_jax_arrays(tmp_path):
    _assert_same_batches(synthetic_depth_dataset(3, (20, 28), n_batches=3, seed=4),
                         jloop.synthetic_depth_dataset(3, (20, 28), n_batches=3, seed=4))
    _assert_same_batches(tdata.synthetic_pairs(5, 16, 24, seed=3), jdata.synthetic_pairs(5, 16, 24, seed=3))
    for kw in ({"epochs": 2, "seed": 7}, {"shuffle": False, "drop_remainder": False}):
        _assert_same_batches(tdata.batches(tdata.synthetic_pairs(10, 16, 24), 4, **kw),
                             jdata.batches(jdata.synthetic_pairs(10, 16, 24), 4, **kw))
    rng = np.random.default_rng(0)
    (tmp_path / "scene").mkdir()
    for i in range(3):
        np.savez(tmp_path / ("scene" if i else ".") / f"s{i}.npz", image=rng.integers(0, 256, (8, 12, 3), np.uint8),
                 disparity=rng.random((8, 12)).astype(np.float64))
    _assert_same_batches(tdata.iter_npz_dir(tmp_path), jdata.iter_npz_dir(tmp_path))
    with pytest.raises(FileNotFoundError):
        list(tdata.iter_npz_dir(tmp_path / "nope"))


def test_device_prefetch_restarts_and_keeps_values():
    host = tdata.batches(tdata.synthetic_pairs(12, 8, 12), 4, shuffle=False)
    dev = tdata.device_prefetch(host, size=2, device="cpu")
    for _ in range(2):  # a re-iterable source restarts through the prefetcher
        _assert_same_batches(dev, host)
    with pytest.raises(ValueError, match="empty dataset"):
        tdata.batches([], 2)
