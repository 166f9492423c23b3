"""The port's sharded training on four gloo ranks (one spawned world for the
module, ``tests/torch_parallel_ranks.py``): a (dp=2, tp=2) AdamW step of the
preprocess-fused tiny DPT against the one-process step and JAX's sharded
step on the same weights and u8 batches, ``fit(mesh=)`` and its resume from
a checkpoint, and ``device_prefetch(mesh=)``. Tolerances are
tests/test_torch_train_step.py's (the ranks run with oneDNN off, as it
does); against JAX's sharded loss, JAX's own rtol 5e-4 between its sharded
and one-device losses (tests/test_parallel_train.py:110)."""

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.parallel import mesh as jmesh
from depth_estimation_tpu.train import step as jstep
from depth_estimation_tpu.train.data import batches, make_training_apply, synthetic_pairs
from depth_estimation_tpu_torch.config import DPT_PREPROCESS
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.train.data import TrainingApply
from depth_estimation_tpu_torch.train.step import make_optimizer, make_train_step, trainable_tensors
from depth_estimation_tpu_torch.utils.checkpoint import load_train_state
from tests.test_torch_train_step import (DPT128, JAX_DPT128, JAX_DPT_PREPROCESS, LR, NET_HW, SRC_HW, _family,
                                         max_scaled_errors)
from tests.test_torch_parallel_pipeline import assert_updates_match
from tests.torch_parallel_ranks import train_world

BATCH = 4  # dp=2 slices of 2


@pytest.fixture(scope="module")
def setup():
    _, _, jparams, to_port, _, _ = _family("dpt")
    (imgs, gt), = list(batches(synthetic_pairs(BATCH, *SRC_HW, seed=5), BATCH, shuffle=False))
    hub_sd = {k: v.numpy() for k, v in to_port(jparams).items()}
    return jparams, to_port, hub_sd, imgs, gt


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel_train")


@pytest.fixture(scope="module")
def world(setup, root):
    _, _, hub_sd, imgs, gt = setup
    fields = {f: getattr(DPT128, f) for f in DPT128.__dataclass_fields__}
    return spawn(train_world, 4, "cpu", fields, hub_sd, imgs, gt, NET_HW, LR, str(root))


@pytest.fixture(scope="module")
def single(setup):
    """The one-process step: loss, gradients and updated tensors, then two more losses."""
    _, _, hub_sd, imgs, gt = setup
    from depth_estimation_tpu_torch.models.dpt import DPT

    model = DPT(DPT128)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in hub_sd.items()})
    step = make_train_step(TrainingApply(model, DPT_PREPROCESS, net_hw=NET_HW), make_optimizer(model, lr=LR))
    imgs_t, gt_t = torch.from_numpy(imgs), torch.from_numpy(gt)
    with torch.backends.mkldnn.flags(enabled=False):
        losses = [float(step(imgs_t, gt_t))]
        grads = {k: t.grad.numpy().copy() for k, t in trainable_tensors(model).items()}
        params = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        losses += [float(step(imgs_t, gt_t)) for _ in range(2)]
    return losses, grads, params


@pytest.fixture(scope="module")
def jax_sharded(setup):
    """JAX's (dp=2, tp=2) step on make_mesh(4, tp=2): three losses and the
    tensors after the first."""
    jparams, to_port, _, imgs, gt = setup
    japply = make_training_apply(jax_dpt128(), JAX_DPT_PREPROCESS, net_hw=NET_HW)
    tx = jstep.make_optimizer(lr=LR)
    mesh = jmesh.make_mesh(4, tp=2)
    step = jstep.make_train_step(japply, tx, donate=False)
    with mesh:
        state = jstep.init_state({"params": jparams}, tx, mesh=mesh)
        xb, gb = jstep.shard_batch(imgs, mesh), jstep.shard_batch(gt, mesh)
        losses, params = [], None
        for _ in range(3):
            state, loss = step(state, xb, gb)
            losses.append(float(loss))
            params = params or jax.tree_util.tree_map(np.asarray, state.params["params"])
    return losses, {k: v.numpy() for k, v in to_port(params).items()}


def jax_dpt128():
    from depth_estimation_tpu.models.dpt import DPT as JaxDPT

    return JaxDPT(JAX_DPT128)


def test_dp_tp_step_loss_matches_single_device(world, single):
    losses, _, _ = single
    for r in world:
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)


def test_dp_tp_step_gradients_match_single_device(world, single):
    """Every gradient of the (dp=2, tp=2) step, gathered, equals the one-process
    step's. Without the Megatron operators' backward all-reduce before qkv
    and fc1, the LayerNorms' and embeddings' would miss the other rank's heads."""
    _, grads, _ = single
    for r in world:
        assert sorted(r["grads"]) == sorted(grads)
        errs = max_scaled_errors(r["grads"], grads)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-4, (worst, errs[worst])


def test_dp_tp_step_updates_match_single_device(world, single):
    """tests/test_torch_parallel_pipeline.py's ``assert_updates_match``; equal on every rank."""
    _, grads, params = single
    for r in world:
        assert_updates_match(r["params"], params, grads)
        for k in params:
            np.testing.assert_array_equal(r["params"][k], world[0]["params"][k], err_msg=k)


def test_every_rank_starts_from_rank_zeros_weights(world, single):
    """Each rank was handed weights shifted by its rank: init_state(mesh=)
    broadcasts rank 0's, so the first loss is the unshifted model's on every rank."""
    losses, _, _ = single
    assert all(abs(r["losses"][0] - losses[0]) <= 1e-5 * abs(losses[0]) for r in world)


def test_optimizer_moments_take_the_shards_shape(world):
    for r in world:
        assert r["local_qkv_rows"] == r["moment_rows"] == 3 * DPT128.embed_dim // 2


def test_dp_tp_step_matches_jax_sharded_step(world, jax_sharded, single):
    """The three losses and the first step's updated tensors
    (``assert_updates_match``, its well-conditioned elements picked by the
    one-process gradients) against JAX's sharded step. The gradients are held
    against the one-process step above, which tests/test_torch_train_step.py
    holds against JAX's."""
    jlosses, jparams = jax_sharded
    _, grads, _ = single
    for r in world:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=5e-4)
        assert_updates_match(r["params"], jparams, grads, LR)


def test_fit_on_a_mesh_resumes_to_the_straight_run(world):
    """JAX ``test_sharded_train_resume``: a run stopped at a checkpoint after
    two steps and resumed logs the straight run's losses for steps 3 and 4."""
    for r in world:
        straight, resumed = dict(r["straight"]), dict(r["resumed"])
        assert sorted(straight) == [1, 2, 3, 4] and sorted(resumed) == [3, 4]
        np.testing.assert_allclose([resumed[3], resumed[4]], [straight[3], straight[4]], rtol=1e-5)
        assert len({round(v, 7) for v in straight.values()}) == 4  # it trains


def test_sharded_checkpoint_is_the_single_device_format(world, root):
    """The checkpoint holds the whole state: it loads into a one-process train state."""
    from depth_estimation_tpu_torch.models.dpt import DPT
    from depth_estimation_tpu_torch.train.step import TrainState

    apply = TrainingApply(DPT(DPT128), DPT_PREPROCESS, net_hw=NET_HW)
    state = load_train_state(root / "ckpt" / "state", TrainState(apply, make_optimizer(apply, lr=LR)))
    assert state.step == 4
    qkv = trainable_tensors(apply)["model.pretrained.model.blocks.0.attn.qkv.weight"]
    assert state.optimizer.state[qkv]["exp_avg"].shape == qkv.shape == (3 * DPT128.embed_dim, DPT128.embed_dim)


def test_device_prefetch_yields_each_ranks_slice_and_restarts(world, setup):
    _, _, _, imgs, gt = setup
    want = [(imgs, gt), (imgs[::-1], gt[::-1])]
    for r in world:
        d = r["dp_rank"]
        for epoch in r["prefetch"]:
            assert len(epoch) == 2
            for (sharded, im, g), (wim, wg) in zip(epoch, want):
                assert sharded
                np.testing.assert_array_equal(im, wim[2 * d:2 * d + 2])
                np.testing.assert_array_equal(g, wg[2 * d:2 * d + 2])
