"""The port's GPipe trunk on four gloo ranks (one spawned world for the
module, ``tests/torch_parallel_ranks.py``), against the plain forwards
(JAX oracles: tests/test_parallel_pipeline.py), and one pipelined AdamW step
against the unpipelined step and JAX's pipelined step on the same weights;
``hook_table``; and per-block remat."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.models.dpt import DPTConfig as JaxDPTConfig
from depth_estimation_tpu.parallel import mesh as jmesh
from depth_estimation_tpu.parallel.pipeline import dpt_apply_pipelined as jax_dpt_apply_pipelined
from depth_estimation_tpu.train import step as jstep
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.parallel.pipeline import gradient_owners, hook_table, stack_stage_params
from depth_estimation_tpu_torch.train.step import make_optimizer, make_train_step, trainable_tensors
from depth_estimation_tpu_torch.utils.convert import params_from_jax
from tests.oracles import dpt_torch as oracle
from tests.test_torch_train_step import SHIFT_ONLY, max_scaled_errors
from tests.torch_parallel_ranks import dpt, pipeline_world

# JAX's pipeline tests' tiny DPT, its hybrid and the ViT they share
FIELDS = dict(embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
              features=32, img_size=64, non_negative=False)
HYBRID_FIELDS = dict(FIELDS, reassemble_channels=(256, 512, 64, 64), hybrid=True)
TINY, JAX_TINY = DPTConfig(**FIELDS), JaxDPTConfig(**FIELDS)
LR = 1e-4


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TINY, seed=4).items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    gt = (rng.random((4, 64, 64)) + 0.1).astype(np.float32)
    return x, gt


@pytest.fixture(scope="module")
def world(hub_sd, batch):
    x, gt = batch
    return spawn(pipeline_world, 4, "cpu", FIELDS, HYBRID_FIELDS, FIELDS, hub_sd, x, gt)


def test_hook_table():
    """JAX ``test_hook_table``: even, ragged and error cases."""
    np.testing.assert_array_equal(hook_table((5, 11, 17, 23), 24, 4), [[5], [5], [5], [5]])
    np.testing.assert_array_equal(hook_table((5, 11, 17, 23), 24, 2), [[5, 11], [5, 11]])
    np.testing.assert_array_equal(hook_table((8, 11), 12, 2), [[0, 0], [2, 5]])  # DPT-Hybrid's
    np.testing.assert_array_equal(hook_table((0, 1, 2, 3), 24, 4)[0], [0, 1, 2, 3])
    with pytest.raises(ValueError):
        hook_table((5,), 24, 5)  # depth not divisible
    with pytest.raises(ValueError):
        hook_table((), 24, 4)  # no hooks
    with pytest.raises(ValueError):
        hook_table((24,), 24, 2)  # out of range


def test_stage_blocks_and_gradient_owners():
    assert list(stack_stage_params(24, 4, 2)) == list(range(12, 18))
    with pytest.raises(ValueError):
        stack_stage_params(24, 5, 0)
    names = [f"model.pretrained.model.blocks.{i}.attn.qkv.weight" for i in range(4)] + [
        "model.pretrained.model.cls_token", "model.scratch.output_conv.0.weight"]
    assert list(gradient_owners(names, 2).values()) == [0, 0, 1, 1, 0, 0]
    # DPT_Hybrid's ResNetV2 stem has ``blocks`` of its own; they run outside the pipe
    stem = [f"pretrained.model.patch_embed.backbone.stages.{s}.blocks.{b}.conv1.weight" for s, b in ((1, 3), (2, 8))]
    trunk = [f"pretrained.model.blocks.{i}.mlp.fc1.weight" for i in range(12)]
    owners = gradient_owners(stem + trunk, 4)
    assert [owners[k] for k in stem] == [0, 0] and [owners[k] for k in trunk] == [i // 3 for i in range(12)]


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipelined_vit_matches_plain(world, pp, microbatches):
    """JAX ``test_pipelined_vit_matches_plain`` at (dp=2, pp=2) and (dp=1, pp=4)."""
    for r in world:
        same_grid, same_count, err = r[f"vit_pp{pp}_m{microbatches}"]
        assert same_grid and same_count and err < 1e-5


def test_pipelined_dpt_forward_matches_plain(world):
    for r in world:
        assert r["dpt_pp4"] < 1e-4


def test_pipelined_hybrid_forward_matches_plain(world):
    """The ResNetV2 stem runs outside the pipe; both transformer hooks land in
    the last stage at pp=2 (a ragged hook table)."""
    for r in world:
        err, scale = r["hybrid_pp2"]
        assert err <= 1e-5 * scale


def test_pipeline_rejects_bad_shapes(world):
    for r in world:
        assert "batch 3 not divisible by microbatches=2" in r["bad_batch"]


def test_pipeline_chains_its_exchanges(world):
    """NCCL pairs sends and receives by order alone: on every stage, each
    microbatch's send (receive) node but the first leads to the previous
    one's, so both sides of a link run the backward's exchanges in the same
    order (M = 4 microbatches; stage 0 receives nothing, the last sends
    nothing)."""
    for pp in (2, 4):
        for rank, r in enumerate(world):
            stage = rank % pp
            sends, recvs = r[f"chain_pp{pp}"]["_SendBackward"], r[f"chain_pp{pp}"]["_RecvBackward"]
            assert sends == ((4, 3) if stage < pp - 1 else (0, 0)), (pp, rank, sends)
            assert recvs == ((4, 3) if stage > 0 else (0, 0)), (pp, rank, recvs)


def unpipelined_step(model, batch):
    """One AdamW step of ``model`` on one process: (loss, gradients, updated state dict)."""
    x, gt = batch
    step = make_train_step(model, make_optimizer(model, lr=LR))
    with torch.backends.mkldnn.flags(enabled=False):
        loss = float(step(torch.from_numpy(x[:4]).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(gt)))
    grads = {k: t.grad.numpy().copy() for k, t in trainable_tensors(model).items()}
    return loss, grads, {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def plain_step(hub_sd, batch):
    """The unpipelined step of the same model on one process."""
    model = DPT(TINY)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in hub_sd.items()})
    return unpipelined_step(model, batch)


@pytest.fixture(scope="module")
def plain_hybrid_step(batch):
    """The unpipelined step of the ranks' DPT_Hybrid (the port's random weights, seed 2)."""
    return unpipelined_step(dpt(HYBRID_FIELDS, seed=2), batch)


@pytest.fixture(scope="module")
def jax_pipelined_step(hub_sd, batch):
    """JAX's pipelined step (its ``test_pipelined_train_step``) on make_mesh(4, pp=4)."""
    x, gt = batch
    x = x[:4]
    variables = {"params": convert_dpt(hub_sd, JAX_TINY)}
    mesh = jmesh.make_mesh(4, pp=4)
    apply = lambda v, imgs: jax_dpt_apply_pipelined(v, imgs, JAX_TINY, mesh, microbatches=2)  # noqa: E731
    tx = jstep.make_optimizer(lr=LR)
    with mesh:
        state, loss = jstep.make_train_step(apply, tx, donate=False)(jstep.init_state(variables, tx), x, gt)
        grads = jax.jit(jax.grad(lambda v: jstep.loss_fn(apply, v, x, gt)))(variables)
    to_port = lambda tree: {k: v.numpy() for k, v in params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree["params"]), TINY).items()}
    return float(loss), to_port(grads), to_port(state.params)


def assert_updates_match(got, want, grads, lr=LR):
    """The tensors after one AdamW step against ``want``. The first update is
    lr·g/(|g| + eps) plus the decay, ±lr wherever |g| ≫ eps, so float noise
    moves a tensor only where it flips the sign of a gradient near zero (up
    to 2·lr, as JAX's pipeline test notes). Hence: within 2·lr everywhere,
    and within 1e-6 (a few f32 ulps of weights near 1, a hundredth of lr)
    where the reference gradient ``grads`` is over 1e-3 of its tensor's
    largest (the gradients agree to 1e-4 of it)."""
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * lr, (k, diff.max())
        if k in grads and k != SHIFT_ONLY:
            g = np.abs(grads[k])
            assert diff[g > 1e-3 * g.max()].max(initial=0) <= 1e-6, (k, diff[g > 1e-3 * g.max()].max())


@pytest.mark.parametrize("pp", [2, 4])
def test_pipelined_step_gradients_match_unpipelined(world, plain_step, pp):
    """Every gradient of the pipelined step equals the unpipelined step's,
    on every rank. Summing the decoder's copies of a hook's gradient over the
    stages would make the trunk's pp times too large (AdamW's first update
    hides a scale, so the gradients are compared). Max-scaled 1e-4, the head's
    last bias against the model's largest (test_torch_train_step.py)."""
    loss, grads, _ = plain_step
    for r in world:
        got = r[f"step_pp{pp}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert sorted(got["grads"]) == sorted(grads)
        errs = max_scaled_errors(got["grads"], grads)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-4, (worst, errs[worst])


@pytest.mark.parametrize("pp", [2, 4])
def test_pipelined_hybrid_step_matches_unpipelined(world, plain_hybrid_step, pp):
    """DPT_Hybrid's ResNetV2 stem runs outside the pipe on every rank and
    its ``stages.S.blocks.B`` tensors belong to stage 0, not to the stage of
    trunk block B: the loss, every gradient (max-scaled 1e-4) and every
    updated tensor equal the unpipelined step's, on every rank."""
    loss, grads, params = plain_hybrid_step
    for r in world:
        got = r[f"hybrid_step_pp{pp}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert sorted(got["grads"]) == sorted(grads)
        errs = max_scaled_errors(got["grads"], grads)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-4, (worst, errs[worst])
        assert_updates_match(got["params"], params, grads)


@pytest.mark.parametrize("pp", [2, 4])
def test_pipelined_step_updates_match_unpipelined(world, plain_step, pp):
    """Every updated tensor equals the unpipelined step's (``assert_updates_match``),
    and every rank holds the same weights after the step."""
    _, grads, params = plain_step
    for r in world:
        got = r[f"step_pp{pp}"]["params"]
        assert_updates_match(got, params, grads)
        for k in params:
            np.testing.assert_array_equal(got[k], world[0][f"step_pp{pp}"]["params"][k], err_msg=k)


def test_pipelined_step_matches_jax_pipelined_step(world, jax_pipelined_step):
    """(dp=1, pp=4) against JAX's pipelined step: the loss, every gradient
    (max-scaled 1e-4, test_torch_train_step.py's) and every updated tensor
    (``assert_updates_match``)."""
    jloss, jgrads, jparams = jax_pipelined_step
    got = world[0]["step_pp4"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    errs = max_scaled_errors(got["grads"], jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])
    assert_updates_match(got["params"], jparams, jgrads)


def test_remat_trunk_matches_plain():
    """JAX ``test_remat_trunk_matches_plain``: remat changes neither the state
    dict, the forward, the loss nor any gradient."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32))
    plain, remat = DPT(TINY), DPT(dataclasses.replace(TINY, remat=True))
    remat.load_state_dict(plain.state_dict())
    assert remat.pretrained.model.remat and not plain.pretrained.model.remat
    outs = []
    for model in (plain, remat):
        out = model(x)
        (out ** 2).sum().backward()
        outs.append((out.detach(), {k: p.grad for k, p in model.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, rtol=0, atol=0, msg=k)
