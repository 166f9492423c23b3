"""Sequence parallelism of the port (``parallel.mesh.sequence_parallel``,
``parallel/ops.py``) and kernel K1 with a key length of its own.

K1's plain version at Nq ≠ Nk is held against the JAX package's
``_attention_xla``. On eight gloo ranks (one spawned world for the module,
``tests/torch_parallel_ranks.py``), JAX's mesh of
``test_sp_sharded_forward_matches_plain``, dp2 × sp2 × tp2: the tiny DPT's
forward with its trunk's tokens over sp and its heads over tp against JAX's
``DPT(TINY).apply`` (1e-5 abs, JAX's own), and one AdamW step of it (with
remat) against the port's one-process step: the loss, every gradient and
every updated tensor."""

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.models.dpt import DPTConfig as JaxDPTConfig
from depth_estimation_tpu.ops.pallas.attention import _attention_xla
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.parallel.ops import token_counts
from depth_estimation_tpu_torch.train.step import make_optimizer, make_train_step, trainable_tensors
from tests.oracles import dpt_torch as oracle
from tests.test_torch_parallel_pipeline import assert_updates_match
from tests.test_torch_train_step import max_scaled_errors
from tests.torch_parallel_ranks import sp_world

# JAX's TINY of tests/test_parallel_pipeline.py: 2 heads of 32, 17 tokens at 64²
SP_FIELDS = dict(embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                 features=32, img_size=64, non_negative=False)
JAX_SP_TINY = JaxDPTConfig(**SP_FIELDS, use_pallas=False)
LR = 1e-4


# -- K1 with its own key length -----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_shape,nk", [((1, 2, 17, 64), 65), ((2, 3, 129, 64), 300)])
def test_attention_plain_with_its_own_key_length_matches_xla(rng, q_shape, nk, dtype):
    """softmax(QKᵀ/√D)V with Nk keys for Nq queries; f32 at 1e-5, bf16 as
    tests/test_torch_kernels.py's bf16 case (both round the probabilities
    and the output to bf16)."""
    import jax.numpy as jnp

    b, h, _, d = q_shape
    q = rng.standard_normal(q_shape).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(2))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tatt.multi_head_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.shape == q_shape and got.dtype == tdt
    want = np.asarray(_attention_xla(*(jnp.asarray(a, jdt) for a in (q, k, v)), d ** -0.5).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_attention_check_takes_its_own_key_length_and_nothing_else():
    """The wrapper's shape rule: B, H and D shared, Nq and Nk free; the
    alignment rule is unchanged (tests/test_torch_kernels.py)."""
    q, kv = torch.zeros((1, 16, 193, 64)), torch.zeros((1, 16, 769, 64))
    tatt._check(q, kv, kv)
    for k, v in [(torch.zeros((1, 8, 769, 64)),) * 2, (torch.zeros((2, 16, 769, 64)),) * 2,
                 (kv, torch.zeros((1, 16, 768, 64))), (torch.zeros((1, 16, 769, 32)),) * 2]:
        with pytest.raises(ValueError, match="one B, H and D"):
            tatt._check(q, k, v)
    with pytest.raises(ValueError, match="empty sequence"):
        tatt._check(q, kv[:, :, :0], kv[:, :, :0])


def test_fake_attention_takes_the_queries_shape():
    with torch.device("meta"):
        q, kv = torch.empty((1, 16, 385, 64)), torch.empty((1, 16, 769, 64))
    assert torch.ops.depth_tpu_torch.attention(q, kv, kv).shape == q.shape


# -- the mesh -----------------------------------------------------------------

def test_tokens_split_as_evenly_as_their_count_allows():
    assert token_counts(577, 2) == (289, 288)
    assert token_counts(769, 4) == (193, 192, 192, 192)
    assert token_counts(17, 2) == (9, 8) and sum(token_counts(5, 8)) == 5


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_SP_TINY, seed=11).items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    gt = (rng.random((2, 64, 64)) + 0.1).astype(np.float32)
    return x, gt


@pytest.fixture(scope="module")
def world(hub_sd, batch):
    x, gt = batch
    return spawn(sp_world, 8, "cpu", SP_FIELDS, hub_sd, np.ascontiguousarray(x.transpose(0, 3, 1, 2)), gt, LR)


@pytest.fixture(scope="module")
def single(hub_sd, batch):
    """The port's one-process step on the whole batch: loss, gradients, tensors after it."""
    x, gt = batch
    model = DPT(DPTConfig(**SP_FIELDS))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in hub_sd.items()})
    step = make_train_step(model, make_optimizer(model, lr=LR))
    with torch.backends.mkldnn.flags(enabled=False):
        loss = float(step(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(gt)))
    grads = {k: t.grad.numpy().copy() for k, t in trainable_tensors(model).items()}
    return loss, grads, {k: v.numpy().copy() for k, v in model.state_dict().items()}


def test_sp_mesh_coordinates(world):
    """dp outermost, tp innermost, as make_mesh lays out every mesh."""
    assert [tuple(r["coords"].values()) for r in world] == [(d, s, t) for d in (0, 1) for s in (0, 1)
                                                            for t in (0, 1)]
    assert all(r["sp_group_size"] == 2 for r in world)


def test_sp_attention_runs_local_queries_against_every_key(world):
    """17 tokens over sp 2: the sp rank 0 holds 9, rank 1 8, and each K1
    call takes them against all 17 keys, at one head of 32 (2 over tp 2)."""
    for r in world:
        n = 9 if r["coords"]["sp"] == 0 else 8
        assert r["attention_shapes"] == [((1, 1, n, 32), (1, 1, 17, 32))] * SP_FIELDS["depth"]


def test_sp_sharded_forward_matches_plain(world, hub_sd, batch):
    """JAX ``test_sp_sharded_forward_matches_plain``: the dp2 × sp2 × tp2
    forward equals JAX's replicated ``DPT(TINY).apply`` within 1e-5, every
    rank holding its dp slice."""
    x, _ = batch
    want = np.asarray(jax.jit(JaxDPT(JAX_SP_TINY).apply)({"params": convert_dpt(hub_sd, JAX_SP_TINY)}, x))
    for r in world:
        d = r["coords"]["dp"]
        np.testing.assert_allclose(r["forward"], want[d:d + 1], atol=1e-5)


def test_sp_step_loss_matches_single_process(world, single):
    loss, _, _ = single
    for r in world:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)


def test_sp_step_gradients_match_single_process(world, single):
    """Every gradient of the dp × sp × tp step (with remat), gathered over tp,
    equals the one-process step's within 1e-5 of its tensor's largest (the
    head's last bias against the model's). The trap: the blocks' gradients
    are partial over the tokens and must be summed over sp, the embedding's
    and the decoder's are whole and must not be; either mistake leaves the
    forward right and a gradient off by a factor."""
    _, grads, _ = single
    for r in world:
        assert sorted(r["grads"]) == sorted(grads)
        errs = max_scaled_errors(r["grads"], grads)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-5, (worst, errs[worst])


def test_sp_step_updates_match_single_process(world, single):
    """``assert_updates_match``; the tensors equal on every rank."""
    _, grads, params = single
    for r in world:
        assert_updates_match(r["params"], params, grads, LR)
        for k in params:
            np.testing.assert_array_equal(r["params"][k], world[0]["params"][k], err_msg=k)
