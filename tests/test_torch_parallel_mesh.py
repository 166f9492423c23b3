"""The port's mesh, tensor-parallel rules and sharded predictors on four gloo
ranks (one spawned world for the module, ``tests/torch_parallel_ranks.py``),
held against the port's one-process predictors and the JAX package's
sharded ones on the same weights; and the port's ``dryrun_multichip``.

The tiny DPT has 4 heads (head_dim 16), so that tp ∈ {2, 4} split whole
heads on both sides of each parity test: the port shards attention by head
and refuses ``num_heads % tp`` (JAX's GSPMD takes tp=8 on 2 heads)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import PreprocessConfig as JaxPreprocessConfig
from depth_estimation_tpu.estimator import DepthEstimator as JaxEstimator
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.models.dpt import DPTConfig as JaxDPTConfig
from depth_estimation_tpu.parallel import mesh as jmesh
from depth_estimation_tpu.utils.convert import convert_dpt
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.models.dpt import DPTConfig
from depth_estimation_tpu_torch.models.vit import Attention
from depth_estimation_tpu_torch.parallel.dryrun import dryrun_multichip
from depth_estimation_tpu_torch.parallel.launch import spawn
from depth_estimation_tpu_torch.parallel.mesh import Split, make_mesh, param_pspecs, shard_params, unshard_params
from tests.oracles import dpt_torch as oracle
from tests.test_torch_midas_v21 import TINY_FIELDS as V21_FIELDS
from tests.torch_parallel_ranks import TINY_PREPROCESS, mesh_world

TP_FIELDS = dict(embed_dim=64, depth=4, num_heads=4, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                 features=32, img_size=64)
TP_TINY, JAX_TP_TINY = DPTConfig(**TP_FIELDS), JaxDPTConfig(**TP_FIELDS)
QKV = "pretrained.model.blocks.0.attn.qkv"


@pytest.fixture(scope="module")
def hub_sd():
    return {k: v.numpy() for k, v in oracle.make_random_state_dict(JAX_TP_TINY, seed=3).items()}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (96, 128, 3), np.uint8), rng.integers(0, 256, (4, 96, 128, 3), np.uint8)


@pytest.fixture(scope="module")
def world(hub_sd, frames):
    img, imgs = frames
    return spawn(mesh_world, 4, "cpu", TP_FIELDS, hub_sd, V21_FIELDS, img, imgs)


@pytest.fixture(scope="module")
def jax_estimator(hub_sd):
    jreg.register(jreg.ModelEntry("TinyDPT_parallel_jax", lambda: JaxDPT(JAX_TP_TINY),
                                  JaxPreprocessConfig(**TINY_PREPROCESS), lambda sd: sd))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxEstimator("TinyDPT_parallel_jax", params=convert_dpt(hub_sd, JAX_TP_TINY), verbose=False)


def _max_scaled(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-8))


def test_mesh_shapes_and_axis_names(world):
    """JAX ``test_mesh_shapes`` / ``test_mesh_4d_axes`` on four ranks."""
    for r in world:
        assert r["mesh_2"] == (("dp", "tp"), {"dp": 2, "tp": 2})
        assert r["mesh_4"] == (("dp", "pp", "sp", "tp"), {"dp": 1, "pp": 1, "sp": 2, "tp": 2})
        assert r["mesh_pp"] == (("dp", "pp", "sp", "tp"), {"dp": 1, "pp": 4, "sp": 1, "tp": 1})


def test_mesh_divisibility_errors(world):
    for r in world:
        assert "not divisible by tp*sp*pp=3" in r["errors"]["tp3"]
        assert "not divisible by tp*sp*pp=6" in r["errors"]["tp3_pp2"]


def test_mesh_takes_every_rank(world):
    """A difference from JAX, which takes the first n devices: n_devices must be the world size."""
    for r in world:
        assert "the world has 4 ranks" in r["errors"]["n8"]


def test_make_mesh_and_spawn_on_cuda_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        spawn(print, 1, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DepthEstimator("DPT_Large", device="cuda", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):  # the defaults are the card's
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dryrun_multichip(1)


def test_tp_rules_hit_transformer_matmuls(hub_sd):
    """JAX ``test_tp_rules_hit_transformer_matmuls`` on the state-dict names:
    the six rules hit exactly qkv, fc1 (column), proj and fc2 weights (row)."""
    specs = param_pspecs(hub_sd)
    hit = {k: s for k, s in specs.items() if s is not None}
    blocks = range(TP_TINY.depth)
    prefix = "pretrained.model.blocks"
    assert hit == {
        **{f"{prefix}.{i}.attn.qkv.{w}": Split(0, by_head=True) for i in blocks for w in ("weight", "bias")},
        **{f"{prefix}.{i}.mlp.fc1.{w}": Split(0) for i in blocks for w in ("weight", "bias")},
        **{f"{prefix}.{i}.attn.proj.weight": Split(1) for i in blocks},
        **{f"{prefix}.{i}.mlp.fc2.weight": Split(1) for i in blocks},
    }
    assert specs["scratch.output_conv.0.weight"] is None and specs[f"{prefix}.0.attn.proj.bias"] is None
    assert all(s is None for s in param_pspecs(hub_sd, tensor_parallel=False).values())
    # JAX's rules hit the same matmuls
    jspecs = jmesh.param_pspecs({"params": convert_dpt(hub_sd, JAX_TP_TINY)})["params"]
    assert jspecs["vit"]["blocks_0"]["attn"]["qkv"]["kernel"] == jax.sharding.PartitionSpec(None, "tp")
    assert jspecs["vit"]["blocks_0"]["attn"]["proj"]["kernel"] == jax.sharding.PartitionSpec("tp", None)


@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_shards_hold_their_heads_of_q_k_and_v(hub_sd, tp):
    """Rank r's qkv rows are heads r·H/tp … (r+1)·H/tp of each of q, k and v
    (a contiguous 3C/tp block would give rank 0 all of q and part of k); the
    unsharded shards give the state dict back bitwise."""
    H, C = TP_TINY.num_heads, TP_TINY.embed_dim
    D, h = C // H, TP_TINY.num_heads // tp
    full = {k: torch.from_numpy(v) for k, v in hub_sd.items()}
    shards = [shard_params(full, r, tp) for r in range(tp)]
    w = full[f"{QKV}.weight"].reshape(3, H, D, C)
    for r, s in enumerate(shards):
        assert torch.equal(s[f"{QKV}.weight"], w[:, r * h:(r + 1) * h].reshape(3 * h * D, C))
        assert s["pretrained.model.blocks.0.attn.proj.weight"].shape == (C, C // tp)
        assert s["pretrained.model.blocks.0.mlp.fc1.bias"].shape == (4 * C // tp,)
    back = unshard_params(shards)
    assert sorted(back) == sorted(full) and all(torch.equal(back[k], full[k]) for k in full)


def test_shards_on_the_ranks_hold_their_heads_and_gather_bitwise(world, hub_sd):
    w = torch.from_numpy(hub_sd[f"{QKV}.weight"]).reshape(3, 4, 16, 64)
    b = torch.from_numpy(hub_sd[f"{QKV}.bias"]).reshape(3, 4, 16)
    for r in world:
        t = r["tp_rank"]
        np.testing.assert_array_equal(r["qkv_shard"][f"{QKV}.weight"], w[:, 2 * t:2 * t + 2].reshape(96, 64).numpy())
        np.testing.assert_array_equal(r["qkv_shard"][f"{QKV}.bias"], b[:, 2 * t:2 * t + 2].reshape(96).numpy())
        assert r["gather_bitwise"]
        assert r["cached_qkv_rows"] == {2: (96, 64), 4: (48, 64)}


def test_attention_refuses_heads_that_do_not_split():
    """JAX runs tp=8 on the 2-head tiny DPT; the port cuts whole heads and raises."""
    with pytest.raises(ValueError, match="num_heads=2 does not split over tp=4"):
        Attention(64, 2).shard_(4, None)


@pytest.mark.parametrize("key", ["tp2", "tp4"])
def test_predict_sharded_matches_predict(world, key):
    """JAX ``test_predict_sharded_tp_matches_single``'s 2e-5, every rank."""
    for r in world:
        np.testing.assert_allclose(r[key], r["single"], rtol=2e-5, atol=2e-5)


def test_predict_batch_sharded_dp_tp_matches_predict_batch(world):
    """(dp=2, tp=2), JAX ``test_predict_batch_sharded_dp_tp_matches_single``'s 2e-5, every rank."""
    for r in world:
        assert r["dp2_tp2"].shape == (4, 96, 128)
        np.testing.assert_allclose(r["dp2_tp2"], r["batch"], rtol=2e-5, atol=2e-5)


def test_conv_family_runs_replicated_over_tp(world):
    """Tiny MiDaS v2.1 (K4's family) has no transformer block: tp replicates
    it and dp splits its batch."""
    for r in world:
        np.testing.assert_allclose(r["v21_dp2_tp2"], r["v21_batch"], rtol=2e-5, atol=2e-5)


def test_sharded_predictors_match_jax(world, jax_estimator, frames):
    """The port's predict_sharded (tp=2) and predict_batch_sharded (dp=2,
    tp=2) against JAX's on make_mesh(4, tp=2), max-scaled 5e-5."""
    img, imgs = frames
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        want_one = jax_estimator.predict_sharded(img, mesh)
        want_batch = jax_estimator.predict_batch_sharded(imgs, mesh)
    for r in world:
        assert _max_scaled(r["tp2"], want_one) < 5e-5
        assert _max_scaled(r["dp2_tp2"], want_batch) < 5e-5


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """All six programs run, 2 (dp × sp × tp) and 5 (predict_spatial) included."""
    lines = dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines and len(lines) == 6
    for i in range(1, 7):
        assert lines[i - 1].startswith(f"dryrun_multichip {i}/6 OK")
    assert "(dp=1, sp=2, tp=2)" in lines[1] and "4-way row-sharded (spatial)" in lines[4]
    assert not any("waits" in line for line in lines)
