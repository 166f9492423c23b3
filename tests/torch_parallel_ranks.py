"""Rank functions of tests/test_torch_parallel_*.py.

``parallel.launch.spawn`` runs them on four gloo ranks; each rank imports
this module, so it imports the port and no JAX. Each returns numpy results
that the test process holds against the port's single-process programs and
the JAX package's.
"""

import os

import numpy as np
import torch

from depth_estimation_tpu_torch.config import PreprocessConfig
from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
from depth_estimation_tpu_torch.parallel.mesh import (axis_rank, batch_slice, gather_params, make_mesh, mesh_shape,
                                                      shard_params)
from depth_estimation_tpu_torch.registry import ModelEntry, register

# the preprocess of the JAX package's TP tests: the tiny nets' 64×64 grid
TINY_PREPROCESS = dict(target_height=64, target_width=64, keep_aspect_ratio=False, ensure_multiple_of=32)
# the DPT families' spatial tests: 120×160 frames to a 96×128 network input, a 6×8 patch grid, so that 2
# of 8 ranks own no patch rows (and 5 no rows of the hybrid's stride-32 level)
SPATIAL_DPT_PREPROCESS = dict(target_height=96, target_width=128, keep_aspect_ratio=False, ensure_multiple_of=32)


def numpy_dict(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def dpt(fields, hub_sd=None, seed=0):
    """A DPT of ``fields`` with the hub state dict ``hub_sd``, or the port's random weights from ``seed``."""
    cfg = DPTConfig(**fields)
    if hub_sd is None:
        with torch.device("meta"):
            meta = DPT(cfg)
        hub_sd = random_state_dict(meta, seed)
    model = DPT(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in hub_sd.items()})
    return model


def estimator(name, make_model, params, preprocess=TINY_PREPROCESS):
    register(ModelEntry(name, make_model, PreprocessConfig(**preprocess)))
    return DepthEstimator(name, params=params, seed=0, verbose=False, device="cpu")


# -- mesh and predictors ------------------------------------------------------

def mesh_world(rank, fields, hub_sd, v21_fields, img, imgs):
    out = {}
    m = make_mesh(4, tp=2, device="cpu")
    out["mesh_2"] = (m.mesh_dim_names, mesh_shape(m))
    m_sp = make_mesh(4, tp=2, sp=2, device="cpu")
    out["mesh_4"] = (m_sp.mesh_dim_names, mesh_shape(m_sp))
    m_pp = make_mesh(4, pp=4, device="cpu")
    out["mesh_pp"] = (m_pp.mesh_dim_names, mesh_shape(m_pp))
    out["errors"] = {}
    for key, kw in {"tp3": dict(tp=3), "tp3_pp2": dict(tp=3, pp=2), "n8": dict(n_devices=8)}.items():
        try:
            make_mesh(device="cpu", **kw)
            out["errors"][key] = None
        except ValueError as e:
            out["errors"][key] = str(e)

    full = {k: torch.as_tensor(v) for k, v in hub_sd.items()}
    out["tp_rank"] = axis_rank(m, "tp")
    shard = shard_params(full, out["tp_rank"], 2)
    out["qkv_shard"] = numpy_dict({k: v for k, v in shard.items() if k.endswith("blocks.0.attn.qkv.weight")
                                   or k.endswith("blocks.0.attn.qkv.bias")})
    gathered = gather_params(shard, m)
    out["gather_bitwise"] = sorted(gathered) == sorted(full) and all(torch.equal(gathered[k], full[k]) for k in full)

    est = estimator("TinyDPT_parallel_test", lambda: DPT(DPTConfig(**fields)), hub_sd)
    out["single"], out["batch"] = est.predict(img), est.predict_batch(imgs)
    out["tp2"] = est.predict_sharded(img, m)
    m_tp4 = make_mesh(4, tp=4, device="cpu")
    out["tp4"] = est.predict_sharded(img, m_tp4)
    out["dp2_tp2"] = est.predict_batch_sharded(imgs, m)
    out["cached_qkv_rows"] = {tp: tuple(est._params_for_mesh(mesh, True).pretrained.model.blocks[0].attn.qkv
                                        .weight.shape) for tp, mesh in ((2, m), (4, m_tp4))}

    # a conv family (MiDaS v2.1, K4's) runs replicated over tp, its batch over dp
    from depth_estimation_tpu_torch.models.midas_v21 import MidasV21, MidasV21Config

    v21 = estimator("TinyV21_parallel_test", lambda: MidasV21(MidasV21Config(**v21_fields)), None)
    out["v21_batch"], out["v21_dp2_tp2"] = v21.predict_batch(imgs), v21.predict_batch_sharded(imgs, m)
    return out


# -- pipeline -----------------------------------------------------------------

def pipeline_world(rank, fields, hybrid_fields, train_fields, hub_sd, x, gt):
    from depth_estimation_tpu_torch.parallel.pipeline import (PipelinedDPT, dpt_apply_pipelined, pipeline_blocks,
                                                              vit_apply_pipelined)
    from depth_estimation_tpu_torch.train.step import init_state, make_train_step, shard_batch, trainable_tensors

    out = {}
    meshes = {pp: make_mesh(4, pp=pp, device="cpu") for pp in (2, 4)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()  # (8, 3, 64, 64)
    model = dpt(fields, seed=1).eval()
    vit = model.pretrained.model
    with torch.no_grad():
        for pp, mesh in meshes.items():
            xs = batch_slice(xt, mesh)
            _, want, grid = vit(xs)
            for m in (1, 2, 4):
                _, got, got_grid = vit_apply_pipelined(vit, xs, mesh, m)
                out[f"vit_pp{pp}_m{m}"] = (got_grid == grid, len(got) == len(want),
                                           max(float((a - b).abs().max()) for a, b in zip(got, want)))
        xs = batch_slice(xt[:4], meshes[4])
        out["dpt_pp4"] = float((dpt_apply_pipelined(model, xs, meshes[4], 2) - model(xs)).abs().max())
        hybrid = dpt(hybrid_fields, seed=2).eval()
        xs = batch_slice(xt, meshes[2])
        want = hybrid(xs)
        out["hybrid_pp2"] = (float((dpt_apply_pipelined(hybrid, xs, meshes[2], 2) - want).abs().max()),
                             float(want.abs().max()))
        try:
            pipeline_blocks(lambda i, t: t, torch.zeros(3, 17, 64), meshes[4], (0, 1, 2, 3), 4, 2)
            out["bad_batch"] = None
        except ValueError as e:
            out["bad_batch"] = str(e)

    # the backward's exchanges are chained in the graph: on each side of a
    # link, microbatch m's send (receive) node leads to m − 1's
    for pp, mesh in meshes.items():
        xs = batch_slice(xt, mesh)
        _, hooked, _ = vit_apply_pipelined(vit, xs, mesh, 4)
        out[f"chain_pp{pp}"] = exchange_chains(hooked)

    # one AdamW step of the pipelined DPT and DPT_Hybrid, (dp=1, pp=4) and (dp=2, pp=2)
    xt, gtt = torch.from_numpy(x[:4]).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(gt)
    models = {"step": lambda: dpt(train_fields, hub_sd), "hybrid_step": lambda: dpt(hybrid_fields, seed=2)}
    for name, make in models.items():
        for pp, mesh in meshes.items():
            pipelined = PipelinedDPT(make(), mesh, microbatches=2)
            state = init_state(pipelined, mesh=mesh)
            step = make_train_step(pipelined, state.optimizer, mesh=mesh)
            with torch.backends.mkldnn.flags(enabled=False):
                loss = float(step(shard_batch(xt, mesh), shard_batch(gtt, mesh)))
            strip = len("model.")
            out[f"{name}_pp{pp}"] = dict(loss=loss, grads={k[strip:]: t.grad.numpy().copy()
                                                           for k, t in trainable_tensors(pipelined).items()},
                                         params=numpy_dict(pipelined.model.state_dict()))
    return out


def exchange_chains(outputs):
    """{node name: (nodes, links)} of the pipeline's send and receive
    Functions in the autograd graph behind ``outputs``: how many there are,
    and how many lead straight to another of their kind."""
    kinds = ("_SendBackward", "_RecvBackward")
    nodes, links = dict.fromkeys(kinds, 0), dict.fromkeys(kinds, 0)
    seen, stack = set(), [t.grad_fn for t in outputs]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        nxt = [n for n, _ in node.next_functions if n is not None]
        if name in kinds:
            nodes[name] += 1
            links[name] += sum(type(n).__name__ == name for n in nxt)
        stack.extend(nxt)
    return {k: (nodes[k], links[k]) for k in kinds}


# -- training -----------------------------------------------------------------

def train_world(rank, fields, hub_sd, imgs, gt, net_hw, lr, root):
    import torch.distributed as dist

    from depth_estimation_tpu_torch.config import DPT_PREPROCESS
    from depth_estimation_tpu_torch.train.data import ShardedBatch, TrainingApply, device_prefetch
    from depth_estimation_tpu_torch.train.loop import fit
    from depth_estimation_tpu_torch.train.step import init_state, make_train_step, shard_batch, trainable_tensors

    out = {}
    mesh = make_mesh(4, tp=2, device="cpu")
    out["dp_rank"], out["tp_rank"] = axis_rank(mesh, "dp"), axis_rank(mesh, "tp")

    def apply():
        return TrainingApply(dpt(fields, hub_sd), DPT_PREPROCESS, net_hw=net_hw)

    # every rank starts from global rank 0's weights, whatever it was given
    model = apply()
    with torch.no_grad():
        for t in model.parameters():
            t.add_(rank)
    state = init_state(model, lr=lr, mesh=mesh)
    step = make_train_step(model, state.optimizer, mesh=mesh)
    imgs_t, gt_t = shard_batch(imgs, mesh), shard_batch(gt, mesh)
    strip = len("model.")
    with torch.backends.mkldnn.flags(enabled=False):
        losses = [float(step(imgs_t, gt_t))]
        tensors = trainable_tensors(model)
        out["grads"] = numpy_dict({k[strip:]: v for k, v in
                                   gather_params({k: t.grad for k, t in tensors.items()}, mesh).items()})
        out["params"] = numpy_dict({k[strip:]: v for k, v in gather_params(model.state_dict(), mesh).items()})
        losses += [float(step(imgs_t, gt_t)) for _ in range(2)]
    out["losses"] = losses
    out["local_qkv_rows"] = model.model.pretrained.model.blocks[0].attn.qkv.weight.shape[0]
    out["moment_rows"] = state.optimizer.state[tensors["model.pretrained.model.blocks.0.attn.qkv.weight"]][
        "exp_avg"].shape[0]

    # fit over the mesh: straight, and stopped at a checkpoint then resumed
    data = [(imgs, gt)]
    _, straight = fit(apply(), data, steps=4, lr=lr, mesh=mesh, log_every=1, verbose=False)
    ck = os.path.join(root, "ckpt")
    fit(apply(), data, steps=2, lr=lr, mesh=mesh, ckpt_dir=ck, ckpt_every=2, log_every=1, verbose=False)
    _, resumed = fit(apply(), data, steps=4, lr=lr, mesh=mesh, ckpt_dir=ck, ckpt_every=2, log_every=1,
                     verbose=False)
    out["straight"], out["resumed"] = straight, resumed

    # device_prefetch(mesh=): the rank's slice of every batch, twice over
    batches = [(imgs, gt), (imgs[::-1].copy(), gt[::-1].copy())]
    pf = device_prefetch(batches, mesh=mesh, device="cpu")
    out["prefetch"] = [[(isinstance(b, ShardedBatch), b[0].numpy().copy(), b[1].numpy().copy()) for b in pf]
                       for _ in range(2)]
    dist.barrier()
    return out


# -- sequence parallelism -----------------------------------------------------

def sp_world(rank, fields, hub_sd, x, gt, lr):
    """The (dp=2, sp=2, tp=2) mesh of eight ranks: the tiny DPT's forward with
    its trunk sequence- and tensor-parallel, K1's (q, k) token counts, and one
    AdamW step of it with remat, its gradients and tensors gathered whole."""
    import torch.distributed as dist

    from depth_estimation_tpu_torch.models import vit as vit_module
    from depth_estimation_tpu_torch.parallel.mesh import sequence_parallel, seq_sharding, tensor_parallel
    from depth_estimation_tpu_torch.train.step import init_state, make_train_step, shard_batch, trainable_tensors

    out = {}
    mesh = make_mesh(8, tp=2, sp=2, device="cpu")
    out["coords"] = {a: axis_rank(mesh, a) for a in ("dp", "sp", "tp")}
    out["sp_group_size"] = dist.get_world_size(seq_sharding(mesh))
    model = sequence_parallel(tensor_parallel(dpt(fields, hub_sd).eval(), mesh), mesh)
    shapes, attention = [], vit_module.multi_head_attention

    def recorded(q, k, v):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return attention(q, k, v)

    vit_module.multi_head_attention = recorded
    try:
        with torch.no_grad():
            out["forward"] = model(batch_slice(torch.from_numpy(x), mesh)).numpy()
    finally:
        vit_module.multi_head_attention = attention
    out["attention_shapes"] = shapes

    model = sequence_parallel(dpt({**fields, "remat": True}, hub_sd), mesh)
    state = init_state(model, lr=lr, mesh=mesh)
    step = make_train_step(model, state.optimizer, mesh=mesh)
    with torch.backends.mkldnn.flags(enabled=False):
        out["loss"] = float(step(shard_batch(x, mesh), shard_batch(gt, mesh)))
    tensors = trainable_tensors(model)
    out["grads"] = numpy_dict(gather_params({k: t.grad for k, t in tensors.items()}, mesh))
    out["params"] = numpy_dict(gather_params(model.state_dict(), mesh))
    return out


# -- spatial partitioning -----------------------------------------------------

def spatial_world(rank, v21_fields, v21_sd, x, small_sd, img, dpts, dpt_img):
    """Eight ranks: tiny MiDaS v2.1's forward with every layer's rows cut
    over tp = 8 and tp = 4 (two dp replicas), MiDaS_small's
    ``predict_spatial`` over tp = 8, the tiny DPT's and tiny hybrid's
    (``dpts``: name → (DPTConfig fields, state dict)) over tp = 8 and 4, and
    the height refusal."""
    from depth_estimation_tpu_torch.models.midas_v21 import MidasV21, MidasV21Config
    from depth_estimation_tpu_torch.parallel.spatial import RowWorld, spatial_forward

    out = {}
    meshes = {8: make_mesh(8, tp=8, device="cpu"), 4: make_mesh(8, tp=4, device="cpu")}
    v21 = MidasV21(MidasV21Config(**v21_fields))
    v21.load_state_dict({k: torch.as_tensor(v) for k, v in v21_sd.items()})
    with torch.no_grad():
        for n, mesh in meshes.items():
            out[f"v21_tp{n}"] = spatial_forward(RowWorld.over(mesh, "tp"), v21.eval(), torch.from_numpy(x)).numpy()
    est = DepthEstimator("MiDaS_small", params=small_sd, seed=0, verbose=False, device="cpu")
    out["small_tp8"] = est.predict_spatial(img, meshes[8])
    try:
        est.predict_spatial(np.zeros((97, *img.shape[1:]), np.uint8), meshes[8])
    except ValueError as e:
        out["tall_error"] = str(e)
    for name, (fields, sd) in dpts.items():
        dpt_est = estimator(name, lambda fields=fields: DPT(DPTConfig(**fields)), sd, SPATIAL_DPT_PREPROCESS)
        for n, mesh in meshes.items():
            out[f"{name}_tp{n}"] = dpt_est.predict_spatial(dpt_img, mesh)
    return out

