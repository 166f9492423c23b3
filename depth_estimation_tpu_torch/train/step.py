"""The train step (JAX ``train/step.py``): AdamW on every trainable tensor,
loss and gradient in one call.

``TrainState`` is the model, its ``torch.optim.AdamW`` and the step count.
The trainable tensors are the JAX package's param leaves: the module's
parameters and the four tensors of every frozen batch norm, which the JAX
package holds as params and updates and decays like any other leaf
(``trainable_tensors``). ``make_optimizer`` is ``optax.adamw``'s defaults
with no mask, p − lr·wd·p − lr·m̂/(√v̂ + eps), which is
``torch.optim.AdamW``'s rule.

The step runs under the frame program's f32 numerics (``device.full_f32``,
``device.conv_algorithms_by_timing``), so on the card it goes through the
kernels (K1, K2, K3, and K4 for MiDaS v2.1) and their autograd Functions,
and with cuDNN's deterministic algorithms (``device.deterministic_convs``):
with the upsampling's matrix backward (``models/midas_small.py``), the same
state and batch give the same gradient bit for bit on the card.

``float64_gradients`` is the step's loss and gradients in float64 on the
CPU, the reference that f32 gradients, the card's and the CPU's, are held
against.

Over a mesh (``parallel.mesh.make_mesh``) every rank runs the same step on
its own part: ``init_state(model, mesh=)`` gives every rank global rank 0's
weights and cuts the model to the rank's tp shard before AdamW is built (so
its moments take the shard's shapes), ``shard_batch`` gives the rank's dp
slice, and the step takes each gradient from the pipeline stage that owns
it, then averages the gradients and the loss over ``dp``. The tp ranks need
no gradient exchange: the Megatron operators (``parallel/mesh.py``) leave a
replicated tensor's gradient whole and equal on every tp rank, and a cut
tensor's gradient is the rank's own. Under sequence parallelism
(``parallel.mesh.sequence_parallel``) the ViT blocks' gradients are partial
over the tokens and are summed over sp; the embedding's and the decoder's
are whole on every sp rank (``parallel/ops.py``) and are not. ``save_sharded_train_state`` writes
such a state whole, in ``utils/checkpoint.py``'s single-device format, and
``load_sharded_train_state`` cuts every rank's shard from it again, so a
checkpoint moves between meshes and a single device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, deterministic_convs, full_f32
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.parallel.mesh import (axis_rank, axis_size, batch_slice, gather_params, gather_tensor,
                                                      mesh_device, param_pspecs, shard_tensor, sp_partial_tensors,
                                                      tensor_parallel)
from depth_estimation_tpu_torch.parallel.pipeline import gradient_owners
from depth_estimation_tpu_torch.train.losses import gradient_matching_loss, ssi_loss
from depth_estimation_tpu_torch.utils.checkpoint import read_train_state, write_train_state


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: Any = None  # the DeviceMesh the model is sharded over, or None


def trainable_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor the trainer updates, by state-dict name: the parameters
    and the frozen batch norms' buffers, each set to require grad. Call it
    after the model is on its device (moving a module replaces its
    buffers)."""
    params = dict(model.named_parameters())
    frozen = {f"{prefix}.{name}".lstrip(".") for prefix, mod in model.named_modules()
              if isinstance(mod, FrozenBatchNorm2d) for name, _ in mod.named_buffers(recurse=False)}
    out = {k: v for k, v in model.state_dict(keep_vars=True).items() if k in params or k in frozen}
    for t in out.values():
        t.requires_grad_(True)
    return out


def make_optimizer(model: nn.Module, lr: float = 1e-4, weight_decay: float = 1e-2) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)`` over ``trainable_tensors(model)``."""
    return torch.optim.AdamW(list(trainable_tensors(model).values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_state(model: nn.Module, lr: float = 1e-4, weight_decay: float = 1e-2, mesh=None) -> TrainState:
    """The train state of ``model`` (already on its device). With a mesh:
    every rank takes global rank 0's weights, then keeps its tp shard, and
    AdamW is built on the shard."""
    if mesh is not None:
        if dist.get_world_size() > 1:
            with torch.no_grad():
                for t in model.state_dict().values():
                    dist.broadcast(t, src=0)
        tensor_parallel(model, mesh)
    return TrainState(model, make_optimizer(model, lr=lr, weight_decay=weight_decay), mesh=mesh)


def shard_batch(batch, mesh) -> torch.Tensor:
    """The rank's dp slice of a global batch (numpy or tensor), on the rank's device."""
    return torch.as_tensor(batch_slice(batch, mesh)).to(mesh_device(mesh), non_blocking=True)


def _moments_by_name(model: nn.Module, optimizer_sd: Dict, convert) -> Dict:
    """``optimizer_sd`` with ``convert(name, tensor)`` applied to each
    parameter's AdamW moments (the optimizer's parameter i is the model's
    i-th trainable tensor, ``make_optimizer``)."""
    names = list(trainable_tensors(model))
    per_param = {i: {k: convert(names[i], v) if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
                 for i, st in optimizer_sd["state"].items()}
    return {**optimizer_sd, "state": per_param}


def save_sharded_train_state(path, state: TrainState) -> None:
    """Save a state over a mesh; every rank calls it. The tp shards of the
    weights and of AdamW's moments are gathered, global rank 0 writes the
    whole state (``utils.checkpoint.write_train_state``) and the ranks meet
    at a barrier."""
    model_sd = state.model.state_dict()
    specs = param_pspecs(model_sd)
    optimizer_sd = _moments_by_name(state.model, state.optimizer.state_dict(),
                                    lambda k, v: gather_tensor(v, specs[k], state.mesh))
    model_sd = gather_params(model_sd, state.mesh)
    if dist.get_rank() == 0:
        write_train_state(path, model_sd, optimizer_sd, state.step)
    dist.barrier()


def load_sharded_train_state(path, state: TrainState) -> TrainState:
    """Restore a whole saved state (either save's) into a state over a mesh,
    each rank taking its tp shard; returns ``state``."""
    model_sd, optimizer_sd, step = read_train_state(path)
    specs = param_pspecs(model_sd)
    r, n = axis_rank(state.mesh, "tp"), axis_size(state.mesh, "tp")

    def cut(k, v):
        return v if specs[k] is None or n == 1 else shard_tensor(v, specs[k], r, n)

    state.model.load_state_dict({k: cut(k, v) for k, v in model_sd.items()})
    state.optimizer.load_state_dict(_moments_by_name(state.model, optimizer_sd, cut))
    state.step = step
    return state


def sync_gradients(model: nn.Module, mesh) -> None:
    """Make every rank's gradients the mesh-wide step's: each tensor's from
    the pipeline stage that owns it (``pipeline.gradient_owners``; the same
    on every stage without a pipeline), the sum over sp of the
    sequence-parallel blocks' partial gradients, then the mean over dp."""
    tensors = trainable_tensors(model)
    pp, dp = axis_size(mesh, "pp"), axis_size(mesh, "dp")
    for group, partial in sp_partial_tensors(model):
        for t in partial:
            if t.grad is not None:
                dist.all_reduce(t.grad, group=group)
    if pp > 1:
        group = mesh.get_group("pp")
        for name, owner in gradient_owners(list(tensors), pp).items():
            t = tensors[name]
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            dist.broadcast(t.grad, src=dist.get_global_rank(group, owner), group=group)
    if dp > 1:
        group = mesh.get_group("dp")
        for t in tensors.values():
            if t.grad is not None:
                dist.all_reduce(t.grad, group=group)
                t.grad /= dp


def loss_fn(model: nn.Module, images, gt_disparity, alpha: float = 0.5) -> torch.Tensor:
    pred = model(images)
    loss = ssi_loss(pred, gt_disparity)
    if alpha > 0:
        loss = loss + alpha * gradient_matching_loss(pred, gt_disparity)
    return loss


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, alpha: float = 0.5,
                    accum_steps: int = 1, mesh=None):
    """step(images, gt) -> the batch's loss (a detached scalar tensor), after
    one optimizer update. The gradients stay in each tensor's ``.grad``
    until the next step.

    ``accum_steps > 1`` splits the batch into that many equal microbatches,
    accumulates their gradients and averages them before the single update.
    Both losses are per-image means, so the average equals the full-batch
    gradient up to float association.

    With ``mesh``, ``images`` and ``gt`` are the rank's dp slice
    (``shard_batch``) and the loss returned is the global batch's."""

    def step(images: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
        with full_f32(), conv_algorithms_by_timing(), deterministic_convs():
            optimizer.zero_grad(set_to_none=True)
            if accum_steps == 1:
                loss = loss_fn(model, images, gt, alpha)
                loss.backward()
            else:
                loss = torch.zeros((), device=gt.device)
                for im, g in zip(images.chunk(accum_steps), gt.chunk(accum_steps)):
                    micro = loss_fn(model, im, g, alpha)
                    (micro / accum_steps).backward()
                    loss = loss + micro.detach()
                loss = loss / accum_steps
            loss = loss.detach()
            if mesh is not None:
                sync_gradients(model, mesh)
                if axis_size(mesh, "dp") > 1:
                    dist.all_reduce(loss, group=mesh.get_group("dp"))
                    loss /= axis_size(mesh, "dp")
            optimizer.step()
        return loss

    return step


def float64_gradients(apply: nn.Module, images: torch.Tensor, gt: torch.Tensor,
                      alpha: float = 0.5) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and every trainable tensor's gradient of one step of
    ``apply`` (a ``train.data.TrainingApply``) on a u8 batch, in float64 on
    the CPU: a float64 copy of the model, whose plain attention, grouped
    convolution and resizes compute in the input's type, on the f32 network
    input of the plain preprocess, resized back by the same cubic matrices.
    ``apply`` is left as it was."""
    with torch.no_grad():  # buffers that require grad stay leaves when moved
        model = copy.deepcopy(apply.model).to("cpu", torch.float64)
    tensors = trainable_tensors(model)
    for t in tensors.values():
        t.grad = None
    cfg = apply.preprocess_cfg
    src_hw = (int(images.shape[1]), int(images.shape[2]))
    net_hw = apply.net_hw or compute_resize_shape(*src_hw, cfg)
    x = fused_preprocess(images.cpu().contiguous(), net_hw, cfg.mean, cfg.std, bgr_to_rgb=apply.bgr).double()
    loss = loss_fn(lambda t: resize_planes(model(t), src_hw), x, gt.cpu().double(), alpha)
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t in tensors.items()}
