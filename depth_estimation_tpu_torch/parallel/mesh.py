"""Device mesh and the tensor-parallel rules (JAX ``parallel/mesh.py``).

``make_mesh`` gives a ``torch.distributed.DeviceMesh`` over the world's
ranks: ``("dp", "tp")``, or ``("dp", "pp", "sp", "tp")`` when ``sp`` or ``pp``
is over 1, with ``tp`` innermost (neighbouring ranks share a tp group) and
``dp`` outermost, as in JAX.

Tensor parallelism (Megatron style) shards the transformer matmuls, where
DPT's FLOPs are; everything else is replicated. The rules, on the port's
state-dict names (a torch ``Linear`` weight is ``(out, in)``):

* ``attn.qkv.weight`` / ``.bias`` — column-parallel **by head**. Their rows
  are ``[q (all heads); k (all heads); v (all heads)]``, so rank r takes
  heads ``r·H/tp … (r+1)·H/tp`` of each of q, k and v (a contiguous
  ``3C/tp`` block would give rank 0 all of q and part of k);
* ``mlp.fc1.weight`` / ``.bias`` — column-parallel on dim 0;
* ``attn.proj.weight``, ``mlp.fc2.weight`` — row-parallel on dim 1; their
  biases stay whole and are added once, after the all-reduce.

Each block then needs one all-reduce after ``proj`` and one after ``fc2``:
Megatron's two operators, in ``parallel/ops.py``.

``shard_params`` and ``unshard_params`` are pure functions of state dicts, so
one process can hold every rank's shard in turn; ``gather_params`` is the
collective form of ``unshard_params`` over the mesh's tp group.

Sequence parallelism (JAX ``seq_sharding`` + ``ViT.act_sharding``):
``sequence_parallel`` gives a model's ViTs the mesh's sp group, so their
blocks run on each sp rank's share of the tokens (``parallel/ops.py``). The
weights stay replicated over sp; the blocks' gradients, partial over the
tokens, are summed over sp by the train step.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from depth_estimation_tpu_torch.device import resolve_device
from depth_estimation_tpu_torch.models.vit import Attention, Mlp, ViT


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1, pp: int = 1, device="cuda"):
    """DeviceMesh over all ranks of the initialized world (``parallel.launch``).

    ``n_devices``, when given, must be the world size: a rank cannot drop out
    of its world (JAX takes the first ``n_devices`` devices). The devices left
    over by ``tp·sp·pp`` fill ``dp``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: start them with "
                           "parallel.launch.spawn or torchrun")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices} but the world has {n} ranks; every rank is in the mesh")
    if n % (tp * sp * pp):
        raise ValueError(f"n_devices={n} not divisible by tp*sp*pp={tp * sp * pp}")
    if sp == 1 and pp == 1:
        return init_device_mesh(dev.type, (n // tp, tp), mesh_dim_names=("dp", "tp"))
    return init_device_mesh(dev.type, (n // (tp * sp * pp), pp, sp, tp), mesh_dim_names=("dp", "pp", "sp", "tp"))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, as JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def mesh_device(mesh) -> torch.device:
    """The rank's device: the CPU for a gloo mesh, the current card for NCCL."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Split(NamedTuple):
    """How a tensor is cut over tp: along ``dim``; ``by_head`` cuts each of
    the q, k and v thirds of dim 0 alike."""
    dim: int
    by_head: bool = False


# (regex on the state-dict name, Split) — first match wins
_TP_RULES = (
    # column-parallel: shard the output features
    (re.compile(r"blocks\.\d+\.attn\.qkv\.weight$"), Split(0, by_head=True)),
    (re.compile(r"blocks\.\d+\.attn\.qkv\.bias$"), Split(0, by_head=True)),
    (re.compile(r"blocks\.\d+\.mlp\.fc1\.weight$"), Split(0)),
    (re.compile(r"blocks\.\d+\.mlp\.fc1\.bias$"), Split(0)),
    # row-parallel: shard the input features (all-reduce after)
    (re.compile(r"blocks\.\d+\.attn\.proj\.weight$"), Split(1)),
    (re.compile(r"blocks\.\d+\.mlp\.fc2\.weight$"), Split(1)),
)


def param_pspecs(names, tensor_parallel: bool = True) -> Dict[str, Optional[Split]]:
    """The plan by name: the ``Split`` of each tensor the TP rules hit, None
    (replicated) for every other."""
    def spec_for(name):
        if tensor_parallel:
            for rx, spec in _TP_RULES:
                if rx.search(name):
                    return spec
        return None

    return {name: spec_for(name) for name in names}


def shard_tensor(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` (a copy of its own)."""
    if split.by_head:
        if t.shape[0] % (3 * size):
            raise ValueError(f"qkv of {t.shape[0]} rows does not split into 3 × {size} head groups")
        return t.reshape(3, size, -1, *t.shape[1:])[:, rank].reshape(-1, *t.shape[1:]).clone()
    if t.shape[split.dim] % size:
        raise ValueError(f"dim {split.dim} of {tuple(t.shape)} does not split {size} ways")
    n = t.shape[split.dim] // size
    return t.narrow(split.dim, rank * n, n).clone(memory_format=torch.contiguous_format)


def unshard_tensor(parts: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's part, in tp-rank order."""
    if split.by_head:
        rest = parts[0].shape[1:]
        return torch.stack([p.reshape(3, -1, *rest) for p in parts], 1).reshape(-1, *rest)
    return torch.cat(list(parts), split.dim)


def shard_params(state_dict: Mapping[str, torch.Tensor], tp_rank: int, tp_size: int) -> Dict[str, torch.Tensor]:
    """Rank ``tp_rank``'s state dict: the TP rules' tensors cut, the rest as they are."""
    specs = param_pspecs(state_dict)
    return {k: v if specs[k] is None or tp_size == 1 else shard_tensor(v, specs[k], tp_rank, tp_size)
            for k, v in state_dict.items()}


def unshard_params(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every tp rank's ``shard_params`` (rank order)."""
    specs = param_pspecs(shards[0])
    return {k: v if specs[k] is None or len(shards) == 1 else unshard_tensor([s[k] for s in shards], specs[k])
            for k, v in shards[0].items()}


def gather_tensor(t: torch.Tensor, split: Optional[Split], mesh) -> torch.Tensor:
    """``t`` whole on every rank: all-gathered over the mesh's tp group if it is cut."""
    tp = axis_size(mesh, "tp")
    if split is None or tp == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("tp"))
    return unshard_tensor(parts, split)


def gather_params(state_dict: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict on every rank of a tp group, from each rank's shard."""
    specs = param_pspecs(state_dict)
    return {k: gather_tensor(v, specs[k], mesh) for k, v in state_dict.items()}


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model`` in place to this rank's tp shard: each ViT ``Attention``
    keeps ``num_heads/tp`` heads and each ``Mlp`` ``hidden/tp`` features,
    with the mesh's tp group for their all-reduces. A model with no
    transformer block (the conv families) is left whole, replicated."""
    tp = axis_size(mesh, "tp")
    blocks = [m for m in model.modules() if isinstance(m, (Attention, Mlp))]
    if tp == 1 or not blocks:
        return model
    full = model.state_dict()
    group = mesh.get_group("tp")
    for m in blocks:
        m.shard_(tp, group)
    model.load_state_dict(shard_params(full, axis_rank(mesh, "tp"), tp))
    return model


def seq_sharding(mesh):
    """The mesh's sp process group, over which a ViT's tokens are cut
    (JAX ``seq_sharding``: batch over dp, tokens over sp). Raises
    ``ValueError`` for a mesh without an 'sp' axis."""
    if "sp" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no 'sp' axis: {mesh.mesh_dim_names}")
    return mesh.get_group("sp")


def sequence_parallel(model: nn.Module, mesh) -> nn.Module:
    """Run ``model``'s ViT trunks sequence-parallel over the mesh's sp axis, in
    place (weights unchanged and replicated): each sp rank's blocks see its
    share of the tokens, K and V are gathered for the attention, and the hook
    tokens come back whole for the decoder, which every sp rank runs. It
    composes with ``tensor_parallel`` and with ``remat``; a pipelined trunk
    (pp > 1) is refused. At sp = 1 the same path runs over a group of one. A
    model with no ViT (the conv families) is left as it is."""
    group = seq_sharding(mesh)
    if axis_size(mesh, "pp") > 1:
        raise ValueError(f"sequence parallelism runs the trunk unpipelined; the mesh has pp={axis_size(mesh, 'pp')}")
    for m in model.modules():
        if isinstance(m, ViT):
            m.sp_group = group
    return model


def sp_partial_tensors(model: nn.Module):
    """[(sp group, [tensor])]: the parameters of each sequence-parallel ViT's
    blocks, whose gradients are partial over the tokens."""
    return [(m.sp_group, list(m.blocks.parameters())) for m in model.modules()
            if isinstance(m, ViT) and m.sp_group is not None]


def batch_slice(x, mesh):
    """The rank's contiguous dp slice of a batch (JAX ``batch_pspec`` = P("dp"))."""
    dp, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp={dp}")
    b = x.shape[0] // dp
    return x[r * b:(r + 1) * b]


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch on every rank, from each dp rank's slice (``batch_slice``'s inverse)."""
    dp = axis_size(mesh, "dp")
    if dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("dp"))
    return torch.cat(parts)
