"""Spatial partitioning of one frame over a mesh axis (JAX ``predict_spatial``).

The JAX package shards the source frame's rows over a mesh axis and lets
GSPMD propagate the sharding through the frame program, inserting the halo
exchanges each convolution needs. Here the same is written out, layer by
layer, for the four families (MiDaS v2.1, MiDaS_small, DPT_Large and
DPT_Hybrid):

* every layer's output rows are cut over the axis's ranks as evenly as their
  count allows (``row_bounds``; a rank may own none: tiny v2.1 at 64×96 over
  8 ranks leaves 2 rows at stride 32);
* for its output rows, a rank works out the input rows they read, from the
  kernel, stride and pads (convolutions, the max pools, the transposed
  convs), or from the tap tables (the 2× bilinear upsampling, kernels K2
  and K3), and fetches the rows it lacks from the ranks that own them:
  neighbours' edge rows, never the whole tensor (``RowWorld.fetch``);
* it then computes its rows from that slab: a convolution pads the slab's
  columns as the layer does and its rows only at the frame's own edges; K4
  runs on the slab with one halo row on each side and keeps the interior
  rows (its zero padding is right at the frame's edges, and the rows it
  computes wrong at the slab's inner edges are dropped); the upsampling
  takes its taps from the global row index; K2 and K3 run on output-row
  windows (``ops/kernels/resize.py``); batch norm, ReLU, ReLU6 and the
  residual adds are row-local; GroupNorm (DPT_Hybrid's ResNetV2 stem) takes
  its statistics over the axis (``RowWorld.sum``).

The DPT families cut the patch rows: the patch embedding (DPT_Large's
stride-16 conv, or DPT_Hybrid's stem and 1×1 projection) runs by the rules
above; each rank flattens its patch rows to tokens with its rows of the
position embedding, rank 0 leading with the cls token; the tokens are
gathered whole and the ViT's blocks run sequence-parallel over the axis's
own group (``ViT.trunk``: each rank's share of the tokens, K1 on its local
queries against the gathered K/V, the hooks gathered whole); each rank
reassembles its grid rows of the hooks, and the decoder runs by the rules.

Each operation is so an exchange and a compute on (local slab, halo rows).
A ``RowWorld`` over a mesh axis holds one rank in each process and exchanges
rows point to point (``torch.distributed.batch_isend_irecv``); a local
``RowWorld`` holds every rank in one process and fetches by slicing the whole
tensor, so the compute half runs alone on one card (chip_smoke's
``parallel_sp`` phase); there the ViT's blocks run on the whole tokens. The
weights are replicated. A module without a rule raises
``NotImplementedError``, so that nothing runs unpartitioned by mistake.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from depth_estimation_tpu_torch.models.dpt import DPT, Reassemble
from depth_estimation_tpu_torch.models.layers import (Conv2dSame, DepthwiseSeparable, FrozenBatchNorm2d,
                                                      InvertedResidual, same_pads)
from depth_estimation_tpu_torch.models.midas_small import (FeatureFusionBlock, MidasSmall, ResidualConvUnit,
                                                           UpsampleConv3x3)
from depth_estimation_tpu_torch.models.midas_v21 import (FeatureFusionBlockV21, GroupedConv3x3, MidasV21,
                                                         ResNeXtBottleneck)
from depth_estimation_tpu_torch.models.resnetv2 import Bottleneck as ResNetV2Bottleneck
from depth_estimation_tpu_torch.models.resnetv2 import GroupNormAct, ResNetV2Stem, StdConv, standardize
from depth_estimation_tpu_torch.models.vit import HybridEmbed, ViT, resize_pos_embed
from depth_estimation_tpu_torch.ops.kernels.grouped_conv import grouped_conv3x3
from depth_estimation_tpu_torch.ops.kernels.resize import (_device_taps, band_taps, fused_preprocess, resize_planes,
                                                           window_rows)
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.parallel.mesh import axis_rank, axis_size
from depth_estimation_tpu_torch.parallel.ops import token_counts

Span = Tuple[int, int]


def row_bounds(n_rows: int, size: int) -> List[Span]:
    """[r0, r1) of each rank: ``n_rows`` cut as evenly as the count allows, the first ranks one more."""
    ends = np.cumsum((0,) + token_counts(n_rows, size))
    return [(int(a), int(b)) for a, b in zip(ends[:-1], ends[1:])]


class Rows:
    """A tensor cut by rows: ``parts[r]`` holds rows ``row_bounds(height,
    size)[r]`` along ``dim``, for each rank r that this process computes."""

    def __init__(self, parts: Dict[int, torch.Tensor], height: int, dim: int):
        self.parts, self.height, self.dim = parts, height, dim

    @property
    def width(self) -> int:
        return next(iter(self.parts.values())).shape[-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rows":
        """A row-local operation on every part, empty ones too."""
        return Rows({r: fn(t) for r, t in self.parts.items()}, self.height, self.dim)

    def __add__(self, other: "Rows") -> "Rows":
        return Rows({r: t + other.parts[r] for r, t in self.parts.items()}, self.height, self.dim)


class RowWorld:
    """``size`` ranks, of which this process computes ``ranks``. ``group``
    (a process group of ``size`` ranks, this process one of them): rows move
    point to point between the processes; ``None``: one process holds every
    rank, and a fetch slices the whole tensor."""

    def __init__(self, size: int, ranks: Sequence[int], group=None):
        self.size, self.ranks, self.group = size, tuple(ranks), group

    @classmethod
    def over(cls, mesh, axis: str) -> "RowWorld":
        """The ranks of the mesh axis ``axis``, this process one of them."""
        if axis not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no {axis!r} axis: {mesh.mesh_dim_names}")
        return cls(axis_size(mesh, axis), (axis_rank(mesh, axis),), mesh.get_group(axis))

    @classmethod
    def local(cls, size: int) -> "RowWorld":
        """All ``size`` ranks in this process."""
        return cls(size, range(size))

    def shard(self, x: torch.Tensor, dim: int) -> Rows:
        """Each of this process's ranks' rows of a whole tensor."""
        bounds = row_bounds(x.shape[dim], self.size)
        return Rows({r: x.narrow(dim, a, b - a) for r in self.ranks for a, b in [bounds[r]]}, x.shape[dim], dim)

    def fetch(self, x: Rows, needs: Dict[int, Span]) -> Dict[int, torch.Tensor]:
        """The exchange: for each rank r of ``needs`` that this process
        computes, the rows ``needs[r]`` of ``x`` (inside its height) as one
        slab. Over a group every rank calls it with the same ``needs``
        (functions of shapes only), sends each other rank the rows of its own
        that the other needs and receives the rest."""
        dim, bounds = x.dim, row_bounds(x.height, self.size)
        if self.group is None:
            whole = torch.cat([x.parts[r] for r in range(self.size)], dim)
            return {r: whole.narrow(dim, lo, hi - lo) for r, (lo, hi) in needs.items() if r in self.ranks}
        me = self.ranks[0]
        (a, b), mine = bounds[me], x.parts[me]
        ops, pieces = [], []
        for dst, (lo, hi) in needs.items():
            s, e = max(lo, a), min(hi, b)
            if dst != me and s < e:
                ops.append(dist.P2POp(dist.isend, mine.narrow(dim, s - a, e - s).contiguous(),
                                      dist.get_global_rank(self.group, dst), self.group))
        if me in needs:
            lo, hi = needs[me]
            for src, (c, d) in enumerate(bounds):
                s, e = max(lo, c), min(hi, d)
                if s >= e:
                    continue
                if src == me:
                    pieces.append(mine.narrow(dim, s - a, e - s))
                else:
                    shape = list(mine.shape)
                    shape[dim] = e - s
                    buf = mine.new_empty(shape)
                    ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, src), self.group))
                    pieces.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if me not in needs:
            return {}
        return {me: pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)}

    def gather(self, x: Rows, bounds: Optional[Sequence[Span]] = None) -> torch.Tensor:
        """The whole tensor, on every rank. ``bounds``: each rank's [a, b)
        along ``x.dim``, where they are not ``row_bounds(x.height, size)``."""
        if self.group is None:
            return torch.cat([x.parts[r] for r in range(self.size)], x.dim)
        counts = token_counts(x.height, self.size) if bounds is None else [b - a for a, b in bounds]
        part = x.parts[self.ranks[0]].movedim(x.dim, 0).contiguous()
        padded = part.new_zeros((max(counts), *part.shape[1:]))
        padded[:part.shape[0]] = part
        outs = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(outs, padded, group=self.group)
        return torch.cat([o[:c] for o, c in zip(outs, counts)], 0).movedim(0, x.dim)

    def sum(self, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
        """The sum over the axis of one tensor a rank (``parts[r]`` for each
        rank r of this process, all of one shape), on every rank: over a
        group an all-reduce, in one process the sum of the parts."""
        if self.group is None:
            return torch.stack([parts[r] for r in range(self.size)]).sum(0)
        total = parts[self.ranks[0]].clone()
        dist.all_reduce(total, group=self.group)
        return total


def _layer(world: RowWorld, x: Rows, out_height: int, need: Callable[[int, int], Span],
           compute: Callable[[torch.Tensor, Span, Span], torch.Tensor], empty: Callable[[torch.Tensor], torch.Tensor],
           dim: int = 2) -> Rows:
    """One operation: the exchange of the input rows each rank's output rows
    read (``need(r0, r1)``, unclipped), then ``compute(slab, (lo, hi) unclipped,
    (r0, r1))`` on the slab of rows [max(lo, 0), min(hi, height)); a rank
    with no output rows gets ``empty(its input part)``."""
    bounds = row_bounds(out_height, world.size)
    wanted = {r: need(*bounds[r]) for r in range(world.size) if bounds[r][1] > bounds[r][0]}
    slabs = world.fetch(x, {r: (max(lo, 0), min(hi, x.height)) for r, (lo, hi) in wanted.items()})
    return Rows({r: compute(slabs[r], wanted[r], bounds[r]) if r in slabs else empty(x.parts[r])
                 for r in world.ranks}, out_height, dim)


# -- the operations -----------------------------------------------------------


def _windowed(world: RowWorld, x: Rows, k: int, stride: int, pads_h: Span, pads_w: Span, channels: int,
              fn: Callable[[torch.Tensor], torch.Tensor], pad_value: float = 0.0) -> Rows:
    """A k×k window op at ``stride`` over the frame padded by ``pads_h`` /
    ``pads_w``: ``fn`` on each rank's slab, padded by ``pad_value`` in its
    columns and, at the frame's top and bottom, in its rows."""
    height = (x.height + sum(pads_h) - k) // stride + 1
    w_out = (x.width + sum(pads_w) - k) // stride + 1

    def need(r0, r1):
        return r0 * stride - pads_h[0], (r1 - 1) * stride - pads_h[0] + k

    def compute(slab, span, _out):
        lo, hi = span
        return fn(F.pad(slab, (*pads_w, max(-lo, 0), max(hi - x.height, 0)), value=pad_value))

    def empty(part):
        return part.new_empty((part.shape[0], channels, 0, w_out))

    return _layer(world, x, height, need, compute, empty)


def conv(world: RowWorld, x: Rows, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
         pads_h: Span, pads_w: Span, groups: int = 1) -> Rows:
    """A k×k convolution of the frame zero-padded by ``pads_h`` / ``pads_w``, on NCHW rows."""
    return _windowed(world, x, weight.shape[-1], stride, pads_h, pads_w, weight.shape[0],
                     lambda t: F.conv2d(t, weight, bias, stride, 0, 1, groups))


def max_pool(world: RowWorld, x: Rows, k: int, stride: int, pads_h: Span, pads_w: Span) -> Rows:
    """A k×k max pool of the frame padded by −inf."""
    channels = next(iter(x.parts.values())).shape[1]
    return _windowed(world, x, k, stride, pads_h, pads_w, channels, lambda t: F.max_pool2d(t, k, stride),
                     -math.inf)


def conv_module(world: RowWorld, x: Rows, m: nn.Conv2d) -> Rows:
    """An ``nn.Conv2d`` with symmetric zero padding."""
    (ph, pw), s = m.padding, m.stride[0]
    return conv(world, x, m.weight, m.bias, s, (ph, ph), (pw, pw), m.groups)


def conv_same(world: RowWorld, x: Rows, m: nn.Conv2d, weight: Optional[torch.Tensor] = None) -> Rows:
    """TF-SAME padding from the global height and width (``layers.same_pads``),
    with ``weight`` in place of the layer's where given (``StdConv``'s
    standardized kernel)."""
    weight = m.weight if weight is None else weight
    k, s = weight.shape[-1], m.stride[0]
    return conv(world, x, weight, m.bias, s, same_pads(x.height, k, s), same_pads(x.width, k, s), m.groups)


def conv_transpose(world: RowWorld, x: Rows, m: nn.ConvTranspose2d) -> Rows:
    """A transposed conv whose kernel equals its stride s, without padding
    (DPT's reassemble, s = 4 and 2): input row i alone makes output rows
    s·i … s·i + s − 1, so a rank's output rows [o0, o1) come from input rows
    [⌊o0/s⌋, ⌈o1/s⌉), and the slab's output rows outside them are dropped."""
    if (m.kernel_size != m.stride or m.padding != (0, 0) or m.output_padding != (0, 0)
            or m.dilation != (1, 1) or m.groups != 1):
        raise NotImplementedError(f"no row rule for {m}")
    s = m.stride[0]

    def compute(slab, span, out):
        return F.conv_transpose2d(slab, m.weight, m.bias, m.stride)[:, :, out[0] - s * span[0]:out[1] - s * span[0]]

    def empty(part):
        return part.new_empty((part.shape[0], m.out_channels, 0, part.shape[3] * m.stride[1]))

    return _layer(world, x, s * x.height, lambda r0, r1: (r0 // s, -(-r1 // s)), compute, empty)


def group_norm(world: RowWorld, x: Rows, m: nn.GroupNorm) -> Rows:
    """GroupNorm of the whole frame on NCHW rows: each group's mean from
    every rank's sums over its rows, summed over the axis, then its variance
    from the sums of squared deviations from that mean, in float64 (two
    passes: E[x²] − E[x]² would cancel); then, row-local, x·scale + shift
    with scale = weight / √(var + eps) and shift = bias − mean·scale."""
    b, c = next(iter(x.parts.values())).shape[:2]
    g = m.num_groups
    count = c // g * x.height * x.width

    def grouped(t):
        return t.double().reshape(b, g, -1)

    mean = world.sum({r: grouped(t).sum(2) for r, t in x.parts.items()}) / count
    var = world.sum({r: (grouped(t) - mean[..., None]).square().sum(2) for r, t in x.parts.items()}) / count
    scale = torch.rsqrt(var + m.eps).repeat_interleave(c // g, 1) * m.weight
    shift = m.bias - mean.repeat_interleave(c // g, 1) * scale
    dtype = torch.promote_types(next(iter(x.parts.values())).dtype, torch.float32)  # bf16's affine in f32
    scale, shift = (v.to(dtype)[:, :, None, None] for v in (scale, shift))
    return x.map(lambda t: (t.to(dtype) * scale + shift).to(t.dtype))


def grouped_conv(world: RowWorld, x: Rows, m: GroupedConv3x3) -> Rows:
    """The bottleneck's grouped 3×3: at stride 1, K4 on the slab with one halo
    row each side, its interior rows kept; at stride 2, ``F.conv2d``."""
    if m.stride != (1, 1):
        return conv_module(world, x, m)

    def compute(slab, span, out):
        r0, r1 = out
        first = max(span[0], 0)
        return grouped_conv3x3(slab.contiguous(), m.weight, m.groups)[:, :, r0 - first:r1 - first]

    def empty(part):
        return part.new_empty((part.shape[0], m.weight.shape[0], 0, part.shape[3]))

    return _layer(world, x, x.height, lambda r0, r1: (r0 - 1, r1 + 1), compute, empty)


def _lerp(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """out[..., o, ...] = Σ_j w[o, j] · x[..., idx[o, j], ...] along ``dim``."""
    taps = x.index_select(dim, idx.reshape(-1)).unflatten(dim, idx.shape)
    shape = [1] * taps.dim()
    shape[dim:dim + 2] = w.shape
    return (taps * w.to(x.dtype).reshape(shape)).sum(dim + 1)


def upsample2x(world: RowWorld, x: Rows, align_corners: bool) -> Rows:
    """2× bilinear upsampling (``models.midas_small.upsample2x``): each output
    row's two source rows and weights from the global row index (the linear
    tap table of the whole height), then the columns' the same way."""
    idx = band_taps(x.height, 2 * x.height, "linear", align_corners)[0]

    def need(r0, r1):
        return int(idx[r0:r1, 0].min()), int(idx[r0:r1].max()) + 1

    def compute(slab, span, out):
        r0, r1 = out
        h_idx, h_w = _device_taps(x.height, 2 * x.height, "linear", align_corners, slab.device)
        rows = _lerp(slab, h_idx[r0:r1] - span[0], h_w[r0:r1], 2)
        w_in = slab.shape[3]
        return _lerp(rows, *_device_taps(w_in, 2 * w_in, "linear", align_corners, slab.device), 3)

    def empty(part):
        return part.new_empty((*part.shape[:2], 0, 2 * part.shape[3]))

    return _layer(world, x, 2 * x.height, need, compute, empty)


def resize_rows(world: RowWorld, x: Rows, out_hw: Tuple[int, int]) -> Rows:
    """K3 (bicubic, align_corners=False) of (B, h, w) planes cut by rows, on output-row windows."""

    def compute(slab, span, out):
        lo = max(span[0], 0)
        return resize_planes(slab.contiguous(), out_hw, window=(*out, x.height, lo))

    def empty(part):
        return part.new_empty((part.shape[0], 0, out_hw[1]))

    return _layer(world, x, out_hw[0], lambda r0, r1: window_rows(x.height, out_hw[0], r0, r1), compute, empty, 1)


def preprocess_rows(world: RowWorld, frames: Rows, net_hw: Tuple[int, int], mean, std, bgr: bool = True) -> Rows:
    """K2 of u8 (B, H, W, 3) frames cut by rows, on output-row windows → (B, 3, h, w) rows."""

    def compute(slab, span, out):
        return fused_preprocess(slab.contiguous(), net_hw, mean, std, bgr_to_rgb=bgr,
                                window=(*out, frames.height, max(span[0], 0)))

    def empty(part):
        return part.new_empty((part.shape[0], 3, 0, net_hw[1]), dtype=torch.float32)

    return _layer(world, frames, net_hw[0], lambda r0, r1: window_rows(frames.height, net_hw[0], r0, r1), compute,
                  empty)


# -- the families, layer by layer ----------------------------------------------


def _bottleneck(world, x, m: ResNeXtBottleneck):
    sc = x if m.downsample is None else apply(world, m.downsample, x)
    h = conv_module(world, x, m.conv1).map(lambda t: F.relu(m.bn1(t)))
    h = grouped_conv(world, h, m.conv2).map(lambda t: F.relu(m.bn2(t)))
    h = conv_module(world, h, m.conv3).map(m.bn3)
    return (h + sc).map(F.relu)


def _resnetv2_bottleneck(world, x, m: ResNetV2Bottleneck):
    sc = x if m.downsample is None else apply(world, m.downsample, x)
    h = apply(world, m.norm1, apply(world, m.conv1, x))
    h = apply(world, m.norm2, apply(world, m.conv2, h))
    h = apply(world, m.norm3, apply(world, m.conv3, h))
    return (h + sc).map(F.relu)


def _depthwise_separable(world, x, m: DepthwiseSeparable):
    h = conv_same(world, x, m.conv_dw).map(lambda t: F.relu6(m.bn1(t)))
    h = conv_module(world, h, m.conv_pw).map(m.bn2)
    return h + x if m.residual else h


def _inverted_residual(world, x, m: InvertedResidual):
    h = conv_module(world, x, m.conv_pw).map(lambda t: F.relu6(m.bn1(t)))
    h = conv_same(world, h, m.conv_dw).map(lambda t: F.relu6(m.bn2(t)))
    h = conv_module(world, h, m.conv_pwl).map(m.bn3)
    return h + x if m.residual else h


def _residual_conv_unit(world, x, m: ResidualConvUnit):
    h = conv_module(world, x.map(F.relu), m.conv1)
    return conv_module(world, h.map(F.relu), m.conv2) + x


def _fusion(world, m, x, skip=None):
    """``FeatureFusionBlock`` (MiDaS_small and DPT, with its 1×1 ``out_conv``) or ``FeatureFusionBlockV21``."""
    h = x if skip is None else x + _residual_conv_unit(world, skip, m.resConfUnit1)
    h = _residual_conv_unit(world, h, m.resConfUnit2)
    if isinstance(m, FeatureFusionBlock):
        h = conv_module(world, h, m.out_conv)
    return upsample2x(world, h, getattr(m, "align_corners", True))  # v2.1's block is align_corners=True


_ROW_LOCAL = (FrozenBatchNorm2d, nn.ReLU, nn.ReLU6, nn.Identity)


def apply(world: RowWorld, m: nn.Module, x: Rows) -> Rows:
    """``m(x)`` on NCHW rows, for the modules of the four families; any
    other module raises, so that none runs unpartitioned by mistake."""
    if isinstance(m, nn.Sequential):
        for child in m:
            x = apply(world, child, x)
        return x
    if isinstance(m, _ROW_LOCAL):
        return x.map(m)
    if isinstance(m, GroupNormAct):
        h = group_norm(world, x, m)
        return h.map(F.relu) if m.act else h
    if isinstance(m, UpsampleConv3x3):
        return conv_module(world, upsample2x(world, x, m.align_corners), m)
    if isinstance(m, GroupedConv3x3):
        return grouped_conv(world, x, m)
    if isinstance(m, StdConv):
        return conv_same(world, x, m, standardize(m.weight))
    if isinstance(m, Conv2dSame):
        return conv_same(world, x, m)
    if isinstance(m, nn.Conv2d):
        return conv_module(world, x, m)
    if isinstance(m, nn.ConvTranspose2d):
        return conv_transpose(world, x, m)
    if isinstance(m, nn.MaxPool2d):
        p = m.padding if isinstance(m.padding, int) else m.padding[0]
        if m.ceil_mode or m.dilation not in (1, (1, 1)):
            raise NotImplementedError(f"no row rule for {m}")
        return max_pool(world, x, m.kernel_size, m.stride, (p, p), (p, p))
    for kind, rule in ((ResNeXtBottleneck, _bottleneck), (ResNetV2Bottleneck, _resnetv2_bottleneck),
                       (DepthwiseSeparable, _depthwise_separable), (InvertedResidual, _inverted_residual),
                       (ResidualConvUnit, _residual_conv_unit)):
        if isinstance(m, kind):
            return rule(world, x, m)
    raise NotImplementedError(f"no row rule for {type(m).__name__}")


def _resnetv2(world, m: ResNetV2Stem, x: Rows) -> Tuple[Rows, List[Rows]]:
    """DPT_Hybrid's stem (``ResNetV2Stem.forward``): the stem conv, its
    GroupNorm and the TF-SAME 3×3/2 max pool, then the three stages →
    (stage 3's rows, [stage 1's, stage 2's])."""
    h = apply(world, m.stem.norm, apply(world, m.stem.conv, x))
    h = max_pool(world, h, 3, 2, same_pads(h.height, 3, 2), same_pads(h.width, 3, 2))
    outs = []
    for stage in m.stages:
        h = apply(world, stage.blocks, h)
        outs.append(h)
    return outs[-1], outs[:-1]


def embed_tokens(world: RowWorld, vit: ViT, patches: Rows) -> torch.Tensor:
    """The ViT's tokens (B, 1 + gh·gw, C), whole on every rank: each rank
    flattens its patch rows to tokens and adds its rows of the position
    embedding (resized once, whole), rank 0 leading with the cls token;
    then the ranks' tokens are gathered."""
    gh, gw = patches.height, patches.width
    pos = resize_pos_embed(vit.pos_embed, (gh, gw), vit.orig_grid)
    spans = [(0 if r == 0 else 1 + r0 * gw, 1 + r1 * gw) for r, (r0, r1) in enumerate(row_bounds(gh, world.size))]
    parts = {}
    for r, t in patches.parts.items():
        tokens = t.flatten(2).transpose(1, 2)
        if r == 0:
            tokens = torch.cat([vit.cls_token.expand(t.shape[0], -1, -1), tokens], 1)
        parts[r] = tokens + pos[:, spans[r][0]:spans[r][1]]
    return world.gather(Rows(parts, 1 + gh * gw, 1), spans)


def reassemble(world: RowWorld, m: Reassemble, hook: torch.Tensor, grid: Tuple[int, int]) -> Rows:
    """DPT's reassemble of the whole hook tokens on each rank's grid rows:
    the readout folds the cls token (token 0) into each token, so it and the
    1×1 projection are row-local; then the resample's rule."""
    gh, gw = grid
    bounds = row_bounds(gh, world.size)
    parts = {}
    for r in world.ranks:
        r0, r1 = bounds[r]
        t = m._modules["0"](torch.cat([hook[:, :1], hook[:, 1 + r0 * gw:1 + r1 * gw]], 1))
        parts[r] = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], r1 - r0, gw)
    return apply(world, m._modules["4"], apply(world, m._modules["3"], Rows(parts, gh, 2)))


def _decoder(world, s: nn.Module, layers: Sequence[Rows]) -> Rows:
    """The four ``layer*_rn`` convs, the four fusion blocks and the head on
    the pyramid's four levels → (B, H, W) rows."""
    rn = [apply(world, getattr(s, f"layer{i + 1}_rn"), layers[i]) for i in range(4)]
    p4 = _fusion(world, s.refinenet4, rn[3])
    p3 = _fusion(world, s.refinenet3, p4, rn[2])
    p2 = _fusion(world, s.refinenet2, p3, rn[1])
    p1 = _fusion(world, s.refinenet1, p2, rn[0])
    out = apply(world, s.output_conv, p1)
    return Rows({r: t[:, 0] for r, t in out.parts.items()}, out.height, 1)


def _dpt(world, model: DPT, x: Rows) -> Rows:
    """``DPT.forward`` on rows: the patch embedding (DPT_Hybrid's stem and
    projection, or DPT_Large's stride-16 conv), the tokens, the ViT's blocks
    over the axis's group (``ViT.trunk``; whole in a local world), each
    hook reassembled on the ranks' grid rows, and the decoder."""
    vit = model.pretrained.model
    embed = vit.patch_embed
    if isinstance(embed, HybridEmbed):
        feats, levels = _resnetv2(world, embed.backbone, x)
    else:
        if x.height % embed.patch or x.width % embed.patch:
            raise ValueError(f"input {x.height}x{x.width} not a multiple of patch {embed.patch}")
        feats, levels = x, []
    patches = apply(world, embed.proj, feats)
    hooked = vit.trunk(embed_tokens(world, vit, patches), world.group)
    grid = (patches.height, patches.width)
    return _decoder(world, model.scratch, levels + [
        reassemble(world, getattr(model.pretrained, f"act_postprocess{len(levels) + i + 1}"), t, grid)
        for i, t in enumerate(hooked)])


_FAMILIES = (MidasV21, MidasSmall, DPT)


def _check_family(model: nn.Module) -> None:
    if not isinstance(model, _FAMILIES):
        raise NotImplementedError(f"{type(model).__name__}: no spatial program (predict_spatial runs DPT_Large, "
                                  "DPT_Hybrid, MiDaS v2.1 and MiDaS_small)")


def forward_rows(world: RowWorld, model: nn.Module, x: Rows) -> Rows:
    """The network's forward on (B, 3, H, W) rows → (B, H, W) rows: for the
    conv families the encoder's four taps, for DPT its patch rows, tokens and
    reassembled hooks (``_dpt``), then the four fusion blocks and the head,
    as the families' forwards run them."""
    _check_family(model)
    if isinstance(model, DPT):
        return _dpt(world, model, x)
    pre = model.pretrained
    l1 = apply(world, pre.layer1, x)
    l2 = apply(world, pre.layer2, l1)
    l3 = apply(world, pre.layer3, l2)
    return _decoder(world, model.scratch, [l1, l2, l3, apply(world, pre.layer4, l3)])


def spatial_forward(world: RowWorld, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` with the rows of every layer cut over ``world``: x is the
    whole (B, 3, H, W) input on every rank, the whole (B, H, W) output comes
    back on every rank."""
    return world.gather(forward_rows(world, model, world.shard(x, 2)))


def spatial_depth(world: RowWorld, est, frames: torch.Tensor) -> torch.Tensor:
    """The frame program of ``est`` (a ``DepthEstimator``) on u8 (B, H, W, 3)
    frames on its device, the rows of every layer cut over ``world``: K2 on
    each rank's network-input rows, the network, K3 on each rank's source
    rows; the whole (B, H, W) f32 map on every rank. The caller enters
    inference mode and the estimator's numerics."""
    _check_family(est.model)
    in_hw = (int(frames.shape[1]), int(frames.shape[2]))
    cfg = est.preprocess_cfg
    net_hw = compute_resize_shape(*in_hw, cfg)
    x = preprocess_rows(world, world.shard(frames, 1), net_hw, cfg.mean, cfg.std).map(lambda t: t.to(est.dtype))
    pred = forward_rows(world, est.model, x).map(lambda t: t.float())
    return world.gather(resize_rows(world, pred, in_hw))
