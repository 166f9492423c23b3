"""DepthEstimator — the reference's top-level depth API on PyTorch.

Mirrors ``DepthEstimator`` (reference: depth_midas.py:6-35) and the JAX
package's ``estimator.py``: construct by model-type string, call
``.predict(bgr_u8_image) -> float32 HxW relative inverse depth``.

The frame program (JAX ``estimator.py:95-132``) runs on the estimator's
device: the u8 frame is copied to the device as it is, kernel K2 flips
BGR→RGB, scales, resizes and normalizes it, the network runs, and kernel K3
upsamples the depth map back to the source size (bicubic,
align_corners=False, depth_midas.py:28-33). On the CPU the kernels' plain
versions run instead. In float32 the program runs matmuls and convolutions
in full f32 (``device.full_f32``); bfloat16 is an opt-in speed mode with no
parity gate. In either type cuDNN picks each convolution's algorithm by timing
(``device.conv_algorithms_by_timing``); the first call at a new shape pays
for the search.

Over a mesh of ranks (``parallel.mesh.make_mesh``), every rank calls the
same method: ``predict_batch_sharded`` runs the rank's dp slice of a batch
and all-gathers the maps over dp, ``predict_sharded`` runs one frame with
the transformer matmuls tensor-parallel over tp, and ``predict_spatial``
one frame with the rows of every layer cut over a mesh axis
(``parallel/spatial.py``). Each returns the whole result on every rank.
"""

from __future__ import annotations

import contextlib
import copy
import math
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32, resolve_device
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d, PReLU
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.registry import get_entry
from depth_estimation_tpu_torch.runtime import tracing
from depth_estimation_tpu_torch.utils import checkpoint
from depth_estimation_tpu_torch.utils.debug import check_depth_output, check_frame_input

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Deterministic random weights for ``model`` from ``seed``, made on the
    CPU so that every device gets the same ones. Pipeline-valid and
    numerically meaningless: weights ~ N(0, 1/fan_in), biases ~ N(0, 0.02²),
    LayerNorm, GroupNorm and frozen batch norm at identity, PReLU slopes at
    0.25 (the detector nets'), embeddings ~ N(0, 0.02²). Covers buffers too,
    since the model is built on the meta device."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, mod in model.named_modules():
        for name, p in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm2d)):
                v = torch.ones(p.shape) if name in ("weight", "running_var") else torch.zeros(p.shape)
            elif isinstance(mod, PReLU):
                v = torch.full(p.shape, 0.25)
            elif name == "weight" and p.dim() >= 2:
                fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
                v = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            else:  # biases, cls token, position embedding
                v = 0.02 * torch.randn(p.shape, generator=g)
            sd[f"{prefix}.{name}" if prefix else name] = v
    return sd


def _unread_hub_key(key: str) -> bool:
    """Keys a hub checkpoint carries that the forward never reads, skipped
    by the JAX converters too: BatchNorm's step counters, the top fusion
    block's first unit, which never gets a skip input, and the timm ViT's
    final LayerNorm and classifier (DPT reads its hooks before that norm and
    classifies nothing). Any other missing or unexpected key makes the strict
    load raise."""
    return key.endswith(".num_batches_tracked") or key.startswith(
        ("scratch.refinenet4.resConfUnit1.", "pretrained.model.norm.", "pretrained.model.head."))


class DepthEstimator:
    def __init__(
        self,
        model_type: str,
        params: Optional[Mapping] = None,
        seed: int = 0,
        verbose: bool = True,
        dtype: str = "float32",
        device="cuda",
    ):
        """params: a state dict with the torch-hub key names (tensors or
        numpy arrays), such as a hub checkpoint; None means the cached one
        (``utils/checkpoint.py``, filled by ``tools.import_weights``), or
        random weights from ``seed`` when there is none.
        dtype: 'float32' (parity with the reference) or 'bfloat16'.
        device: 'cuda' by default; 'cpu' must be asked for, and runs the
        kernels' plain PyTorch versions."""
        self.model_type = model_type
        if verbose:
            print(f"Loading model: {self.model_type}")  # reference: depth_midas.py:9
        self.entry = get_entry(model_type)
        self.device = resolve_device(device)
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.dtype = _DTYPES[dtype]
        self.preprocess_cfg = self.entry.preprocess

        with torch.device("meta"):  # shapes only; the weights come below
            model = self.entry.make_model()
        if params is None:
            params = checkpoint.load_params(model_type)
        if params is None:
            warnings.warn(
                f"No weights given or cached for {model_type!r}; using random initialization "
                f"(seed {seed}). Pass a torch-hub state dict as params=, or import one with "
                f"`python -m depth_estimation_tpu_torch.tools.import_weights <ckpt.pt> {model_type}`.",
                stacklevel=2,
            )
            params = random_state_dict(model, seed)
        model = model.to_empty(device=self.device)
        model.load_state_dict(
            {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
             for k, v in params.items() if not _unread_hub_key(k)})
        self.model = model.to(self.dtype).eval()
        self._fn_cache: Dict[Tuple, object] = {}
        self._mesh_params: Dict[Tuple, nn.Module] = {}

    # -- frame program --------------------------------------------------------

    def _numerics(self):
        stack = contextlib.ExitStack()
        stack.enter_context(conv_algorithms_by_timing())
        if self.dtype == torch.float32:
            stack.enter_context(full_f32())
        return stack

    def _to_device(self, imgs) -> torch.Tensor:
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        return imgs.to(self.device, non_blocking=True).contiguous()

    def _program(self, imgs, output: str = "f32") -> torch.Tensor:
        """The frame program on host (or device) u8 BGR frames (B, H, W, 3):
        the copy to the device, then ``_run``. Its spans time the host's
        enqueue, not the device's work."""
        with tracing.span("program", rows=len(imgs)):
            with tracing.span("program.upload"):
                imgs = self._to_device(imgs)
            return self._run(imgs, output)

    def _run(self, imgs: torch.Tensor, output: str = "f32", model: Optional[nn.Module] = None) -> torch.Tensor:
        """u8 BGR (B, H, W, 3) on the device → (B, H, W) float32 depth, or
        with output='u8' the reference's wrap-around uint8 cast of it
        (depth_midas.py:83), cast by K3 itself, so the stream fetches a quarter
        of the bytes. ``model``: the network to run, by default ``self.model``."""
        with torch.inference_mode(), self._numerics():
            return self.depth_branch(imgs, output, model=model)

    def depth_branch(self, imgs: torch.Tensor, output: str = "f32", bgr: bool = True,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     model: Optional[nn.Module] = None) -> torch.Tensor:
        """``_run``'s body, for a caller that has entered inference mode and
        ``_numerics()`` itself (the fused frame program): K2, the network, K3.
        ``bgr=False`` takes RGB frames. ``params``: a state dict that the
        network runs on in place of its own (``torch.func.functional_call``).
        ``model``: another network to run (a rank's tp shard)."""
        in_hw = (int(imgs.shape[1]), int(imgs.shape[2]))
        cfg = self.preprocess_cfg
        net_hw = compute_resize_shape(*in_hw, cfg)
        with tracing.span("program.k2"):
            x = fused_preprocess(imgs, net_hw, cfg.mean, cfg.std, bgr_to_rgb=bgr).to(self.dtype)
        net = self.model if model is None else model
        with tracing.span("program.network"):
            pred = (net(x) if params is None else functional_call(net, params, (x,))).float()  # (B, h, w)
        with tracing.span("program.k3"):
            return resize_planes(pred, in_hw, "cubic", align_corners=False, output=output)

    def frame_fn(self, in_hw: Tuple[int, int], bgr: bool = True, output: str = "f32"):
        """The frame program at source size ``in_hw`` with the weights as an
        argument (JAX ``frame_fn``): fn(params, img_u8 (H, W, 3)) → (H, W)
        float32 depth, or with output='u8' its wrap-around uint8 cast.
        ``params`` is a state dict of the model's keys (``self.params``); the
        frame is a tensor on the estimator's device or a numpy array. Cached
        per (in_hw, bgr, output)."""
        return self._frame_fn(in_hw, bgr, output, batched=False)

    def batched_frame_fn(self, in_hw: Tuple[int, int], bgr: bool = True, output: str = "f32"):
        """``frame_fn`` for (B, H, W, 3) batches: fn(params, imgs) → (B, H, W),
        one K2 launch, one network pass and one K3 launch a batch."""
        return self._frame_fn(in_hw, bgr, output, batched=True)

    def _frame_fn(self, in_hw, bgr, output, batched):
        key = (int(in_hw[0]), int(in_hw[1]), bool(bgr), output, batched)
        if key not in self._fn_cache:
            hw = key[:2]

            def frame(params, img):
                imgs = self._to_device(img if batched else img[None])
                if tuple(imgs.shape[1:3]) != hw:
                    raise ValueError(f"frames of {tuple(imgs.shape[1:3])} given to the {hw} program")
                with torch.inference_mode(), self._numerics():
                    out = self.depth_branch(imgs, output, bool(bgr), params)
                return out if batched else out[0]

            self._fn_cache[key] = frame
        return self._fn_cache[key]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict, the weights that ``frame_fn``'s programs take."""
        return self.model.state_dict()

    # -- public API -----------------------------------------------------------

    def predict(self, img: np.ndarray) -> np.ndarray:
        """BGR uint8 (H, W, 3) → float32 (H, W) relative inverse depth
        (reference: depth_midas.py:21-35)."""
        check_frame_input(img)
        out = self._program(img[None]).cpu().numpy()[0]
        check_depth_output(out, img.shape[:2])
        return out

    def predict_device(self, img) -> torch.Tensor:
        """Same as predict, but the (H, W) float32 map stays on the device."""
        return self._program(img[None])[0]

    def predict_device_u8(self, img) -> torch.Tensor:
        """The depth map with the reference's raw uint8 cast (wraparound
        preserved) applied on the device, left there: the streaming loop's
        path, which copies H×W bytes back instead of 4·H×W."""
        return self._program(img[None], "u8")[0]

    def predict_batch(self, imgs: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) BGR uint8 → (B, H, W) float32, one frame program."""
        return self._batched_fn(imgs.shape[1:3])(imgs).cpu().numpy()

    def _params_for_mesh(self, mesh, tensor_parallel: bool) -> nn.Module:
        """The network this rank runs on ``mesh``: a copy cut to the rank's tp
        shard (``parallel.mesh.tensor_parallel``) when asked for and the mesh
        has a tp axis over 1, else the estimator's own (replicated). Cached
        per (mesh, mode); a model with no transformer block is never cut."""
        from depth_estimation_tpu_torch.parallel.mesh import axis_size, tensor_parallel as cut

        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh given to an estimator on {self.device}")
        tp = tensor_parallel and axis_size(mesh, "tp") > 1
        key = (mesh, tp)
        if key not in self._mesh_params:
            self._mesh_params[key] = cut(copy.deepcopy(self.model), mesh) if tp else self.model
        return self._mesh_params[key]

    def predict_batch_sharded(self, imgs: np.ndarray, mesh, tensor_parallel: bool = True) -> np.ndarray:
        """Batched inference over a mesh (JAX ``predict_batch_sharded``):
        (B, H, W, 3) BGR u8, the same on every rank → (B, H, W) float32 on
        every rank. Each rank runs K2, the network and K3 on its contiguous
        dp slice (B must divide by dp), with the transformer matmuls
        tensor-parallel over tp when the mesh has a tp axis over 1, and the
        maps are all-gathered over dp."""
        from depth_estimation_tpu_torch.parallel.mesh import batch_slice, gather_batch

        model = self._params_for_mesh(mesh, tensor_parallel)
        local = self._run(self._to_device(batch_slice(imgs, mesh)), model=model)
        return gather_batch(local, mesh).cpu().numpy()

    def predict_sharded(self, img: np.ndarray, mesh) -> np.ndarray:
        """One frame with the transformer matmuls tensor-parallel over the
        mesh's tp axis (JAX ``predict_sharded``): the frame replicated on
        every rank, qkv/fc1 column-parallel and proj/fc2 row-parallel, two
        all-reduces a block. (H, W) float32 on every rank. A conv-only model
        runs replicated."""
        model = self._params_for_mesh(mesh, tensor_parallel=True)
        return self._run(self._to_device(np.asarray(img)[None]), model=model)[0].cpu().numpy()

    def predict_spatial(self, img: np.ndarray, mesh, axis: str = "tp") -> np.ndarray:
        """One frame spatially partitioned over the mesh axis ``axis`` (JAX
        ``predict_spatial``): the source frame's rows are cut over the axis's
        ranks, and every layer's output rows after them, each rank fetching
        the halo rows its convolutions, upsamplings and resizes read from the
        ranks that own them (``parallel/spatial.py``): K2 and K3 on row
        windows, K4 on halo'd slabs. The DPT families cut their patch rows
        the same way (DPT_Hybrid's stem too, its GroupNorms' statistics
        summed over the axis) and run the ViT's blocks sequence-parallel over
        the axis's group, K1 on each rank's queries against the gathered
        keys. The weights are replicated; the whole (H, W) float32 map comes
        back on every rank. The source height must divide by the axis size
        (``ValueError``). All four families run so."""
        from depth_estimation_tpu_torch.parallel.mesh import axis_size
        from depth_estimation_tpu_torch.parallel.spatial import RowWorld, spatial_depth

        img = np.asarray(img)
        n = axis_size(mesh, axis)
        if img.shape[0] % n:
            raise ValueError(f"source height {img.shape[0]} not divisible by mesh axis {axis!r} of size {n}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh given to an estimator on {self.device}")
        world = RowWorld.over(mesh, axis)
        with torch.inference_mode(), self._numerics():
            return spatial_depth(world, self, self._to_device(img[None]))[0].cpu().numpy()

    def _batched_fn(self, in_hw: Tuple[int, int], output: str = "f32"):
        """The frame program for (B, H, W, 3) batches at source size ``in_hw``:
        one K2 launch, one network pass and one K3 launch per batch."""
        in_hw = (int(in_hw[0]), int(in_hw[1]))

        def batch_fn(imgs):
            if tuple(imgs.shape[1:3]) != in_hw:
                raise ValueError(f"batch of {tuple(imgs.shape[1:3])} frames given to the {in_hw} program")
            return self._program(imgs, output)

        return batch_fn
