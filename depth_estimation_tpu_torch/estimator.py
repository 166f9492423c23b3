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
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32, resolve_device
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes
from depth_estimation_tpu_torch.ops.postprocess import wraparound_u8
from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
from depth_estimation_tpu_torch.registry import get_entry
from depth_estimation_tpu_torch.utils.debug import check_depth_output, check_frame_input

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Deterministic random weights for ``model`` from ``seed``, made on the
    CPU so that every device gets the same ones. Pipeline-valid and
    numerically meaningless: weights ~ N(0, 1/fan_in), biases ~ N(0, 0.02²),
    LayerNorm and frozen batch norm at identity, embeddings ~ N(0, 0.02²).
    Covers buffers too, since the model is built on the meta device."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, mod in model.named_modules():
        for name, p in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if isinstance(mod, (nn.LayerNorm, FrozenBatchNorm2d)):
                v = torch.ones(p.shape) if name in ("weight", "running_var") else torch.zeros(p.shape)
            elif name == "weight" and p.dim() >= 2:
                fan_in = p.shape[0] if isinstance(mod, nn.ConvTranspose2d) else p[0].numel()
                v = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            else:  # biases, cls token, position embedding
                v = 0.02 * torch.randn(p.shape, generator=g)
            sd[f"{prefix}.{name}" if prefix else name] = v
    return sd


def _unread_hub_key(key: str) -> bool:
    """Keys a hub checkpoint carries that the forward never reads, skipped
    by the JAX converters too: BatchNorm's step counters and the top fusion
    block's first unit, which never gets a skip input. Any other missing or
    unexpected key makes the strict load raise."""
    return key.endswith(".num_batches_tracked") or key.startswith("scratch.refinenet4.resConfUnit1.")


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
        numpy arrays), such as a hub checkpoint; None means random weights
        from ``seed``.
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
            warnings.warn(
                f"No weights given for {model_type!r}; using random initialization "
                f"(seed {seed}). Pass a torch-hub state dict as params=.",
                stacklevel=2,
            )
            params = random_state_dict(model, seed)
        model = model.to_empty(device=self.device)
        model.load_state_dict(
            {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
             for k, v in params.items() if not _unread_hub_key(k)})
        self.model = model.to(self.dtype).eval()

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

    def _run(self, imgs: torch.Tensor, output: str = "f32") -> torch.Tensor:
        """u8 BGR (B, H, W, 3) on the device → (B, H, W) float32 depth, or
        with output='u8' the reference's wrap-around uint8 cast of it
        (depth_midas.py:83), so the stream fetches a quarter of the bytes."""
        in_hw = (int(imgs.shape[1]), int(imgs.shape[2]))
        cfg = self.preprocess_cfg
        net_hw = compute_resize_shape(*in_hw, cfg)
        with torch.inference_mode(), self._numerics():
            x = fused_preprocess(imgs, net_hw, cfg.mean, cfg.std, bgr_to_rgb=True)
            pred = self.model(x.to(self.dtype)).float()  # (B, h, w)
            out = resize_planes(pred, in_hw, "cubic", align_corners=False)
            return wraparound_u8(out) if output == "u8" else out

    # -- public API -----------------------------------------------------------

    def predict(self, img: np.ndarray) -> np.ndarray:
        """BGR uint8 (H, W, 3) → float32 (H, W) relative inverse depth
        (reference: depth_midas.py:21-35)."""
        check_frame_input(img)
        out = self._run(self._to_device(img[None])).cpu().numpy()[0]
        check_depth_output(out, img.shape[:2])
        return out

    def predict_device(self, img) -> torch.Tensor:
        """Same as predict, but the (H, W) float32 map stays on the device."""
        return self._run(self._to_device(img[None]))[0]

    def predict_device_u8(self, img) -> torch.Tensor:
        """The depth map with the reference's raw uint8 cast (wraparound
        preserved) applied on the device, left there: the streaming loop's
        path, which copies H×W bytes back instead of 4·H×W."""
        return self._run(self._to_device(img[None]), "u8")[0]

    def predict_batch(self, imgs: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) BGR uint8 → (B, H, W) float32, one frame program."""
        return self._batched_fn(imgs.shape[1:3])(imgs).cpu().numpy()

    def _batched_fn(self, in_hw: Tuple[int, int], output: str = "f32"):
        """The frame program for (B, H, W, 3) batches at source size ``in_hw``:
        one K2 launch, one network pass and one K3 launch per batch."""
        in_hw = (int(in_hw[0]), int(in_hw[1]))

        def batch_fn(imgs):
            if tuple(imgs.shape[1:3]) != in_hw:
                raise ValueError(f"batch of {tuple(imgs.shape[1:3])} frames given to the {in_hw} program")
            return self._run(self._to_device(imgs), output)

        return batch_fn
