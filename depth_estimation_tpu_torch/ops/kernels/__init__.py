"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each kernel is a ``torch.library`` custom operator under the namespace
``depth_tpu_torch`` (``attention``, ``preprocess``, ``resize_planes``,
``grouped_conv3x3``, ``linear``): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and a fake implementation lets
``torch.export`` and ``torch.compile`` trace it. Importing this package
registers them, which is all a loaded ``utils/export.py`` program needs.

Each wrapper counts its kernel launches in a plain integer attribute,
``launches``, so a run can show that the main path went through it.
"""

from depth_estimation_tpu_torch.ops.kernels.attention import multi_head_attention
from depth_estimation_tpu_torch.ops.kernels.grouped_conv import grouped_conv3x3
from depth_estimation_tpu_torch.ops.kernels.dense import linear
from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, resize_planes

WRAPPERS = (multi_head_attention, fused_preprocess, resize_planes, grouped_conv3x3, linear)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
