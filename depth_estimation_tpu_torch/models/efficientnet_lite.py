"""EfficientNet-Lite3 encoder (``tf_efficientnet_lite3``), the MiDaS_small backbone, NCHW.

Counterpart of the JAX package's ``models/efficientnet_lite.py``. Lite: no
squeeze-excite, ReLU6, TF-SAME padding, batch norm eps 1e-3. Module names
follow the hub's ``MidasNet_small``, which regroups geffnet's stages into four
Sequentials (``utils/convert.py::lite3_hub_prefix`` of the JAX package):

  layer1 = [conv_stem, bn1, ReLU6, stage 0, stage 1]   tap, stride 4
  layer2 = [stage 2]                                   tap, stride 8
  layer3 = [stage 3, stage 4]                          tap, stride 16
  layer4 = [stage 5, stage 6]                          tap, stride 32
"""

from __future__ import annotations

from torch import nn

from depth_estimation_tpu_torch.models.layers import (
    LITE_BN_EPS,
    Conv2dSame,
    DepthwiseSeparable,
    FrozenBatchNorm2d,
    InvertedResidual,
)

# (block type, repeats, kernel, stride, expand, out_channels), width 1.2 / depth 1.4
LITE3_STAGES = (
    ("ds", 1, 3, 1, 1, 24),
    ("ir", 3, 3, 2, 6, 32),
    ("ir", 3, 5, 2, 6, 48),
    ("ir", 5, 3, 2, 6, 96),
    ("ir", 5, 5, 1, 6, 136),
    ("ir", 6, 5, 2, 6, 232),
    ("ir", 1, 3, 1, 6, 384),
)
STEM_FEATURES = 32
# the geffnet stages that each hub layer holds
LAYER_STAGES = ((0, 1), (2,), (3, 4), (5, 6))


def _stage(in_c: int, stage: int) -> nn.Sequential:
    btype, reps, k, s, e, c = LITE3_STAGES[stage]
    blocks = []
    for bi in range(reps):
        stride = s if bi == 0 else 1
        if btype == "ds":
            blocks.append(DepthwiseSeparable(in_c, c, k, stride))
        else:
            blocks.append(InvertedResidual(in_c, c, k, stride, e))
        in_c = c
    return nn.Sequential(*blocks)


class EfficientNetLite3(nn.Module):
    """Returns the four MiDaS feature taps (32, 48, 136 and 384 channels)."""

    def __init__(self):
        super().__init__()
        in_c = STEM_FEATURES
        for li, stages in enumerate(LAYER_STAGES, start=1):
            mods = []
            if li == 1:
                mods = [Conv2dSame(3, STEM_FEATURES, 3, 2), FrozenBatchNorm2d(STEM_FEATURES, LITE_BN_EPS), nn.ReLU6()]
            for si in stages:
                mods.append(_stage(in_c, si))
                in_c = LITE3_STAGES[si][-1]
            self.add_module(f"layer{li}", nn.Sequential(*mods))

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)
