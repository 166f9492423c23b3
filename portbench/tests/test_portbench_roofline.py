"""The operation and byte counts against the kernel table's figures in
PERF.md: K1 2.42 GFLOP and 12.6 MB (f32) at (1, 16, 769, 64); K2 0.9 MB in
and 2.4 MB out at 480x640 → 3x384x512; K3 0.8 MB in and 1.2 MB out back;
DPT_Large's trunk 24 blocks of 21.8 GFLOP at 769 tokens."""

import json
import pathlib
import sys
import types

import pytest
import torch

from portbench import roofline
from portbench.reference.dpt import Block

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_k1_counts():
    flops, nbytes = roofline.attention_cost(1, 16, 769, 769, 64, 4)
    assert flops == pytest.approx(2.42e9, rel=2e-3)
    assert nbytes == pytest.approx(12.6e6, rel=2e-3)
    bound = roofline.bound_s(flops, nbytes, 495e12, 3.35e12)
    assert bound == pytest.approx(2.42e9 / 495e12, rel=2e-3)  # bound by operations


def test_k2_k3_counts():
    f2, b2 = roofline.preprocess_cost(1, (480, 640), (384, 512))
    assert b2 == pytest.approx(0.92e6 + 2.36e6, rel=1e-2)
    f3, b3 = roofline.upsample_cost(1, (384, 512), (480, 640), 4)
    assert b3 == pytest.approx(0.79e6 + 1.23e6, rel=1e-2)
    assert roofline.upsample_cost(1, (384, 512), (480, 640), 1)[1] == pytest.approx(0.79e6 + 0.31e6, rel=1e-2)
    for f, b in ((f2, b2), (f3, b3)):  # both bound by bytes
        assert b / 3.35e12 > f / 67e12


def test_a_block_counted_by_shapes_is_torchs_count():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        block = Block(1024, 16, 4096, 1e-6)
        x = torch.empty(1, 769, 1024)
        with FlopCounterMode(display=False) as c, torch.no_grad():
            block(x)
    assert c.get_total_flops() == roofline.vit_block_flops(769, 1024, 4096)
    assert 24 * roofline.vit_block_flops(769, 1024, 4096) == pytest.approx(24 * 21.8e9, rel=2e-3)


@pytest.mark.parametrize("name, trunk", [("dpt_large", 24 * roofline.vit_block_flops(769, 1024, 4096)),
                                         ("dpt_hybrid", 12 * roofline.vit_block_flops(769, 768, 3072))])
def test_network_counts_hold_the_trunk(name, trunk):
    total = roofline.network_flops(_cfg(name))
    assert trunk < total < 2.5 * trunk


def test_a_family_is_found_by_its_configurations_name_and_its_upsampled_1x1_counted_before_the_upsampling():
    from torch import nn

    class Toy(nn.Module):  # a 3x3 conv at 8x8, x2 upsampling, a 1x1 conv at 16x16
        def __init__(self):
            super().__init__()
            self.conv, self.out_conv = nn.Conv2d(3, 4, 3, padding=1), nn.Conv2d(4, 6, 1)

        def forward(self, x):
            return self.out_conv(nn.functional.interpolate(self.conv(x), scale_factor=2))

    toy = types.ModuleType("portbench.reference.toy_family")
    toy.build = lambda cfg: Toy()
    sys.modules[toy.__name__] = toy
    try:
        cfg = {"reference": "toy_family", "net_hw": [8, 8]}
        assert roofline.network_flops(cfg) == 2 * 8 * 8 * 4 * 3 * 9 + 2 * 16 * 16 * 6 * 4
        toy.upsampled_1x1 = lambda model: [model.out_conv]
        assert roofline.network_flops(cfg) == 2 * 8 * 8 * 4 * 3 * 9 + 2 * 8 * 8 * 6 * 4
    finally:
        del sys.modules[toy.__name__]


def test_peaks_are_known_only_for_the_sxm_card():
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["matmul_flops_per_s"]["float32"] == 495e12
    assert roofline.peaks("NVIDIA H100 PCIe") is None
    assert roofline.peaks("cpu") is None
