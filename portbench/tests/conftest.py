"""portbench's tests. ``card`` marks a test that needs a CUDA device: it
skips here, from inside the ``card`` fixture, and runs on the machine with
the card (``python -m pytest portbench/tests -q -p no:cacheprovider``).
``tiny_spec`` is the benchmark's own BENCHMARK.json with its configurations
cut to a tiny DPT_Large-like and DPT_Hybrid-like network at 48x64 frames,
registered under new names in the program's registry, for CPU runs."""

import copy
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    hybrid = cfg["is_hybrid"]
    cfg.update(model_type=f"DPT_Tiny_portbench_{name}", hidden_size=64, num_attention_heads=2, intermediate_size=256,
               num_hidden_layers=2 if hybrid else 4, backbone_out_indices=[0, 1, 0, 1] if hybrid else [0, 1, 2, 3],
               neck_hidden_sizes=[256, 512, 64, 64] if hybrid else [16, 32, 64, 64], fusion_hidden_size=32,
               input_hw=[48, 64], net_hw=[288, 384])
    cfg["weights"] = {**cfg["weights"], "head_gain": 50.0, "head_bias": 20.0}
    return cfg


def register_tiny(cfg: dict) -> None:
    from depth_estimation_tpu_torch import registry
    from depth_estimation_tpu_torch.config import DPT_PREPROCESS
    from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig

    port_cfg = DPTConfig(embed_dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
                         num_heads=cfg["num_attention_heads"], hooks=tuple(cfg["backbone_out_indices"]),
                         reassemble_channels=tuple(cfg["neck_hidden_sizes"]), features=cfg["fusion_hidden_size"],
                         hybrid=cfg["is_hybrid"])
    registry.register(registry.ModelEntry(cfg["model_type"], lambda: DPT(port_cfg), DPT_PREPROCESS))


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    import torch

    from portbench.spec import Spec

    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("tiny_bench")
    bench = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for c in bench["configs"]:
        cfg = tiny_config(c["name"])
        register_tiny(cfg)
        (root / f"{c['name']}.json").write_text(json.dumps(cfg))
        c["file"] = f"{c['name']}.json"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root)
