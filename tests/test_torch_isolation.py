"""The port imports neither JAX/Flax nor the JAX package, nor ``flatbuffers``
(the machine with the card has none)."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "chex", "optax", "depth_estimation_tpu", "flatbuffers")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import depth_estimation_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden})
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_in_a_fresh_process():
    code = _IMPORT_ALL.format(forbidden=set(FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_import_statements():
    files = sorted((ROOT / "depth_estimation_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "k4_breakdown.py", ROOT / "tools" / "train_grad_precision.py",
        ROOT / "tools" / "detection_times.py", ROOT / "tools" / "train_determinism.py"]
    bad = {str(f.relative_to(ROOT)): r for f in files for r in _imported_roots(f) if r in FORBIDDEN}
    assert not bad, bad


_TFLITE_WITHOUT_FLATBUFFERS = """
import os, sys, tempfile
sys.modules["flatbuffers"] = None  # any import of it raises ImportError
import numpy as np, torch
from depth_estimation_tpu_torch.detect import weights
from depth_estimation_tpu_torch.models.blazepose import BlazePoseDetector
from depth_estimation_tpu_torch.utils import convert, tflite, tflite_synth
with torch.device("meta"):
    net = BlazePoseDetector()
blob, sd = tflite_synth.synthesize_model_file(net, (1, 3, 224, 224), np.random.default_rng(0))
with tempfile.TemporaryDirectory() as d:
    os.environ["DEPTH_ESTIMATION_TPU_TORCH_CACHE"] = d
    weights.tflite_dir().mkdir(parents=True)
    (weights.tflite_dir() / "pose_detection.tflite").write_bytes(blob)
    ops, consts, _ = tflite.read_tflite_ops(weights.tflite_dir() / "pose_detection.tflite")
    got = weights.load_detector_params()["blazepose_detector"]
assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
print(len(ops), len(consts))
"""


def test_tflite_route_needs_no_flatbuffers():
    """In a fresh process where ``flatbuffers`` cannot be imported, the
    reader, the writer and the weight cache import, and a synthesized
    pose_detection.tflite converts back to the state dict it encodes."""
    r = subprocess.run([sys.executable, "-c", _TFLITE_WITHOUT_FLATBUFFERS], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


_NATIVE_IMPORT = """
import sys
from depth_estimation_tpu_torch.runtime import native, video
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden})
assert not bad, bad
assert not native._LIBS and not native._LOAD_ERRORS, "importing the bindings built or loaded a library"
assert native.SOURCE.is_file() and native.SOURCE.is_relative_to(native.kernel_build.BUILD_DIR.parent)
"""


def test_native_bindings_import_no_jax_and_build_nothing():
    """``runtime/native.py`` imports none of the JAX package (the port keeps
    its own ``native/framepipe.cpp``) and builds at first use, not at import."""
    code = _NATIVE_IMPORT.format(forbidden=set(FORBIDDEN))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
