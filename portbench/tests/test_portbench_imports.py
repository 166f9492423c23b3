"""Nothing under portbench/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the program either; the run's own check of
``sys.modules`` compares whole top-level names, since the program's
package name begins with the JAX package's."""

import ast
import pathlib
import subprocess
import sys

PB = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "depth_estimation_tpu"}


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_in_portbench():
    bad = {str(f.relative_to(PB)): r for f in PB.rglob("*.py") for r in _roots(f) if r in JAX}
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    banned = JAX | {"depth_estimation_tpu_torch"}
    files = sorted((PB / "reference").rglob("*.py")) + [PB / "weights.py", PB / "compare.py", PB / "roofline.py"]
    bad = {str(f.relative_to(PB)): r for f in files for r in _roots(f) if r in banned}
    assert not bad, bad


def test_the_runs_check_compares_whole_top_level_names():
    code = """
import sys, types
sys.path.insert(0, {root!r})
from portbench.harness import banned_modules
sys.modules["depth_estimation_tpu_torch_fake"] = types.ModuleType("x")
sys.modules["jaxtyping"] = types.ModuleType("x")
assert banned_modules() == [], banned_modules()
sys.modules["depth_estimation_tpu.models"] = types.ModuleType("x")
sys.modules["jax"] = types.ModuleType("x")
print(banned_modules())
""".format(root=str(PB.parent))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "['depth_estimation_tpu.models', 'jax']"


def test_run_exits_without_a_result_where_there_is_no_card():
    r = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "dpt_large.serve_poisson", "--seed",
                        "1", "--seconds", "1"], capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
