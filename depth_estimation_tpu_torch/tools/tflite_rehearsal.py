"""The ``.tflite`` drop rehearsed end to end with structurally real files.

No MediaPipe ``.tflite`` file is in the repository, so this writes all five
at full size (``utils/tflite_synth.py``: full weight tensors in TFLite
layouts, real operator tables, weightless ops interleaved, and 3 extra
branch layers in ``pose_landmark_full.tflite`` for ``allow_skips`` to step
over, as the real pose graph's segmentation branch), stages them through
the CLI (``import_weights --tflite``: structural conversion, then the
cache), imports them a second time (a cache hit: the converters are made to
raise), and checks that ``PersonDetector`` and ``FaceDetector`` built
without weights load exactly the state dicts that the files encode.

    python -m depth_estimation_tpu_torch.tools.tflite_rehearsal [--seed 0] [--keep DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import pathlib
import tempfile
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from depth_estimation_tpu_torch.models.blazeface import BlazeFace
from depth_estimation_tpu_torch.models.blazepose import BlazePose, BlazePoseDetector
from depth_estimation_tpu_torch.models.facemesh import FaceMesh, IrisLandmark

# (file, params key, state-dict prefix, net, NCHW input, extra branch layers)
FILES = (("face_detection_short_range.tflite", "blazeface", "", BlazeFace, (1, 3, 128, 128), 0),
         ("face_landmark.tflite", "facemesh", "mesh.", FaceMesh, (1, 3, 192, 192), 0),
         ("iris_landmark.tflite", "facemesh", "iris.", IrisLandmark, (1, 3, 64, 64), 0),
         ("pose_detection.tflite", "blazepose_detector", "", BlazePoseDetector, (1, 3, 224, 224), 0),
         ("pose_landmark_full.tflite", "blazepose", "", BlazePose, (1, 3, 256, 256), 3))


@contextlib.contextmanager
def _cache_at(root):
    from depth_estimation_tpu_torch.utils.checkpoint import CACHE_ENV

    saved = os.environ.get(CACHE_ENV)
    os.environ[CACHE_ENV] = str(root)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(CACHE_ENV)
        else:
            os.environ[CACHE_ENV] = saved


@contextlib.contextmanager
def _converters_refused():
    """Every ``convert_*_tflite`` raises: a run inside must hit the cache."""
    from depth_estimation_tpu_torch.utils import convert

    def refuse(*_args):
        raise RuntimeError("a TFLite file was converted where the cache should have served it")

    names = [n for n in vars(convert) if n.startswith("convert_") and n.endswith("_tflite")]
    saved = {n: getattr(convert, n) for n in names}
    for n in names:
        setattr(convert, n, refuse)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(convert, n, fn)


def _import(paths) -> float:
    from depth_estimation_tpu_torch.tools import import_weights

    out = io.StringIO()
    t0 = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # the pose landmark file's extra branch: allow_skips warns
        rc = import_weights.main(["--tflite", *paths])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"import_weights --tflite returned {rc}: {out.getvalue()}")
    return seconds


def _check_equal(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], what: str) -> None:
    if got.keys() != want.keys():
        raise RuntimeError(f"{what}: keys differ: {sorted(got.keys() ^ want.keys())[:5]}")
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} tensors differ from the file's, e.g. {bad[:3]}")


def rehearse(cache_root, seed: int = 0, weights: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
             device="cpu", log=print) -> dict:
    """The whole drop inside ``cache_root``: write the five files (from
    ``weights``, {params key: state dict}, where given, else random from
    ``seed``), import them twice, build the detectors on ``device`` with no
    params and hold their state dicts against the files'. Raises on any
    mismatch. Returns {"files": {name: bytes}, "import_seconds",
    "cached_import_seconds", "weights": the state dicts the files encode,
    "person_detector", "face_detector"}."""
    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.detect.face_detector import FaceDetector
    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.geometry.face import FaceDet
    from depth_estimation_tpu_torch.utils.tflite_synth import (fill_random, ordered_slots, serialize_tflite,
                                                               to_tflite_stream)

    rng = np.random.default_rng(seed)
    stage = pathlib.Path(cache_root) / "drop"
    stage.mkdir(parents=True, exist_ok=True)
    expected: Dict[str, Dict[str, torch.Tensor]] = {}
    report = {"files": {}}
    paths = []
    for fname, key, prefix, make, shape, extra in FILES:
        with torch.device("meta"):
            net = make()
        if weights is not None and key in weights:
            sd = {k[len(prefix):]: v.detach().cpu() for k, v in weights[key].items() if k.startswith(prefix)}
        else:
            sd = fill_random(net.state_dict(), rng)
        ops, consts = to_tflite_stream(ordered_slots(net, shape, sd), extra_branch_layers=extra, rng=rng)
        blob = serialize_tflite(ops, consts)
        path = stage / fname
        path.write_bytes(blob)
        paths.append(str(path))
        expected.setdefault(key, {}).update({prefix + k: v for k, v in sd.items()})
        report["files"][fname] = len(blob)
        log(f"wrote {fname}: {len(blob) / 1e6:.2f} MB")

    with _cache_at(cache_root):
        report["import_seconds"] = _import(paths)
        log(f"import_weights --tflite converted and cached all four nets in {report['import_seconds']:.2f} s")
        with _converters_refused():
            report["cached_import_seconds"] = _import(paths)
        log(f"a second import hit the cache in {report['cached_import_seconds']:.2f} s")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det = PersonDetector(FaceDet(20, CARD), device=device)
            fd = FaceDetector(device=device)
    random = [str(w.message) for w in caught if "random" in str(w.message)]
    if random:
        raise RuntimeError(f"a detector took random weights: {random}")
    for impl, who in ((det, "PersonDetector"), (fd._impl, "FaceDetector")):
        for key, net in (("blazeface", impl._face_det), ("facemesh", impl._mesh),
                         ("blazepose_detector", impl._pose_det), ("blazepose", impl._pose)):
            _check_equal(net.state_dict(), expected[key], f"{who}/{key}")
    log("PersonDetector and FaceDetector loaded the files' state dicts exactly")
    report.update(weights=expected, person_detector=det, face_detector=fd)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", default=None, help="use and keep this directory instead of a temporary one")
    ap.add_argument("--device", default="cuda", help="torch device of the detectors ('cpu' or 'cuda')")
    args = ap.parse_args(argv)
    if args.keep:
        report = rehearse(args.keep, seed=args.seed, device=args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="tflite_rehearsal_") as d:
            report = rehearse(d, seed=args.seed, device=args.device)
    sizes = ", ".join(f"{k}={v / 1e6:.2f}MB" for k, v in report["files"].items())
    print(f"REHEARSAL PASS ({sizes})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
