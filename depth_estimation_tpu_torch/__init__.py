"""depth_estimation_tpu_torch — the depth-estimation pipeline on PyTorch and CUDA.

A port of the JAX package ``depth_estimation_tpu`` to one NVIDIA H100. It
imports neither JAX nor the JAX package. The TPU's Pallas kernels on the
ported path are hand-written CUDA kernels (``csrc/``), each with a plain
PyTorch version that runs on the CPU. Entry points run on ``cuda`` unless
the caller asks for ``device="cpu"``.

Ported so far: the depth-only video path (``DepthEstimator``, ``VidStream``,
``python -m depth_estimation_tpu_torch``) with all four families,
``DPT_Large``, ``DPT_Hybrid``, ``MiDaS_small`` and ``MiDaS`` (v2.1 Large),
the hub's ``transforms``, the fused iris/pose + depth path (``FaceDet``,
``PersonDetector``, ``runtime.stream.FusedVidStream``,
``python -m depth_estimation_tpu_torch.midas_mediapipe``, fused or staged)
the detection-only distance pipeline (``FaceDetector``,
``python -m depth_estimation_tpu_torch.depth_by_detection``), the serving
surface (``MultiStream``, ``DepthServer``, ``FusedDepthServer``,
``BucketedDepthServer``, ``python -m depth_estimation_tpu_torch.tools.serve``),
training and evaluation (``train/``, ``utils/checkpoint.py``,
``python -m depth_estimation_tpu_torch.tools.evaluate``), export
(``utils/export.py``: the frame programs on ``torch.export``, weights kept
out of the artifact, ``python -m depth_estimation_tpu_torch.tools.export_program``)
and the MediaPipe ``.tflite`` weights of the detector nets (``detect/weights.py``,
``python -m depth_estimation_tpu_torch.tools.import_weights --tflite FILE...``),
which detectors built without weights load from the cache.

The kernels are ``torch.library`` operators (``torch.ops.depth_tpu_torch``).
The names below are imported at first use, so that a process that imports
only ``depth_estimation_tpu_torch.ops.kernels`` (to load an exported program)
does not import the models.
"""

from importlib import import_module

from depth_estimation_tpu_torch.version import __version__

_EXPORTS = {
    "BucketedDepthServer": "runtime.server", "DepthEstimator": "estimator", "DepthServer": "runtime.server",
    "FaceDet": "geometry.face", "FaceDetector": "detect.face_detector", "FusedDepthServer": "runtime.server",
    "MultiStream": "runtime.multistream", "PersonDetector": "detect.person_detector", "VidStream": "runtime.stream",
}

__all__ = ["__version__", *sorted(_EXPORTS)]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
