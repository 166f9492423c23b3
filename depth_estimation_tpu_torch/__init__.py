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
``python -m depth_estimation_tpu_torch.depth_by_detection``) and the serving
surface (``MultiStream``, ``DepthServer``, ``FusedDepthServer``,
``BucketedDepthServer``, ``python -m depth_estimation_tpu_torch.tools.serve``).
"""

from depth_estimation_tpu_torch.detect.face_detector import FaceDetector
from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
from depth_estimation_tpu_torch.estimator import DepthEstimator
from depth_estimation_tpu_torch.geometry.face import FaceDet
from depth_estimation_tpu_torch.runtime.multistream import MultiStream
from depth_estimation_tpu_torch.runtime.server import BucketedDepthServer, DepthServer, FusedDepthServer
from depth_estimation_tpu_torch.runtime.stream import VidStream

__all__ = ["BucketedDepthServer", "DepthEstimator", "DepthServer", "FaceDet", "FaceDetector", "FusedDepthServer",
           "MultiStream", "PersonDetector", "VidStream"]
