"""Weight conversion (JAX trees and MediaPipe ``.tflite`` files), checkpoints, export and debug guards."""
