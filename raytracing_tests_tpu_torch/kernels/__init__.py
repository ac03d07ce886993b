"""The hot paths: hand-written CUDA kernels with their plain PyTorch versions.

  - ``sweep2``: grouped nearest-hit sphere sweep (``csrc/sweep2.cu``).
  - ``uber``:   whole-frame persistent path tracer (``csrc/uber.cu``).
  - ``mega``:   the shading device functions as tensor code.
  - ``sweep``:  host helpers (scene mode / motion detection).
"""
