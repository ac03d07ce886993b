"""raytracing_tests_tpu_torch — the PyTorch/CUDA port of ``raytracing_tests_tpu``.

Same directory layout and function names as the JAX package, so the
counterpart of a module is found by path.  Plain tensor code is PyTorch; the
two hot kernels (the persistent path tracer and the grouped sphere sweep) are
hand-written CUDA for Hopper under ``csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes`` (``kernels/_build.py``).

  - ``core/``     math: rotations, intersections, deterministic sampling.
  - ``scene/``    ``Scene`` / ``Camera`` dataclasses of tensors, example scenes.
  - ``ops/``      camera rays, the dense intersector, the queue renderer.
  - ``bvh/``      Morton codes (the accel build needs them).
  - ``kernels/``  ``sweep2`` (sphere sweep, kernel + plain version),
                  ``uber`` (whole-frame path tracer, kernel + plain version),
                  ``mega`` (the shading device functions as tensor code).
  - ``models/``   the workload registry; ``app/`` the CLI; ``utils/`` image IO.
  - ``convert``   numpy <-> ``Scene`` / ``Camera`` / ``Accel2``.

Entry points take ``device=None``, which means CUDA, and raise when CUDA is
absent; the CPU runs only when the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from raytracing_tests_tpu_torch.scene.types import (  # noqa: F401
    CUBOID,
    ELLIPSOID,
    Camera,
    Scene,
)
