"""Morton codes for the grouped accel build.  (The LBVH build and traversal
are not ported yet.)"""

from raytracing_tests_tpu_torch.bvh.build import morton3d  # noqa: F401
