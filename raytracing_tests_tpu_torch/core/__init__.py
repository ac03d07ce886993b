"""Math primitives on tensors: rays, intersections, normals, sampling."""

from raytracing_tests_tpu_torch.core import geometry, linalg, sampling  # noqa: F401
