"""LBVH on the scene's device: Morton-sorted Karras build and the stackless
lockstep traversal (the reference-semantics oracle beside the sweeps)."""

from raytracing_tests_tpu_torch.bvh.build import LBVH, build_lbvh  # noqa: F401
from raytracing_tests_tpu_torch.bvh.traverse import (  # noqa: F401
    traverse_nearest,
    traverse_nearest_obj,
)
