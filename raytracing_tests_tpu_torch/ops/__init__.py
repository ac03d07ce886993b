"""Renderer ops: camera rays, the dense intersector and the queue path tracer."""

from raytracing_tests_tpu_torch.ops.render import RenderConfig, render  # noqa: F401
