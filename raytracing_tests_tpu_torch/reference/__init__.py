"""CPU oracle renderer: clarity over speed; the spec for allclose tests."""

from raytracing_tests_tpu_torch.reference.cpu_renderer import render_cpu  # noqa: F401
