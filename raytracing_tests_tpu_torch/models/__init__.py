"""Workload registry: every workload is a named, deterministic, scriptable
scenario run from the CLI or tests."""

from raytracing_tests_tpu_torch.models.registry import (  # noqa: F401
    Workload,
    get_workload,
    list_workloads,
    register,
)
from raytracing_tests_tpu_torch.models import workloads  # noqa: F401  (registers all)
