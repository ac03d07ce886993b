"""Device-mesh parallelism: image rows over devices, gradient all-reduce.

Counterpart of the JAX package's ``parallel/``.  Image rows interleave over
the shards of a one-axis ``Mesh`` (the reference's spiral tile order becomes a
strided assignment, so sky rows and geometry rows balance), the scene and its
accel are replicated, and under a process group the scene-parameter gradients
are summed over the ranks (``diff.train``).  A mesh may repeat a device: n
virtual shards of one card (or of the CPU) run the multi-device program in
one process.
"""

from raytracing_tests_tpu_torch.parallel.mesh import Mesh, make_mesh, row_permutation  # noqa: F401
from raytracing_tests_tpu_torch.parallel.render_sharded import (  # noqa: F401
    render_sharded,
    render_uber_sharded,
)
