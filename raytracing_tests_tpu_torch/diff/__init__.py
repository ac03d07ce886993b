"""Differentiable rendering: scene-parameter gradients and optimisation.

Rendered pixels differentiable with respect to sphere centres / radii
(position / scale), material albedo / fuzz / IOR and the texture atlas, with
the sweeps run as kernels on detached inputs (``diff/fastpath.py``), on one
device or row-sharded over a mesh (``render_loss(mesh=)``,
``make_train_step(mesh=)``; ``parallel.make_mesh``).
"""

from raytracing_tests_tpu_torch.diff.params import (  # noqa: F401
    FLOAT_FIELDS,
    SceneParams,
    apply_params,
    extract_params,
    params_mask,
)
from raytracing_tests_tpu_torch.diff.train import (  # noqa: F401
    TrainState,
    adam,
    banded_value_and_grad,
    make_train_step,
    probe_band_pops,
    probe_max_pops,
    render_loss,
    value_and_grad_loss,
)
