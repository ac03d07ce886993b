"""Host-side (C++) LBVH build giving the same ``LBVH`` as the on-device
builder: the same sort keys and the same Karras linking
(``native/src/rt_native.cpp``), for when the device is busy rendering and the
host cores are idle."""

from __future__ import annotations

import numpy as np
import torch

from raytracing_tests_tpu_torch.bvh.build import LBVH
from raytracing_tests_tpu_torch.scene.types import Scene


def build_lbvh_native(scene: Scene) -> LBVH:
    """Build on the host through ``native.build_lbvh_host`` -> the tree on
    the scene's device.  Padding rows collapse to the scene-max corner, as
    in the device builder.  Raises ``RuntimeError`` without the native
    library."""
    from raytracing_tests_tpu_torch import native

    lo, hi = (x.detach().cpu().numpy() for x in scene.world_aabbs())
    valid = scene.valid.detach().cpu().numpy()
    if not valid.all():
        big = hi[valid].max(axis=0)
        lo = np.where(valid[:, None], lo, big)
        hi = np.where(valid[:, None], hi, big)
    out = native.build_lbvh_host(lo, hi)
    return LBVH(**{k: torch.from_numpy(v).to(scene.device) for k, v in out.items()})
