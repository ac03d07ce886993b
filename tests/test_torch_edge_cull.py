"""The generic silhouette cull's block bound (``kernels/edge_cull.py``) as a
property: for random rotated boxes and ellipsoids, rays and block tables, the
bound of every table entry lies at or below the float32 metric of every
candidate row the entry covers.  Runs where ``hypothesis`` is installed.

Tolerance: none.  The bound must lie at or below the metric as the plain
version computes it in float32 (``_edge_metric_g_np``), on every ray; the
kernel skips an entry only where its bound is strictly above the ray's best.
"""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

from raytracing_tests_tpu_torch.kernels import edge_cull as ec  # noqa: E402
from raytracing_tests_tpu_torch.kernels import sweep2 as tsw2  # noqa: E402
from raytracing_tests_tpu_torch.kernels import sweep2g as tg  # noqa: E402
from raytracing_tests_tpu_torch.scene import types as ttypes  # noqa: E402
from test_torch_sweep2g import _edge_metric_g_np, _unit  # noqa: E402


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True, database=None,
                     suppress_health_check=[hypothesis.HealthCheck.too_slow])
@hypothesis.given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 40),
                  span=st.sampled_from([2.0, 20.0, 200.0]),
                  far=st.sampled_from([1.0, 10.0, 100.0]), gr=st.sampled_from([8, 16, 64]),
                  moving=st.booleans(), ground=st.booleans())
def test_edge_block_bound_is_below_every_rows_metric(seed, n, span, far, gr, moving, ground):
    """For random rotated boxes and ellipsoids (scales 0.02 to 5 on each
    axis), rays and block tables: the bound of every table entry
    (``edge_cull.edge_block_bounds``) is at or below the float32 metric of
    every candidate row the entry covers (``_edge_metric_g_np``, the plain
    version's arithmetic), and an entry bounded by +inf (every centre behind
    the ray) covers no candidate."""
    rng = np.random.default_rng(seed)
    b = ttypes.SceneBuilder()
    if ground:
        b.add_sphere((0.0, -1000.0, 0.0), 1000.0)
    for _ in range(n):
        kw = {"delta_position": tuple(rng.uniform(-0.3, 0.3, 3) * span / 10)} if moving else {}
        b.add(tuple(rng.uniform(-span / 2, span / 2, 3)),
              tuple(np.exp(rng.uniform(np.log(0.02), np.log(5.0), 3))),
              ttypes.ELLIPSOID if rng.uniform() < 0.5 else ttypes.CUBOID,
              rotation_deg=tuple(rng.uniform(0.0, 360.0, 3)), **kw)
    accel = tg.make_accel2g(b.build(), gr=gr, has_motion=moving)
    B = 24
    o = (rng.uniform(-span / 2, span / 2, (B, 3)) + rng.normal(size=(B, 3)) * far).astype(np.float32)
    d = (_unit(rng.normal(size=(B, 3))) * rng.uniform(0.5, 1.5, (B, 1))).astype(np.float32)
    omt = rng.uniform(0.0, 1.0, B).astype(np.float32)
    rays = tsw2.pack_rays(*(torch.from_numpy(x) for x in (o, d, 1.0 - omt, np.full(B, 1e4, np.float32))))
    omt = rays[6].numpy()
    lb = ec.edge_block_bounds(accel, rays).numpy()
    table = ec.edge_blocks(accel)[0].numpy()
    rows = np.arange(accel.n_pad)
    m = _edge_metric_g_np(accel, np.repeat(o, rows.size, axis=0), np.repeat(d, rows.size, axis=0),
                          np.repeat(omt, rows.size) if moving else None, np.tile(rows, B))
    m = m.reshape(B, rows.size)
    cand = m < tg.BIG_T
    for e, (a, k) in enumerate(table[:, [ec.EB_ROW0, ec.EB_NROWS]].astype(int)):
        mm, cc, bb = m[:, a:a + k], cand[:, a:a + k], lb[:, e:e + 1]
        assert not (cc & (mm < bb)).any(), (e, (bb - mm)[cc & (mm < bb)])
        assert not (cc & np.isposinf(bb)).any()
