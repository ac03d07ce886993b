"""The hot paths: hand-written CUDA kernels with their plain PyTorch versions.

  - ``uber``:    whole-frame persistent path tracer (``csrc/uber.cu``, and
                 ``csrc/uber_tex.cu`` for textured scenes), sphere and generic
                 scenes, static or with motion blur.
  - ``texture``: the atlas layout the persistent kernel samples
                 (``pack_atlas``) and the plain sampler.
  - ``mega``:    the chunked megakernel ``mega_step`` (``csrc/mega.cu``): one
                 fused trace-and-shade step per lane; and the shading model as
                 tensor code.
  - ``sweep2``:  grouped nearest-hit sphere sweep (``csrc/sweep2.cu``), static
                 or with motion blur.
  - ``sweep2g``: grouped sweep over rotated ellipsoids and cuboids
                 (``csrc/sweep2g.cu``).
  - ``sweep``:   the first-generation dense and grouped sweeps
                 (``csrc/sweep.cu``) and host helpers (scene mode / motion
                 detection).
  - ``drain``:   one step of the lane-aligned drain's bookkeeping
                 (``csrc/drain.cu``), between two launches of ``mega``.
  - ``gather``:  the gradient path's winner gather and its backward
                 (``csrc/gather.cu``): each lane's row of the scene's packed
                 fields, the lanes' gradients added into the table.
  - ``ri_sum``:  the gradient path's surrounding-refractive-index
                 containment sum and its backward (``csrc/ri_sum.cu``): each
                 point's mean RI over the rows that contain it, each point's
                 gradient added into those rows.
  - ``recompute``: the gradient path's closed-form recompute of each lane's
                 hit on its winner, with its backward and tangent
                 (``csrc/recompute.cu``).
  - ``shade``:   the queue renderers' "bvh" shading of a pop, with its
                 backward and tangent (``csrc/shade.cu``).
  - ``queue``:   the queue renderer's per-lane ray queue: a pop and a pop's
                 push pair, with a backward that touches only the rows a
                 step read or wrote (``csrc/queue.cu``).
  - ``_build``:  builds and loads the kernels at first use; launch counters.

The first-generation sweep entry points are re-exported here, as the JAX
package's ``kernels`` exports them; importing the package builds nothing.
"""

from raytracing_tests_tpu_torch.kernels.sweep import (  # noqa: F401
    intersect_pallas,
    occluded_nearest_obj_pallas,
    surrounding_ri_pallas,
)
