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
  - ``_build``:  builds and loads the kernels at first use; launch counters.
"""
