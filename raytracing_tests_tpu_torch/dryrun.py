"""The multi-device dry run of the port: one sharded training step and the
sharded persistent kernel against the single-device one, at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:

  - one Adam step of ``make_train_step(mesh=)`` on ``materials_scene()``
    (colours perturbed, the target rendered unperturbed), whose loss must be
    finite;
  - ``render_uber_sharded`` against ``render_uber`` on the same device, at
    atol 2e-6, for ``iow_final_scene(side=4)`` ('bvh' shading), for
    ``materials_scene()`` under materials shading and for ``lights_scene()``
    with its emissive lights.

It raises on a mismatch.  ``dryrun_multichip(n)`` runs on the first n CUDA
devices, ``dryrun_multichip(n, devices=["cpu"] * n)`` on virtual CPU shards.
"""

from __future__ import annotations

import numpy as np

UBER_ATOL = 2e-6  # sharded against single device, the JAX dry run's bar


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the dry run on ``make_mesh(n_devices, devices)``; returns the
    train step's loss and each renderer case's max |difference|."""
    from raytracing_tests_tpu_torch.diff import TrainState, adam, make_train_step
    from raytracing_tests_tpu_torch.kernels.uber import render_uber
    from raytracing_tests_tpu_torch.ops.render import RenderConfig, extract_lights, render
    from raytracing_tests_tpu_torch.parallel import make_mesh, render_uber_sharded
    from raytracing_tests_tpu_torch.scene import examples

    mesh = make_mesh(n_devices, devices)
    if mesh.shape["rows"] != n_devices:
        raise ValueError(f"a mesh of {mesh.shape} for {n_devices} devices")
    dev = mesh.home
    found = {}

    scene, camera = examples.materials_scene()
    cfg = RenderConfig(width=16, height=2 * n_devices, spp=2, max_bounces=3)
    target = render(scene, camera, cfg, device=dev)["image"]
    perturbed = scene.replace(color=scene.color * 0.7 + 0.1)
    opt = adam(1e-2)
    step = make_train_step(perturbed, camera, cfg, opt, mesh=mesh, device=dev)
    state = TrainState.create(perturbed, opt, device=dev)
    state, loss = step(state, target)
    found["train_loss"] = float(loss)
    if not np.isfinite(found["train_loss"]):
        raise AssertionError(f"the sharded train step's loss is not finite: {loss}")

    l_scene, l_cam = examples.lights_scene()
    cases = {
        "iow_final": examples.iow_final_scene(side=4) + ("bvh", None),
        "materials": examples.materials_scene() + ("materials", None),
        "lights": (l_scene, l_cam, "bvh", extract_lights(l_scene)),
    }
    for name, (u_scene, u_cam, shading, lights) in cases.items():
        u_cfg = RenderConfig(width=32, height=2 * n_devices, spp=2, max_bounces=3,
                             shading=shading, intersector="pallas").for_scene(u_scene)
        single = render_uber(u_scene, u_cam, u_cfg, lights, gr=64, device=dev)
        sharded = render_uber_sharded(u_scene, u_cam, u_cfg, mesh, lights, gr=64)
        a = single["image"].detach().cpu().numpy()
        b = sharded["image"].detach().cpu().numpy()
        np.testing.assert_allclose(b, a, atol=UBER_ATOL, err_msg=name)
        if int(single["rays"]) != int(sharded["rays"]):
            raise AssertionError(
                f"{name}: rays {int(sharded['rays'])} sharded, {int(single['rays'])} single")
        found[name] = float(np.abs(a - b).max())
    return found
