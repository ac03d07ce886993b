"""Scene representation: SoA scene, cameras, example scenes."""

from raytracing_tests_tpu_torch.scene.types import Camera, Scene, SceneBuilder  # noqa: F401
