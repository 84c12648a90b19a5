from opencl_ray_tracer_tpu_torch.scene.cube import (
    Cube,
    TRIS_PER_CUBE,
    UNIT_CUBE_VERTS,
    bake_cube_params,
    cubes_to_triangles,
)
from opencl_ray_tracer_tpu_torch.scene.scene import (
    Lights,
    PackedScene,
    Scene,
    scene_from_arrays,
    scene_to_arrays,
)
from opencl_ray_tracer_tpu_torch.scene.library import (
    create_scene,
    create_scene1,
    create_scene2,
    create_scene3,
    random_scene,
)

__all__ = [
    "Cube",
    "UNIT_CUBE_VERTS",
    "TRIS_PER_CUBE",
    "bake_cube_params",
    "cubes_to_triangles",
    "Lights",
    "PackedScene",
    "Scene",
    "scene_from_arrays",
    "scene_to_arrays",
    "create_scene",
    "create_scene1",
    "create_scene2",
    "create_scene3",
    "random_scene",
]
