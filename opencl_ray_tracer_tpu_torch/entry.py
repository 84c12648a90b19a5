"""The port's entry point: the counterpart of the repository's
`__graft_entry__.entry()`.

`entry()` returns `(forward, (scene, camera))`: scene 1 under the legacy
ortho camera, and `forward(scene, camera)`, the 640x480 phong + hard-shadow
frame as packed int32 words through the tiled kernel at the config's K
caps. Where the JAX entry returns a jittable forward (`render_tiled` under
`jax.jit`: binning, the gather and the kernel in one program, the brute
kernel taking over on the device through `lax.cond` where a tile's list
overflows), this one is that frame compiled for the card
(`models.renderer.render_jit`, a CUDA graph captured at the first call):
binning, gather and the kernels with no host read, the brute kernel (B3)
taking over on the card where a list overflows. Each call returns the
graph's output, which the next call overwrites.

    forward, (scene, camera) = entry()             # on the card
    words = forward(scene, camera).clone()
    forward, args = entry(device="cpu")            # the plain twins, eagerly
"""

from __future__ import annotations


def entry(device=None):
    from opencl_ray_tracer_tpu_torch import (
        RenderConfig,
        create_scene1,
        legacy_ortho_camera,
    )
    from opencl_ray_tracer_tpu_torch.models.renderer import render_jit
    from opencl_ray_tracer_tpu_torch.runtime import card_or

    dev = card_or(device, "entry()")
    config = RenderConfig(width=640, height=480, shading="phong", shadows=True,
                          framebuffer_dtype="packed")
    return render_jit(config), (create_scene1(device=dev),
                                legacy_ortho_camera(device=dev))
