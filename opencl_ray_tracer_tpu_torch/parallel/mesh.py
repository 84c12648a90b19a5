"""The rank mesh and row-sharded rendering.

The reference has exactly one parallel axis — pixels — mapped to a flat 1-D
OpenCL NDRange on one device (MainState.cpp:858). The port extends the same
axis up the hierarchy, as the JAX package does:

  on the card:   the CUDA kernels' blocks over pixel tiles  (kernels/)
  across cards:  image ROWS sharded over the ranks           (this module)
  across hosts:  the same mesh over torch.distributed        (distributed.py)

Each rank is one process with one card. The scene is REPLICATED on every
rank (it is ~70 KB: `replicate` broadcasts it from rank 0), every rank
renders its own block of rows, and the forward needs no communication
because pixels are independent; only `gather_rows` (display, PNG) and the
train step's gradient all-reduce (parallel/train.py) talk across ranks.

Ray generation is what makes row-sharding free: cameras are affine ray
bundles (camera.py), so rank r's block just shifts the bundle's origin by
its first row — no (H, W) index arrays ever exist.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig
from opencl_ray_tracer_tpu_torch.parallel import distributed
from opencl_ray_tracer_tpu_torch.utils import tracing

IMAGE_AXIS = "image"
HOST_AXIS = "host"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that shard image rows, as this rank sees them.

    `shape` is (n,) over `axis_names` (IMAGE_AXIS,), or (hosts, chips) over
    (HOST_AXIS, IMAGE_AXIS): rank h * chips + c is chip c of host h, and
    rows shard over both axes, host-major, so rank r renders row block r.
    `reduce_groups` are this rank's all-reduce groups, inner first: the
    whole group on a 1-D mesh; on a 2-D mesh the ranks of its host
    {h * chips + c over c}, then its chip's peers on the other hosts
    {h * chips + c over h}. Without a process group (one rank) there are
    none, and nothing is communicated. `device` is where `replicate`,
    `shard_rows` and `gather_rows` put tensors: this rank's device in a
    process group, else None (the tensors stay where they lie)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    device: Optional[torch.device] = None
    reduce_groups: Tuple[Any, ...] = ()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the mesh, one group at a time (inner,
        intra-host first; then one exchange of the host's sums across
        hosts). Returns `t`. Inside the span `mesh.all_reduce`; an exchange
        that runs now adds 1 to the counter `mesh.all_reduces` and t's bytes
        to `mesh.all_reduce_bytes` (`utils.tracing`); one recorded into a
        CUDA graph's capture adds its bytes to `mesh.captured_bytes`, and
        counts at each replay (`parallel.train`)."""
        with tracing.span("mesh.all_reduce"):
            for group in self.reduce_groups:
                dist.all_reduce(t, group=group)
        if self.reduce_groups:
            nbytes = t.numel() * t.element_size()
            if t.is_cuda and torch.cuda.is_current_stream_capturing():
                tracing.count("mesh.captured_bytes", nbytes)
            else:
                count_exchange(nbytes)
        return t

    def barrier(self) -> None:
        if self.reduce_groups:
            dist.barrier()


def count_exchange(nbytes: int) -> None:
    """One run of a mesh's exchange of `nbytes` bytes, on its counters."""
    tracing.count("mesh.all_reduces")
    tracing.count("mesh.all_reduce_bytes", nbytes)


def _check_ranks(shape: Tuple[int, ...]) -> None:
    n, world = math.prod(shape), distributed.world_size()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks; only {world} in the "
                         "process group")
    if n < world:
        raise ValueError(f"mesh {shape} covers {n} of the {world} ranks: a rank "
                         "is one process, so the mesh spans the whole group")


def _rank_device() -> Optional[torch.device]:
    return distributed.local_device() if dist.is_initialized() else None


def make_mesh(n_devices: Optional[int] = None, axis: str = IMAGE_AXIS) -> Mesh:
    """1-D mesh over the image axis: every rank of the process group (n
    must be their number; None: all of them, 1 without a group)."""
    n = distributed.world_size() if n_devices is None else int(n_devices)
    _check_ranks((n,))
    groups = (dist.group.WORLD,) if dist.is_initialized() else ()
    return Mesh((n,), (axis,), distributed.rank(), _rank_device(), groups)


def make_mesh_2d(hosts: int, chips: int, host_axis: str = HOST_AXIS,
                 axis: str = IMAGE_AXIS) -> Mesh:
    """2-D (hosts, chips) mesh. Image rows still shard over every rank (the
    workload has one parallel dimension, pixels); the axes exist so that the
    backward's gradient all-reduce is two-level: over the chips of each host
    first, then once across hosts with the host's already-reduced sum, so
    the slow links carry one message per host. `torchrun` numbers the ranks
    of a host contiguously, so rank h * chips + c is on host h. Every rank
    makes every group, in the same order, as `dist.new_group` requires."""
    shape = (int(hosts), int(chips))
    _check_ranks(shape)
    r = distributed.rank()
    groups = ()
    if dist.is_initialized():
        intra = inter = None
        for h in range(hosts):
            g = dist.new_group([h * chips + c for c in range(chips)])
            intra = g if r // chips == h else intra
        for c in range(chips):
            g = dist.new_group([h * chips + c for h in range(hosts)])
            inter = g if r % chips == c else inter
        groups = (intra, inter)
    return Mesh(shape, (host_axis, axis), r, _rank_device(), groups)


def mesh_row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes image rows shard over: all of the mesh's, in mesh order
    (host-major row blocks on a 2-D mesh)."""
    return tuple(mesh.axis_names)


def mesh_n_shards(mesh: Mesh) -> int:
    return math.prod(mesh.shape)


def mesh_from_config(config: RenderConfig, axis: str = IMAGE_AXIS) -> Mesh:
    """Mesh selected by config.mesh_shape: None = every rank of the process
    group on the flat image mesh (1 without a group), (n,) = n ranks,
    (hosts, chips) = the 2-D mesh with a two-level gradient all-reduce."""
    if config.mesh_shape is None:
        return make_mesh(axis=axis)
    dims = tuple(int(d) for d in config.mesh_shape)
    if len(dims) > 2:
        raise ValueError(
            f"config.mesh_shape {config.mesh_shape}: at most 2 dims "
            f"(hosts, chips) — the workload has one parallel axis (pixels)")
    if len(dims) == 2:
        return make_mesh_2d(dims[0], dims[1], axis=axis)
    return make_mesh(dims[0], axis=axis)


def shift_camera_rows(camera: Camera, row0) -> Camera:
    """Camera for an image slice starting at absolute row `row0`: shift the
    affine bundle along its row derivative, origin and direction (so a
    pinhole block works too). The block renders the rays the full camera
    would, up to the rounding of the shifted origin."""
    r = float(row0)
    return dataclasses.replace(camera, o0=camera.o0 + r * camera.doy,
                               d0=camera.d0 + r * camera.ddy)


def _render_rows(scene, camera: Camera, h: int, w: int, config: RenderConfig,
                 fixed: bool = False):
    """An (h, w) block through `camera` (already shifted to the block), by
    the config's path: MSAA per block in the facade's order; soft through
    the tiled soft kernels for backend "pallas", else the torch-autograd
    oracle; hard through the tiled hard kernel for "pallas", else the
    whole-frame plain backend; packed words where asked. `fixed`: the
    compiled forms, at the config's K caps with no host read (the brute
    kernels take over on the card where a list overflows, as under JAX's
    `jit`); else the eager hard path re-bins with larger caps instead."""
    from opencl_ray_tracer_tpu_torch.ops.shading import pack_framebuffer_words

    if config.msaa > 1:
        # The facade's supersample-resolve-quantise order through the exact
        # shift_subpixel bundle, so a block equals the facade's rows.
        from opencl_ray_tracer_tpu_torch.models.renderer import MSAA_OFFSETS

        sample_cfg = config.replace(msaa=0, framebuffer_dtype="float")
        acc = None
        for dx, dy in MSAA_OFFSETS[config.msaa]:
            img = _render_rows(scene, camera.shift_subpixel(dx, dy), h, w,
                               sample_cfg, fixed)
            acc = img if acc is None else acc + img
        out = acc * (1.0 / config.msaa)
        if config.framebuffer_dtype == "int":
            out = torch.round(out).to(torch.int32)
        elif config.framebuffer_dtype == "packed":
            out = pack_framebuffer_words(torch.round(out))
        return out
    block_cfg = config.replace(height=h, width=w)
    if config.soft:
        if config.backend == "pallas" and fixed:
            from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import _soft_tiled_core

            return _soft_tiled_core(scene.pack(), camera, config.tau_depth,
                                    config.tau_edge, h, w, config.shading,
                                    config.shadows, config.cull_k,
                                    config.shadow_cull_k)
        if config.backend == "pallas":
            from opencl_ray_tracer_tpu_torch.kernels.soft import render_soft_pallas

            return render_soft_pallas(scene, camera, block_cfg)
        from opencl_ray_tracer_tpu_torch.diff.soft import render_soft

        return render_soft(scene, camera, block_cfg)
    if config.backend == "pallas":
        # The shifted camera's origin moves the block's tile rects into world
        # coordinates at binning time; a pinhole block bins through its own
        # shifted projection.
        from opencl_ray_tracer_tpu_torch.kernels.fwd_tiled import (
            render_tiled,
            render_tiled_fixed,
        )

        return (render_tiled_fixed if fixed else render_tiled)(scene, camera,
                                                               block_cfg)
    from opencl_ray_tracer_tpu_torch.models.xla_backend import render_xla

    if config.framebuffer_dtype == "packed":
        return pack_framebuffer_words(
            render_xla(scene, camera, block_cfg.replace(framebuffer_dtype="float")))
    return render_xla(scene, camera, block_cfg)


def _rows_per_rank(height: int, mesh: Mesh) -> int:
    n = mesh_n_shards(mesh)
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    return height // n


def render_sharded(scene, camera: Camera, config: RenderConfig,
                   mesh: Optional[Mesh] = None, axis: str = IMAGE_AXIS):
    """This rank's block of the row-sharded frame: (H/n, W, 4), or (H/n, W)
    int32 words for framebuffer_dtype "packed" — the counterpart of the JAX
    frame's addressable shard (`gather_rows` assembles the whole frame).
    config.msaa > 1 is honoured per block. Without `mesh`,
    config.mesh_shape picks it (mesh_from_config)."""
    mesh = mesh or mesh_from_config(config, axis=axis)
    h_local = _rows_per_rank(config.height, mesh)
    cam = shift_camera_rows(camera, mesh.rank * h_local)
    return _render_rows(scene, cam, h_local, config.width, config)


def render_sharded_jit(config: RenderConfig, mesh: Optional[Mesh] = None,
                       axis: str = IMAGE_AXIS) -> Callable:
    """forward(scene, camera) -> this rank's block of the row-sharded frame
    (what `render_sharded` returns), compiled, as the JAX package's
    `render_sharded` is one `jax.jit` program: the block through the
    row-shifted camera at the config's K caps with no host read (hard
    `pallas`: `render_tiled_fixed`, B3 taking over on the card where a list
    overflows; soft `pallas`: `_soft_tiled_core`; `xla`: the whole-frame
    path), MSAA and packed words per block, through `runtime.graph.jit`.
    On the card the first call of a key captures a CUDA graph (the 8 keys
    used last are held) and every call returns the graph's static output
    (clone what you keep); on the CPU it runs eagerly. It holds no collective: `gather_rows` assembles the frame.
    Without `mesh`, config.mesh_shape picks it (mesh_from_config)."""
    from opencl_ray_tracer_tpu_torch.runtime.graph import jit

    mesh = mesh or mesh_from_config(config, axis=axis)
    h_local = _rows_per_rank(config.height, mesh)
    row0 = mesh.rank * h_local

    def forward(scene, camera: Camera):
        return _render_rows(scene, shift_camera_rows(camera, row0), h_local,
                            config.width, config, fixed=True)

    return jit(forward)


def gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole frame from every rank's row block (an all-gather, in rank
    order), on every rank: the counterpart of pulling the JAX frame to the
    host for display or a PNG."""
    if not mesh.reduce_groups:
        return block
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh_n_shards(mesh))]
    dist.all_gather(parts, block)
    return torch.cat(parts)


def replicate(scene, mesh: Mesh):
    """The scene on this rank's device, every leaf broadcast from rank 0 (a
    copy: the caller's tensors are left as they are)."""
    from opencl_ray_tracer_tpu_torch.parallel.train import scene_leaves
    from opencl_ray_tracer_tpu_torch.scene.scene import scene_from_arrays

    dev = mesh.device or scene.device
    out = scene_from_arrays({k: v.detach().to(dev).clone()
                             for k, v in scene_leaves(scene).items()}, dev)
    if mesh.reduce_groups:
        for v in scene_leaves(out).values():
            dist.broadcast(v, src=0)
    return out


def shard_rows(array, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of an (H, ...) array (e.g. a target image), on its
    device. On a 2-D mesh rows shard over (host, image) jointly."""
    t = torch.as_tensor(array)
    rows = _rows_per_rank(t.shape[0], mesh)
    block = t[mesh.rank * rows:(mesh.rank + 1) * rows]
    return block.to(mesh.device or t.device).contiguous()
