#!/usr/bin/env python3
"""Times of the port's hand-written kernels alone on one NVIDIA card: the
tiled hard kernel B1/B2 (`tiled_kernel`, packed and float output), the
tiled soft forward B4 (`soft_tiled_fwd`) and backward B5 (`soft_tiled_bwd`),
the brute hard kernel B3 (`brute_kernel`) and the brute soft forward and
backward B6 / B7 (`soft_brute_fwd`, `soft_brute_bwd`), for whichever
`opencl_ray_tracer_tpu_torch` is first on PYTHONPATH:

    PYTHONPATH=. python scripts/torch_kernel_times.py [--check] [--kernel B1|B4|B5|B3|B6|B7|finals]

(`--kernel B6` and `--kernel B7` both run the brute soft pair: they share
their inputs.) Each row holds `ms`, back to back per launch (CUDA events
around n launches: the wrapper's host work where that is the longer), and
`device_ms`, the same launches queued behind a spin on the card. To
compare two commits, or a design step against the kernel without it, unpack
the other tree into a directory and run the script once per tree, in turns
on one card (other, this, this, other); the timing helpers are always those
of the tree this script lies in, so both trees are timed by the same code.

B1 inputs: the 1080p headline frame (10 spheres + 1 cube, phong + hard
shadows, legacy ortho camera) with packed and with float (B2) output, the
same frame in legacy shading, the same through a pinhole camera, scene 3
(1,300 primitives) at 640x480 in phong + shadows, and the 640x480 frame of
the entry point (scene 1, phong + shadows). B4 inputs: the 1080p headline
scene's soft tables in the four shading modes of `chip_smoke.py` phase 7
(legacy, lambert, lambert + soft shadows, phong + soft shadows: the train
step's), phong + soft shadows through a pinhole camera, and scene 3 at
640x480. B5 inputs: the 1080p headline scene (10 spheres + 1 cube, phong + soft
shadows, the train step's tables) with the train step's own cotangent
(non-zero on the covered pixels only), with zeros and with 1e-6 on every
pixel; the same scene through a pinhole camera; scene 3 (1,300 primitives)
at 640x480 with the loss's and the dense cotangent (and, for `--check`,
at 256x128, where the twin's autograd graph fits). B3 inputs: the 1080p
headline frame, legacy and phong + hard shadows, ortho and pinhole; scene 3
at 640x480, phong + shadows. B6 / B7 inputs: the 1080p headline scene with
the cotangent of mean(img^2), 1e-6 on every pixel and zeros; scene 3 at
256x128 (B7, all three) and 640x480 (B6).

`--kernel finals` times B4 and B5 in both regimes of the tiled soft pair,
forced through `soft_tiled._FINALS_MIN_SLOTS`: recompute (B4 lean, B5
recomputing each pixel's finals) and stored finals (B4 writing the finals
block, B5 reading it), each with its bound, on the 1080p headline scene's
train tables (ortho and pinhole), 50 spheres + 4 cubes at 1080p (the bench's
`fwd+bwd 50 + 4` row), the stress scene at 1080p (K 96 / 136, the bench's
`fwd+bwd stress` row), scene 3 at 640x480, and scene 1 at 640x480 in phong
+ soft shadows and in lambert without shadows (`cli fit`'s frame); B5 with
the loss's cotangent
(zero where nothing covers) and a dense one (1e-6 everywhere). A `pair` row
a case and cotangent sums B4 + B5 per regime and says which is faster: the
data behind the threshold.

`--check` also holds each kernel against its plain twin: B1/B2 on the
inputs above (packed words within 1 per byte, float within 0.5/255, and the
share of identical pixels), B4 on the inputs above (the largest error,
bar 0.05/255), and, where the package builds one, the card's list of
non-empty tiles against its plain version; B5 on the inputs
above (every gradient normalised by its largest; exact zeros for the
all-zero cotangent; the card's live list against `_live_patches`), B3 on
the inputs above (the largest error and the share of identical pixels), B7
on the headline input and on a scattered, a one-patch and a dense cotangent
at 250x123 and above 2,400 primitives. One JSON object per line on stdout.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.kernels import _build, fwd, fwd_tiled
from opencl_ray_tracer_tpu_torch.kernels import soft as B
from opencl_ray_tracer_tpu_torch.kernels import soft_tiled as S

_spec = importlib.util.spec_from_file_location(
    "_own_bench_util", pathlib.Path(__file__).resolve().parents[1]
    / "opencl_ray_tracer_tpu_torch" / "bench_util.py")
_bench_util = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bench_util)
back_to_back_ms, device_ms = _bench_util.back_to_back_ms, _bench_util.device_ms


def say(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, n):
    return dict(ms=back_to_back_ms(fn, n), device_ms=device_ms(fn, n))


def loss_cotangent(img, scale=1.0):
    """d / d img of sum((img * scale)^2) / (3 H W) over the colour channels
    (scale 1/255: the train step's loss against a zero target)."""
    g = torch.zeros_like(img)
    g[..., :3] = 2.0 * img[..., :3] * (scale * scale / (img.shape[0] * img.shape[1] * 3))
    return g


def grad_err(got, want):
    """Largest error over the operands, each normalised by its largest."""
    worst = 0.0
    for a, b in zip(got, want):
        b = torch.zeros_like(a) if b is None else b
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    return worst


def scenes(dev):
    """(ortho camera, 1080p pinhole camera, headline scene, scene 3)."""
    return (T.legacy_ortho_camera(device=dev),
            T.pinhole_camera((960.0, 540.0, 1100.0), (960.0, 540.0, -60.0),
                             fov_degrees=50.0, width=1920, height=1080, device=dev),
            T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev),
            T.create_scene(3, seed=0, device=dev))


# ---- B1 / B2 ------------------------------------------------------------------

def b1_rows(dev, check):
    ortho, pin, head, scene3 = scenes(dev)
    entry = T.create_scene1(device=dev)
    for name, scene, cam, (w, h), shading, shadows, fmt in (
        ("headline 1080p phong+shadows packed", head, ortho, (1920, 1080), "phong", True, "packed"),
        ("headline 1080p phong+shadows float", head, ortho, (1920, 1080), "phong", True, "float"),
        ("headline 1080p legacy packed", head, ortho, (1920, 1080), "legacy", False, "packed"),
        ("headline 1080p pinhole phong+shadows packed", head, pin, (1920, 1080), "phong", True,
         "packed"),
        ("scene3 640x480 phong+shadows packed", scene3, ortho, (640, 480), "phong", True, "packed"),
        ("entry 640x480 scene1 phong+shadows packed", entry, ortho, (640, 480), "phong", True,
         "packed"),
    ):
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             framebuffer_dtype=fmt)
        packed = scene.pack()
        bins = fwd_tiled.bin_for_config(packed, cam, cfg)
        args, kw = fwd_tiled.kernel_inputs(packed, cam, bins, height=h, width=w, shading=shading,
                                   shadows=shadows, out_format=fmt)
        counts = args[1]
        fn = lambda: fwd_tiled.tiled_kernel(*args, **kw)  # noqa: E731
        row = dict(kernel="B1" if fmt == "packed" else "B2", case=name,
                   **timed(fn, 50 if name.startswith("headline") else 20),
                   tiles=int(counts.shape[0]),
                   nonempty_tiles=int(((counts[:, 0] + counts[:, 1]) > 0).sum()),
                   k_tri=args[2].shape[1], k_sph=args[4].shape[1])
        if check:
            got, want = fn(), fwd_tiled._tiled_kernel_plain(*args, **kw)
            if fmt == "packed":
                a = got.view(torch.uint8).reshape(h, w, 4).int()
                b = want.view(torch.uint8).reshape(h, w, 4).int()
                err = (a - b).abs().amax(-1)
            else:
                err = (got - want).abs().amax(-1)
            row["max_err_vs_twin"] = err.max().item()
            row["identical"] = (err == 0).float().mean().item()
            if hasattr(fwd_tiled, "_tiled_kernel_cuda"):
                tiles = fwd_tiled._tiled_kernel_cuda(*args, **kw)[1]
                row["list_equals_plain"] = _list_equals(tiles, fwd_tiled._live_tiles(counts))
        say(**row)


def _list_equals(live, want):
    """A card's list (live[0] entries from live[2], in any order) against its
    plain version (sorted)."""
    n = int(live[0])
    return n == want.numel() and bool(torch.equal(live[2:2 + n].sort().values.long(), want))


# ---- B4 -----------------------------------------------------------------------

def b4_rows(dev, check):
    ortho, pin, head, scene3 = scenes(dev)
    cases = [(f"train1080 ortho {sh}{'+shadows' if sd else ''}", head, ortho, (1920, 1080),
              sh, sd)
             for sh, sd in (("legacy", False), ("lambert", False), ("lambert", True),
                            ("phong", True))]
    cases += [("train1080 pinhole phong+shadows", head, pin, (1920, 1080), "phong", True),
              ("scene3 640x480 phong+shadows", scene3, ortho, (640, 480), "phong", True)]
    for name, scene, cam, (w, h), shading, shadows in cases:
        cfg = soft_cfg(w, h).replace(shading=shading, shadows=shadows)
        with torch.no_grad():
            params, taus, tables, counts, kc = S.soft_kernel_inputs(scene.pack(), cam, cfg)
        fn = lambda: S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc)  # noqa: E731
        row = dict(kernel="B4", case=name,
                   **timed(fn, 50 if name.startswith("train") else 20),
                   tiles=int(counts.shape[0]),
                   nonempty_tiles=int(((counts[:, 0] + counts[:, 1]) > 0).sum()),
                   k_tri=tables[0].shape[1], k_sph=tables[2].shape[1],
                   sh_rows=(tables[4].shape[1], tables[5].shape[1]))
        if check:
            got = fn()
            with torch.no_grad():
                want = S._soft_tiled_plain(params, taus, tables, counts, cfg=kc)
            row["max_err_vs_twin"] = (got - want).abs().max().item()
            row["covered"] = (got[..., :3] != 0).any(-1).float().mean().item()
            if hasattr(S, "_soft_tiled_fwd_cuda"):
                tiles = S._soft_tiled_fwd_cuda(params, taus, tables, counts, kc)[1]
                row["list_equals_plain"] = _list_equals(tiles, fwd_tiled._live_tiles(counts))
        say(**row)


# ---- B5 ---------------------------------------------------------------------

def soft_cfg(w, h):
    return T.RenderConfig(width=w, height=h, shading="phong", shadows=True,
                          soft=True, framebuffer_dtype="float", tau_depth=1.0,
                          tau_edge=0.5)


def b5_rows(dev, check):
    ortho, pin, head, scene3 = scenes(dev)
    cases = [
        ("train1080 ortho", head, ortho, (1920, 1080), ("loss", "zero", "dense")),
        ("train1080 pinhole", head, pin, (1920, 1080), ("loss",)),
        ("scene3 640x480", scene3, ortho, (640, 480), ("loss", "dense")),
    ]
    if check:  # small enough for the twin's autograd graph
        cases.append(("scene3 256x128", scene3, ortho, (256, 128), ("loss", "dense")))
    for name, scene, cam, (w, h), cots in cases:
        with torch.no_grad():
            params, taus, tables, counts, kc = S.soft_kernel_inputs(
                scene.pack(), cam, soft_cfg(w, h))
            img = S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc)
        gs = {"loss": loss_cotangent(img, 1.0 / 255.0), "zero": torch.zeros_like(img),
              "dense": torch.full_like(img, 1e-6)}
        nonempty = int(((counts[:, 0] + counts[:, 1]) > 0).sum())
        shape = dict(tiles=int(counts.shape[0]), nonempty_tiles=nonempty,
                     k_tri=tables[0].shape[1], k_sph=tables[2].shape[1],
                     sh_rows=(tables[4].shape[1], tables[5].shape[1]))
        for cname in cots:
            g = gs[cname]
            fn = lambda: S.soft_tiled_bwd(params, taus, tables, counts, g, cfg=kc)  # noqa: E731
            row = dict(kernel="B5", case=name, cotangent=cname,
                       **timed(fn, 50 if name.startswith("train") else 10),
                       nonzero_pixels=int((g[..., :3] != 0).any(-1).sum()), **shape)
            if check:
                got = fn()
                if cname == "zero":
                    row["exact_zeros"] = all(bool((t == 0).all()) for t in got)
                elif name != "scene3 640x480":  # its autograd graph is too large
                    leaves = [t.detach().requires_grad_(True)
                              for t in (params, taus) + tuple(tables)]
                    out = S._soft_tiled_plain(leaves[0], leaves[1], leaves[2:], counts,
                                              cfg=kc)
                    want = torch.autograd.grad(out, leaves, g, allow_unused=True)
                    row["err_vs_twin"] = grad_err(got, want)
                    del out, want, leaves
                if hasattr(S, "_soft_tiled_bwd_cuda"):
                    live = S._soft_tiled_bwd_cuda(params, taus, tables, counts, g, kc)[1]
                    ent = live[2:2 + int(live[0])]
                    row["live_patches"] = ent.numel()
                    row["list_equals_plain"] = bool(torch.equal(
                        ent.sort().values.long(), S._live_patches(g, counts, cfg=kc)))
            say(**row)


# ---- B4 + B5 in both regimes -------------------------------------------------

def finals_rows(dev, check):
    from opencl_ray_tracer_tpu_torch.utils import profiling as P

    ortho, pin, head, scene3 = scenes(dev)
    fifty = T.random_scene(50, 4, seed=1, bounds=(1910.0, 1070.0), device=dev)
    stress = T.random_scene(100, 100, seed=0, bounds=(1910.0, 1070.0), device=dev)
    scene1 = T.create_scene1(device=dev)
    cases = [("train1080 ortho", head, ortho, soft_cfg(1920, 1080)),
             ("train1080 pinhole", head, pin, soft_cfg(1920, 1080)),
             ("50+4 1080p", fifty, ortho, soft_cfg(1920, 1080)),
             ("stress 1080p", stress, ortho,
              soft_cfg(1920, 1080).replace(cull_k=96, shadow_cull_k=136)),
             ("scene3 640x480", scene3, ortho, soft_cfg(640, 480)),
             ("scene1 640x480", scene1, ortho, soft_cfg(640, 480)),
             ("fit640 scene1 lambert", scene1, ortho,
              soft_cfg(640, 480).replace(shading="lambert", shadows=False))]
    threshold = S._FINALS_MIN_SLOTS
    try:
        for name, scene, cam, cfg in cases:
            ops = {}
            for regime, slots in (("recompute", 1 << 30), ("stored", 0)):
                S._FINALS_MIN_SLOTS = slots
                with torch.no_grad():
                    ops[regime] = S.soft_kernel_inputs(scene.pack(), cam, cfg)
            params, taus, tables, counts, kc = ops["stored"]
            bins = S.soft_bins_for_config(scene.pack(), cam, cfg)
            n_slots = S._finals_slots(bins, kc["n_lights"], kc["shadows"])
            block = S.finals_block(kc, dev)
            with torch.no_grad():
                img = S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc)
            gs = {"loss": loss_cotangent(img, 1.0 / 255.0),
                  "dense": torch.full_like(img, 1e-6)}
            shape = dict(case=name, slots=n_slots, gate_at_threshold=n_slots >= threshold,
                         nonempty_tiles=int(((counts[:, 0] + counts[:, 1]) > 0).sum()),
                         block_mb=block.numel() * 4 / 2 ** 20)
            fwd_ms = {}
            for regime in ("recompute", "stored"):
                kc_r = ops[regime][4]
                fin = block if regime == "stored" else None
                fn = lambda: S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc_r,  # noqa: E731
                                              finals=fin)
                b4 = P.tiled_soft_bounds(scene, cam, cfg, ops[regime], gs["loss"])[0]
                row = timed(fn, 20)
                fwd_ms[regime] = row["device_ms"]
                say(kernel="B4", regime=regime, **shape, **row, bound_ms=b4[0],
                    bound_by=b4[1])
            with torch.no_grad():  # the block the stored B5 reads
                S.soft_tiled_fwd(params, taus, tables, counts, cfg=kc, finals=block)
            for cname, g in gs.items():
                pair = {}
                got = {}
                for regime in ("recompute", "stored"):
                    kc_r = ops[regime][4]
                    fin = block if regime == "stored" else None
                    fn = lambda: S.soft_tiled_bwd(params, taus, tables, counts, g,  # noqa: E731
                                                  cfg=kc_r, finals=fin)
                    b5 = P.tiled_soft_bounds(scene, cam, cfg, ops[regime], g)[1]
                    row = timed(fn, 20)
                    pair[regime] = fwd_ms[regime] + row["device_ms"]
                    got[regime] = fn()
                    say(kernel="B5", regime=regime, cotangent=cname, **shape, **row,
                        bound_ms=b5[0], bound_by=b5[1])
                say(pair="B4+B5 device_ms", cotangent=cname, **shape, **pair,
                    faster=min(pair, key=pair.get),
                    stored_vs_recompute_grad_err=grad_err(got["stored"],
                                                          got["recompute"]))
    finally:
        S._FINALS_MIN_SLOTS = threshold


# ---- B3 ---------------------------------------------------------------------

def b3_rows(dev, check):
    ortho, pin, head, scene3 = scenes(dev)
    for name, scene, cam, (w, h), shading, shadows in (
        ("headline 1080p ortho legacy", head, ortho, (1920, 1080), "legacy", False),
        ("headline 1080p ortho phong+shadows", head, ortho, (1920, 1080), "phong", True),
        ("headline 1080p pinhole legacy", head, pin, (1920, 1080), "legacy", False),
        ("headline 1080p pinhole phong+shadows", head, pin, (1920, 1080), "phong", True),
        ("scene3 640x480 ortho phong+shadows", scene3, ortho, (640, 480), "phong", True),
    ):
        cfg = T.RenderConfig(width=w, height=h, shading=shading, shadows=shadows,
                             framebuffer_dtype="float")
        args, kw = fwd.brute_kernel_inputs(scene.pack(), cam, cfg)
        fn = lambda: fwd.brute_kernel(*args, **kw)  # noqa: E731
        row = dict(kernel="B3", case=name,
                   **timed(fn, 50 if name.startswith("headline") else 10))
        if check:
            got, want = fn(), fwd._brute_kernel_plain(*args, **kw)
            row["max_err_vs_twin"] = (got - want).abs().max().item()
            row["identical"] = (got == want).all(-1).float().mean().item()
            row["lit"] = (got[..., :3] > 0).any(-1).float().mean().item()
        say(**row)


# ---- B6 / B7 ----------------------------------------------------------------

def brute_soft_operands(scene, cam, w, h, shading="phong", shadows=True):
    packed = scene.pack()
    inputs = [B._camera_params(cam, packed.lights).contiguous(),
              torch.tensor([1.0, 0.5], device=packed.device),
              *(a.contiguous() for a in B._prep_soft_arrays(packed))]
    return inputs, dict(height=h, width=w,
                        cfg=B._static_cfg(packed, shading, shadows, cam.normalize))


def brute_soft_twin_grads(inputs, g, kw):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(B._soft_brute_plain(*leaves, **kw), leaves, g,
                               allow_unused=True)


def brute_soft_rows(dev, check):
    cam, _, head, scene3 = scenes(dev)
    cases = [("headline 1920x1080", *brute_soft_operands(head, cam, 1920, 1080)),
             ("scene3 256x128", *brute_soft_operands(scene3, cam, 256, 128)),
             ("scene3 640x480", *brute_soft_operands(scene3, cam, 640, 480))]
    for name, inputs, kw in cases:
        img = B.soft_brute_fwd(*inputs, **kw)
        torch.cuda.synchronize()
        lit = (img[..., :3] != 0).any(-1).float().mean().item()
        fn = lambda: B.soft_brute_fwd(*inputs, **kw)  # noqa: E731
        say(case=name, kernel="B6", **timed(fn, 50), lit=lit)
        if name == "scene3 640x480":
            continue
        cots = {"loss": loss_cotangent(img),
                "dense": torch.full_like(img, 1e-6),
                "zero": torch.zeros_like(img)}
        for cname, g in cots.items():
            fn = lambda: B.soft_brute_bwd(*inputs, g, **kw)  # noqa: E731
            say(case=name, kernel="B7", cotangent=cname,
                **timed(fn, 50 if name.startswith("headline") else 20),
                nonzero_pixels=int((g[..., :3] != 0).any(-1).sum()))

    if not check:
        return
    name, inputs, kw = cases[0]
    img = B.soft_brute_fwd(*inputs, **kw)
    with torch.no_grad():
        say(check="B6 headline vs twin",
            err=(img - B._soft_brute_plain(*inputs, **kw)).abs().max().item())
    g = loss_cotangent(img)
    want = brute_soft_twin_grads(inputs, g, kw)
    got = B.soft_brute_bwd(*inputs, g, **kw)
    say(check="B7 headline loss cotangent vs twin", err=grad_err(got, want))
    zeros = B.soft_brute_bwd(*inputs, torch.zeros_like(img), **kw)
    say(check="B7 all-zero cotangent gives exact zeros",
        ok=all(bool((t == 0).all()) for t in zeros))
    # small frames: a scattered, a one-patch and a dense cotangent; 2,600 primitives
    small = T.random_scene(5, 3, seed=4, bounds=(250.0, 120.0), device=dev)
    big = T.random_scene(200, 200, seed=1, bounds=(60.0, 30.0), device=dev)
    for label, scene, (w, h) in (("test 250x123", small, (250, 123)),
                                 ("2600 primitives 64x32", big, (64, 32))):
        inputs, kw = brute_soft_operands(scene, cam, w, h)
        n_prims = kw["cfg"]["n_tris"] + kw["cfg"]["n_spheres"]
        gs = {"dense": torch.full((h, w, 4), 1e-3, device=dev)}
        sc = torch.zeros((h, w, 4), device=dev)
        sc[3, 5, 1], sc[20, 60, 0], sc[h - 1, w - 1, 2] = 1.0, -2.0, 0.5
        sc[8:12, 16:24, :3] = 0.5
        gs["scattered + one patch"] = sc
        for cname, g in gs.items():
            want = brute_soft_twin_grads(inputs, g, kw)
            got = B.soft_brute_bwd(*inputs, g, **kw)
            say(check=f"B7 {label} ({n_prims} primitives) {cname} vs twin",
                err=grad_err(got, want))


def main():
    check = "--check" in sys.argv
    only = sys.argv[sys.argv.index("--kernel") + 1] if "--kernel" in sys.argv else None
    if only not in (None, "B1", "B2", "B4", "B5", "B3", "B6", "B7", "finals"):
        sys.exit(f"--kernel takes B1, B4, B5, B3, B6, B7 or finals, got {only}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.load_library()
    say(card=smi, package=T.__file__, ptxas=[
        ln.strip() for ln in _build.BUILD_LOG.splitlines()
        if "Compiling" in ln or ("registers" in ln and "Used" in ln) or "spill" in ln])
    if only in (None, "B1", "B2"):
        b1_rows(dev, check)
    if only in (None, "B4"):
        b4_rows(dev, check)
    if only in (None, "B5"):
        b5_rows(dev, check)
    if only in (None, "B3"):
        b3_rows(dev, check)
    if only in (None, "B6", "B7"):
        brute_soft_rows(dev, check)
    if only == "finals":
        finals_rows(dev, check)


if __name__ == "__main__":
    main()
