#!/usr/bin/env python3
"""Times of the port's hand-written kernels alone on one NVIDIA card: the
tiled soft backward B5 (`soft_tiled_bwd`), the brute hard kernel B3
(`brute_kernel`) and the brute soft forward and backward B6 / B7
(`soft_brute_fwd`, `soft_brute_bwd`), for whichever
`opencl_ray_tracer_tpu_torch` is first on PYTHONPATH:

    PYTHONPATH=. python scripts/torch_kernel_times.py [--check] [--kernel B5|B3|B6|B7]

(`--kernel B6` and `--kernel B7` both run the brute soft pair: they share
their inputs.) Each row holds `ms`, back to back per launch (CUDA events
around n launches: the wrapper's host work where that is the longer), and
`device_ms`, the same launches queued behind a spin on the card. To
compare two commits, or a design step against the kernel without it, unpack
the other tree into a directory and run the script once per tree, in turns
on one card (other, this, this, other); the timing helpers are always those
of the tree this script lies in, so both trees are timed by the same code.

B5 inputs: the 1080p headline scene (10 spheres + 1 cube, phong + soft
shadows, the train step's tables) with the train step's own cotangent
(non-zero on the covered pixels only), with zeros and with 1e-6 on every
pixel; the same scene through a pinhole camera; scene 3 (1,300 primitives)
at 640x480 with the loss's and the dense cotangent (and, for `--check`,
at 256x128, where the twin's autograd graph fits). B3 inputs: the 1080p
headline frame, legacy and phong + hard shadows, ortho and pinhole; scene 3
at 640x480, phong + shadows. B6 / B7 inputs: the 1080p headline scene with
the cotangent of mean(img^2), 1e-6 on every pixel and zeros; scene 3 at
256x128 (B7, all three) and 640x480 (B6).

`--check` also holds each kernel against its plain twin: B5 on the inputs
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
from opencl_ray_tracer_tpu_torch.kernels import _build, fwd
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
    if only not in (None, "B5", "B3", "B6", "B7"):
        sys.exit(f"--kernel takes B5, B3, B6 or B7, got {only}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.load_library()
    say(card=smi, package=T.__file__, ptxas=[
        ln.strip() for ln in _build.BUILD_LOG.splitlines()
        if ("Compiling" in ln and any(k in ln for k in ("soft_bwd", "fwd_brute", "soft_brute")))
        or ("registers" in ln and "Used" in ln) or "spill" in ln])
    if only in (None, "B5"):
        b5_rows(dev, check)
    if only in (None, "B3"):
        b3_rows(dev, check)
    if only in (None, "B6", "B7"):
        brute_soft_rows(dev, check)


if __name__ == "__main__":
    main()
