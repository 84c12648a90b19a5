#!/usr/bin/env python3
"""Times of the port's brute soft kernels B6 (`soft_brute_fwd`) and B7
(`soft_brute_bwd`) on one NVIDIA card, back to back per launch (CUDA
events around 50 launches: `ms`, which holds the wrapper's host work where
that is the longer; and `device_ms`, the same launches queued behind a spin
on the card), for whichever `opencl_ray_tracer_tpu_torch` is
first on PYTHONPATH:

    PYTHONPATH=. python scripts/torch_soft_brute_times.py [--check]

To compare two commits, or a design step against the kernel without it,
unpack the other tree into a directory and run the script once per tree, in
turns on one card (other, this, this, other).

Inputs: the 1080p headline scene (10 spheres + 1 cube, phong + soft
shadows) with the cotangent of mean(img^2) (non-zero on the covered pixels
only), with a cotangent of 1e-6 on every pixel, and with zeros; scene 3
(1,300 primitives) at 256x128 (B7, both cotangents) and 640x480 (B6).
`--check` also holds B7 against its twin on an all-zero, a scattered and a
dense cotangent and above 2,400 primitives. One JSON object per line on
stdout.
"""

import json
import subprocess
import sys

import torch

import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu_torch.bench_util import back_to_back_ms
from opencl_ray_tracer_tpu_torch.kernels import _build
from opencl_ray_tracer_tpu_torch.kernels import soft as B


def device_ms(fn, n):
    """Milliseconds of device time per call: n calls queued behind a spin of
    ~0.1 s on the card, so that the host's share of a call does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def say(**kw):
    print(json.dumps(kw), flush=True)


def operands(scene, cam, w, h, shading="phong", shadows=True):
    packed = scene.pack()
    inputs = [B._camera_params(cam, packed.lights).contiguous(),
              torch.tensor([1.0, 0.5], device=packed.device),
              *(a.contiguous() for a in B._prep_soft_arrays(packed))]
    return inputs, dict(height=h, width=w,
                        cfg=B._static_cfg(packed, shading, shadows, cam.normalize))


def loss_cotangent(img):
    g = torch.zeros_like(img)
    g[..., :3] = 2.0 * img[..., :3] / (img.shape[0] * img.shape[1] * 3)
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


def twin_grads(inputs, g, kw):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(B._soft_brute_plain(*leaves, **kw), leaves, g,
                               allow_unused=True)


def main():
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.load_library()
    say(card=smi, package=T.__file__, ptxas=[
        ln.strip() for ln in _build.BUILD_LOG.splitlines()
        if "soft_brute" in ln or ("registers" in ln and "Used" in ln)][:40])
    cam = T.legacy_ortho_camera(device=dev)
    head = T.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), device=dev)
    scene3 = T.create_scene(3, seed=0, device=dev)
    cases = [("headline 1920x1080", *operands(head, cam, 1920, 1080)),
             ("scene3 256x128", *operands(scene3, cam, 256, 128)),
             ("scene3 640x480", *operands(scene3, cam, 640, 480))]
    for name, inputs, kw in cases:
        img = B.soft_brute_fwd(*inputs, **kw)
        torch.cuda.synchronize()
        lit = (img[..., :3] != 0).any(-1).float().mean().item()
        fn = lambda: B.soft_brute_fwd(*inputs, **kw)  # noqa: E731
        say(case=name, kernel="B6", ms=back_to_back_ms(fn, 50),
            device_ms=device_ms(fn, 50), lit=lit)
        if name == "scene3 640x480":
            continue
        cots = {"loss": loss_cotangent(img),
                "dense": torch.full_like(img, 1e-6),
                "zero": torch.zeros_like(img)}
        for cname, g in cots.items():
            n = 50 if name.startswith("headline") else 20
            fn = lambda: B.soft_brute_bwd(*inputs, g, **kw)  # noqa: E731
            say(case=name, kernel="B7", cotangent=cname,
                ms=back_to_back_ms(fn, n), device_ms=device_ms(fn, n),
                nonzero_pixels=int((g[..., :3] != 0).any(-1).sum()))

    if "--check" not in sys.argv:
        return
    name, inputs, kw = cases[0]
    img = B.soft_brute_fwd(*inputs, **kw)
    with torch.no_grad():
        say(check="B6 headline vs twin",
            err=(img - B._soft_brute_plain(*inputs, **kw)).abs().max().item())
    g = loss_cotangent(img)
    want = twin_grads(inputs, g, kw)
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
        inputs, kw = operands(scene, cam, w, h)
        n_prims = kw["cfg"]["n_tris"] + kw["cfg"]["n_spheres"]
        gs = {"dense": torch.full((h, w, 4), 1e-3, device=dev)}
        sc = torch.zeros((h, w, 4), device=dev)
        sc[3, 5, 1], sc[20, 60, 0], sc[h - 1, w - 1, 2] = 1.0, -2.0, 0.5
        sc[8:12, 16:24, :3] = 0.5
        gs["scattered + one patch"] = sc
        for cname, g in gs.items():
            want = twin_grads(inputs, g, kw)
            got = B.soft_brute_bwd(*inputs, g, **kw)
            say(check=f"B7 {label} ({n_prims} primitives) {cname} vs twin",
                err=grad_err(got, want))


if __name__ == "__main__":
    main()
