"""The fit's reference: the loss of `cli fit` / `fit_scene` (the mean squared
error over the RGB channels in 0..1 units, over every pixel of the frame),
its gradients by autograd through `reference.soft`, and Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8), followed for a few steps from the
fit's start."""

from __future__ import annotations

import math

import torch

from rtbench.reference import soft

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_and_grads(s: dict, target, cam: dict, cfg: dict, leaves, *,
                   dtype=torch.float32, rows=None):
    """(loss, {leaf: gradient}) of the scene `s` against `target`
    (H, W, 4), gradients for the named leaves, in blocks of rows. `rows`
    (a slice) restricts the loss to those rows, normalised by their own
    pixels."""
    h, w = cfg["height"], cfg["width"]
    rows = rows or slice(0, h)
    n_px = (rows.stop - rows.start) * w
    params = {k: s[k].detach().clone().requires_grad_(True) for k in leaves}
    sd = {**s, **params}
    step = soft.block_rows(w, soft.n_prims(s))
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for r0 in range(rows.start, rows.stop, step):
        r1 = min(r0 + step, rows.stop)
        img = soft.render(sd, cam, h, w, shading=cfg["shading"],
                          shadows=cfg["shadows"], tau_d=cfg["tau_depth"],
                          tau_e=cfg["tau_edge"], dtype=dtype, rows=slice(r0, r1))
        diff = (img[..., :3] - target[r0:r1, :, :3].to(dtype)) * (1.0 / 255.0)
        part = torch.sum(diff * diff) * (1.0 / (n_px * 3.0))
        g = torch.autograd.grad(part, list(params.values()), allow_unused=True)
        for k, gi in zip(params, g):
            if gi is not None:
                grads[k] += gi.to(grads[k].dtype)
        total += part.detach().double()
    return float(total), {k: v.float() for k, v in grads.items()}


def adam_steps(start: dict, target, cam: dict, cfg: dict, leaves, lr: float,
               n_steps: int, **kw):
    """Follow the fit for `n_steps` Adam steps from `start`: (losses,
    first gradients {leaf: g}, parameters after the steps {leaf: p})."""
    s = {k: v.clone() for k, v in start.items()}
    m = {k: torch.zeros_like(s[k]) for k in leaves}
    v = {k: torch.zeros_like(s[k]) for k in leaves}
    losses, first = [], None
    for t in range(1, n_steps + 1):
        loss, g = loss_and_grads(s, target, cam, cfg, leaves, **kw)
        losses.append(loss)
        if first is None:
            first = g
        for k in leaves:
            m[k] = B1 * m[k] + (1.0 - B1) * g[k]
            v[k] = B2 * v[k] + (1.0 - B2) * g[k] * g[k]
            denom = (v[k].sqrt() / math.sqrt(1.0 - B2 ** t)) + EPS
            s[k] = s[k] - (lr / (1.0 - B1 ** t)) * m[k] / denom
    return losses, first, {k: s[k] for k in leaves}
