"""The check fails what it must: the control (the reference in bfloat16 in
the program's place) and the faults each cell can have, planted in the
port underneath a whole run on the CPU (no look for a card), each read
against the cell's own limits."""

import argparse

import pytest
import torch

import opencl_ray_tracer_tpu_torch.models.renderer as renderer
import opencl_ray_tracer_tpu_torch.parallel.train as train
from rtbench.lib import files
from rtbench.lib.main import Run, execute

CPU = torch.device("cpu")


def _args(workload, seconds=0.6):
    return argparse.Namespace(workload=workload, seed=2 ** 31 + 901, seconds=seconds,
                              trace=0)


def _fit_over(small):
    """The fit cut to a 256 x 128 frame whose scene spans it: bfloat16's
    spacing there is what the control needs to show."""
    over = {k: dict(v) for k, v in small["rt10_1080.fit"].items()}
    scene = dict(over["config"]["scene"], bounds=[250.0, 120.0],
                 lights=dict(over["config"]["scene"]["lights"],
                             position=[[120.0, 60.0, 200.0]]))
    over["config"] = dict(over["config"], width=256, height=128, scene=scene)
    return over


def test_sound_runs_are_correct(small):
    assert execute(_args("rt10_1080.fly"), CPU, overrides=small["rt10_1080.fly"])[0]["correct"]
    assert execute(_args("rt10_1080.fit", 1.0), CPU, overrides=_fit_over(small))[0]["correct"]


def test_an_altered_frame_is_not_correct(small, monkeypatch):
    orig = renderer.render

    def altered(*a, **kw):
        return torch.roll(orig(*a, **kw), shifts=3, dims=1)

    monkeypatch.setattr(renderer, "render", altered)
    res, checks, _ = execute(_args("rt10_1080.fly"), CPU, overrides=small["rt10_1080.fly"])
    assert res["correct"] is False and res["failed"] == 1


def test_the_frame_control_is_not_correct(small):
    run = Run(_args("rt10_1080.fly"), files.benchmark(), CPU, small["rt10_1080.fly"])
    loop = files.load("loops", "frames")
    loop.setup(run)
    low = loop.control(run)
    assert low["frame_mismatch_share"] > run.limits["frame_mismatch_share"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_rows"])
def test_a_faulty_step_is_not_correct(small, monkeypatch, fault):
    orig = train._descend

    def state_unchanged(state, img, target, config, mesh, param_filter):
        diff = (img[..., :3] - target[..., :3]) * (1.0 / 255.0)
        return (torch.sum(diff * diff) / (config.height * config.width * 3.0)).detach()

    def half_rows(state, img, target, config, mesh, param_filter):
        h = img.shape[0] // 2
        return orig(state, img[:h], target[:h], config.replace(height=h), mesh,
                    param_filter)

    monkeypatch.setattr(train, "_descend", {"state_unchanged": state_unchanged,
                                            "half_rows": half_rows}[fault])
    res, checks, _ = execute(_args("rt10_1080.fit", 1.0), CPU, overrides=_fit_over(small))
    assert res["correct"] is False, checks


def test_the_fit_control_is_not_correct(small):
    run = Run(_args("rt10_1080.fit"), files.benchmark(), CPU, _fit_over(small))
    loop = files.load("loops", "fit")
    loop.setup(run)
    low = loop.control(run)
    for reading in low.values():
        assert any(reading[k] > run.limits[k] for k in ("loss_gap", "grad_gap", "change_gap")), low
