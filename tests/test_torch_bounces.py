"""Three bounces, the viewer's default, on the CPU: the port's samples
against the benchmark's plain reference (vxbench/reference.py), bit for
bit, in every mode. Bounces 2 and 3 run what one bounce never does: the
scatter's new directions, roulette, the escape MIS and legs that start
at collisions inside the volume."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu_torch.render.pathtrace import render_pixels
from volxel_tpu_torch.utils import profiling
from vxbench import reference, scene

CONFIG = Path(__file__).resolve().parents[1] / "vxbench" / "configs" / "ct512-1080p-viewer.json"


def _config():
    """The viewer's default deployment at 32x24 on a 32x32x24 volume."""
    config = json.loads(CONFIG.read_text())
    config["volume"]["size"] = [32, 32, 24]
    config["width"], config["height"] = 32, 24
    return config


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_three_bounces_equal_the_plain_reference(mode):
    config = _config()
    workload = {"modes": [mode], "settings": {}}
    assert scene.settings(config, workload)["bounces"] == 3
    volume = scene.make_volume(config["volume"]["size"], config["volume"]["bits_stored"], 2**31 + 11, "cpu")
    r, *_ = scene.port_renderer(config, workload, volume, "cpu")
    sc = reference.Scene(scene.reference_scene(config, workload, mode, scene.normalised(volume)), "cpu")
    conf, params, grid = r._config(), r.volume_params(), r._device_grid
    assert conf.bounces == 3 and conf.mode == mode
    inv_view, inv_proj, light = r._camera_operands(conf)
    pixels = torch.arange(config["width"] * config["height"])
    for frame in (5, 17):
        with profiling.spans():
            ours = render_pixels(conf, grid, params, r._lut, r.environment.state, inv_view, inv_proj, light,
                                 pixels, frame)
        live = profiling.take_live_lanes()
        profiling.take_spans(), profiling.take_counts()
        assert live[2]["lanes"] > 0  # some lanes scattered twice: the third bounce ran on them
        theirs = sc.samples(pixels, torch.full_like(pixels, frame))
        assert torch.equal(ours, theirs)
