"""The port's load-and-benchmark path against the JAX package's, on the CPU.

Renderer.restart_from_zip / load_env / from_attributes and the benchmark
harness (volxel_tpu_torch/api/benchmark.py) take the same inputs as the JAX
package's: a DICOM zip and an HDR environment written by the fixture
writers, and the settings export of tests/test_api.py's spec. Records must
carry the JAX records' keys (the fingerprint's version fields aside), and a
16x16 render after the same loads meets tests/test_torch_render.py's
contract against the JAX renderer.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.api import benchmark as j_benchmark
from volxel_tpu.utils import profiling as j_profiling
from volxel_tpu_torch import Renderer as TRenderer
from volxel_tpu_torch import kernels
from volxel_tpu_torch.api import benchmark as t_benchmark
from volxel_tpu_torch.ingest import read_zip_to_grid
from volxel_tpu_torch.utils import fixtures as t_fixtures
from volxel_tpu_torch.utils import profiling as t_profiling

from .test_torch_render import FIXTURE, _assert_contract

W = H = 16
FRAMES = 12  # frames 5..11 accumulate
# the fingerprint fields that name each package's framework
JAX_ONLY = {"jaxVersion"}
TORCH_ONLY = {"torchVersion", "cudaVersion"}

# tests/test_api.py's spec (test_benchmark_single_and_collection)
SETTINGS = {
    "version": "v3",
    "transfer": {
        "densityMultiplier": 1.0,
        "transfer": {"type": "color_stops", "colors": [{"color": [1, 1, 1, 1], "stop": 0.0}]},
        "histogramRange": [0.0, 1.0],
    },
    "display": {"samples": 2, "bounces": 1, "gamma": 2.2, "exposure": 5.5, "debugHits": False,
                "renderMode": "raymarch", "resolutionFactor": 1.0},
    "lighting": {"useEnv": True, "showEnv": True, "envStrength": 1.0, "syncLightDir": False,
                 "lightDir": [-0.577, -0.577, -0.577]},
    "other": {"cameraPos": [0, 0, -2], "cameraLookAt": [0, 0, 0], "clipMin": [0, 0, 0], "clipMax": [1, 1, 1]},
}


def _spec(with_resources: bool) -> dict:
    benchmarks = [
        {"renderMode": "raymarch", "settings": 0, "name": "rm"},
        {"renderMode": "no_dda", "settings": 0, "name": "dt"},
    ]
    if with_resources:
        benchmarks += [
            {"renderMode": "default", "settings": 0, "name": "loaded", "zip": "ct.zip", "env": "sky.hdr"},
            {"renderMode": "default", "settings": 0, "name": "missing", "zip": "absent.zip"},
        ]
    return {"sharedSettings": [SETTINGS], "benchmarks": benchmarks}


@pytest.fixture(scope="module")
def inputs():
    vol = t_fixtures.synthetic_ct_volume((24, 24, 24), bits_stored=12, seed=0)
    return {"ct.zip": t_fixtures.write_dicom_zip(vol, bits_stored=12), "sky.hdr": t_fixtures.synthetic_env_hdr(64, 32)}


@pytest.fixture(scope="module")
def jax_loaded(inputs):
    """The JAX renderer after restart_from_zip + load_env (built once)."""
    r = JRenderer(width=W, height=H)
    r.restart_from_zip(inputs["ct.zip"])
    r.load_env(inputs["sky.hdr"])
    return r


def _torch_loaded(inputs):
    r = TRenderer(W, H, device="cpu")
    r.restart_from_zip(inputs["ct.zip"])
    r.load_env(inputs["sky.hdr"])
    return r


def _record_keys(record: dict, drop: set) -> tuple:
    return sorted(record), sorted(set(record["device"]) - drop), sorted(record["device"]["accelerator"])


def test_single_benchmark_record_matches_jax(inputs, jax_loaded):
    tr = _torch_loaded(inputs)
    for r in (tr, jax_loaded):
        r.restore_settings(SETTINGS)
        r.render_mode = "default"
        r.settings.max_samples = 1
    got = t_benchmark.run_single_benchmark(tr, name="tiny")
    want = j_benchmark.run_single_benchmark(jax_loaded, name="tiny")
    assert _record_keys(got, TORCH_ONLY) == _record_keys(want, JAX_ONLY)
    assert set(got["device"]) & (TORCH_ONLY | JAX_ONLY) == TORCH_ONLY
    assert got["settings"] == want["settings"]
    assert got["viewport"] == want["viewport"] == [0, 0, W, H]
    assert got["name"] == "tiny" and got["timePerSample"] > 0
    assert got["totalTime"] == pytest.approx(got["timePerSample"])
    assert got["device"]["accelerator"]["platform"] == "cpu"
    assert "powerLimit" not in got["device"]  # only a card's record reads one
    assert tr.frame_index == 1  # warm-up frame, then restart and one sample


def test_power_limit_read_once_and_null_without_nvidia_smi(monkeypatch):
    calls = []

    def missing(cmd, **kwargs):
        calls.append(cmd)
        raise FileNotFoundError(cmd[0])

    t_benchmark._power_limit.cache_clear()
    monkeypatch.setattr(t_benchmark.subprocess, "run", missing)
    try:
        assert t_benchmark._power_limit(0) is None
        assert t_benchmark._power_limit(0) is None
        assert len(calls) == 1 and calls[0][0] == "nvidia-smi"
    finally:
        t_benchmark._power_limit.cache_clear()


def test_benchmark_collection_resolves_resources(inputs, tmp_path):
    r = TRenderer(W, H, device="cpu")
    r.restart_from_grid(read_zip_to_grid(inputs["ct.zip"]))
    loads = []

    def load(rel):
        loads.append(rel)
        return inputs.get(rel)

    kernels.reset_launch_counts()
    results = t_benchmark.run_benchmark_collection(_spec(True), r, load_zip=load, load_env=load)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain versions only
    assert [x["name"] for x in results] == ["rm", "dt", "loaded", "missing"]
    assert [x["settings"]["renderMode"] for x in results] == ["raymarch", "no_dda", "default", "default"]
    assert loads == ["ct.zip", "sky.hdr", "absent.zip"]
    assert r.environment.texture.shape == (32, 64, 3)  # the entry's env replaced the default
    assert all(x["timePerSample"] > 0 and x["viewport"] == [0, 0, W, H] for x in results)
    out = tmp_path / "results.json"
    t_benchmark.save_benchmark(results, out)
    assert json.loads(out.read_text()) == results


def test_from_attributes_local_paths(inputs, tmp_path):
    for name, blob in inputs.items():
        (tmp_path / name).write_bytes(blob)
    settings = dict(SETTINGS, lighting=dict(SETTINGS["lighting"], envStrength=2.5))
    (tmp_path / "settings.json").write_text(json.dumps(settings))
    (tmp_path / "bench.json").write_text(json.dumps(_spec(True)))
    r = TRenderer.from_attributes(
        width=W, height=H, zip_path=tmp_path / "ct.zip", env_path=tmp_path / "sky.hdr",
        settings_path=tmp_path / "settings.json", render_mode="no_dda", benchmark_path=tmp_path / "bench.json",
        device="cpu",
    )
    assert [x["name"] for x in r.last_benchmark] == ["rm", "dt", "loaded", "missing"]
    assert r.device.type == "cpu" and r.grid is not None
    assert r.environment.texture.shape == (32, 64, 3)
    assert r.env_strength == 1.0  # the spec's settings came last
    r.env_strength = 3.0
    assert float(r.environment.state.strength) == 3.0 and r.frame_index == 0

    plain = TRenderer.from_attributes(width=W, height=H, files_dir=_write_slices(tmp_path / "slices"),
                                      settings_path=tmp_path / "settings.json", render_mode="no_dda", device="cpu")
    assert plain.render_mode == "no_dda" and plain.env_strength == 2.5
    assert plain.grid.brick_counter > 0
    with pytest.raises(NotImplementedError):
        TRenderer.from_attributes(width=W, height=H, zip_url="http://localhost/ct.zip", device="cpu")


def _write_slices(folder: Path) -> Path:
    folder.mkdir()
    vol = t_fixtures.synthetic_ct_volume((8, 16, 16), bits_stored=12)
    for i, blob in enumerate(t_fixtures.write_dicom_series(vol, bits_stored=12)):
        (folder / f"slice_{i:04d}.dcm").write_bytes(blob)
    return folder


def test_render_after_zip_and_env_matches_jax(inputs, jax_loaded):
    """Both renderers load the same zip and HDR map, take the reference
    export (strength survives load_env) and accumulate 12 frames."""
    tr = _torch_loaded(inputs)
    export = json.loads(FIXTURE.read_text())["sharedSettings"][0]
    for r in (tr, jax_loaded):
        r.restore_settings(export)
        r.settings.resolution_factor = 1.0
        r.render_mode = "default"
        r.restart_rendering()
    for r in (tr, jax_loaded):
        r.env_strength = 1.7
        r.load_env(inputs["sky.hdr"])
        assert r.env_strength == pytest.approx(1.7)
    for _ in range(FRAMES):
        jax_loaded.render_frame()
        tr.render_frame()
    _assert_contract(tr._framebuffer.numpy(), np.asarray(jax_loaded._framebuffer), 0.98)
    np.testing.assert_allclose(tr.image(), jax_loaded.image(), rtol=0, atol=2e-2)
    assert float(tr._framebuffer.mean()) > 0


def test_profiling_utils_match_jax(tmp_path):
    times = [0.0012, 0.0031, 0.0020, 0.0100, 0.0009]
    assert t_profiling.frame_stats(times) == j_profiling.frame_stats(times)
    import torch

    timer = t_profiling.StageTimer(log=False)
    with timer.stage("a"):
        pass
    with timer.stage("b", fence=torch.zeros(2)):  # a CPU tensor: no wait
        pass
    assert list(timer.report()) == ["a", "b"]
    assert all(dt >= 0 for dt in timer.report().values())
    jtimer = j_profiling.StageTimer(log=False)
    with jtimer.stage("a"):
        pass
    assert list(jtimer.report()) == ["a"]
    with t_profiling.trace(tmp_path / "trace") as out:
        torch.ones(4).sum()
    assert (out / "trace.json").exists()

