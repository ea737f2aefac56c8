"""Runs of the harness on the CPU at a small size: the reference against the
program's plain path, a cell and a metric added as new files, the import
check, the faults the comparison must catch, and the control it must
reject. The run on the card is marked `cuda` and skips without one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vxbench import control, harness, judge, reference, scene

ROOT = Path(__file__).resolve().parents[2]
HOME = ROOT / "vxbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"size": [32, 32, 24], "width": 40, "height": 24}


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_config(name="ct512-1080p"):
    config = json.loads((HOME / "configs" / f"{name}.json").read_text())
    config["volume"]["size"] = SMALL["size"]
    config["width"], config["height"] = SMALL["width"], SMALL["height"]
    if config["environment"]["kind"] != "default":
        config["environment"].update(width=64, height=32)
    return config


def _small_home(tmp_path):
    """A copy of the benchmark's files with the configurations cut to a small size."""
    home = tmp_path / "vxbench"
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(HOME / d, home / d)
    for path in (home / "configs").glob("*.json"):
        path.write_text(json.dumps(_small_config(path.stem)))
    for path in (home / "workloads").glob("*.json"):
        workload = json.loads(path.read_text())
        if workload.get("turn_frames"):
            workload["turn_frames"] = 3  # every mode takes its turns in a short window
            path.write_text(json.dumps(workload))
    return home


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
@pytest.mark.parametrize("extra", [{}, {"gradient_shading": True}, {"bounces": 3}],
                         ids=["plain", "gradient", "bounces3"])
def test_reference_matches_the_programs_plain_path(mode, extra):
    """On the CPU the program runs its kernels' plain versions; the
    reference gives the same samples, bit for bit."""
    from volxel_tpu_torch.render.pathtrace import render_pixels

    config = _small_config()
    workload = {"modes": [mode], "settings": extra}
    volume = scene.make_volume(config["volume"]["size"], 12, 5, "cpu")
    data = scene.normalised(volume)
    r, *_ = scene.port_renderer(config, workload, volume, "cpu")
    sc = reference.Scene(scene.reference_scene(config, workload, mode, data), "cpu")
    conf, params, grid = r._config(), r.volume_params(), r._device_grid
    inv_view, inv_proj, light = r._camera_operands(conf)
    pixels = torch.arange(config["width"] * config["height"])
    for frame in (5, 12):
        ours = render_pixels(conf, grid, params, r._lut, r.environment.state, inv_view, inv_proj, light, pixels,
                             frame)
        theirs = sc.samples(pixels, torch.full_like(pixels, frame))
        assert torch.equal(ours, theirs)


@pytest.mark.parametrize("mode", ["default", "no_dda"])
def test_the_roofline_counts_every_brick_a_camera_ray_enters(mode):
    """Every brick that a pixel's camera ray passes through inside the box
    (marched at a tenth of a voxel) is counted reachable; in the default
    mode only the occupied ones are, and a camera that looks away reaches
    none."""
    config = _small_config()
    data = scene.normalised(scene.make_volume(config["volume"]["size"], 12, 5, "cpu"))
    workload = {"modes": [mode], "settings": {}}
    sc = reference.Scene(scene.reference_scene(config, workload, mode, data), "cpu", torch.float64)
    reach = scene.reachable_bricks(sc)
    pixels = torch.arange(sc.width * sc.height)
    _, o, d = sc.camera(pixels, torch.full_like(pixels, 5))
    hit, near, far = reference._box(o, d, sc.aabb_lo, sc.aabb_hi)
    ipos, idir = sc._index_rays(o, d)
    entered = torch.zeros_like(reach)
    for t in torch.linspace(0.0, 1.0, 10 * max(sc.extent)):
        p = ipos + (near + t * (far - near))[:, None] * idir
        b = torch.floor(p).to(torch.int64).clamp_min(0) // scene.BRICK
        b = torch.minimum(b, torch.tensor(reach.shape[::-1]) - 1)
        entered[b[hit, 2], b[hit, 1], b[hit, 0]] = True
    if mode == "default":
        entered &= sc.maj[0, :reach.shape[0], :reach.shape[1], :reach.shape[2]] > 0
    assert entered.any() and not (entered & ~reach).any()
    voxels = int(np.prod(sc.extent))
    assert 0 < scene.reachable_field_bytes(sc) <= 2 * voxels
    away = dict(config, camera={"pos": [0.0, 0.0, -1.5], "look_at": [0.0, 0.0, -3.0]})
    sc = reference.Scene(scene.reference_scene(away, workload, mode, data), "cpu", torch.float64)
    assert scene.reachable_field_bytes(sc) == 0


def _run(home, cell, bench=None, hook=None, seconds=0.6, seed=2**31 + 77):
    return harness.run_cell(cell, seed, seconds, False, time.monotonic(), home=home, bench=bench or BENCH,
                            device="cpu", renderer_hook=hook)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(tmp_path, cell):
    code, result = _run(_small_home(tmp_path), cell, seconds=1.5)
    assert code == 0 and result["correct"] and result["failed"] == 0
    assert {"ms_per_sample", "setup_s"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    """A later cell and metric are new files and new BENCHMARK.json entries:
    no file of the harness is edited."""
    home = _small_home(tmp_path)
    before = {p: p.read_bytes() for p in HOME.rglob("*.py")}
    workload = json.loads((home / "workloads" / "ct512-1080p.default.json").read_text())
    workload["modes"] = ["no_dda"]
    (home / "workloads" / "ct512-1080p.no_dda.json").write_text(json.dumps(workload))
    (home / "metrics" / "frames_seen.py").write_text(
        'UNIT, LAYER, MOVES, SOURCE = "frames", "facade", None, "host_clock"\n\n\n'
        "def read(run):\n    return len(run.frames)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ct512-1080p.no_dda", "config": "ct512-1080p", "traffic": "no_dda",
                               "chips": 1, "why": "no_dda"})
    bench["end_to_end"].append({"name": "frames_seen", "unit": "frames", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["ct512-1080p.no_dda"]})
    code, result = _run(home, "ct512-1080p.no_dda", bench=bench)
    assert code == 0 and result["correct"]
    assert result["metrics"]["frames_seen"]["value"] == result["attempted"] > 0
    assert {p: p.read_bytes() for p in HOME.rglob("*.py")} == before


def _freeze_every_third_frame(r):
    render = r.render_frame

    def frame():
        if r.frame_index % 3 == 2:
            r.frame_index += 1  # the frame is counted, its sample never accumulated
            return r._framebuffer
        return render()
    r.render_frame = frame


def _patch_samples(monkeypatch, change):
    from volxel_tpu_torch.api import renderer as renderer_module

    original = renderer_module.render_sample

    def render_sample(*args, **kwargs):
        return change(original(*args, **kwargs))
    monkeypatch.setattr(renderer_module, "render_sample", render_sample)


def _half_left_out(sample):
    out = sample.clone()
    out[1::2] = 0.0  # every other pixel left out of the sample
    return out


def _altered(sample):
    out = sample.clone()
    out[::8] *= 1.01  # an answer altered where it is produced
    return out


def _image_altered(r):
    image = r.image

    def altered(*args, **kwargs):
        img = image(*args, **kwargs).copy()
        img[0, 0, 0] += 1e-3
        return img
    r.image = altered


@pytest.mark.parametrize("fault", ["frozen", "half", "altered", "image"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    hook = None
    if fault == "frozen":
        hook = _freeze_every_third_frame
    elif fault == "half":
        _patch_samples(monkeypatch, _half_left_out)
    elif fault == "altered":
        _patch_samples(monkeypatch, _altered)
    else:
        hook = _image_altered
    code, result = _run(_small_home(tmp_path), "ct512-1080p.default", hook=hook)
    assert code == 0 and not result["correct"] and result["failed"] == result["attempted"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(cell):
    """The reference computed in bfloat16, in the program's place, fails the
    cell's limits."""
    workload = json.loads((HOME / "workloads" / f"{cell}.json").read_text())
    numbers = control.readings(cell, 9, 40, torch.bfloat16, "cpu", config=_small_config(), workload=workload)
    correct, _ = judge.verdict(numbers, workload["check"]["limits"])
    assert not correct


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    import volxel_tpu_torch  # noqa: F401  (the port's name begins with the JAX package's)

    monkeypatch.delitem(sys.modules, "volxel_tpu", raising=False)
    assert "volxel_tpu" not in harness.forbidden_modules()
    fake = types.ModuleType("volxel_tpu")
    monkeypatch.setitem(sys.modules, "volxel_tpu", fake)
    monkeypatch.setitem(sys.modules, "volxel_tpu.render", types.ModuleType("volxel_tpu.render"))
    assert "volxel_tpu" in harness.forbidden_modules()
    assert "volxel_tpu_torch" not in harness.forbidden_modules()


def test_the_harness_loads_no_jax(tmp_path):
    """A run's process, up to its result, loads neither JAX nor the JAX
    package (checked in a fresh interpreter at a small size on the CPU)."""
    home = _small_home(tmp_path)
    code = (f"import sys, time, json; sys.path.insert(0, {str(ROOT)!r}); import torch; torch.set_num_threads(1)\n"
            "from pathlib import Path\nfrom vxbench import harness\n"
            f"c, r = harness.run_cell('ct512-1080p.default', 3, 0.3, False, time.monotonic(), "
            f"home=Path({str(home)!r}), device='cpu')\n"
            "print(json.dumps({'code': c, 'correct': r['correct'], 'mods': harness.forbidden_modules(), "
            "'torch_mods': sorted(m for m in sys.modules if m.split('.')[0] == 'volxel_tpu_torch')[:1]}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["code"] == 0 and res["correct"] and res["mods"] == [] and res["torch_mods"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "vxbench/run.py", "--workload", "ct512-1080p.default", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_in_a_directory_without_the_program_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HOME, tmp_path / "vxbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "vxbench/run.py", "--workload", "ct512-1080p.default", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the program's CUDA kernels")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "vxbench/run.py", "--workload", "ct512-1080p.default", "--seed",
                          str(2**31 + 5), "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["ms_per_sample"]["value"])
