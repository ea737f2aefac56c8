"""`python -m volxel_tpu_torch` on the CPU, each subcommand in a subprocess.

Each run is made with `-X importtime`, whose report names every module the
process imported: none may be jax or volxel_tpu. The renders are 16x16 on a
32^3 volume; the PNG is read back with PIL here.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.__main__ import main
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume, write_dicom_zip

REPO = Path(__file__).resolve().parent.parent


def _run(*args, cwd=REPO) -> str:
    """Run the CLI; return its standard output, after checking that it
    imported neither jax nor volxel_tpu."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-X", "importtime", "-m", "volxel_tpu_torch", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines() if line.startswith("import time:")}
    assert "volxel_tpu_torch.__main__" in imported or "volxel_tpu_torch" in imported
    assert not {m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "volxel_tpu")}
    return out.stdout


def test_render_writes_a_png(tmp_path):
    out = tmp_path / "r.png"
    stdout = _run("render", "--device", "cpu", "--synthetic", "32", "--size", "16x16", "--samples", "8",
                  "--out", str(out))
    assert f"wrote {out}: 16x16, 8 samples" in stdout
    with Image.open(out) as im:
        assert im.mode == "RGB" and im.size == (16, 16)
        img = np.asarray(im)
    assert img.max() > img.min()


def test_ingest_and_benchmark(tmp_path):
    vol = synthetic_ct_volume((24, 20, 16), bits_stored=12)
    (tmp_path / "scan.zip").write_bytes(write_dicom_zip(vol, bits_stored=12))
    stdout = _run("ingest", "--zip", str(tmp_path / "scan.zip"))
    assert "grid resolution: 16 20 24" in stdout and "bricks:" in stdout

    r = Renderer(8, 8, device="cpu")
    r.settings.max_samples = 2
    spec = {"sharedSettings": [r.export_settings()],
            "benchmarks": [{"zip": "scan.zip", "renderMode": "no_dda", "settings": 0, "name": "one"}]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    results = tmp_path / "results.json"
    stdout = _run("benchmark", "--device", "cpu", "--spec", str(tmp_path / "spec.json"), "--size", "8x8",
                  "--out", str(results))
    assert "one: " in stdout and "ms/sample" in stdout
    (rec,) = json.loads(results.read_text())
    assert rec["name"] == "one" and rec["settings"]["renderMode"] == "no_dda" and rec["timePerSample"] > 0
    assert rec["viewport"] == [0, 0, 8, 8] and rec["device"]["accelerator"]["platform"] == "cpu"


def test_info():
    stdout = _run("info", "--device", "cpu")
    fingerprint = json.loads(stdout[:stdout.index("\n}") + 2])
    assert fingerprint["torchVersion"] and fingerprint["accelerator"]["platform"] == "cpu"
    assert "native ingest: " in stdout and "torch " in stdout


def test_serve_mesh_with_volume_slabs(monkeypatch):
    """`serve --mesh 2,2,2 --device cpu` hands the server a
    DistributedRenderer whose volume lies in z-slabs over 'vz': it serves
    frames of sp samples each, and no drag preview (the previews need the
    whole field)."""
    from volxel_tpu_torch.api.server import PreviewServer
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    served = []
    monkeypatch.setattr(PreviewServer, "serve_forever", lambda self: served.append(self))
    main(["serve", "--device", "cpu", "--synthetic", "16", "--size", "16x16", "--mesh", "2,2,2"])
    (server,) = served
    r = server.renderer
    assert isinstance(r, DistributedRenderer) and r.mesh.shape == {"sp": 2, "px": 2, "vz": 2}
    assert r._slabbed is not None and r._device_grid.dense is None
    r.settings.max_samples = 4
    assert server.step() == "frame" and server.step() == "frame" and server.step() == "idle"
    assert r.samples_rendered() == 4 and np.isfinite(r.image()).all()
    server._motion_until = float("inf")  # as while a drag goes on
    assert server._maybe_dvr_preview() is False and server.last_error is None
