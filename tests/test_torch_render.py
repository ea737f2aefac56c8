"""The port's path tracer against the JAX package's, end to end.

Both renderers load the same brick grid, apply the reference's settings
export (tests/fixtures/reference_benchmark.json), switch to the render mode
under test and accumulate 12 frames; the port runs on the CPU with its
plain PyTorch versions. The same contract holds the port against the
scalar GLSL oracle (tests/oracle.py) in the no_dda and raymarch modes. It is
tests/test_parity_oracle.py's: > 98% of pixels within 0.1% relative
(> 97% at bounces 3, where an ulp-level flip of a stochastic compare —
XLA contracts multiply-adds into FMAs and rounds log/exp/pow differently
from ATen — changes a whole path), median relative error < 1e-4, and means
within 0.5%.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.render.pathtrace import accumulate_progressive as jax_accumulate
from volxel_tpu.render.pathtrace import render_sample as jax_render_sample
from volxel_tpu.render.sampling import decode_dense as jax_decode_dense
from volxel_tpu.render.sampling import device_grid_from_brick as jax_device_grid
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import Renderer as TRenderer
from volxel_tpu_torch import kernels
from volxel_tpu_torch.api.convert import from_jax_state
from volxel_tpu_torch.grid import construct_brick_grid as torch_construct
from volxel_tpu_torch.render import modes as tmodes
from volxel_tpu_torch.render.pathtrace import RenderConfig, accumulate_progressive, render_sample
from volxel_tpu_torch.render.sampling import decode_dense_device, device_grid_from_brick

from .oracle import F, Oracle

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"
REPO = Path(__file__).resolve().parent.parent
W = H = 16
FRAMES = 12  # frames 5..11 accumulate


def _volume():
    vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _setup(r, grid, bounces, use_env, physical=False, mode="default"):
    r.restart_from_grid(grid)
    r.restore_settings(json.loads(FIXTURE.read_text())["sharedSettings"][0])
    r.settings.resolution_factor = 1.0
    r.render_mode = mode
    r.settings.bounces = bounces
    r.settings.use_env = use_env
    if bounces == 3:
        r.settings.density_multiplier = 2.0  # more hits -> more deep bounces
    if physical:
        r.settings.physical_shadows = r.settings.physical_majorant = r.settings.physical_pdf = True
    r.restart_rendering()
    return r


def _assert_contract(ours, theirs, tight_min):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert np.isfinite(ours).all()
    rel = np.abs(ours - theirs) / (np.abs(theirs) + 1e-3)
    frac = float((rel.max(axis=-1) < 1e-3).mean())
    assert frac > tight_min, f"only {frac:.2%} of pixels within 0.1% (max rel {rel.max():.2e})"
    assert float(np.median(rel)) < 1e-4, "systematic drift"
    assert abs(ours.mean() - theirs.mean()) < 5e-3 * max(theirs.mean(), 1e-3)


@pytest.mark.parametrize(
    "mode,bounces,use_env,physical",
    [
        pytest.param("default", 1, True, False, id="1-True-False"),
        pytest.param("default", 3, True, False, id="3-True-False"),
        pytest.param("default", 1, False, False, id="1-False-False"),
        pytest.param("default", 3, False, False, id="3-False-False"),
        pytest.param("default", 1, True, True, id="1-True-True"),
        pytest.param("raymarch", 1, True, False, id="raymarch-1-True-False"),
        pytest.param("no_dda", 1, True, False, id="no_dda-1-True-False"),
    ],
)
def test_renderer_matches_jax_renderer(mode, bounces, use_env, physical):
    data = _volume()
    eye = np.eye(4, dtype=np.float32)
    jr = _setup(JRenderer(width=W, height=H), jax_construct(data, transform=eye), bounces, use_env, physical, mode)
    tr = _setup(TRenderer(W, H, device="cpu"), torch_construct(data, transform=eye), bounces, use_env, physical,
                mode)
    kernels.reset_launch_counts()
    for _ in range(FRAMES):
        jr.render_frame()
        tr.render_frame()
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # CPU: plain versions only
    _assert_contract(tr._framebuffer.numpy(), np.asarray(jr._framebuffer), 0.97 if bounces == 3 else 0.98)
    np.testing.assert_allclose(tr.image(), jr.image(), rtol=0, atol=2e-2)
    assert tr.export_settings() == jr.export_settings()


@pytest.mark.parametrize("samples", [4, 9])
def test_render_after_a_prior_frame_matches_jax(samples):
    """Renderer.render(samples) after one render_frame(), in both packages:
    up to WARMUP_SAMPLES + 1 it renders `samples` more frames, beyond that
    the image is the mean of frames [5, samples), recomputed whatever came
    before. Frame index and framebuffer agree (the contract above)."""
    data = _volume()
    eye = np.eye(4, dtype=np.float32)
    jr = _setup(JRenderer(width=W, height=H), jax_construct(data, transform=eye), 1, True)
    tr = _setup(TRenderer(W, H, device="cpu"), torch_construct(data, transform=eye), 1, True)
    jr.render_frame()
    tr.render_frame()
    jimg, timg = jr.render(samples), tr.render(samples)
    assert tr.frame_index == jr.frame_index == (1 + samples if samples <= 6 else samples)
    _assert_contract(tr._framebuffer.numpy(), np.asarray(jr._framebuffer), 0.98)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=2e-2)


class _DenseOracle(Oracle):
    """The scalar GLSL oracle reading its voxels from the port's bf16 dense
    field, the port's only decode (the oracle's own exact brick decode
    differs from it by bf16 rounding, ~0.4%, which would swamp the contract)."""

    def __init__(self, renderer):
        super().__init__(renderer)
        self.dense = renderer._device_grid.dense.to(torch.float32).numpy()

    def _density_brick(self, iipos):
        ix, iy, iz = iipos
        if min(ix, iy, iz) < 0 or ix >= self.extent[0] or iy >= self.extent[1] or iz >= self.extent[2]:
            return F(0.0)
        return F(self.dense[iz, iy, ix])


@pytest.mark.parametrize("mode", ["raymarch", "no_dda"])
def test_renderer_matches_scalar_oracle(mode):
    """The port against the per-pixel GLSL transliteration, at
    tests/test_parity_oracle.py's size and contract."""
    tr = _setup(TRenderer(W, H, device="cpu"), torch_construct(_volume(), transform=np.eye(4, dtype=np.float32)),
                1, True, mode=mode)
    for _ in range(FRAMES):
        tr.render_frame()
    _assert_contract(tr._framebuffer.numpy(), _DenseOracle(tr).render(FRAMES), 0.98)


def test_render_from_carried_jax_state():
    """Both packages render from one scene state, carried into the port by
    from_jax_state, with the same camera matrices."""
    data = _volume()
    jr = _setup(JRenderer(width=W, height=H), jax_construct(data, transform=np.eye(4, dtype=np.float32)), 1, True)
    config = jr._config()
    (_, jgrid, jparams, jlut, jenv, inv_view, inv_proj, light) = jr._prime_operands(config)
    as_np = jax.tree_util.tree_map(np.asarray, (jgrid, jparams, jlut, jenv))
    grid, params, lut, env = from_jax_state(*as_np, device="cpu")
    tconfig = RenderConfig(width=W, height=H, bounces=1)
    t_ops = tuple(torch.from_numpy(np.array(a)) for a in (inv_view, inv_proj, light))
    j_acc = np.zeros((W * H, 3), np.float32)
    t_acc = torch.zeros((W * H, 3))
    for f in range(FRAMES):
        js = jax_render_sample(config, jgrid, jparams, jlut, jenv, inv_view, inv_proj, light, np.uint32(f))
        j_acc = jax_accumulate(j_acc, js, np.uint32(f))
        t_acc = accumulate_progressive(t_acc, render_sample(tconfig, grid, params, lut, env, *t_ops, f), f)
    _assert_contract(t_acc.numpy(), np.asarray(j_acc), 0.98)


def test_dense_decode_bit_equal():
    """The device decode gives the JAX package's bf16 field bit for bit."""
    grid = torch_construct(_volume())
    ours = device_grid_from_brick(grid, "cpu").dense
    theirs = np.asarray(jax_device_grid(grid).dense)
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(), theirs.view(np.int16))
    host = torch.from_numpy(jax_decode_dense(grid)).to(torch.bfloat16)
    assert torch.equal(ours.view(torch.int16), host.view(torch.int16))
    jgrid = jax.tree_util.tree_map(np.asarray, jax_device_grid(grid, dense=False))
    atlas = decode_dense_device(*(torch.from_numpy(np.array(a)) for a in
                                  (jgrid.atlas, jgrid.range_lo, jgrid.range_hi, jgrid.ptr)))
    assert torch.equal(atlas.view(torch.int16), ours.view(torch.int16))


def test_device_grid_carries_its_extent_on_the_host():
    """The grid's extent, which the legs read without a sync, is a tuple of
    host ints equal to the volume's index extent, whether the grid is built
    here or carried from the JAX package's state."""
    grid = torch_construct(_volume()[:, :30, :27])
    built = device_grid_from_brick(grid, "cpu")
    jgrid = jax.tree_util.tree_map(np.asarray, jax_device_grid(jax_construct(_volume()[:, :30, :27])))
    carried = from_jax_state(jgrid, *_jax_scene_state(), device="cpu")[0]
    for g in (built, carried):
        assert g.extent == tuple(grid.index_extent)
        assert all(type(v) is int for v in g.extent)


def _jax_scene_state():
    """(params, lut, env) of a JAX Renderer's scene, as numpy."""
    jr = JRenderer(width=8, height=8)
    jr.restart_from_grid(jax_construct(_volume()))
    _, _, params, lut, env, *_ = jr._prime_operands(jr._config())
    return jax.tree_util.tree_map(np.asarray, (params, lut, env))


@pytest.mark.parametrize("name", ["debug_hits", "gradient_shading", "warmup_low_res"])
def test_settings_render(name):
    """Each of these settings renders a finite frame through render_frame()
    and image()."""
    r = TRenderer(8, 8, device="cpu")
    r.restart_from_grid(torch_construct(_volume()))
    setattr(r.settings, name, True)
    for _ in range(7):  # past warmup_low_res's five preview frames
        fb = r.render_frame()
        img = r.image()
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert bool(torch.isfinite(fb).all()) and float(fb.mean()) > 0


def test_unported_modes_raise():
    """A render mode the port does not have raises; every render mode of
    the JAX package has its two legs."""
    for mode in ("default", "no_dda", "raymarch"):
        assert len(tmodes.get_mode_functions(mode)) == 2
    with pytest.raises(ValueError):
        tmodes.get_mode_functions("pathtrace")


@pytest.mark.parametrize("mode", ["raymarch", "no_dda"])
def test_restored_settings_render_in_their_mode(mode):
    """A settings export whose renderMode is raymarch or no_dda renders in
    that mode through render(), and exports the mode back."""
    settings = json.loads(FIXTURE.read_text())["sharedSettings"][0]
    settings["display"]["renderMode"] = mode
    r = TRenderer(8, 8, device="cpu")
    r.restart_from_grid(torch_construct(_volume()))
    r.restore_settings(settings)
    img = r.render(6)
    assert r.render_mode == mode and r._config().mode == mode
    assert img.shape == (6, 6, 3) and np.isfinite(img).all() and img.mean() > 0  # the export's 0.8 resolution
    assert r.export_settings()["display"]["renderMode"] == mode


def test_premul_majorant_built_for_default_mode_only(monkeypatch):
    """The DDA march's premultiplied pyramid is setup work of the default
    mode alone, as in the JAX package's render_pixels."""
    import volxel_tpu_torch.render.pathtrace as pathtrace

    built = []
    real = pathtrace.with_premul_majorant
    monkeypatch.setattr(pathtrace, "with_premul_majorant", lambda *a: built.append(a[0].mode) or real(*a))
    r = TRenderer(8, 8, device="cpu")
    r.restart_from_grid(torch_construct(_volume()))
    for mode in ("raymarch", "no_dda", "default"):
        r.render_mode = mode
        r.render_frame()
    assert built == ["default"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter renders 16x16 with the port on the CPU, in the
    default mode and then one frame each of raymarch and no_dda, imports the
    preview server, the CLI, every module of parallel/ and
    utils/stepstats.py, renders one step of a DistributedRenderer on a 2x2
    mesh of CPU positions, and never loads jax or volxel_tpu; every kernel
    launch counter stays 0."""
    code = """
import sys, json
import numpy as np
from volxel_tpu_torch import Renderer, kernels
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
vol = synthetic_ct_volume((32, 32, 32), bits_stored=12)
r = Renderer(16, 16, device="cpu")
r.restart_from_grid(construct_brick_grid(vol.astype(np.float32) / vol.max()))
img = r.render(8)
means = [float(img.mean())]
for mode in ("raymarch", "no_dda"):
    r.render_mode = mode
    fb = r.render_frame()
    means.append(float(fb.mean()) if bool(fb.isfinite().all()) else -1.0)
import volxel_tpu_torch.api.server, volxel_tpu_torch.__main__
import volxel_tpu_torch.parallel.mesh, volxel_tpu_torch.parallel.multihost, volxel_tpu_torch.parallel.shard
import volxel_tpu_torch.parallel.distributed, volxel_tpu_torch.parallel.multiview, volxel_tpu_torch.parallel.slab
import volxel_tpu_torch.utils.stepstats
from volxel_tpu_torch.parallel import make_mesh
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
d = DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=2, devices=["cpu"] * 4))
d.restart_from_grid(construct_brick_grid(vol.astype(np.float32) / vol.max()))
fb = d.render_frame()
means.append(float(fb.mean()) if bool(fb.isfinite().all()) and d.samples_rendered() == 2 else -1.0)
print(json.dumps({"jax": "jax" in sys.modules, "volxel_tpu": "volxel_tpu" in sys.modules,
                  "launches": kernels.LAUNCHES, "finite": bool(np.isfinite(img).all()), "means": means}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] is False and res["volxel_tpu"] is False
    assert all(v == 0 for v in res["launches"].values())
    assert res["finite"] and all(m > 0 for m in res["means"])


def test_renderer_device_defaults_to_the_card():
    """A Renderer made without a device is made for the card ("cuda"); the
    card test of tests/test_torch_cuda.py renders through it."""
    import inspect

    assert inspect.signature(TRenderer.__init__).parameters["device"].default == "cuda"


def test_renderer_on_the_cpu_when_asked():
    """A caller that asks for the CPU gets a renderer whose tensors lie on
    the CPU and that renders 16x16 through the plain versions, launching no
    kernel."""
    kernels.reset_launch_counts()
    r = TRenderer(16, 16, device="cpu")
    r.restart_from_grid(torch_construct(_volume(), transform=np.eye(4, dtype=np.float32)))
    img = r.render(6)
    assert r.device.type == "cpu" and r._framebuffer.device.type == "cpu"
    assert r.environment.state.imp_mips[0].device.type == "cpu"
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and float(img.mean()) > 0
    assert all(v == 0 for v in kernels.LAUNCHES.values())
