"""The port's parallel/ package on the CPU, against the JAX package's on its
8 virtual CPU devices (tests/conftest.py).

The port's meshes here are positions that all name the CPU, which run one
after another in this process, as the JAX tests' virtual devices do.
Tolerances: within the port everything is bit for bit (a sharded step is
the same sum, in position order, of the same single-position samples; a
batch of views is the same rays' samples, each lane seeded by its own
view's frame); against the JAX package the framebuffers meet
tests/test_torch_render.py's contract (> 98% of pixels within 0.1%, median
relative error < 1e-4, means within 0.5%) and images its atol of 2e-2,
because XLA and ATen round some transcendentals an ulp apart
(ROADMAP.md §3); brick ranges equal JAX's exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu import Renderer as JRenderer
from volxel_tpu.api.timeseries import TimeSeriesPlayer as JTimeSeriesPlayer
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.parallel import make_mesh as jax_make_mesh
from volxel_tpu.parallel import render_sample_sharded as jax_render_sample_sharded
from volxel_tpu.parallel.distributed import DistributedRenderer as JDistributedRenderer
from volxel_tpu.parallel.multiview import render_views as jax_render_views
from volxel_tpu.parallel.multiview import sharded_multiview_fn as jax_sharded_multiview_fn
from volxel_tpu.parallel.slab import brick_ranges_sharded as jax_brick_ranges_sharded
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.__main__ import main
from volxel_tpu_torch.api.server import PreviewServer
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.grid.brick import _dilated_brick_minmax
from volxel_tpu_torch.parallel import make_mesh, render_sample_sharded, sharded_render_fn
from volxel_tpu_torch.parallel import shard
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.parallel.multiview import render_views, sharded_multiview_fn
from volxel_tpu_torch.parallel.slab import HALO, _halo_exchange_z, brick_ranges_sharded
from volxel_tpu_torch.render import modes
from volxel_tpu_torch.render import pathtrace
from volxel_tpu_torch.render.pathtrace import WARMUP_SAMPLES, render_sample

from .test_torch_render import _assert_contract
from .torch_mesh import replayed_framebuffer, step_mean

CPU8 = ["cpu"] * 8
EYE = np.eye(4, dtype=np.float32)


def _volume(shape=(24, 24, 24)):
    vol = synthetic_ct_volume(shape, bits_stored=12)
    return vol.astype(np.float32) / vol.max()


def _setup(r, data, mode="default", bounces=2):
    """The scene of tests/test_parallel.py and tests/test_distributed.py."""
    r.restart_from_grid((jax_construct if isinstance(r, JRenderer) else construct_brick_grid)(data, transform=EYE))
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.render_mode = mode
    r.settings.bounces = bounces
    return r


def _operands(r):
    config = r._config()
    inv_view, inv_proj, light = r._camera_operands(config)
    return config, (r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light)


def _jax_operands(r):
    config = r._config()
    inv_view = jnp.asarray(np.linalg.inv(r.camera.view_matrix()).astype(np.float32))
    inv_proj = jnp.asarray(np.linalg.inv(r.camera.proj_matrix(config.width / config.height)).astype(np.float32))
    light = jnp.asarray(r.settings.light_dir, jnp.float32)
    return config, (r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bits_equal(a, b):
    assert torch.equal(_bits(a), _bits(b)), f"max abs diff {float((a - b).abs().max())}"


# -- mesh ----------------------------------------------------------------------


def test_mesh_construction(monkeypatch):
    mesh = make_mesh(sp=2, px=4, devices=CPU8)
    assert mesh.shape == {"sp": 2, "px": 4} == dict(jax_make_mesh(sp=2, px=4).shape)
    assert mesh.axis_names == ("sp", "px") and mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat) and mesh.local_positions() == mesh.positions()
    assert make_mesh(sp=2, devices=CPU8).shape == {"sp": 2, "px": 4}  # px defaults to the rest
    three = make_mesh(sp=2, px=2, vz=2, devices=CPU8)
    assert three.shape == {"sp": 2, "px": 2, "vz": 2} and three.axis_names == ("sp", "px", "vz")
    owned = make_mesh(sp=2, px=1, devices=[(0, "cpu"), (1, "cpu")])
    assert owned.processes.tolist() == [[0], [1]] and owned.local_positions() == [(0, 0)]
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        make_mesh(sp=3, px=3, devices=CPU8)
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        jax_make_mesh(sp=3, px=3)
    # no card and no positions named: an error, never the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(sp=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedRenderer(16, 16, sp=2)


# -- sample and pixel sharding -----------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    data = _volume()
    port = {mode: _setup(Renderer(16, 16, device="cpu"), data, mode) for mode in ("default", "raymarch", "no_dda")}
    return data, port, _setup(JRenderer(width=16, height=16), data)


@pytest.mark.parametrize("sp,px", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_single_position_samples(scenes, sp, px):
    """Bit-equal to the ordered sum of single-position render_sample
    calls / sp, on the mesh's first device; JAX's sharded step on its 8
    devices at the contract."""
    _, port, jr = scenes
    config, ops = _operands(port["default"])
    mesh = make_mesh(sp=sp, px=px, devices=CPU8)
    out = render_sample_sharded(config, mesh, *ops, 1)
    assert out.shape == (256, 3) and out.device == torch.device("cpu")
    _assert_bits_equal(out, step_mean((config, *ops), 1, sp))
    jconfig, jops = _jax_operands(jr)
    theirs = jax_render_sample_sharded(jconfig, jax_make_mesh(sp=sp, px=px), *jops, jnp.uint32(1))
    _assert_contract(out.numpy(), np.asarray(theirs), 0.98)


@pytest.mark.parametrize("mode", ["raymarch", "no_dda"])
def test_sharded_matches_single_position_samples_other_modes(scenes, mode):
    _, port, _ = scenes
    config, ops = _operands(port[mode])
    out = render_sample_sharded(config, make_mesh(sp=2, px=4, devices=CPU8), *ops, 0)
    _assert_bits_equal(out, step_mean((config, *ops), 0, 2))


def test_indivisible_pixel_count_rejected(scenes):
    _, port, _ = scenes
    config, ops = _operands(port["default"])
    config = config._replace(width=15, height=15)  # 225 not divisible by 8
    with pytest.raises(ValueError, match="not divisible"):
        render_sample_sharded(config, make_mesh(sp=1, px=8, devices=CPU8), *ops, 0)


def test_vz_axis_runs_the_three_entry_points(scenes):
    """On an sp=1, px=4, vz=2 mesh: sharded_render_fn with the replicated
    grid is bit-equal to sample 0 (each position renders half of its
    block), sharded_multiview_fn to render_views, and
    DistributedRenderer.restart_from_grid loads z-slabs whose step is
    bit-equal to the (1, 4) mesh's."""
    data, port, _ = scenes
    config, ops = _operands(port["default"])
    mesh = make_mesh(sp=1, px=4, vz=2, devices=CPU8)
    _assert_bits_equal(sharded_render_fn(config, mesh)(*ops, 0), step_mean((config, *ops), 0, 1))
    r = port["default"]
    cams = [r._camera_operands(config) for _ in range(2)]
    view_ops = (*ops[:4], torch.stack([c[0] for c in cams]), torch.stack([c[1] for c in cams]), ops[6])
    _assert_bits_equal(sharded_multiview_fn(config, mesh, 2)(*view_ops, 1), render_views(config, *view_ops, 1))
    slab = DistributedRenderer(16, 16, mesh=mesh)
    slab.restart_from_grid(construct_brick_grid(data, transform=EYE))
    flat = DistributedRenderer(16, 16, mesh=make_mesh(sp=1, px=4, devices=CPU8[:4]))
    flat.restart_from_grid(construct_brick_grid(data, transform=EYE))
    assert slab._slabbed is not None and slab._device_grid.dense is None
    _assert_bits_equal(slab.render_frame(), flat.render_frame())


def test_operands_copied_once_per_card_and_pyramid_built_once_per_step(monkeypatch, scenes):
    """A DistributedRenderer's 2x2 mesh on one device: the operands are
    placed on the card at the first step and again only after a restart,
    and a second renderer on an equal mesh does not replace them; each
    step builds the default mode's premultiplied pyramid once on the card,
    and no position builds its own."""
    data = scenes[0]
    builds = {"step": 0, "position": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            builds[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(shard, "with_premul_majorant", counted("step", shard.with_premul_majorant))
    monkeypatch.setattr(pathtrace, "with_premul_majorant", counted("position", pathtrace.with_premul_majorant))
    r = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=2, devices=["cpu"] * 4)), data)
    cpu = torch.device("cpu")
    r.render_frame()
    cards = r._cards
    first = cards._copies[cpu]
    assert first[0].dense is r._device_grid.dense and list(cards._copies) == [cpu]
    r.render_frame()
    assert cards._copies[cpu] is first and builds == {"step": 2, "position": 0}
    r.settings.density_multiplier = 1.5
    r.restart_rendering()
    r.render_frame()
    again = r._cards._copies[cpu]
    assert again is not first and builds == {"step": 3, "position": 0}
    # a second renderer on an equal mesh keeps copies of its own
    other = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=2, devices=["cpu"] * 4)), data)
    other.render_frame()
    r.render_frame()
    assert other._cards is not r._cards and r._cards._copies[cpu] is again


# -- DistributedRenderer -------------------------------------------------------------


def test_distributed_matches_single_position_mean(scenes):
    """sp=4, px=2: three steps are samples 0..11, bit-equal to the update
    replayed over single-position samples and within f32 rounding of
    their plain mean; JAX's DistributedRenderer at the contract."""
    data = scenes[0]
    dist = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=4, px=2, devices=CPU8)), data)
    assert dist.device == torch.device("cpu")
    for _ in range(3):
        dist.render_frame()
    assert dist.samples_rendered() == 12
    config, ops = _operands(dist)
    _assert_bits_equal(dist._framebuffer, replayed_framebuffer(dist, 3))
    mean = torch.stack([render_sample(config, *ops, i) for i in range(12)]).mean(0)
    np.testing.assert_allclose(dist._framebuffer.numpy(), mean.numpy(), atol=1e-6, rtol=1e-5)
    jdist = _setup(JDistributedRenderer(width=16, height=16, sp=4, px=2), data)
    for _ in range(3):
        jdist.render_frame()
    _assert_contract(dist._framebuffer.numpy(), np.asarray(jdist._framebuffer), 0.98)
    np.testing.assert_allclose(dist.image(), jdist.image(), rtol=0, atol=2e-2)


def test_distributed_image_and_settings(scenes):
    data = scenes[0]
    dist = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=4, devices=CPU8)), data)
    dist.render_frame()
    img = dist.image()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    jdist = _setup(JDistributedRenderer(width=16, height=16, sp=2, px=4), data)
    assert dist.export_settings() == jdist.export_settings()
    assert dist.export_settings()["version"] == "v3"


@pytest.mark.parametrize("samples,steps", [(8, 2), (7, 2), (4, 1)])
def test_distributed_render_steps(scenes, samples, steps):
    """render(samples) takes ceil(samples / sp) steps, as JAX's does."""
    data = scenes[0]
    dist = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=4, px=2, devices=CPU8)), data)
    img = dist.render(samples=samples)
    assert dist.frame_index == steps and dist.samples_rendered() == 4 * steps
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_distributed_warmup_divergence_pinned(scenes):
    """The documented divergence of tests/test_distributed.py, in the port:
    the single-card renderer's accumulator is the mean of samples [5, N)
    (zero-weight warm-up), the DistributedRenderer's the mean of [0, N);
    warmup_low_res renders no low-res preview on the mesh."""
    data = scenes[0]
    n = 8
    dist = _setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=4, devices=CPU8)), data)
    dist.settings.warmup_low_res = True
    single = _setup(Renderer(16, 16, device="cpu"), data)
    for _ in range(n // 2):
        dist.render_frame()
    for _ in range(n):
        single.render_frame()
    assert dist._warmup_preview is None
    config, ops = _operands(single)
    samples = torch.stack([render_sample(config, *ops, i) for i in range(n)])
    np.testing.assert_allclose(dist._framebuffer.numpy(), samples.mean(0).numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(single._framebuffer.numpy(), samples[WARMUP_SAMPLES:].mean(0).numpy(), atol=1e-6,
                               rtol=1e-5)
    assert not torch.equal(dist._framebuffer, single._framebuffer)


def test_timeseries_over_distributed_mesh():
    """tests/test_config45.py's 4D playback over a DistributedRenderer, at
    vz = 1: per timestep the mesh player's framebuffer is the update
    replayed over single-position samples of that timestep's grid, the
    timesteps differ, eviction keeps playback working, and the images
    meet JAX's mesh player's at atol 2e-2."""
    base = synthetic_ct_volume((24, 16, 16), bits_stored=12).astype(np.float32) / 4095.0
    vols = np.stack([base * (1.0 - 0.3 * t) for t in range(3)])

    def setup(r):
        r.restart_from_grid((jax_construct if isinstance(r, JRenderer) else construct_brick_grid)(vols[0]))
        r.camera.rotate_around_view(0.4, 0.2)
        r.camera.zoom(2.0)
        r.settings.bounces = 1
        return r

    dist = setup(DistributedRenderer(16, 16, mesh=make_mesh(sp=2, px=2, devices=["cpu"] * 4)))
    player = TimeSeriesPlayer(dist, vols)
    frames = list(player.play(samples_per_step=2))
    assert [t for t, _ in frames] == [0, 1, 2]
    for t in range(3):
        player.set_timestep(t)
        dist.render_frame()
        dist.render_frame()
        _assert_bits_equal(dist._framebuffer, replayed_framebuffer(dist, 2))
        np.testing.assert_array_equal(dist.image(), frames[t][1])
    assert not np.allclose(frames[0][1], frames[2][1])
    player.evict(0)
    assert 0 not in player._device_cache
    player.set_timestep(0)
    dist.render_frame()

    jdist = setup(JDistributedRenderer(width=16, height=16, mesh=jax_make_mesh(sp=2, px=2, devices=jax.devices()[:4])))
    jframes = list(JTimeSeriesPlayer(jdist, vols).play(samples_per_step=2))
    for (t, ours), (_, theirs) in zip(frames, jframes):
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-2, err_msg=f"timestep {t}")


def test_serve_mesh_serves_from_a_distributed_renderer(monkeypatch):
    """`serve --mesh 2,2,1 --device cpu` puts every position on the CPU and
    hands the server a DistributedRenderer, whose steps count sp samples."""
    served = []
    monkeypatch.setattr(PreviewServer, "serve_forever", lambda self: served.append(self))
    main(["serve", "--device", "cpu", "--synthetic", "16", "--size", "16x16", "--mesh", "2,2,1"])
    (server,) = served
    r = server.renderer
    assert isinstance(r, DistributedRenderer) and r.mesh.shape == {"sp": 2, "px": 2}
    assert r.device == torch.device("cpu")
    r.settings.max_samples = 4
    assert server.step() == "frame" and server.step() == "frame" and server.step() == "idle"
    assert r.samples_rendered() == 4


# -- multi-view -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def views():
    """tests/test_config45.py's four views of one 32x32 scene, both packages."""
    data = _volume()
    rs = [Renderer(32, 32, device="cpu"), JRenderer(width=32, height=32)]
    cams = [[], []]
    for r, cam in zip(rs, cams):
        r.restart_from_grid((jax_construct if isinstance(r, JRenderer) else construct_brick_grid)(data, transform=EYE))
        r.camera.rotate_around_view(0.5, 0.3)
        r.camera.zoom(2.0)
        for _ in range(4):
            r.camera.rotate_around_view(0.3, 0.0)
            cam.append((np.linalg.inv(r.camera.view_matrix()).astype(np.float32),
                        np.linalg.inv(r.camera.proj_matrix(1.0)).astype(np.float32)))
    return rs, cams


def _view_operands(r, cams):
    inv_views = torch.from_numpy(np.stack([c[0] for c in cams]))
    inv_projs = torch.from_numpy(np.stack([c[1] for c in cams]))
    light = r._to_device(r.settings.light_dir)
    return (r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_views, inv_projs, light)


@pytest.mark.parametrize("mode", ["default", "raymarch", "no_dda"])
def test_render_views_matches_sequential(monkeypatch, views, mode):
    """One wavefront (each leg called once at bounces 1) bit-equal to V
    single renders at frame * V + view, the views distinct; JAX's vmap at
    the contract."""
    (r, jr), (cams, jcams) = views
    r.render_mode = jr.render_mode = mode
    r.settings.bounces = jr.settings.bounces = 1
    config = r._config()
    ops = _view_operands(r, cams)
    legs = {"default": "dda_leg_sample", "raymarch": "tile_march_sample", "no_dda": "track_leg_sample"}[mode]
    calls = []
    original = getattr(modes, legs)

    def counted(*args):  # the lanes of each call: its first (n, 3) operand, ipos
        calls.append(next(a.shape[0] for a in args if isinstance(a, torch.Tensor) and a.shape[1:] == (3,)))
        return original(*args)

    monkeypatch.setattr(modes, legs, counted)
    batched = render_views(config, *ops, 2)
    assert batched.shape == (4, 32 * 32, 3) and calls == [4 * 32 * 32]
    for v in range(4):
        _assert_bits_equal(batched[v], render_sample(config, ops[0], ops[1], ops[2], ops[3], ops[4][v], ops[5][v],
                                                     ops[6], 2 * 4 + v))
    assert not torch.equal(batched[0], batched[1])
    jops = (jr._device_grid, jr.volume_params(), jr._lut, jr.environment.state,
            jnp.asarray(np.stack([c[0] for c in jcams])), jnp.asarray(np.stack([c[1] for c in jcams])),
            jnp.asarray(jr.settings.light_dir, jnp.float32))
    theirs = np.asarray(jax_render_views(jr._config(), *jops, jnp.uint32(2)))
    for v in range(4):
        _assert_contract(batched[v].numpy(), theirs[v], 0.98)


@pytest.mark.parametrize("sp,px", [(2, 4), (4, 2), (1, 8)])
def test_sharded_multiview_matches_render_views(views, sp, px):
    """Bit-equal to render_views; JAX's sharded_multiview_fn on its 8
    devices at the contract, view by view."""
    (r, jr), (cams, jcams) = views
    r.render_mode = jr.render_mode = "default"
    r.settings.bounces = jr.settings.bounces = 2
    config = r._config()
    ops = _view_operands(r, cams)
    fn = sharded_multiview_fn(config, make_mesh(sp=sp, px=px, devices=CPU8), 4)
    ours = fn(*ops, 3)
    _assert_bits_equal(ours, render_views(config, *ops, 3))
    jops = (jr._device_grid, jr.volume_params(), jr._lut, jr.environment.state,
            jnp.asarray(np.stack([c[0] for c in jcams])), jnp.asarray(np.stack([c[1] for c in jcams])),
            jnp.asarray(jr.settings.light_dir, jnp.float32))
    theirs = np.asarray(jax_sharded_multiview_fn(jr._config(), jax_make_mesh(sp=sp, px=px), 4)(*jops, jnp.uint32(3)))
    for v in range(4):
        _assert_contract(ours[v].numpy(), theirs[v], 0.98)
    with pytest.raises(ValueError, match="must divide"):
        sharded_multiview_fn(config, make_mesh(sp=8, px=1, devices=CPU8), 4)


# -- sharded brick ranges ----------------------------------------------------------


@pytest.mark.parametrize("sp,px,axis", [(1, 8, "px"), (2, 4, "sp"), (4, 2, "px")])
def test_brick_ranges_sharded_matches_host_and_jax(sp, px, axis):
    vol = _volume((20, 24, 28))
    lo, hi, (bx, by, bz) = brick_ranges_sharded(vol, make_mesh(sp=sp, px=px, devices=CPU8), axis=axis)
    assert lo.shape == hi.shape == (bz, by, bx) and lo.dtype == np.float32
    full = np.zeros((bz * 8, by * 8, bx * 8), np.float32)
    full[:20, :24, :28] = vol
    exp_lo, exp_hi = _dilated_brick_minmax(np.pad(full, 2))
    np.testing.assert_array_equal(lo, exp_lo)
    np.testing.assert_array_equal(hi, exp_hi)
    jlo, jhi, jcount = jax_brick_ranges_sharded(vol, jax_make_mesh(sp=sp, px=px), axis=axis)
    assert jcount == (bx, by, bz)
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    np.testing.assert_array_equal(hi, np.asarray(jhi))


def test_halo_exchange_between_local_slabs():
    """Each slab gets its neighbours' boundary slices, the ends zeros."""
    slabs = {i: torch.full((4, 3, 2), float(i + 1)) for i in range(3)}
    out = _halo_exchange_z(slabs, [0, 0, 0])
    assert [tuple(t.shape) for t in out.values()] == [(4 + 2 * HALO, 3, 2)] * 3
    assert out[0][:HALO].eq(0).all() and out[2][-HALO:].eq(0).all()
    assert out[1][:HALO].eq(1).all() and out[1][-HALO:].eq(3).all() and out[1][HALO:-HALO].eq(2).all()
    assert out[0][-HALO:].eq(2).all() and out[2][:HALO].eq(2).all()
