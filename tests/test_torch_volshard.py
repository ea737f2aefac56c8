"""Render-time volume slabs in the port (parallel/volshard.py, SlabGrid) on
the CPU, held to the replicated field and to the JAX package.

The port's cases of tests/test_volshard.py and of
tests/test_config45.py::test_timeseries_over_distributed_mesh, on meshes
whose positions all name the CPU. Within the port everything is bit for
bit: a vz mesh renders the same pixels at the same samples as the vz = 1
mesh, each tap read from the slab that owns it, whose halo holds the
stencil. Against the JAX package: the slab lookups meet JAX's
_slab_density_int exactly and _slab_density_trilinear within 1e-6
(XLA contracts the weights' products into FMAs), and the vz = 4 frames
meet JAX's DistributedRenderer(vz=4) images at atol 2e-2, as
tests/test_torch_parallel.py's mesh tests do (ROADMAP.md §3). bf16 taps
drift from f32 ones by JAX's own bound (max < 0.1, mean < 5e-3).
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.grid import construct_brick_grid as jax_construct
from volxel_tpu.parallel.distributed import DistributedRenderer as JDistributedRenderer
from volxel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from volxel_tpu.parallel.volshard import build_slabbed_volume as jax_build_slabbed_volume
from volxel_tpu.render.sampling import _slab_density_int as jax_slab_density_int
from volxel_tpu.render.sampling import _slab_density_trilinear as jax_slab_density_trilinear
from volxel_tpu.render.sampling import decode_dense_brick_rows as jax_decode_dense_brick_rows
from volxel_tpu.render.sampling import device_grid_from_brick as jax_device_grid
from volxel_tpu.utils.fixtures import synthetic_ct_volume
from volxel_tpu_torch import Renderer
from volxel_tpu_torch.api.server import PreviewServer
from volxel_tpu_torch.api.timeseries import TimeSeriesPlayer
from volxel_tpu_torch.grid import construct_brick_grid
from volxel_tpu_torch.parallel import make_mesh, multihost, render_sample_sharded
from volxel_tpu_torch.parallel.distributed import DistributedRenderer
from volxel_tpu_torch.parallel.mesh import Mesh
from volxel_tpu_torch.parallel.volshard import (
    SlabbedVolume,
    build_slabbed_volume,
    build_slabbed_volume_from_brick,
)
from volxel_tpu_torch.render import sampling
from volxel_tpu_torch.render.pathtrace import render_sample
from volxel_tpu_torch.render.sampling import (
    SLAB_HALO,
    SlabGrid,
    decode_dense_device,
    decode_dense_rows_device,
    device_grid_from_brick,
    lookup_density_brick_int,
    trilinear_sum,
)

EYE = np.eye(4, dtype=np.float32)
CPU = torch.device("cpu")


def _data(shape=(24, 16, 16)):
    vol = synthetic_ct_volume(shape, bits_stored=12)
    return vol.astype(np.float32) / vol.max()


@pytest.fixture(scope="module")
def grid():
    return construct_brick_grid(_data(), transform=EYE)


def _setup(r, grid, mode="default", bounces=2):
    """The scene of tests/test_volshard.py."""
    r.restart_from_grid(grid)
    r.camera.rotate_around_view(0.4, 0.2)
    r.camera.zoom(2.0)
    r.settings.bounces = bounces
    r.render_mode = mode
    return r


def _mesh(sp=1, px=2, vz=1):
    return make_mesh(sp=sp, px=px, vz=vz, devices=["cpu"] * (sp * px * vz))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bits_equal(a, b):
    assert torch.equal(_bits(a), _bits(b)), f"max abs diff {float((a - b).abs().max())}"


def _pair(grid, mode, sp=1, px=2, vz=4, **kwargs):
    """(the vz = 1 renderer, the vz one), the same scene."""
    rep = _setup(DistributedRenderer(16, 16, mesh=_mesh(sp, px)), grid, mode)
    slab = _setup(DistributedRenderer(16, 16, mesh=_mesh(sp, px, vz), **kwargs), grid, mode)
    return rep, slab


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_slab_render_bit_identical(grid, mode):
    rep, slab = _pair(grid, mode)
    assert isinstance(slab._render_grid(), SlabbedVolume) and slab._device_grid.dense is None
    for _ in range(2):
        a, b = rep.render_frame(), slab.render_frame()
    _assert_bits_equal(b, a)
    assert float(a.max()) > 0


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_slab_gradient_shading_bit_identical(grid, mode):
    """Gradient shading reads the density's gradient through the plain slab
    lookups (each slab gathers the taps it owns): bit-equal to vz = 1."""
    rep, slab = _pair(grid, mode)
    for r in (rep, slab):
        r.settings.gradient_shading = True
    a, b = rep.render_frame(), slab.render_frame()
    _assert_bits_equal(b, a)
    assert float(a.max()) > 0


def test_slab_render_with_sp_axis(grid):
    """sp x px x vz all at once."""
    rep, slab = _pair(grid, "default", sp=2, px=2, vz=2)
    _assert_bits_equal(slab.render_frame(), rep.render_frame())


def test_slab_nondividing_z():
    """z = 40 over vz = 4: 40 slices brick-padded to 64, slabs of 16."""
    g = construct_brick_grid(_data((40, 16, 16)), transform=EYE)
    rep, slab = _pair(g, "default")
    assert slab._slabbed.slab == 16
    _assert_bits_equal(slab.render_frame(), rep.render_frame())


def test_slabbed_volume_memory_split(grid):
    """Each slab is (ceil(Z / vz) + 2 * SLAB_HALO, Y, X), a CPU named by
    every position holds each slab once, and the metadata holds nothing
    volume-sized."""
    dg = device_grid_from_brick(grid, CPU)
    z, y, x = dg.dense.shape
    for sv in (build_slabbed_volume(dg, _mesh(vz=4)), build_slabbed_volume_from_brick(grid, _mesh(vz=4))):
        slab = -(-z // 4)
        assert sv.slab == slab and sorted(v for _, v in sv.slabs) == [0, 1, 2, 3]
        assert all(s.shape == (slab + 2 * SLAB_HALO, y, x) and s.dtype == torch.bfloat16 for s in sv.slabs.values())
        assert sv.meta.dense is None
        sizes = [t.numel() for t in sv.meta if isinstance(t, torch.Tensor)]
        assert max(sizes) * 8 <= dg.dense.numel()  # the pyramid: one value a brick and level


def test_a_device_named_by_several_rows_holds_each_slab_once(grid):
    """On an sp = 2, vz = 2 mesh whose positions all name the CPU, both
    rows read the same two slabs (positions on distinct cards hold copies
    of their own: tests/test_torch_cuda.py::test_slabs_over_two_cards)."""
    dg = device_grid_from_brick(grid, CPU)
    mesh = _mesh(sp=2, px=1, vz=2)
    sv = build_slabbed_volume(dg, mesh)
    assert len(sv.slabs) == 2  # one CPU: each slab once for both rows
    g0, g1 = sv.local_grid((0, 0, 1)), sv.local_grid((1, 0, 0))
    assert all(a is b for a, b in zip(g0.slabs, g1.slabs))


def test_slab_from_brick_bit_identical_blocks(grid):
    """Slabs decoded from the brick grid's rows are bit-equal to slabs cut
    from the decoded field, and the pyramids equal."""
    mesh = _mesh(vz=4)
    via_dense = build_slabbed_volume(device_grid_from_brick(grid, CPU), mesh)
    via_brick = build_slabbed_volume_from_brick(grid, mesh)
    assert via_dense.slabs.keys() == via_brick.slabs.keys()
    for key, s in via_dense.slabs.items():
        assert torch.equal(s.view(torch.int16), via_brick.slabs[key].view(torch.int16)), key
    assert torch.equal(via_dense.meta.maj_mips, via_brick.meta.maj_mips)
    assert via_dense.meta.extent == via_brick.meta.extent


def test_capacity_load_path_no_full_field(grid, monkeypatch):
    """With every whole-field decode disabled, a vz = 4 renderer still
    loads (per-slab decodes only), each slab smaller than the whole field,
    and renders bit-equal to the replicated renderer."""
    import volxel_tpu_torch.api.renderer as renderer_module

    rep = _setup(DistributedRenderer(16, 16, mesh=_mesh()), grid)
    a = rep.render_frame()

    def boom(*args, **kwargs):
        raise AssertionError("the whole dense field was decoded")

    monkeypatch.setattr(sampling, "decode_dense_device", boom)
    monkeypatch.setattr(sampling, "device_grid_from_brick", boom)
    monkeypatch.setattr(renderer_module, "device_grid_from_brick", boom)
    slab = _setup(DistributedRenderer(16, 16, mesh=_mesh(vz=4)), grid)
    _assert_bits_equal(slab.render_frame(), a)
    whole = int(np.prod([d * 8 for d in grid.brick_count])) * 2
    assert all(s.numel() * 2 < whole for s in slab._slabbed.slabs.values())


def test_decoded_rows_equal_the_whole_decode(grid):
    """decode_dense_rows_device equals those rows of decode_dense_device's
    field and the JAX package's decode_dense_brick_rows of the same rows in
    bf16, bit for bit."""
    whole = device_grid_from_brick(grid, CPU).dense
    bz = grid.brick_count[2]
    for b0, b1 in ((0, bz), (1, 2), (2, 2), (0, 1)):
        dev = decode_dense_rows_device(grid, b0, b1, CPU)
        assert torch.equal(dev.view(torch.int16), whole[b0 * 8:b1 * 8].view(torch.int16))
        jax_rows = torch.from_numpy(np.asarray(jax_decode_dense_brick_rows(grid, b0, b1))).to(torch.bfloat16)
        assert torch.equal(dev.view(torch.int16), jax_rows.view(torch.int16))
    assert torch.equal(decode_dense_device(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        grid.atlas, grid.range_lo, grid.range_hi, grid.indirection))).view(torch.int16), whole.view(torch.int16))


def test_slab_custom_axis_name(grid):
    """A SlabbedVolume built on an axis named 'vol' renders through
    render_sample_sharded bit-equal to a single render_sample."""
    r = _setup(Renderer(16, 16, device="cpu"), grid)
    r.render_frame()
    config = r._config()
    inv_view, inv_proj, light = r._camera_operands(config)
    ops = (r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light)
    devices = np.empty(8, dtype=object)
    devices[:] = [CPU] * 8
    mesh = Mesh(devices.reshape(1, 2, 4), np.zeros((1, 2, 4), np.int64), ("sp", "px", "vol"))
    sv = build_slabbed_volume(r._device_grid, mesh, axis="vol")
    assert sv.axis == "vol" and isinstance(sv.local_grid((0, 1, 3)), SlabGrid)
    out = render_sample_sharded(config, mesh, sv, *ops, 0)
    _assert_bits_equal(out, render_sample(config, r._device_grid, *ops, 0))


def test_slab_step_copies_no_field(grid, monkeypatch):
    """After the load, a step neither exchanges nor copies any slab: no
    multihost.exchange and no .to() of a slab (what the JAX package's
    collective budget pins: one all-reduce per traversal loop, no field
    traffic)."""
    slab = _setup(DistributedRenderer(16, 16, mesh=_mesh(sp=2, px=1, vz=2)), grid)
    slab.render_frame()
    storages = {s.untyped_storage().data_ptr() for s in slab._slabbed.slabs.values()}
    moved, exchanged = [], []
    to = torch.Tensor.to

    def counted_to(self, *args, **kwargs):
        if self.untyped_storage().data_ptr() in storages:
            moved.append(tuple(self.shape))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", counted_to)
    monkeypatch.setattr(multihost, "exchange", lambda *a, **k: exchanged.append(a))
    for mode in ("default", "no_dda", "raymarch"):
        slab.render_mode = mode
        slab.render_frame()
    assert moved == [] and exchanged == []


def test_slab_bf16_tap_payload(grid):
    """vz_tap_dtype="bfloat16" rounds each trilinear sum to bf16: the
    frames differ from the f32 taps' by at most JAX's drift bound."""
    images = {}
    for dtype in ("float32", "bfloat16"):
        r = _setup(DistributedRenderer(16, 16, mesh=_mesh(vz=4), vz_tap_dtype=dtype), grid, bounces=1)
        assert r._render_grid().tap_dtype == dtype
        images[dtype] = r.render_frame().numpy()
    diff = np.abs(images["bfloat16"] - images["float32"])
    assert np.isfinite(images["bfloat16"]).all()
    assert diff.max() < 0.1 and diff.mean() < 5e-3


def test_bf16_taps_round_the_trilinear_sum(grid):
    """On the same points a bf16 SlabGrid's trilinear sums are the f32
    ones rounded to bf16; integer taps are the same."""
    sv = build_slabbed_volume(device_grid_from_brick(grid, CPU), _mesh(vz=4))
    f32 = sv.local_grid()
    bf16 = f32._replace(tap_dtype="bfloat16")
    pos = torch.from_numpy(np.random.default_rng(3).uniform(-2, 26, (4096, 3)).astype(np.float32))
    assert torch.equal(trilinear_sum(bf16, pos), trilinear_sum(f32, pos).to(torch.bfloat16).float())
    ip = torch.floor(pos).to(torch.int32)
    assert torch.equal(lookup_density_brick_int(bf16, ip), lookup_density_brick_int(f32, ip))


def test_timeseries_vz2_bit_equal_per_timestep():
    """tests/test_config45.py's playback over sp x px x vz = 2x2x2: each
    timestep's frames bit-equal to the vz = 1 player's (the slabs rebuilt
    at each timestep swap), the timesteps differ, eviction keeps playback
    working."""
    base = synthetic_ct_volume((24, 16, 16), bits_stored=12).astype(np.float32) / 4095.0
    vols = np.stack([base * (1.0 - 0.3 * t) for t in range(3)])

    def setup(r):
        r.restart_from_grid(construct_brick_grid(vols[0]))
        r.camera.rotate_around_view(0.4, 0.2)
        r.camera.zoom(2.0)
        r.settings.bounces = 1
        return r

    rep = setup(DistributedRenderer(16, 16, mesh=_mesh(sp=2, px=2)))
    slab = setup(DistributedRenderer(16, 16, mesh=_mesh(sp=2, px=2, vz=2)))
    rep_frames = list(TimeSeriesPlayer(rep, vols).play(samples_per_step=2))
    player = TimeSeriesPlayer(slab, vols)
    slab_frames = list(player.play(samples_per_step=2))
    for (t0, a), (t1, b) in zip(rep_frames, slab_frames):
        assert t0 == t1
        np.testing.assert_array_equal(b, a, err_msg=f"timestep {t0}")
    assert not np.allclose(slab_frames[0][1], slab_frames[2][1])
    player.evict(0)
    assert 0 not in player._device_cache
    player.set_timestep(0)
    slab.render_frame()


def test_slabbed_renderer_has_no_preview(grid):
    """The shear-warp previews need the whole field: a slabbed renderer
    raises a RuntimeError, as the JAX package's does."""
    slab = _setup(DistributedRenderer(16, 16, mesh=_mesh(vz=2)), grid)
    with pytest.raises(RuntimeError, match="dense volume"):
        slab.render_preview()
    with pytest.raises(RuntimeError, match="dense volume"):
        slab.render_dvr()


def test_slabbed_server_fallback_histogram():
    """A slabbed renderer's server builds the fallback histogram from the
    brick grid, eight brick rows at a time (here two chunks, the last one
    short), equal to a vz = 1 renderer's server's from its dense field."""
    grid = construct_brick_grid(_data((88, 16, 16)), transform=EYE)
    hists = []
    for vz in (1, 2):
        r = DistributedRenderer(16, 16, mesh=_mesh(px=1, vz=vz))
        r.restart_from_grid(grid)
        hists.append(PreviewServer(r, port=0)._fallback_histogram())
    assert hists[1][0].sum() == int(np.prod([d * 8 for d in grid.brick_count]))
    for a, b in zip(*hists):
        np.testing.assert_array_equal(b, a, strict=True)


# -- against the JAX package ---------------------------------------------------


def test_slab_lookups_match_jax(grid):
    """The port's slab lookups against JAX's _slab_density_int and
    _slab_density_trilinear inside shard_map over a vz = 4 CPU mesh, on
    points in and around the volume: integer taps equal, trilinear sums
    within 1e-6; with bf16 taps too (JAX's bf16 psum of one owner's value)."""
    mesh = jax_make_mesh(sp=1, px=1, vz=4, devices=jax.devices()[:4])
    jgrid = jax_device_grid(jax_construct(_data(), transform=EYE))
    rng = np.random.default_rng(7)
    pos = rng.uniform(-3.0, 27.0, (2048, 3)).astype(np.float32)
    ipos = np.floor(pos).astype(np.int32)
    unit = types.SimpleNamespace(density_scale=jnp.float32(1.0))
    for dtype in ("float32", "bfloat16"):
        sv = jax_build_slabbed_volume(jgrid, mesh, tap_dtype=dtype)

        def lookups(vol, p, ip):
            g = vol.local_grid()
            return jax_slab_density_int(g, ip), jax_slab_density_trilinear(g, unit, p)

        fn = jax.jit(shard_map(lookups, mesh=mesh, in_specs=(sv.in_spec(), P(), P()), out_specs=(P(), P()),
                               check_vma=False))
        want_int, want_tri = (np.asarray(a) for a in fn(sv, jnp.asarray(pos), jnp.asarray(ipos)))
        ours = build_slabbed_volume_from_brick(grid, _mesh(px=1, vz=4), tap_dtype=dtype).local_grid()
        got_int = lookup_density_brick_int(ours, torch.from_numpy(ipos)).numpy()
        got_tri = trilinear_sum(ours, torch.from_numpy(pos)).numpy()
        np.testing.assert_array_equal(got_int, want_int)
        np.testing.assert_allclose(got_tri, want_tri, rtol=0, atol=1e-6 if dtype == "float32" else 4e-3)
        assert (want_int > 0).mean() > 0.05 and (got_tri == 0).mean() > 0.05


@pytest.mark.parametrize("mode", ["default", "no_dda", "raymarch"])
def test_slab_frames_match_jax(grid, mode):
    """One vz = 4 frame (sp 1, px 2) against the JAX package's
    DistributedRenderer(vz=4) on its 8 devices, image at atol 2e-2."""
    ours = _setup(DistributedRenderer(16, 16, mesh=_mesh(vz=4)), grid, mode)
    theirs = _setup(JDistributedRenderer(width=16, height=16, sp=1, px=2, vz=4), jax_construct(_data(), transform=EYE),
                    mode)
    ours.render_frame()
    theirs.render_frame()
    np.testing.assert_allclose(ours.image(), np.asarray(theirs.image()), rtol=0, atol=2e-2)
