"""The port's numpy host copies against the JAX package's originals.

volxel_tpu_torch carries its own copies of the numpy host modules (the
card's machine has no JAX, and importing any volxel_tpu module imports it).
Tolerance: none — the copies must give exactly the same arrays and values.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.api import settings as j_settings
from volxel_tpu.grid import brick as j_brick
from volxel_tpu.scene.camera import Camera as JCamera
from volxel_tpu.scene.volume import Volume as JVolume
from volxel_tpu.transfer import function as j_function
from volxel_tpu.utils import fixtures as j_fixtures
from volxel_tpu.utils import mathutil as j_math
from volxel_tpu_torch.api import settings as t_settings
from volxel_tpu_torch.grid import brick as t_brick
from volxel_tpu_torch.scene.camera import Camera as TCamera
from volxel_tpu_torch.scene.volume import Volume as TVolume
from volxel_tpu_torch.transfer import function as t_function
from volxel_tpu_torch.utils import fixtures as t_fixtures
from volxel_tpu_torch.utils import mathutil as t_math

FIXTURE = Path(__file__).parent / "fixtures" / "reference_benchmark.json"


def _grid_arrays(g):
    out = {
        "range_lo": g.range_lo, "range_hi": g.range_hi, "indirection": g.indirection,
        "atlas": g.atlas, "transform": g.transform, "histogram": g.histogram,
    }
    for i, (lo, hi) in enumerate(g.range_mips):
        out[f"mip{i}_lo"], out[f"mip{i}_hi"] = lo, hi
    return out


@pytest.mark.parametrize("case", ["ct32", "random40"])
def test_construct_brick_grid_identical(case):
    if case == "ct32":
        vol = t_fixtures.synthetic_ct_volume((32, 32, 32), bits_stored=12)
        data = vol.astype(np.float32) / vol.max()
    else:  # ragged extent: padding to the brick/mip alignment
        data = np.random.default_rng(7).random((40, 24, 33), dtype=np.float32)
        data[data < 0.6] = 0.0
    tg = t_brick.construct_brick_grid(data, transform=np.eye(4, dtype=np.float32))
    jg = j_brick.construct_brick_grid(data, transform=np.eye(4, dtype=np.float32), use_native=False)
    assert tg.brick_count == jg.brick_count
    assert tg.brick_counter == jg.brick_counter
    assert tg.min_maj == jg.min_maj
    ta, ja = _grid_arrays(tg), _grid_arrays(jg)
    assert ta.keys() == ja.keys()
    for k in ta:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_array_equal(tg.packed_range(), jg.packed_range())
    np.testing.assert_array_equal(tg.packed_indirection(), jg.packed_indirection())


def test_synthetic_volume_identical():
    for seed in (0, 3):
        a = t_fixtures.synthetic_ct_volume((24, 20, 16), bits_stored=12, seed=seed)
        b = j_fixtures.synthetic_ct_volume((24, 20, 16), bits_stored=12, seed=seed)
        np.testing.assert_array_equal(a, b)


def test_camera_and_projection_identical():
    tc, jc = TCamera(1.0), JCamera(1.0)
    for cam in (tc, jc):
        cam.rotate_around_view(0.6, 0.4)
        cam.zoom(2.0)
        cam.translate_on_plane(0.01, -0.02)
        cam.rotate_around_view(-0.3, 2.0)  # pitch clamp
    np.testing.assert_array_equal(tc.view_matrix(), jc.view_matrix())
    for aspect in (1.0, 16 / 9):
        np.testing.assert_array_equal(tc.proj_matrix(aspect), jc.proj_matrix(aspect))
    np.testing.assert_array_equal(t_math.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]),
                                  j_math.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0]))


def test_volume_transforms_identical():
    vol = t_fixtures.synthetic_ct_volume((32, 24, 16), bits_stored=12)
    grid = t_brick.construct_brick_grid(vol.astype(np.float32) / vol.max())
    tv, jv = TVolume.from_grid(grid), JVolume.from_grid(grid)
    assert tv.rescale_to_unit_cube() == jv.rescale_to_unit_cube()
    np.testing.assert_array_equal(tv.combined_transform(), jv.combined_transform())
    for a, b in zip(tv.aabb_clipped([0.1, 0, 0.2], [0.9, 1, 1]), jv.aabb_clipped([0.1, 0, 0.2], [0.9, 1, 1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "stops",
    [
        t_function.DEFAULT_COLOR_STOPS,
        [
            {"color": [0.5686, 0.2549, 0.6745, 0.54], "stop": 0.0},
            {"color": [0.9725, 0.8941, 0.3608, 1.0], "stop": 0.1782},
            {"color": [0.0, 1.0, 1.0, 0.17], "stop": 0.3985},
        ],
        [{"color": [1.0, 0.2, 0.1, 0.5], "stop": 0.3}, {"color": [0.1, 0.2, 1.0, 1.0], "stop": 0.7}],
    ],
)
def test_transfer_luts_identical(stops):
    a = t_function.generate_transfer_function(stops)
    b = j_function.generate_transfer_function(stops)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    text = "0.1 0.2 0.3 0.4\nbad line\n1 1 1 1\n"
    assert t_function.parse_transfer_function(text) == j_function.parse_transfer_function(text)


def test_settings_round_trips_identical():
    export = json.loads(FIXTURE.read_text())["sharedSettings"][0]
    a = t_settings.verify_settings(export)
    b = j_settings.verify_settings(export)
    assert a == b
    s_t, s_j = t_settings.ViewerSettings(), j_settings.ViewerSettings()
    assert s_t.to_json_dict() == s_j.to_json_dict()
    kw = dict(transfer_colors=t_function.DEFAULT_COLOR_STOPS, transfer_type="color_stops",
              histogram_range=[0.0, 1.0], env_strength=1.0,
              camera_pos=np.array([0.0, 0.0, -1.0]), camera_look_at=np.zeros(3))
    assert t_settings.make_settings_export(s_t, **kw) == j_settings.make_settings_export(s_j, **kw)
