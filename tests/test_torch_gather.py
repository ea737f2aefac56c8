"""The port's exact f32 table fetches (render/gather.py, kernel 2's plain
versions) against the JAX package's mxu_gather_f32 and its call sites.

gather_f32 must give the table's 32-bit words bit for bit, NaN payloads,
infinities, denormals and -0.0 included: it is held bit-equal to
mxu_gather_f32 (its Pallas kernel in interpret mode) and to numpy's
indexing. The transfer-LUT fetch is the same arithmetic as the JAX
lookup_transfer, so it is held bit-equal too, with and without the packed
table (`mxu=`). The environment lookups go through gather_f32 on the port's
side and through mxu_gather_f32 with the packed tables attached on the JAX
side; they are held at test_torch_environment.py's tolerance (rtol 1e-5,
atol 1e-6 on >= 99.9% of lanes), which covers the ulp differences of
ATen's and XLA's acos and atan2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.render import sampling as jsampling
from volxel_tpu.render.mxu_gather import mxu_gather_f32, pack_gather_table
from volxel_tpu.scene import environment as jenv
from volxel_tpu_torch.render import gather
from volxel_tpu_torch.render import sampling as tsampling
from volxel_tpu_torch.scene import environment as tenv

N = 2048
TOL = dict(rtol=1e-5, atol=1e-6)


def special_table(rows: int, cols: int, seed: int = 0) -> np.ndarray:
    """Random f32 words with NaNs of several payloads, +-inf, denormals,
    +-0.0 and the largest finite values mixed in."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=rows * cols).astype(np.float32) * 1e3
    bits = flat.view(np.uint32)
    specials = np.array(
        [0x7FC00000, 0x7FC00001, 0xFFC12345, 0x7F800001, 0x7F800000, 0xFF800000,
         0x00000001, 0x007FFFFF, 0x80000005, 0x00000000, 0x80000000, 0x7F7FFFFF],
        np.uint32,
    )
    where = rng.choice(flat.size, size=4 * specials.size, replace=False)
    bits[where] = np.tile(specials, 4)
    return flat.reshape(rows, cols)


@pytest.mark.parametrize("idx_shape", [(300,), (7, 5, 3), (2, 1000)])
def test_gather_f32_bit_equal_to_mxu_gather(idx_shape):
    table = special_table(40, 33)  # 1320 words: not a multiple of the 128-lane rows
    rng = np.random.default_rng(1)
    idx = rng.integers(0, table.size, size=idx_shape)
    special = np.flatnonzero(~np.isfinite(table) | (np.abs(table) < 1e-37) | (np.abs(table) > 1e38))
    assert special.size == 48
    idx.reshape(-1)[:48] = special  # every special word is fetched
    got = gather.gather_f32(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    want = np.asarray(mxu_gather_f32(pack_gather_table(jnp.asarray(table.reshape(-1))),
                                     jnp.asarray(idx, jnp.int32), interpret=True))
    assert got.shape == idx_shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), table.reshape(-1)[idx].view(np.uint32))


@pytest.mark.parametrize("idx_shape", [(1,), (3,), (5,), (4097,), (7, 5, 3)])
def test_gather_f32_int32_bit_equal_to_mxu_gather(idx_shape):
    """The card's index type: int32 indices give the same words as the
    Pallas kernel in interpret mode; negative ones wrap as numpy's do."""
    table = special_table(40, 33)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, table.size, size=idx_shape).astype(np.int32)
    special = np.flatnonzero(~np.isfinite(table) | (np.abs(table) < 1e-37) | (np.abs(table) > 1e38))
    head = min(idx.size, special.size)
    idx.reshape(-1)[:head] = special[:head]
    got = gather.gather_f32(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    want = np.asarray(mxu_gather_f32(pack_gather_table(jnp.asarray(table.reshape(-1))), jnp.asarray(idx),
                                     interpret=True))
    assert got.shape == idx_shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    negative = (idx - table.size).astype(np.int32)
    wrapped = gather.gather_f32(torch.from_numpy(table), torch.from_numpy(negative)).numpy()
    np.testing.assert_array_equal(wrapped.view(np.uint32), table.reshape(-1)[negative].view(np.uint32))


def _densities(n: int, seed: int) -> np.ndarray:
    """Normalized densities across and beyond the LUT and the sample range,
    with the exact bin edges, NaN and +-inf."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    d[:129] = np.arange(129, dtype=np.float32) / 128  # every bin edge, 1.0 included
    d[129:133] = [np.nan, np.inf, -np.inf, -0.0]
    return d


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sample_range", [(0.0564, 1.0), (0.0, 2.0)])
def test_lookup_transfer_bit_equal_to_jax(packed, sample_range):
    rng = np.random.default_rng(2)
    lut = special_table(128, 4, seed=3) if packed else rng.random((128, 4), dtype=np.float32)
    density = _densities(4000, 4).reshape(40, 100)
    mxu = pack_gather_table(jnp.asarray(lut.reshape(-1))) if packed else None
    want = np.asarray(jsampling.lookup_transfer(jnp.asarray(lut), jnp.asarray(sample_range, jnp.float32),
                                                jnp.asarray(density), mxu=mxu))
    trange = torch.tensor(sample_range, dtype=torch.float32)
    got = tsampling.lookup_transfer(torch.from_numpy(lut), trange, torch.from_numpy(density)).numpy()
    assert got.shape == (40, 100, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = gather.lookup_transfer_plain(torch.from_numpy(lut), trange, torch.from_numpy(density)).numpy()
    np.testing.assert_array_equal(plain.view(np.uint32), got.view(np.uint32))


@pytest.fixture(scope="module")
def packed_states():
    """The default 8x6 map: the JAX state with its envmap and importance
    base packed for mxu_gather_f32, and the port's state carrying the same
    arrays."""
    tex = np.ascontiguousarray(tenv.default_environment_image()[::-1])
    j = jenv.build_env_state(tex, 1.3)
    j = j._replace(envmap_mxu=pack_gather_table(j.envmap.reshape(-1)),
                   imp0_mxu=pack_gather_table(j.imp_mips[0].reshape(-1)))
    t = tenv.EnvState(
        envmap=torch.from_numpy(np.array(j.envmap)),
        imp_mips=tuple(torch.from_numpy(np.array(m)) for m in j.imp_mips),
        strength=torch.tensor(float(j.strength), dtype=torch.float32),
    )
    return j, t


def _agree(pairs) -> float:
    ok = np.ones(N, bool)
    for a, b in pairs:
        a, b = np.asarray(a).reshape(N, -1), np.asarray(b).reshape(N, -1)
        ok &= np.isclose(a, b, **TOL).all(axis=1)
    return float(ok.mean())


@pytest.mark.parametrize("physical", [False, True])
def test_environment_lookups_match_packed_jax(packed_states, physical):
    j, t = packed_states
    rng = np.random.default_rng(5)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rnd2 = rng.random((N, 2), dtype=np.float32)
    look = (tenv.lookup_environment(t, torch.from_numpy(d)), jenv.lookup_environment(j, jnp.asarray(d)))
    pdf = (tenv.pdf_environment(t, torch.from_numpy(d), physical), jenv.pdf_environment(j, jnp.asarray(d), physical))
    sampled = zip(tenv.sample_environment(t, torch.from_numpy(rnd2), physical),
                  jenv.sample_environment(j, jnp.asarray(rnd2), physical))
    frac = _agree([look, pdf, *sampled])
    assert frac >= 0.999, f"environment lookups agree on {frac:.4%} of lanes"

    # the bilinear taps alone, at identical (u, v): the 4 x 3 fetch is exact
    u, v = (np.array(x) for x in jenv._dir_to_uv(jnp.asarray(d)))
    got = tenv._bilinear_wrap_clamp(t.envmap, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    want = np.asarray(jenv._bilinear_wrap_clamp(j.envmap, jnp.asarray(u), jnp.asarray(v), packed=j.envmap_mxu))
    np.testing.assert_allclose(got, want, **TOL)


def test_environment_entry_points_take_the_callers_device():
    """build_env_state, Environment and default_environment build on the
    device they are given and have no default one."""
    img = tenv.default_environment_image()
    tex = np.ascontiguousarray(img[::-1])
    built = [
        tenv.build_env_state(tex, 1.0, device="cpu"),
        tenv.Environment(img, device="cpu").state,
        tenv.default_environment("cpu").state,
        tenv.default_environment(device=torch.device("cpu")).state,
    ]
    for state in built:
        assert state.envmap.device.type == "cpu" and state.strength.device.type == "cpu"
        assert all(m.device.type == "cpu" for m in state.imp_mips)
        torch.testing.assert_close(state.imp_mips[-1], built[0].imp_mips[-1], rtol=0, atol=0)
    with pytest.raises(TypeError):
        tenv.build_env_state(tex, 1.0)
    with pytest.raises(TypeError):
        tenv.Environment(img)
    with pytest.raises(TypeError):
        tenv.default_environment()
