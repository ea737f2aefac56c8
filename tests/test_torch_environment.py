"""The port's environment setup and sampling against the JAX package's.

build_env_state: the port resizes the luma to 512^2 with the rule of
jax.image.resize("linear") in float64 and pools it in float32, where JAX
resizes in float32; tolerance rtol 1e-5, checked for the default 8x6 map
(an upsample) and a 1024x512 random map (a downsample, which jax
antialiases).

Sampling runs on state carried across from JAX, with identical uniforms.
The hierarchical warp descends by comparisons, and an ulp of difference in
a transcendental or a division (XLA and ATen round differently) can send a
lane into a neighbouring texel, so >= 99.9% of lanes must agree within
rtol 1e-5 (atol 1e-6 for components near 0).

Looking a direction up goes through acos, which XLA computes as
atan2(sqrt((1-y)(1+y)), y) and ATen directly; the two differ by an ulp on
~18% of inputs. The bilinear weight multiplies that by the map height, so
on the 512-row noise map a lookup can move by ~1e-4 relative. There the
direction -> (u, v) step is held at rtol 1e-6 and the lookup at identical
(u, v) at rtol 1e-5; the end-to-end pdf and lookup are held at rtol 1e-5
on the default map, whose 6 rows keep the amplification below it.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.scene import environment as jenv
from volxel_tpu_torch.scene import environment as tenv

N = 8192
TOL = dict(rtol=1e-5, atol=1e-6)


def _maps():
    default = np.ascontiguousarray(tenv.default_environment_image()[::-1])
    rng = np.random.default_rng(9)
    big = (rng.random((512, 1024, 3), dtype=np.float32) ** 3 * 8.0).astype(np.float32)
    return {"default8x6": default, "random1024x512": big}


@pytest.fixture(scope="module", params=["default8x6", "random1024x512"])
def states(request):
    tex = _maps()[request.param]
    j = jenv.build_env_state(tex, 1.7)
    t = tenv.build_env_state(tex, 1.7, device="cpu")
    carried = tenv.EnvState(
        envmap=torch.from_numpy(np.array(j.envmap)),
        imp_mips=tuple(torch.from_numpy(np.array(m)) for m in j.imp_mips),
        strength=torch.tensor(float(j.strength), dtype=torch.float32),
    )
    return j, t, carried


def test_build_env_state_matches(states):
    j, t, _ = states
    np.testing.assert_array_equal(t.envmap.numpy(), np.asarray(j.envmap))
    assert len(t.imp_mips) == len(j.imp_mips) == tenv.IMP_BASE_MIP + 1
    for a, b in zip(t.imp_mips, j.imp_mips):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert float(t.strength) == float(j.strength)


def _agree(pairs) -> np.ndarray:
    ok = np.ones(N, bool)
    for a, b in pairs:
        a, b = np.asarray(a).reshape(N, -1), np.asarray(b).reshape(N, -1)
        ok &= np.isclose(a, b, **TOL).all(axis=1)
    return ok


@pytest.mark.parametrize("physical", [False, True])
def test_sampling_matches_on_carried_state(states, physical):
    j, _, t = states
    rng = np.random.default_rng(12)
    rnd2 = rng.random((N, 2), dtype=np.float32)
    jl, jp, jw = jenv.sample_environment(j, jnp.asarray(rnd2), physical)
    tl, tp, tw = tenv.sample_environment(t, torch.from_numpy(rnd2), physical)
    frac = _agree([(tl, jl), (tp, jp), (tw, jw)]).mean()
    assert frac >= 0.999, f"sample_environment agrees on {frac:.4%} of lanes"

    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pdf_j = jenv.pdf_environment(j, jnp.asarray(d), physical)
    pdf_t = tenv.pdf_environment(t, torch.from_numpy(d), physical)
    if physical or j.envmap.shape[0] <= 8:
        look_j = jenv.lookup_environment(j, jnp.asarray(d))
        look_t = tenv.lookup_environment(t, torch.from_numpy(d))
        frac = _agree([(pdf_t, pdf_j)] + ([] if physical else [(look_t, look_j)])).mean()
        assert frac >= 0.999, f"pdf/lookup agree on {frac:.4%} of lanes"

    uv_j = jenv._dir_to_uv(jnp.asarray(d))
    uv_t = tenv._dir_to_uv(torch.from_numpy(d))
    for a, b in zip(uv_t, uv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    u, v = (np.array(x) for x in uv_j)
    np.testing.assert_allclose(
        tenv._bilinear_wrap_clamp(t.envmap, torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        np.asarray(jenv._bilinear_wrap_clamp(j.envmap, jnp.asarray(u), jnp.asarray(v))), **TOL)


def test_light_fallback_matches():
    j = jenv.build_env_state(_maps()["default8x6"], 1.0)
    t = tenv.build_env_state(_maps()["default8x6"], 1.0, device="cpu")
    rng = np.random.default_rng(13)
    light = np.array([-1.0, -1.0, -1.0], np.float32) / np.float32(np.sqrt(3.0))
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tenv.lookup_environment_light(t, torch.from_numpy(d), torch.from_numpy(light)).numpy(),
        np.asarray(jenv.lookup_environment_light(j, jnp.asarray(d), jnp.asarray(light))), **TOL)
    rnd2 = rng.random((N, 2), dtype=np.float32)
    for a, b in zip(tenv.sample_environment_light(t, torch.from_numpy(rnd2), torch.from_numpy(light)),
                    jenv.sample_environment_light(j, jnp.asarray(rnd2), jnp.asarray(light))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _bilinear_indices_int64(tex, u, v):
    """The bilinear taps' flat indices at (u, v), computed in int64."""
    h, w, c = tex.shape
    x0 = torch.floor(u * w - 0.5).to(torch.int64)
    y0 = torch.floor(v * h - 0.5).to(torch.int64)
    x0i = torch.remainder(x0, w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0, 0, h - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    base = torch.stack([y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i])
    return base[..., None] * c + torch.arange(c)


def _walk_indices_int64(env, rnd2):
    """The hierarchical warp's texel index, its walk computed in int64."""
    pos_x = torch.zeros(rnd2.shape[:-1], dtype=torch.int64)
    pos_y = torch.zeros(rnd2.shape[:-1], dtype=torch.int64)
    px, py = rnd2[..., 0], rnd2[..., 1]
    for mip in range(tenv.IMP_BASE_MIP - 1, -1, -1):
        dim = env.imp_mips[mip].shape[1]
        flat = env.imp_mips[mip].reshape(-1)
        row0 = (pos_y * 2) * dim + pos_x * 2
        w00, w10, w01, w11 = flat[row0], flat[row0 + 1], flat[row0 + dim], flat[row0 + dim + 1]
        q0, q1 = w00 + w01, w10 + w11
        d = q0 / torch.clamp_min(q0 + q1, 1e-8)
        go_right = px >= d
        e = torch.where(go_right, w10, w00) / torch.clamp_min(torch.where(go_right, q1, q0), 1e-8)
        px = torch.where(go_right, (px - d) / torch.clamp_min(1.0 - d, 1e-8), px / torch.clamp_min(d, 1e-8))
        go_up = py >= e
        py = torch.where(go_up, (py - e) / torch.clamp_min(1.0 - e, 1e-8), py / torch.clamp_min(e, 1e-8))
        pos_x = pos_x * 2 + go_right.to(torch.int64)
        pos_y = pos_y * 2 + go_up.to(torch.int64)
    return pos_y * tenv.IMP_DIM + pos_x


@pytest.mark.parametrize("physical", [False, True])
def test_environment_indices_are_int32_and_equal_int64(states, physical, monkeypatch):
    """Every flat index the environment hands to the table fetch is int32,
    and equals the same computation in int64, on seeded directions and
    uniforms and on (u, v) at the wrap and outside [0, 1]."""
    from volxel_tpu_torch.render import gather

    _, t, _ = states
    rng = np.random.default_rng(21)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:4] = [[-1.0, 0.0, 0.0], [-1.0, 0.3, -0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]  # u = 0 or 1, v = 0 or 1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d)
    rnd2 = torch.from_numpy(rng.random((N, 2), dtype=np.float32))
    u = np.concatenate([[-0.2, 0.0, 1e-7, 1 - 1e-7, 1.0, 1.3], rng.uniform(-0.5, 1.5, 58)]).astype(np.float32)
    v = np.concatenate([[-0.3, 0.0, 1.0, 1.2, -1e-7, 1 + 1e-7], rng.uniform(-0.5, 1.5, 58)]).astype(np.float32)

    seen, taps = [], []
    bilinear = tenv._bilinear_wrap_clamp

    def recording_gather(table, idx):
        seen.append(idx)
        return gather.gather_f32_plain(table, idx)

    def recording_bilinear(tex, u, v):
        taps.append(_bilinear_indices_int64(tex, u, v))
        return bilinear(tex, u, v)

    monkeypatch.setattr(gather, "gather_f32", recording_gather)
    monkeypatch.setattr(tenv, "_bilinear_wrap_clamp", recording_bilinear)
    tenv._bilinear_wrap_clamp(t.envmap, torch.from_numpy(u), torch.from_numpy(v))
    tenv.lookup_environment(t, d)
    tenv.sample_environment(t, rnd2, physical)
    tenv.pdf_environment(t, d, physical)

    du, dv = tenv._dir_to_uv(d)
    texel = (torch.clamp((dv * tenv.IMP_DIM).to(torch.int64), 0, tenv.IMP_DIM - 1) * tenv.IMP_DIM
             + torch.clamp((du * tenv.IMP_DIM).to(torch.int64), 0, tenv.IMP_DIM - 1))
    want = [*taps[:3], _walk_indices_int64(t, rnd2), texel if physical else taps[3]]
    assert len(seen) == len(want) == 5 and len(taps) == (3 if physical else 4)
    for got, wide in zip(seen, want):
        assert got.dtype == torch.int32 and wide.dtype == torch.int64
        assert torch.equal(got.to(torch.int64), wide)
