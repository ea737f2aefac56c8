"""The port's RNG words against the JAX package and the GLSL words.

Tolerance: none. Words are carried as int64 in the port and must equal the
JAX package's uint32 words over 10k+ seeds, and the pure-Python
transliterations of random.glsl pinned by tests/test_rng.py.
"""

from __future__ import annotations

import numpy as np
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads)
from volxel_tpu.render import rng as jrng
from volxel_tpu_torch.render import rng as trng

from .test_rng import _py_tea, _py_wang, _py_xoshiro_next

N = 12288


def _seeds():
    rng = np.random.default_rng(11)
    s = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return s


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_tea_and_wang_bit_equal_to_jax():
    a, b = _seeds(), _seeds()[::-1].copy()
    np.testing.assert_array_equal(trng.tea(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))).numpy(),
                                  _np(jrng.tea(a, b)))
    np.testing.assert_array_equal(trng.wang_hash(torch.from_numpy(a.astype(np.int64))).numpy(), _np(jrng.wang_hash(a)))


def test_xoshiro_stream_and_draws_bit_equal_to_jax():
    seeds = _seeds()
    ts = trng.seed_xoshiro(torch.from_numpy(seeds.astype(np.int64)))
    js = jrng.seed_xoshiro(seeds)
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    for _ in range(6):
        ts, tw = trng.next_u32(ts)
        js, jw = jrng.next_u32(js)
        np.testing.assert_array_equal(tw.numpy(), _np(jw))
    for _ in range(3):
        ts, tx = trng.rng3(ts)
        js, jx = jrng.rng3(js)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_masked_draws_bit_equal_to_jax():
    seeds = _seeds()
    mask = np.random.default_rng(3).random(N) < 0.5
    ts, js = trng.seed_xoshiro(torch.from_numpy(seeds.astype(np.int64))), jrng.seed_xoshiro(seeds)
    for t_fn, j_fn in ((trng.rng_where, jrng.rng_where), (trng.rng2_where, jrng.rng2_where),
                       (trng.rng3_where, jrng.rng3_where)):
        ts, tx = t_fn(torch.from_numpy(mask), ts)
        js, jx = j_fn(mask, js)
        np.testing.assert_array_equal(ts.numpy(), _np(js))
        np.testing.assert_array_equal(tx.numpy()[mask], np.asarray(jx)[mask])


def test_seed_rays_bit_equal_to_jax():
    pix = np.arange(N, dtype=np.uint32) * 37
    for frame in (0, 5, 2**31 + 3):
        t = trng.seed_rays(torch.from_numpy(pix.astype(np.int64)), frame)
        j = jrng.seed_rays(pix, np.uint32(frame))
        np.testing.assert_array_equal(t.numpy(), _np(j))


def test_seed_rays_per_lane_frames_bit_equal_to_jax():
    """A tensor of one frame per lane (parallel.multiview's frame * V +
    view) gives every lane the words of seed_rays at that lane's frame,
    in the port and against the JAX package's uint32 words."""
    pix = np.arange(N, dtype=np.uint32) * 37
    frames = np.random.default_rng(5).integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    frames[:3] = [0, 0xFFFFFFFF, 2**31 + 3]
    t = trng.seed_rays(torch.from_numpy(pix.astype(np.int64)), torch.from_numpy(frames.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy(), _np(jrng.seed_rays(pix, frames)))
    for i in (0, 1, 2, N - 1):
        one = trng.seed_rays(torch.from_numpy(pix[i:i + 1].astype(np.int64)), int(frames[i]))
        np.testing.assert_array_equal(t[i:i + 1].numpy(), one.numpy())


def test_words_match_the_glsl_transliteration():
    pairs = [(0, 0), (1, 7), (42, 99), (123456, 2**31), (0xFFFFFFFF, 0xFFFFFFFF)]
    got = trng.tea(torch.tensor([p[0] for p in pairs]), torch.tensor([p[1] for p in pairs]))
    assert [int(v) for v in got] == [_py_tea(a, b) for a, b in pairs]
    xs = [0, 1, 2, 1337, 0xDEADBEEF]
    assert [int(v) for v in trng.wang_hash(torch.tensor(xs))] == [_py_wang(x) for x in xs]
    state = trng.seed_xoshiro(torch.tensor([12345]))
    py_state = [_py_wang(12345 + i) for i in range(4)]
    for _ in range(20):
        state, r = trng.next_u32(state)
        assert int(r[0]) == _py_xoshiro_next(py_state)
    state, x = trng.rng(trng.seed_xoshiro(torch.arange(4096)))
    assert x.dtype == torch.float32 and bool(((x >= 0) & (x < 1)).all())
