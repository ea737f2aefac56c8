#!/usr/bin/env python3
"""Hold the PyTorch/CUDA port's main paths to their plain versions on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port is correct on the card; the benchmark
(vxbench/) measures it. Phases, each of which raises (exit code != 0) on
failure:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from volxel_tpu_torch/csrc; build csrc/dda_leg.cu
   and csrc/track_leg.cu once more to cubins and check in their SASS
   (cuobjdump) that the leg kernels' own code (dense, slab and park forms)
   holds no FFMA;
2b. ingest and the reference benchmark, in a temporary directory: write
   the 512^3 12-bit synthetic CT volume with the port's fixture writer as a
   deflated DICOM zip; ingest it on the native path and build the grid
   once more on numpy (bit-equal; fails if the native library does not
   build); write a 2048x1024 HDR map and load it with Renderer.load_env on
   the card (one importance-pyramid launch); then, with every launch
   counter at 0 before it, Renderer.from_attributes with the zip, the map
   and tests/fixtures/reference_benchmark.json (one entry per mode at
   bounces 1, 1536x864 and 500 samples): print each record and the
   fingerprint (the card's name and power limit), and check every
   timePerSample, the image after each entry and that every kernel of the
   three modes launched; then hold each of those kernels against its plain
   version on the spec's grid and map (one frame a mode, every call; K4 at
   image(), K3 on the map's base);
2c. the app path, on the zip and the map of phase 2b: with every launch
   counter at 0 before it, Renderer.from_attributes at 960x540 (`serve`'s
   default size) in bench.py's framing, then the preview server on an
   ephemeral port, driven over HTTP: GET /, /frame.png (decoded here: its
   size, not black), /state, /histogram, /transfer; rotate commands until
   drag previews are served (the K7 and K4 launches over the drags); POST
   /settings with gradient_shading, debug_hits and warmup_low_res, each
   followed by a served frame; render_mode raymarch and no_dda, each
   followed by a served frame; POST /benchmark of 16 samples and
   /benchmark_result (the card's name and power limit); the first fallback
   histogram (the dense field to the host); the server stops, and every
   kernel of the path must have launched. On the server's renderer
   (960x540, bounces 3, the zip's grid and the map), after the counts are
   read: one frame in each mode with each kernel held at every call of its
   three bounces, one warm-up frame (the legs at 0.33 of the size, K4 on
   its image()) and one drag preview (K7, within 1e-6 where only expf and
   ATen's exp can round apart, and K4). Then through the Renderer at
   1920x1080: a gradient-shaded sample in each mode (one launch of each
   leg and of the shading), and one more with each of its kernels held bit
   for bit at every call; a debug-hits sample (no leg, no LUT fetch; one
   K4 at image()).
   Then `python -m volxel_tpu_torch render --synthetic 256 --size 512x512
   --samples 16` and `info` in subprocesses, the PNG decoded here;
2d. the mesh (parallel/), on the bench scene at the main paths' size: with
   every launch counter at 0 before it, a DistributedRenderer on a 2x2
   mesh whose four positions name the card, 3 steps (6 samples) in each
   mode, the framebuffer bit-equal to the same steps replayed over
   single-position render_sample calls, each leg four launches a step and
   the LUT fetch one a default step; then one more step a mode with every
   kernel held at every call (hold_frame_kernels); render_views of 4 views
   in one wavefront (each leg one launch, each view bit-equal to
   render_sample at frame * 4 + view; then one more call with every kernel
   held at every call, at its 4 x 1080p lanes); two processes on the card
   joined over gloo with sp = 2 spanning them (a first step equal to the
   mean of samples 0 and 1 in each, process_info reporting 2 processes),
   and NCCL in a process group of one (its all_gather of a frame buffer);
   step_statistics in the default and no_dda modes (each leg one launch,
   then every kernel it launched held bit-equal, budgets and events
   included); PreviewServer over a 2x2 DistributedRenderer at 960x540,
   stepped (frames, the server's benchmark counting sp samples a step, a
   drag preview through K7), then on its renderer one frame with every
   kernel held and one drag preview with K7 and K4 held;
   `python -m volxel_tpu_torch serve --synthetic 64 --mesh 1,1,1` in a
   subprocess (/state, /frame.png); sp = 2 over cuda:0 and cuda:1 where
   the machine has two cards, else one line saying it was skipped;
2e. render-time volume slabs (parallel/volshard.py), on the bench scene at
   the main paths' size: with every launch counter at 0 before it, a
   DistributedRenderer whose (1, 1, 4) positions name the card, loaded by
   restart_from_grid from the brick grid (each slab's bytes, and the
   load's peak above what it keeps, which must stay below the whole
   field's bytes), beside a vz = 1 renderer on the card; 2 steps in each
   mode, the framebuffer bit-equal to vz = 1's, each leg launched only in
   its slab form, 4 times a bounce; then, after the counts are read, one
   step of each renderer with every kernel held bit for bit at every call;
   two gradient-shaded default steps bit-equal to vz = 1's; one (sp=2,
   px=1, vz=2) step bit-equal to an sp = 2 one; vz = 2 over cuda:0 and
   cuda:1 where the machine has two cards, else one line saying it was
   skipped; `python -m volxel_tpu_torch serve --synthetic 64 --mesh 1,1,2
   --device cuda:0` in a subprocess (/state, /frame.png);
2f. a vz row across the processes of a node (parallel/nodeshare.py), on
   the bench scene at the main paths' size: two processes on the card
   joined over gloo (`chip_smoke.py --node-worker ADDR PID DEVICES`), a
   (1, 1, 2) mesh with one position each, loaded by restart_from_grid:
   each process decodes its own slab and maps the other's through CUDA
   IPC (its device bytes after the load, which must stay below the whole
   field's); in each mode, with the counters at 0 before them, 2 steps,
   each leg launched only in its slab form, rank 0's framebuffer bit-equal
   to one-process vz = 1 and vz = 2 renderers'; one step with each leg
   held bit for bit against its plain version on every 16th lane of each
   call through the table that holds the mapped slab; then 2 timestep
   swaps (each process cuts its slab from a whole field) with no host sync
   of the caller's, bit-equal to vz = 1, each swap freeing the slab it
   replaced, and close(); again with the processes on cuda:0 and cuda:1,
   joined over NCCL, where the machine has two cards;
2g. a vz row across nodes (parallel/migrate.py), rehearsed on the one
   machine: two processes on the card over gloo (`chip_smoke.py
   --cross-worker ADDR PID DEVICES NODES`), fed the node identities A and
   B (printed beside the machine's own), a (1, 1, 2) row across them at
   the main paths' size: each holds its own slab, the other's is absent,
   and a lane that reaches it parks, moves to its owner and is resumed by
   the leg's park form. In each mode, with the counters at 0 before them,
   2 steps: each leg launched only in its park form, no slab mapped, rank
   0's framebuffer bit-equal to a one-process vz = 1 renderer's, each leg
   call's lanes (running, parked, moved, returned), rounds and bytes
   printed; one step with each park form held bit for bit against its
   plain park form on every 16th lane of each call in both processes; each
   process's device bytes after the load. Again over NCCL on cuda:0 and
   cuda:1 where the machine has two cards; then four processes fed [A, A,
   B, B] at 256^3 and 960x540 (slabs mapped within a node, lanes moved
   across), bit-equal to vz = 1, and again over NCCL on cuda:0-3 where the
   machine has four cards. `chip_smoke.py --cross-nodes-only` builds the
   kernels and runs this phase alone (its NCCL runs on a machine of four
   cards);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes:
   - both default-mode legs (the DDA march and its collisions, each lane
     until it ends) at every call of one 1080p default-mode sample of the
     512^3 scene, the shadow leg with physical shadows at every call of one
     more, and both legs at every call of one sample at bounces 3
     (bit-equal on every output of every lane); the legs' -logf(1 - xi)
     against torch.log at all 2^24 draws;
   - both no_dda legs (delta and ratio tracking, each lane until it ends)
     at every call of one 1080p no_dda sample, bit-equal on every output
     of every lane;
   - both table fetches: the transfer-LUT fetch where it still runs (the
     default sample's premultiplied pyramid) and gather_f32, on no render
     path since the environment's kernels took its sites, at every call of
     the plain environment's warp and escape lookup over 1920x1080 lanes
     (bit-equal);
   - the importance pyramid on the default environment's 512^2 base
     (bit-equal, its launches per build), and the tonemap, bit-equal on a
     1920x1080x3 buffer and at all 2^32 f32 inputs;
   - the shear-warp intermediate on the 512^3 volume, on the preview's
     fixed canvas and on one view's static canvas (bit-equal, or within
     1e-6 where the card's expf and ATen's exp round apart), and on the
     fixed canvas through the Renderer's default transfer and at a
     translucent density; again at each of the preview's six poses in
     phase 4;
   - the per-ray RNG's seeding of every 1920x1080 pixel and a masked
     rng2_where on its words (bit-equal, words and floats at every lane);
   - the environment's warp sample and lookup (csrc/env.cu) over 1920x1080
     uniforms and directions, each form bit-equal to the plain version at
     every lane in one launch;
   - both raymarch step loops (the camera leg's and the shadow leg's) at
     every call of one 1080p raymarch sample (bit-equal on state, hit, t
     and rgb, or state and tau, of every lane), and the nearest-tap sums on
     that sample's camera rays at 64 steps (bit-equal);
4. run the main paths through the Renderer: the 512^3 synthetic CT volume
   in the benchmark framing (bench.py), 1920x1080, 5 warm-up + 3
   accumulated frames, then image(), in the default, the raymarch and the
   no_dda mode, each with every launch counter at 0 before it; check the
   output, that every kernel of the path launched, that each leg of the
   mode is one launch per bounce and that the LUT fetch launched once per
   default sample and never in the other modes, that the RNG is seeded in
   one launch a sample and that the environment's warp and escape lookup
   launch once each a bounce; in the three modes, and the default mode
   once more at bounces 3, one sample with each leg watched for host syncs
   (there must be none); then the shear-warp preview: render_preview() at
   six camera poses that use all six (principal axis, flip) volumes, each
   called 1 + 3 times, K7 held to its plain version at each pose, and
   render_dvr(screen=True) once, with the counters at 0 before it;
5. render the same scene at 64x64 on the card and on the CPU (plain
   versions) in each of the three modes, plain and with gradient shading,
   and hold the images to the parity contract of
   tests/test_parity_oracle.py; debug hits in each mode and the preview at
   three poses are held to max abs err 1e-5.

Each phase logs its own seconds. The last line is {"ok": true, "device":
{...}}. Without a CUDA device, or without the volxel_tpu_torch package
beside it, the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

# bench.py's scene: framing, transfer and sample range (bench.py:186-200)
BENCH_TRANSFER = [
    {"color": [0.5686, 0.2549, 0.6745, 0.54], "stop": 0.0},
    {"color": [0.9725, 0.8941, 0.3608, 1.0], "stop": 0.1782},
    {"color": [0.0, 1.0, 1.0, 0.17], "stop": 0.3985},
]
BENCH_SAMPLE_RANGE = [0.0564, 1.0]
WARMUP_FRAMES = 5
ACCUMULATED_FRAMES = 3
PARITY_FRAMES = 12  # frames 5..11 accumulate, as tests/test_parity_oracle.py
# the preview's camera poses, applied one after the other to the bench
# framing: each turns the view onto another (principal axis, flip)
PREVIEW_POSES = ((0.0, 0.0), (1.57, 0.0), (1.57, 0.0), (1.57, 0.0), (0.0, 1.2), (0.0, -2.4))
PREVIEW_REPEATS = 3  # calls after the first at each pose
PREVIEW_PARITY_ATOL = 1e-5
# a view whose static canvas phase 3 checks: x principal, flipped
STATIC_VIEW = (-0.9, 0.35, 0.3)
# the bench's density makes every voxel of the 512^3 scene opaque (sigma * a
# >= 100 for every LUT row), so most of K7's compositing there is not needed
# (a pixel with t = 0 keeps its colour); at this fraction of it a ray through
# the volume gathers an optical depth of a few units, no pixel turns opaque,
# and every pixel-slice of the footprints is composited
TRANSLUCENT = 2.0**-16


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_renderer(grid, width: int, height: int, device, mode: str = "default", bounces: int = 1):
    from volxel_tpu_torch import Renderer

    r = Renderer(width, height, device=device)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.settings.bounces = bounces
    bench_look(r)
    return r


def bench_look(r) -> None:
    """bench.py's framing, transfer and sample range on a loaded renderer."""
    r.camera.rotate_around_view(0.6, 0.4)
    r.camera.zoom(2.0)
    r.set_transfer_colors(BENCH_TRANSFER)
    r.settings.sample_range = list(BENCH_SAMPLE_RANGE)
    r.restart_rendering()


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(got, want) -> float:
    """Largest |difference| over the outputs; lanes outside the box carry
    NaN/inf through unchanged, so those count as 0."""
    return max(float((a.double() - b.double()).abs().nan_to_num(0.0).max()) for a, b in zip(got, want))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sample_operands(r):
    config = r._config()
    inv_view, inv_proj, light_dir = r._camera_operands(config)
    return (config, r._device_grid, r.volume_params(), r._lut, r.environment.state, inv_view, inv_proj, light_dir)


@contextlib.contextmanager
def compared_calls(module, name: str, cuda_fn, plain_fn, outputs, lanes=lambda args: 0, atol: float = 0.0):
    """Replace module.<name>, for the block's duration, by a stand-in that
    sends each call's inputs through the kernel and the plain version,
    raises unless they agree bit for bit on every output (or, with `atol`,
    within it), and returns the kernel's result. Yields the tally: calls,
    lanes (`lanes(args)` summed over the calls), the largest difference,
    whether every call was bit-equal, and the first call's arguments."""
    tally = {"calls": 0, "lanes": 0, "err": 0.0, "equal": True, "first_args": None}

    def compared(*args):
        got = cuda_fn(*args)
        want = plain_fn(*args)
        got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        bad = [nm for nm, a, b in zip(outputs, got_t, want_t) if not bits_equal(a, b)]
        err = max_abs(got_t, want_t)
        if bad and not err <= atol:
            raise SystemExit(f"{name} call {tally['calls']}: kernel differs from its plain version "
                             f"in {bad} (max abs {err})")
        tally["equal"] = tally["equal"] and not bad
        tally["calls"] += 1
        tally["lanes"] += lanes(args)
        tally["err"] = max(tally["err"], err)
        if tally["first_args"] is None:
            tally["first_args"] = args
        return got

    original = getattr(module, name)
    setattr(module, name, compared)
    try:
        yield tally
    finally:
        setattr(module, name, original)


def check_every_call(r, module, names, frame: int = 0, what: str = "") -> list[dict]:
    """Render one sample of `r` with each module.<name> compared at every
    call (compared_calls); `names` maps a name to compared_calls' other
    arguments. Fails unless each was called. Returns the tallies in the
    order of `names`."""
    from volxel_tpu_torch.render.pathtrace import render_sample

    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(compared_calls(module, name, **kw)) for name, kw in names.items()]
        render_sample(*sample_operands(r), frame)
    config = r._config()
    for name, tally in zip(names, tallies):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in one {config.mode} sample{what}")
        log_tally(name, tally, f"one {config.width}x{config.height} {config.mode} sample{what}")
    return tallies


def log_tally(name: str, tally: dict, where: str) -> None:
    log(f"{name}: bit-equal at all {tally['calls']} calls of {where} ({tally['lanes']} lanes in all)")


def check_legs(r) -> None:
    """Both default-mode leg kernels at every call of one 1080p default
    sample (the camera leg and the shadow leg; lanes counted: the running
    ones), then the shadow leg with physical shadows at every call of one
    more sample, then both legs at every call of one sample at bounces 3:
    bit-equal on every output of every lane, budgets included."""
    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import ddaleg

    def compare(leg):
        name = f"dda_leg_{leg}"
        outputs = ("state", "hit", "t", "rgb", "budget") if leg == "sample" else ("state", "tr", "budget")
        return dict(cuda_fn=getattr(ddaleg, f"{name}_cuda"), plain_fn=getattr(ddaleg, f"{name}_plain"),
                    outputs=outputs, lanes=lambda a: int(a[13].sum()))

    legs = {"dda_leg_sample": compare("sample"), "dda_leg_shadow": compare("shadow")}
    check_every_call(r, modes, legs)
    r.settings.physical_shadows = True
    try:
        check_every_call(r, modes, {"dda_leg_shadow": compare("shadow")}, frame=1, what=" with physical shadows")
    finally:
        r.settings.physical_shadows = False
    r.settings.bounces = 3
    try:
        check_every_call(r, modes, legs, frame=2, what=" at bounces 3")
    finally:
        r.settings.bounces = 1


def check_track_legs(r) -> None:
    """Both no_dda leg kernels at every call of one 1080p no_dda sample (the
    camera leg and the shadow leg; lanes counted: the running ones),
    bit-equal on every output of every lane, events left included."""
    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render import trackleg

    def compare(leg):
        name = f"track_leg_{leg}"
        outputs = ("state", "hit", "t", "rgb", "events") if leg == "sample" else ("state", "tr", "events")
        return dict(cuda_fn=getattr(trackleg, f"{name}_cuda"), plain_fn=getattr(trackleg, f"{name}_plain"),
                    outputs=outputs, lanes=lambda a: int(a[9].sum()))

    r.render_mode = "no_dda"
    try:
        check_every_call(r, modes, {"track_leg_sample": compare("sample"), "track_leg_shadow": compare("shadow")})
    finally:
        r.render_mode = "default"


def check_neg_log1m() -> None:
    """The legs' -logf(1 - xi) against -torch.log(1.0 - xi) at all 2^24
    values a draw takes (k * 2^-24), bit for bit."""
    import torch

    from volxel_tpu_torch.render.ddaleg import neg_log1m_cuda

    xi = torch.arange(2**24, dtype=torch.int32, device="cuda").to(torch.float32) * (1.0 / 16777216.0)
    got, want = neg_log1m_cuda(xi), -torch.log(1.0 - xi)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if bad:
        raise SystemExit(f"-logf(1 - xi) differs from -torch.log(1.0 - xi) at {bad} of the 2^24 draws")
    log(f"-logf(1 - xi) of the legs: bit-equal to -torch.log(1.0 - xi) at all {xi.numel()} draws")


# the sources whose SASS phase 2 reads, each with the pattern of its leg
# kernels (dense, slab and park forms), whose own code must hold no FFMA,
# and how many there are
SASS_CHECKS = {"dda_leg.cu": (r"dda_leg_(sample|shadow)(_slabs|_park)?_kernel", 15),
               "track_leg.cu": (r"track_leg_(sample|shadow)(_slabs|_park)?_kernel", 10)}


def own_ffma(sass: str) -> dict:
    """{function: the FFMA in its own code} of a cuobjdump -sass listing.
    The out-of-line functions at its CALL targets, which cuobjdump lists
    after the code of the kernel that calls them, are left out."""
    found = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        own_end = min((int(a, 16) for a in re.findall(r"CALL\.REL\S*\s+0x([0-9a-f]+)", body)), default=float("inf"))
        found[name] = sum(1 for addr, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
                          if int(addr, 16) < own_end and "FFMA" in text)
    return found


def check_sass() -> None:
    """Build SASS_CHECKS' sources once more, each to a cubin, all at once,
    and count the FFMA in each kernel's own code (cuobjdump -sass): the leg
    kernels' must hold none, so no f32 operation of theirs is contracted.
    The log and the IEEE division, whose code needs FFMA, are out-of-line
    functions, left out."""
    from volxel_tpu_torch import kernels

    nvcc = kernels._nvcc()
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD) as tmp:
        procs = {}
        for name in SASS_CHECKS:
            src = kernels.CSRC / name
            cubin = str(Path(tmp) / f"{src.stem}.cubin")
            procs[name] = (cubin, subprocess.Popen([nvcc, *kernels._flags(src), "-cubin", "-o", cubin, str(src)],
                                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name, (cubin, proc) in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise SystemExit(f"nvcc -cubin failed on {name}:\n{err}")
            sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            pattern, expected = SASS_CHECKS[name]
            legs = {fn: n for fn, n in own_ffma(sass).items() if re.search(pattern, fn)}
            if len(legs) != expected or any(legs.values()):
                raise SystemExit(f"the leg kernels' own SASS in {name} holds FFMA, or not every leg kernel was found: "
                                 f"{legs}")
            log(f"{name}: no FFMA in the own SASS of its {len(legs)} leg kernels")


def lut_fetch_cuda(lut, sample_range, density):
    from volxel_tpu_torch.render import gather

    return gather.lookup_transfer_cuda(lut.contiguous(), sample_range.contiguous(), density.contiguous())


def check_gather(r) -> None:
    """csrc/gather.cu's two entry points, bit-equal: the LUT fetch where it
    still runs, at every call of one 1080p default-mode sample (the
    premultiplied pyramid, its only call); gather_f32, which no render path
    calls since csrc/env.cu took the environment's sites, at every call of
    the plain environment's warp sample and escape lookup over 1920x1080
    seeded lanes (the bilinear taps and the importance texels)."""
    import torch

    from volxel_tpu_torch.render import gather
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.scene import environment as env_mod

    def gather_cuda(table, idx):
        return gather.gather_f32_cuda(table.contiguous(), idx.contiguous())

    with compared_calls(gather, "lookup_transfer_fetch", lut_fetch_cuda, gather.lookup_transfer_plain, ("rgba",),
                        lambda a: a[2].numel()) as lut:
        render_sample(*sample_operands(r), 0)
    if lut["calls"] == 0:
        raise SystemExit("lookup_transfer was not called in one default sample")
    log_tally("lookup_transfer", lut, f"one {r.width}x{r.height} default sample (the premultiplied pyramid)")
    rng = np.random.default_rng(2)
    d = rng.normal(size=(1920 * 1080, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dirs = torch.from_numpy(d).cuda()
    rnd2 = torch.from_numpy(rng.random((1920 * 1080, 2), dtype=np.float32)).cuda()
    state = r.environment.state
    with compared_calls(gather, "gather_f32", gather_cuda, gather.gather_f32_plain, ("values",),
                        lambda a: a[1].numel()) as sel:
        le, _, _ = env_mod.sample_environment_plain(state, rnd2)
        le_esc, _ = env_mod.lookup_environment_pdf_plain(state, dirs)
    finite = bool(torch.isfinite(le).all()) and bool(torch.isfinite(le_esc).all())
    if not (sel["calls"] == 3 and finite):
        raise SystemExit(f"the plain environment: {sel['calls']} gather calls (want 3), finite {finite}")
    log_tally("gather_f32", sel, f"the plain environment's warp sample and escape lookup over {dirs.shape[0]} lanes")


def check_rng(width: int, height: int) -> None:
    """The per-ray RNG's two kernels (csrc/rng.cu) at width x height, bit
    for bit against the plain int64 version on the card: the seeding of
    every pixel at a frame past 2^31, then a masked rng2_where on its
    words (about 70% of the lanes drawing), words and floats at every
    lane, masked-out lanes included."""
    import torch

    from volxel_tpu_torch.render import rng

    cuda = torch.device("cuda")
    pix = torch.arange(width * height, dtype=torch.int64, device=cuda)
    frame = 2**31 + 5
    state = rng.seed_rays_cuda(pix, frame)
    if not bits_equal(state, rng.seed_rays_plain(pix, frame)):
        raise SystemExit("rng_seed: the words differ from the plain version's")
    mask = torch.rand(pix.shape, generator=torch.Generator(cuda).manual_seed(3), device=cuda) < 0.7
    got, want = rng.draw_cuda(state, 2, mask), rng.draw_plain(state, 2, mask)
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("rng_draw: a masked rng2_where differs from the plain version's")
    log(f"rng_seed and rng_draw: bit-equal to the plain int64 version at all {pix.numel()} lanes of "
        f"{width}x{height} (the words, and a masked rng2_where's words and floats)")


def check_env(r, width: int, height: int) -> None:
    """The environment's two kernels (csrc/env.cu) on `r`'s map at width x
    height lanes, bit for bit against the plain version on the card, one
    launch a call: the warp sample with each pdf over seeded uniforms (0,
    0.5 and 1 - ulp among them), and the lookup with each pdf, alone and
    the pdf alone over seeded directions (the poles among them)."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.scene import environment as env_mod

    cuda = torch.device("cuda")
    n = width * height
    g = torch.Generator(cuda).manual_seed(5)
    rnd2 = torch.rand((n, 2), generator=g, device=cuda)
    rnd2[:3] = torch.tensor([[0.0, 0.0], [0.5, 0.5], [1.0 - 2.0**-24] * 2], device=cuda)
    d = torch.randn((n, 3), generator=g, device=cuda)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d[:2] = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], device=cuda)
    state = r.environment.state
    forms = {"env_sample": [(f"physical {p}", env_mod.sample_environment_cuda, env_mod.sample_environment_plain,
                             (state, rnd2, p)) for p in (False, True)],
             "env_lookup": [(f"lookup and pdf, physical {p}", env_mod.lookup_environment_pdf_cuda,
                             env_mod.lookup_environment_pdf_plain, (state, d, p)) for p in (False, True)]
             + [("lookup", env_mod.lookup_environment_cuda, env_mod.lookup_environment_plain, (state, d))]
             + [(f"pdf, physical {p}", env_mod.pdf_environment_cuda, env_mod.pdf_environment_plain, (state, d, p))
                for p in (False, True)]}
    for name, calls in forms.items():
        for label, cuda_fn, plain_fn, args in calls:
            before = kernels.LAUNCHES[name]
            got = cuda_fn(*args)
            launches = kernels.LAUNCHES[name] - before
            want = plain_fn(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if launches != 1 or not all(bits_equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{name} ({label}): {launches} launches, max abs {max_abs(got, want)} from the "
                                 "plain version")
            log(f"{name} ({label}): bit-equal at all {n} lanes of {width}x{height} in one launch")


def check_pyramid(r) -> None:
    """K3 on the default environment's 512^2 importance base, bit-equal to
    its plain version on every level, with its launches per build."""
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.pallas_ops import build_importance_pyramid_cuda, build_importance_pyramid_plain

    base = r.environment.state.imp_mips[0]
    before = kernels.LAUNCHES["importance_pyramid"]
    got = build_importance_pyramid_cuda(base)
    launches = kernels.LAUNCHES["importance_pyramid"] - before
    want = build_importance_pyramid_plain(base)
    bad = [tuple(a.shape) for a, b in zip(got, want) if not bits_equal(a, b)]
    if bad:
        raise SystemExit(f"importance pyramid levels {bad} differ from the plain version (max abs "
                         f"{max_abs(got, want)})")
    log(f"importance_pyramid: bit-equal on all {len(got)} levels, {launches} launches per build")


def tonemap_every_input(exposure: float, gamma: float) -> None:
    """K4 against its plain version at all 2^32 f32 bit patterns (NaN
    payloads, +-inf, denormals and negatives among them), 2^28 at a time:
    bit-equal, NaN included."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import tonemap_cuda, tonemap_plain

    chunk = 2**28
    bad = 0
    for first in range(-(2**31), 2**31, chunk):
        x = torch.arange(first, first + chunk, dtype=torch.int32, device="cuda").view(torch.float32).reshape(-1, 4)
        got = tonemap_cuda(x, exposure, gamma)
        bad += int((got.view(torch.int32) != tonemap_plain(x, exposure, gamma).view(torch.int32)).sum())
        del x, got
    if bad:
        raise SystemExit(f"tonemap differs from its plain version at {bad} of the 2^32 f32 inputs")
    log(f"tonemap: bit-equal to its plain version at all 2^32 f32 inputs (exposure {exposure}, gamma {gamma})")


def check_tonemap(exposure: float, gamma: float) -> None:
    """K4 on a 1920x1080x3 buffer of seeded radiances, bit-equal; then at
    every f32 input."""
    import torch

    from volxel_tpu_torch.render.pallas_ops import tonemap_cuda, tonemap_plain

    fb = np.random.default_rng(1).uniform(0.0, 4.0, (1920 * 1080, 3)).astype(np.float32)
    fb = torch.from_numpy(fb).cuda()
    got = tonemap_cuda(fb, exposure, gamma)
    want = tonemap_plain(fb, exposure, gamma)
    if not bits_equal(got, want):
        raise SystemExit(f"tonemap kernel differs from its plain version (max abs {max_abs([got], [want])})")
    log(f"tonemap: bit-equal on {fb.numel()} floats of a 1920x1080x3 buffer")
    tonemap_every_input(exposure, gamma)


def check_tile_march(r) -> None:
    """K5 and the shadow leg's step loop at every call of one 1080p raymarch
    sample (the legs of each bounce; lanes counted: those inside the box),
    bit-equal on state, hit, t and rgb, or state and tau, of every lane;
    then K6 on that sample's camera rays at 64 steps, bit-equal."""
    import volxel_tpu_torch.render.modes as modes
    from volxel_tpu_torch.render.tilemarch import (
        STEPS,
        tile_march_sample_cuda,
        tile_march_sample_plain,
        tile_march_sums_cuda,
        tile_march_sums_plain,
        tile_march_transmittance_cuda,
        tile_march_transmittance_plain,
    )

    sample, _ = check_every_call(r, modes, {
        "tile_march_sample": dict(cuda_fn=tile_march_sample_cuda, plain_fn=tile_march_sample_plain,
                                  outputs=("state", "hit", "t", "rgb"), lanes=lambda a: int(a[6].sum())),
        "tile_march_transmittance": dict(cuda_fn=tile_march_transmittance_cuda,
                                         plain_fn=tile_march_transmittance_plain, outputs=("state", "tau"),
                                         lanes=lambda a: int(a[6].sum())),
    })
    dense, ipos, idir, start, dt, far, valid, _, _, _, _, extent = sample["first_args"]
    args = (dense, ipos, idir, start, dt, far, valid, extent, STEPS)
    got, want = tile_march_sums_cuda(*args), tile_march_sums_plain(*args)
    if not bits_equal(got, want):
        raise SystemExit(f"tile_march_sums differs from its plain version (max abs {max_abs([got], [want])})")
    log(f"tile_march_sums: bit-equal on the {ipos.shape[0]} camera rays of that sample at {STEPS} steps "
        f"(mean sum {float(got.mean()):.4f})")


def check_shearwarp(r) -> None:
    """K7 on the 512^3 volume: at the bench view on the preview's fixed
    canvas (the main path's shape) and at STATIC_VIEW on its static
    canvas, against the plain slice loop on the card; then on the fixed
    canvas through the Renderer's default transfer (air transparent, a
    linear ramp to opaque white), where part of the tiles turn opaque, and
    at TRANSLUCENT times the bench's density, where none does (the kernel
    then composites every pixel-slice, as it would without its opaque-tile
    path). Bit-equal, or within 1e-6 where only the card's expf and ATen's
    exp can round apart."""
    import torch

    from volxel_tpu_torch.render import shearwarp
    from volxel_tpu_torch.transfer.function import DEFAULT_COLOR_STOPS, generate_transfer_function

    density = float(r.density_scale * r.settings.density_multiplier)
    default_lut = torch.as_tensor(generate_transfer_function(DEFAULT_COLOR_STOPS), dtype=torch.float32).cuda()
    for canvas, view, scale, lut in (("fixed", r._index_view_dir(), 1.0, r._lut),
                                     ("static", np.array(STATIC_VIEW), 1.0, r._lut),
                                     ("default-transfer fixed", r._index_view_dir(), 1.0, default_lut),
                                     ("translucent fixed", r._index_view_dir(), TRANSLUCENT, r._lut)):
        perm, flip, sx, sy = shearwarp.shear_parameters(view)
        vol = shearwarp.permuted_volume(r._device_grid.dense, perm, flip)
        sigma_dt = scale * density * float(np.sqrt(1.0 + sx * sx + sy * sy))
        args = (vol, lut, sx, sy, 1.0, sigma_dt, canvas != "static")
        got = shearwarp.shearwarp_intermediate_cuda(*args)
        want = shearwarp.shearwarp_intermediate_plain(*args)
        err = max_abs(got, want)
        equal = all(bits_equal(a, b) for a, b in zip(got, want))
        if not (equal or err <= 1e-6):
            raise SystemExit(f"shearwarp_intermediate ({canvas} canvas) differs from its plain version by {err}")
        t = got[1]
        log(f"shearwarp_intermediate ({canvas} canvas {tuple(t.shape)}, perm {perm}, flip {flip}, "
            f"s=({sx:.4f}, {sy:.4f})): {'bit-equal' if equal else f'within 1e-6 (max abs {err:.3e})'}; min t "
            f"{float(t.min()):.4f}, share of t == 0 {float((t == 0).float().mean()):.4f}")
        del vol, got, want
        torch.cuda.empty_cache()


# the kernels each mode's main path must launch
PATH_KERNELS = {
    "default": ("dda_leg_sample", "dda_leg_shadow", "lookup_transfer", "env_sample", "env_lookup",
                "importance_pyramid", "tonemap", "rng_seed", "rng_draw"),
    "raymarch": ("tile_march_sample", "tile_march_transmittance", "env_sample", "env_lookup", "importance_pyramid",
                 "tonemap", "rng_seed", "rng_draw"),
    "no_dda": ("track_leg_sample", "track_leg_shadow", "env_sample", "env_lookup", "importance_pyramid", "tonemap",
               "rng_seed", "rng_draw"),
    "preview": ("shearwarp_intermediate", "tonemap"),
}
# each mode's two legs, each one launch per bounce
MODE_LEGS = {"default": ("dda_leg_sample", "dda_leg_shadow"),
             "raymarch": ("tile_march_sample", "tile_march_transmittance"),
             "no_dda": ("track_leg_sample", "track_leg_shadow")}


def main_path(grid, width: int, height: int, mode: str) -> None:
    """The Renderer from construction to image() in one render mode, with
    every launch counter at 0 just before it starts; the counts checked
    just after."""
    import torch

    from volxel_tpu_torch import kernels

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    r = bench_renderer(grid, width, height, "cuda", mode)
    for _ in range(WARMUP_FRAMES):
        r.render_frame()
    launches_before = dict(kernels.LAUNCHES)
    for _ in range(ACCUMULATED_FRAMES):
        r.render_frame()
    counted = {k: kernels.LAUNCHES[k] - launches_before[k] for k in kernels.LAUNCHES}
    per_sample = {k: n / ACCUMULATED_FRAMES for k, n in counted.items()}
    img = r.image()
    launches = dict(kernels.LAUNCHES)
    raw = r._framebuffer
    log(f"main path ({mode}): {width}x{height}, {WARMUP_FRAMES} warm-up and {ACCUMULATED_FRAMES} accumulated "
        f"frames; launches per sample {per_sample}, peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"launches ({mode}): {launches}")
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise SystemExit(f"image() gave shape {img.shape} or non-finite values")
    mean = float(raw.mean())
    if not (bool(torch.isfinite(raw).all()) and mean > 0.0):
        raise SystemExit(f"framebuffer not finite or mean radiance {mean} <= 0")
    for name in PATH_KERNELS[mode]:
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the {mode} main path")
    # the LUT fetch runs once per default sample (the premultiplied pyramid)
    # and nowhere in the other modes' legs; each leg is one launch per
    # bounce
    if per_sample["lookup_transfer"] != (1 if mode == "default" else 0):
        raise SystemExit(f"the LUT fetch launched {per_sample['lookup_transfer']} times per {mode} sample")
    legs = tuple(per_sample[name] for name in MODE_LEGS[mode])
    if legs != (r.settings.bounces,) * 2:
        raise SystemExit(f"the {mode} legs launched {legs} times per sample at bounces {r.settings.bounces}")
    # the RNG seeds every pixel once a sample, in one launch
    if per_sample["rng_seed"] != 1:
        raise SystemExit(f"the RNG was seeded {per_sample['rng_seed']} times per {mode} sample")
    # the environment's warp and escape lookup, one launch each a bounce
    env = (per_sample["env_sample"], per_sample["env_lookup"], per_sample["gather_f32"])
    if env != (r.settings.bounces, r.settings.bounces, 0):
        raise SystemExit(f"the environment launched (env_sample, env_lookup, gather_f32) {env} times per {mode} "
                         f"sample at bounces {r.settings.bounces}")
    log(f"main path output ({mode}): mean radiance {mean:.6f}, image mean {float(img.mean()):.6f}; "
        f"{time.perf_counter() - t0:.1f} s")


def host_syncs(fn):
    """(output, where) of one call of `fn`: `where` lists the file:line of
    each synchronizing call PyTorch made inside it, which
    torch.cuda.set_sync_debug_mode("warn") reports as a warning."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def leg_host_syncs(grid, width: int, height: int, mode: str, bounces: int = 1) -> None:
    """One sample of `mode` at `bounces` with each of its legs (the mode's
    sample_volume and transmittance) called under host_syncs, which must
    first see a known sync to count: fails if a leg synchronizes with the
    host. Logs the repo's kernel launches in each leg."""
    import torch

    import volxel_tpu_torch.render.pathtrace as pathtrace
    from volxel_tpu_torch import kernels

    if not host_syncs(lambda: bool(torch.ones(1, device="cuda").any()))[1]:
        raise SystemExit("the host-sync count does not see bool() of a CUDA tensor")
    r = bench_renderer(grid, width, height, "cuda", mode, bounces)
    r.render_frame()  # warm
    syncs = {"camera": [], "shadow": []}
    launches = {"camera": 0, "shadow": 0}

    def watched(name, fn):
        def run(*args):
            before = sum(kernels.LAUNCHES.values())
            out, where = host_syncs(lambda: fn(*args))
            syncs[name] += where
            launches[name] += sum(kernels.LAUNCHES.values()) - before
            return out
        return run

    original = pathtrace.get_mode_functions

    def split(mode, physical_shadows=False):
        sample_volume, transmittance = original(mode, physical_shadows)
        return watched("camera", sample_volume), watched("shadow", transmittance)

    pathtrace.get_mode_functions = split
    try:
        r.render_frame()
    finally:
        pathtrace.get_mode_functions = original
    log(f"{mode} legs at bounces {bounces}: launches of the repo's kernels in the legs {launches}, host syncs in "
        f"the legs {({k: len(v) for k, v in syncs.items()})} at {syncs}")
    if any(syncs.values()):
        raise SystemExit(f"the {mode} legs synchronized with the host at {syncs}")


def check_image(img, width: int, height: int, what: str) -> None:
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise SystemExit(f"{what}: shape {img.shape} or non-finite values")
    if not float(img.max() - img.min()) > 1e-3:
        raise SystemExit(f"{what}: the image is constant ({float(img.min())})")


def preview_path(grid, width: int, height: int) -> None:
    """The interactive preview through the Renderer, with every launch
    counter at 0 just before it: render_preview() at each pose (its first
    call builds the permuted volume of its (principal axis, flip)), then
    render_dvr(screen=True) once; the counts checked just after; then K7
    held at each pose (hold_preview_poses)."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.render.shearwarp import shear_parameters

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    r = bench_renderer(grid, width, height, "cuda")
    keys, shears = [], []
    for pose in PREVIEW_POSES:
        r.camera.rotate_around_view(*pose)
        perm, flip, sx, sy = shear_parameters(r._index_view_dir())
        key = (perm, flip)
        shears.append((key, sx, sy))
        img = r.render_preview()
        check_image(img, width, height, f"render_preview at {key}")
        for _ in range(PREVIEW_REPEATS):
            r.render_preview()
        keys.append(key)
        log(f"preview {key}: image mean {float(img.mean()):.4f}")
    if len(set(keys)) != 6:
        raise SystemExit(f"the preview poses used {len(set(keys))} of the 6 (perm, flip) volumes: {keys}")
    check_image(r.render_dvr(screen=True), width, height, "render_dvr(screen=True)")
    launches = dict(kernels.LAUNCHES)
    calls = len(PREVIEW_POSES) * (1 + PREVIEW_REPEATS) + 1
    log(f"main path (preview): {width}x{height}, {len(PREVIEW_POSES)} poses x {1 + PREVIEW_REPEATS} previews and "
        f"render_dvr(screen=True): {calls} images, launches shearwarp_intermediate "
        f"{launches['shearwarp_intermediate']}, tonemap {launches['tonemap']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name in PATH_KERNELS["preview"]:
        if launches[name] <= 0:
            raise SystemExit(f"kernel {name} was not launched on the preview main path")
    hold_preview_poses(r, shears)


def hold_preview_poses(r, shears) -> None:
    """K7 alone at each preview pose, on that pose's cached volume and the
    fixed canvas: held to the plain slice loop (bit-equal, or within 1e-6
    where only expf and ATen's exp can round apart)."""
    from volxel_tpu_torch.render.shearwarp import shearwarp_intermediate_cuda, shearwarp_intermediate_plain

    density = float(r.density_scale * r.settings.density_multiplier)
    for (perm, flip), sx, sy in shears:
        args = (r._preview_volume(perm, flip), r._lut, sx, sy, 1.0,
                density * float(np.sqrt(1.0 + sx * sx + sy * sy)), True)
        got = shearwarp_intermediate_cuda(*args)
        want = shearwarp_intermediate_plain(*args)
        err = max_abs(got, want)
        equal = all(bits_equal(a, b) for a, b in zip(got, want))
        if not (equal or err <= 1e-6):
            raise SystemExit(f"shearwarp_intermediate at the preview's {(perm, flip)} pose differs from its plain "
                             f"version by {err}")
        log(f"shearwarp_intermediate at the preview's {(perm, flip)} pose, s=({sx:.4f}, {sy:.4f}): "
            f"{'bit-equal' if equal else f'within 1e-6 (max abs {err:.3e})'}")


def preview_parity(grid, size: int) -> None:
    """The preview at the first three poses on the card and on the CPU
    (plain versions): deterministic, so held to max abs err 1e-5 on the
    tonemapped image."""
    images = {}
    for device in ("cuda", "cpu"):
        r = bench_renderer(grid, size, size, device)
        images[device] = []
        for pose in PREVIEW_POSES[:3]:
            r.camera.rotate_around_view(*pose)
            images[device].append(r.render_preview())
    err = max(float(np.abs(a - b).max()) for a, b in zip(images["cuda"], images["cpu"]))
    log(f"parity {size}x{size} (preview, 3 poses): max abs err {err:.3e}")
    if not err <= PREVIEW_PARITY_ATOL:
        raise SystemExit(f"card and CPU previews differ by {err} > {PREVIEW_PARITY_ATOL}")


def parity(grid, size: int, mode: str, setting: str | None = None) -> None:
    """The same scene on the card and on the CPU, held to the slice
    contract; with `setting` ("gradient_shading" or "debug_hits") turned
    on. Debug hits, which draw nothing, are held to max abs err
    DEBUG_HITS_ATOL instead."""
    what = mode if setting is None else f"{mode}, {setting}"
    images = {}
    for device in ("cuda", "cpu"):
        r = bench_renderer(grid, size, size, device, mode)
        if setting is not None:
            setattr(r.settings, setting, True)
        for _ in range(PARITY_FRAMES):
            r.render_frame()
        images[device] = r._framebuffer.cpu().numpy().astype(np.float64)
    gpu, cpu = images["cuda"], images["cpu"]
    if setting == "debug_hits":
        err = float(np.abs(gpu - cpu).max())
        log(f"parity {size}x{size} ({what}): max abs err {err:.3e}, means {gpu.mean():.6f} (card) "
            f"{cpu.mean():.6f} (cpu)")
        if not (err <= DEBUG_HITS_ATOL and cpu.mean() > 0):
            raise SystemExit(f"card and CPU debug-hits renders ({mode}) differ by {err} > {DEBUG_HITS_ATOL}")
        return
    rel = np.abs(gpu - cpu) / (np.abs(cpu) + 1e-3)
    tight = float((rel.max(axis=-1) < 1e-3).mean())
    median = float(np.median(rel))
    means = (float(gpu.mean()), float(cpu.mean()))
    log(f"parity {size}x{size} ({what}): {tight:.4%} of pixels within 0.1%, median rel {median:.3e}, "
        f"means {means[0]:.6f} (card) {means[1]:.6f} (cpu)")
    if not (tight > 0.98 and median < 1e-4 and abs(means[0] - means[1]) < 5e-3 * max(means[1], 1e-3)):
        raise SystemExit(f"card and CPU renders ({what}) disagree beyond the parity contract")


# phase 2b: the reference's own benchmark spec (three entries, one per
# mode, at bounces 1, resolutionFactor 0.8 and 500 samples) on a DICOM zip
# and an HDR environment that the fixture writers make here
REFERENCE_SPEC = Path(__file__).resolve().parent / "tests" / "fixtures" / "reference_benchmark.json"
ENV_SIZE = (2048, 1024)


# phase 2b's comparisons: for each render mode, the kernels one sample
# launches, each as (module whose attribute the sample calls, that name,
# the CUDA entry, the plain version, the outputs held bit for bit); a
# gradient-shaded sample (`shaded`) makes one environment lookup and one
# shading launch (csrc/shade.cu), and no warp sample or escape
def spec_sample_kernels(mode: str, shaded: bool = False) -> list:
    import volxel_tpu_torch.render.modes as modes
    import volxel_tpu_torch.scene.environment as env_mod
    from volxel_tpu_torch.render import ddaleg, gather, shading, tilemarch, trackleg

    if shaded:
        taps = (env_mod, "lookup_environment_cuda", env_mod.lookup_environment_cuda,
                env_mod.lookup_environment_plain, ("le",))
    else:
        taps = (env_mod, "sample_environment_cuda", env_mod.sample_environment_cuda,
                env_mod.sample_environment_plain, ("le", "pdf", "w_i"))
        escape = (env_mod, "lookup_environment_pdf_cuda", env_mod.lookup_environment_pdf_cuda,
                  env_mod.lookup_environment_pdf_plain, ("le", "pdf"))
    if mode == "default":
        checks = [(modes, "dda_leg_sample", ddaleg.dda_leg_sample_cuda, ddaleg.dda_leg_sample_plain,
                   ("state", "hit", "t", "rgb", "budget")),
                  (modes, "dda_leg_shadow", ddaleg.dda_leg_shadow_cuda, ddaleg.dda_leg_shadow_plain,
                   ("state", "tr", "budget")),
                  (gather, "lookup_transfer_fetch", lut_fetch_cuda, gather.lookup_transfer_plain, ("rgba",)), taps]
    elif mode == "no_dda":
        checks = [(modes, "track_leg_sample", trackleg.track_leg_sample_cuda, trackleg.track_leg_sample_plain,
                   ("state", "hit", "t", "rgb", "events")),
                  (modes, "track_leg_shadow", trackleg.track_leg_shadow_cuda, trackleg.track_leg_shadow_plain,
                   ("state", "tr", "events")), taps]
    else:
        checks = [(modes, "tile_march_sample", tilemarch.tile_march_sample_cuda, tilemarch.tile_march_sample_plain,
                   ("state", "hit", "t", "rgb")),
                  (modes, "tile_march_transmittance", tilemarch.tile_march_transmittance_cuda,
                   tilemarch.tile_march_transmittance_plain, ("state", "tau")), taps]
    if shaded:
        return checks + [(shading, "shade_hits_cuda", shading.shade_hits_cuda, shading.shade_hits_plain,
                          ("radiance",))]
    return checks + [escape]


def mask_lanes(args) -> int:
    """The lanes of a leg call, by its 1-D bool mask of running lanes (0
    for the table fetches, which take none)."""
    import torch

    return max((a.numel() for a in args if isinstance(a, torch.Tensor) and a.dtype == torch.bool and a.dim() == 1),
               default=0)


def held_sample_kernels(fn, mode: str, shaded: bool = False) -> tuple:
    """fn() with each kernel of a `mode` sample (spec_sample_kernels: the
    legs, the environment's warp sample and escape lookup, or a
    gradient-shaded sample's lookup, the default mode's LUT fetch) held bit
    for bit against its plain version at every call. Returns fn's result
    and [(name, tally)] in the order of the checks."""
    checks = spec_sample_kernels(mode, shaded)
    with contextlib.ExitStack() as stack:
        tallies = [stack.enter_context(compared_calls(module, name, cuda_fn, plain_fn, outputs, mask_lanes))
                   for module, name, cuda_fn, plain_fn, outputs in checks]
        out = fn()
    return out, [(name, tally) for (_, name, *_), tally in zip(checks, tallies)]


def hold_frame_kernels(r, what: str) -> None:
    """One render_frame() of `r` with each kernel of its mode's sample held
    bit for bit against its plain version at every call
    (held_sample_kernels), then K4 at image(); fails unless each was
    called. Launches made here are not the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops

    _, tallies = held_sample_kernels(r.render_frame, r.render_mode, r.settings.gradient_shading)
    with compared_calls(pallas_ops, "tonemap_cuda", pallas_ops.tonemap_cuda, pallas_ops.tonemap_plain,
                        ("image",)) as tonemap:
        img = r.image()
    # a warm-up frame renders, and image() tonemaps, the low-res preview
    w, h = r._warmup_preview[:2] if r._warmup_preview is not None else r._render_dims()
    for name, tally in (*tallies, ("tonemap", tonemap)):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in one {r.render_mode} sample of {what}")
        log(f"{what}, {r.render_mode} ({w}x{h}): {name} bit-equal at all {tally['calls']} calls of one sample")
    if not np.isfinite(img).all():
        raise SystemExit(f"image() of the held {r.render_mode} sample of {what} is not finite")


def hold_spec_kernels(r, spec: dict) -> None:
    """Every kernel of the reference spec's path against its plain version
    on the spec's own inputs: the spec renderer's ingested grid and loaded
    map. For each entry, with its settings on `r`, one render_frame() (the
    first frame after the restart, which image() then shows alone) held at
    every call (hold_frame_kernels); K3 on the map's 512^2 importance base.
    Launches made here are not the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops
    from volxel_tpu_torch.api.benchmark import apply_entry_settings

    for entry in spec["benchmarks"]:
        apply_entry_settings(spec, entry, r)
        hold_frame_kernels(r, "reference spec")
    base = r.environment.state.imp_mips[0]
    got = pallas_ops.build_importance_pyramid_cuda(base)
    want = pallas_ops.build_importance_pyramid_plain(base)
    bad = [tuple(a.shape) for a, b in zip(got, want) if not bits_equal(a, b)]
    if bad:
        raise SystemExit(f"importance pyramid of the loaded map: levels {bad} differ from the plain version "
                         f"(max abs {max_abs(got, want)})")
    log(f"reference spec: importance_pyramid bit-equal on all {len(got)} levels of the loaded map's "
        f"{base.shape[0]}x{base.shape[1]} base")


def ingest_and_reference_benchmark(size: int, env_size: tuple, width: int, height: int, spec_path: Path, tmp: Path,
                                   device="cuda") -> tuple:
    """Phase 2b: from DICOM bytes to the reference's benchmark records
    through the port's entry points, with every launch counter at 0 just
    before Renderer.from_attributes and read just after; then every kernel
    of that path held against its plain version on its inputs. Writes the
    zip and the HDR map into `tmp` and returns their paths."""
    import torch

    from volxel_tpu_torch import Renderer, kernels
    from volxel_tpu_torch.api import benchmark
    from volxel_tpu_torch.grid import grid_differences
    from volxel_tpu_torch.grid.brick import construct_brick_grid
    from volxel_tpu_torch.ingest import series as series_mod
    from volxel_tpu_torch.ingest import ziploader
    from volxel_tpu_torch.ingest.hdr import decode_env_bytes
    from volxel_tpu_torch.native import loader
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume, synthetic_env_hdr, write_dicom_zip
    from volxel_tpu_torch.utils.profiling import fence_device

    t_phase = time.perf_counter()
    if not loader.native_available():
        raise SystemExit(f"the native ingest library did not build or load: {loader._load_error}")
    cuda = torch.device(device).type == "cuda"
    spec = json.loads(spec_path.read_text())
    # 1. the DICOM zip, deflated as users' archives are
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    zip_path = tmp / f"ct{size}.zip"
    zip_path.write_bytes(write_dicom_zip(vol, bits_stored=12))
    del vol
    log(f"ingest: wrote {zip_path.name} ({size} slices of {size}x{size}, 12-bit, deflated), "
        f"{zip_path.stat().st_size} bytes (the fixture writer, not the port)")

    # 2. the ingest on the native path; the grid again on numpy
    series = ziploader.read_zip_series(zip_path.read_bytes())
    grid = series_mod.series_to_grid(series)
    grad, gmin, gmax = series.histogram_gradient()
    plain = construct_brick_grid(series.normalized(), transform=series.transform, min_maj=(0.0, 1.0),
                                 histogram=series.histogram, histogram_gradient=grad,
                                 histogram_gradient_range=(gmin, gmax), use_native=False)
    differ = grid_differences(grid, plain)
    log(f"ingest ({size}^3, native): {grid.brick_counter} bricks in the atlas; native and numpy grids "
        f"{'bit-equal' if not differ else 'differ in ' + ', '.join(differ)}")
    if differ:
        raise SystemExit(f"the native and numpy brick grids differ in {differ}")
    del series, grid, plain

    # 3. the environment, decoded on the host and built on the device
    env_path = tmp / "sky.hdr"
    env_path.write_bytes(synthetic_env_hdr(*env_size))
    env_bytes = env_path.read_bytes()
    image = decode_env_bytes(env_bytes)
    r = Renderer(width, height, device=device)
    fence_device(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated() if cuda else 0
    before = kernels.LAUNCHES["importance_pyramid"]
    r.load_env(env_bytes)
    fence_device(device)
    k3 = kernels.LAUNCHES["importance_pyramid"] - before
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**20 if cuda else float("nan")
    log(f"load_env ({env_size[0]}x{env_size[1]} HDR, {len(env_bytes)} bytes): importance-pyramid launches {k3}; "
        f"peak device memory above the renderer's {peak:.1f} MiB")
    if image.shape[:2] != (env_size[1], env_size[0]) or (cuda and k3 != 1):
        raise SystemExit(f"load_env decoded {image.shape} and launched the pyramid {k3} times (want 1)")
    del r, image
    if cuda:
        torch.cuda.empty_cache()

    # 4. the spec, through from_attributes; image() after each entry
    looks = []
    run_single = benchmark.run_single_benchmark

    def run_and_look(renderer, name=None, warmup=1):
        rec = run_single(renderer, name=name, warmup=warmup)
        img = renderer.image()
        looks.append((img.shape, bool(np.isfinite(img).all()), float(img.max()), float(img.mean())))
        return rec

    benchmark.run_single_benchmark = run_and_look
    try:
        fence_device(device)
        kernels.reset_launch_counts()
        r = Renderer.from_attributes(width=width, height=height, zip_path=zip_path, env_path=env_path,
                                     benchmark_path=spec_path, device=device)
        fence_device(device)
        launches = dict(kernels.LAUNCHES)
    finally:
        benchmark.run_single_benchmark = run_single
    records = r.last_benchmark
    log(f"reference spec ({spec_path.name}): launches {launches}")
    log(f"reference spec device: {json.dumps(records[0]['device'])}")
    for rec, (shape, finite, peak_value, mean) in zip(records, looks):
        log("reference spec record: " + json.dumps(
            {"name": rec["name"], "mode": rec["settings"]["renderMode"], "viewport": rec["viewport"],
             "samples": rec["settings"]["maxSamples"], "bounces": rec["settings"]["bounces"],
             "timePerSample": rec["timePerSample"], "totalTime": rec["totalTime"], "image_mean": mean}))
    if len(records) != len(spec["benchmarks"]) or len(looks) != len(records):
        raise SystemExit(f"{len(records)} records and {len(looks)} images for {len(spec['benchmarks'])} entries")
    for rec, entry, (shape, finite, peak_value, mean) in zip(records, spec["benchmarks"], looks):
        tps = rec["timePerSample"]
        w, h = rec["viewport"][2:]
        if rec["settings"]["renderMode"] != entry["renderMode"] or not (np.isfinite(tps) and tps > 0):
            raise SystemExit(f"record {rec['settings']['renderMode']}: timePerSample {tps}")
        if shape != (h, w, 3) or not finite or not peak_value > 0.0:
            raise SystemExit(f"image() after the {entry['renderMode']} entry: shape {shape}, finite {finite}, "
                             f"max {peak_value}")
    if cuda:
        acc = records[0]["device"]["accelerator"]
        if acc["platform"] != "gpu" or not records[0]["device"].get("powerLimit"):
            raise SystemExit(f"the records' fingerprint lacks the card or its power limit: {records[0]['device']}")
        modes = {e["renderMode"] for e in spec["benchmarks"]}
        for name in sorted({k for m in modes for k in PATH_KERNELS[m]}):
            if launches[name] <= 0:
                raise SystemExit(f"kernel {name} was not launched on the reference spec's path")
        if launches["importance_pyramid"] != 2:  # the default environment, then load_env
            raise SystemExit(f"the importance pyramid launched {launches['importance_pyramid']} times (want 2)")
        hold_spec_kernels(r, spec)
    del r
    if cuda:
        torch.cuda.empty_cache()
    log(f"phase 2b (ingest and the reference benchmark): {time.perf_counter() - t_phase:.1f} s")
    return zip_path, env_path


# phase 2c: the app path. The preview server (`serve`'s default size) on
# the zip and the HDR map that phase 2b writes, driven over HTTP; gradient
# shading and debug hits through the Renderer at the main paths' size; the
# CLI in subprocesses
APP_SIZE = (960, 540)
APP_SETTINGS = ("gradient_shading", "debug_hits", "warmup_low_res")
APP_WAIT = 120.0  # the longest wait, in seconds, for a served frame or a result
DRAGS = 3  # rotate commands, each followed by its first preview
SERVER_BENCH_SAMPLES = 16
DEBUG_HITS_ATOL = 1e-5
CLI_RENDER = ("render", "--synthetic", "256", "--size", "512x512", "--samples", "16")
# every kernel the app path launches (K6 and gather_f32 lie on no render path;
# the gradient-shading setting's frames launch the shading)
APP_KERNELS = tuple(sorted({name for names in PATH_KERNELS.values() for name in names} | {"shade"}))


def http(base: str, path: str, body=None) -> tuple:
    """(status, content type, body) of a GET of `path`, or of a POST of
    `body` as JSON."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST")
    with urllib.request.urlopen(request, timeout=APP_WAIT) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def wait_until(fn, what: str):
    """fn()'s first truthy value, polled for at most APP_WAIT seconds."""
    deadline = time.monotonic() + APP_WAIT
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.005)
    raise SystemExit(f"app: no {what} within {APP_WAIT} s")


def next_served(served: list, since: float, preview: bool = False, **want) -> dict:
    """The first frame the server encoded after `since` (perf_counter
    seconds), a drag preview or a progressive frame, whose record holds
    `want`."""
    def find():
        return next((rec for rec in list(served) if rec["t"] > since and rec["preview"] == preview
                     and all(rec[k] == v for k, v in want.items())), None)

    return wait_until(find, f"{'preview' if preview else 'frame'} served with {want}")


def served_frame(base: str, width: int, height: int, what: str) -> np.ndarray:
    """GET /frame.png, decoded; fails unless it has the size and is not black."""
    from volxel_tpu_torch.utils.png import decode_png

    status, ctype, png = http(base, "/frame.png")
    img = decode_png(png)
    if status != 200 or ctype != "image/png" or img.shape != (height, width, 3) or not img.max() > 0:
        raise SystemExit(f"app: /frame.png after {what}: {status} {ctype}, {img.shape}, max {img.max()}")
    return img


def hold_app_kernels(r, preview_scale: float) -> None:
    """Every kernel of the app path against its plain version on the
    server's renderer `r` at the shapes the server gave it: one frame in
    each mode (every call of every bounce, hold_frame_kernels), one
    default-mode warm-up frame (its legs at 0.33 of the size and K4 on its
    image()) and one drag preview at `preview_scale` (hold_drag_preview).
    Launches made here are not the main path's."""
    # default last: the server's warm-up frame was a default-mode one
    for mode in ("raymarch", "no_dda", "default"):
        r.render_mode = mode
        hold_frame_kernels(r, f"app path, bounces {r.settings.bounces}")
    r.settings.warmup_low_res = True
    r.restart_rendering()
    hold_frame_kernels(r, "app path warm-up")
    r.settings.warmup_low_res = False
    r.restart_rendering()
    hold_drag_preview(r, preview_scale, "app path")


def hold_drag_preview(r, preview_scale: float, what: str) -> None:
    """One drag preview of `r` at `preview_scale` with K7 held to its plain
    version (bit-equal, or within 1e-6 where only the card's expf and
    ATen's exp can round apart, as check_shearwarp holds it) and K4
    bit-equal; fails unless each was called. Launches made here are not
    the main path's."""
    import volxel_tpu_torch.render.pallas_ops as pallas_ops
    from volxel_tpu_torch.render import shearwarp

    with compared_calls(shearwarp, "shearwarp_intermediate_cuda", shearwarp.shearwarp_intermediate_cuda,
                        shearwarp.shearwarp_intermediate_plain, ("colour", "transmittance"), atol=1e-6) as k7, \
            compared_calls(pallas_ops, "tonemap_cuda", pallas_ops.tonemap_cuda, pallas_ops.tonemap_plain,
                           ("image",)) as k4:
        img = r.render_preview(scale=preview_scale)
    h, w = img.shape[:2]
    for name, tally in (("shearwarp_intermediate", k7), ("tonemap", k4)):
        if tally["calls"] == 0:
            raise SystemExit(f"{name} was not called in a {w}x{h} drag preview of the {what}")
        agree = "bit-equal" if tally["equal"] else f"within 1e-6 (max abs {tally['err']:.3e})"
        log(f"{what} drag preview ({w}x{h}): {name} {agree} at all {tally['calls']} calls")
    check_image(img, w, h, f"the {what}'s held drag preview")


def app_server(zip_path: Path, env_path: Path, device="cuda") -> None:
    """The preview server on `device`, over HTTP on an ephemeral port, with
    every launch counter at 0 just before its renderer loads the zip and
    the map (Renderer.from_attributes, then bench.py's framing and transfer)
    and read after the server stopped: each route, drag previews, each of
    APP_SETTINGS, the raymarch and no_dda modes, the server's benchmark and
    the first fallback histogram (the dense field copied to the host)."""
    import torch

    from volxel_tpu_torch import Renderer, kernels
    from volxel_tpu_torch.api import server as server_mod
    from volxel_tpu_torch.utils.profiling import fence_device

    cuda = torch.device(device).type == "cuda"
    width, height = APP_SIZE
    t_phase = time.perf_counter()
    fence_device(device)
    kernels.reset_launch_counts()
    r = Renderer.from_attributes(width=width, height=height, zip_path=zip_path, env_path=env_path, device=device)
    bench_look(r)
    s = server_mod.PreviewServer(r, port=0)
    served = []
    encode_frame = s._encode_frame

    def recorded(img=None):
        encode_frame(img)
        served.append({"t": time.perf_counter(), "preview": img is not None, "mode": r.render_mode,
                       "frame": r.frame_index, **{name: getattr(r.settings, name) for name in APP_SETTINGS}})

    s._encode_frame = recorded
    t_start = time.perf_counter()
    base = f"http://127.0.0.1:{s.start()}"
    try:
        status, ctype, page = http(base, "/")
        if status != 200 or ctype != "text/html" or b"</html>" not in page:
            raise SystemExit(f"app: GET / gave {status} {ctype}, {len(page)} bytes")
        next_served(served, t_start)
        img = served_frame(base, width, height, "the first frame")
        log(f"app: first frame served; /frame.png {img.shape}, mean {img.mean():.2f} of 255")
        state = json.loads(http(base, "/state")[2])
        if (state["width"], state["height"]) != APP_SIZE or state["samples"] <= 0 or state["error"] is not None:
            raise SystemExit(f"app: /state {state['width']}x{state['height']}, samples {state['samples']}, "
                             f"error {state['error']}")
        hist = json.loads(http(base, "/histogram")[2])
        transfer = json.loads(http(base, "/transfer")[2])
        if not hist["bars"] or transfer["type"] != "color_stops" or len(transfer["colors"]) != len(BENCH_TRANSFER):
            raise SystemExit(f"app: /histogram {len(hist['bars'])} bars, /transfer {transfer}")
        fallback = s._fallback_histogram()
        log(f"app: /histogram (the ingest's histogram) {len(hist['bars'])} bars; the fallback histogram (the "
            f"{'x'.join(map(str, r._device_grid.dense.shape))} bf16 field to the host as f32, np.histogram) "
            f"{int(fallback[0].sum())} voxels")

        before = dict(kernels.LAUNCHES)
        t_drag = time.perf_counter()
        for _ in range(DRAGS):
            wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the last drag's motion")
            t0 = time.perf_counter()
            http(base, "/input", {"type": "rotate", "by": [0.05, 0.02]})
            next_served(served, t0, preview=True)
        wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the last drag's motion")
        next_served(served, time.perf_counter())
        drag = {name: kernels.LAUNCHES[name] - before[name] for name in ("shearwarp_intermediate", "tonemap")}
        previews = sum(1 for rec in list(served) if rec["preview"] and rec["t"] > t_drag)
        log(f"app: {DRAGS} rotate commands, each followed by a preview; {previews} previews at "
            f"{r.width // 2}x{r.height // 2} served while the motion lasted; launches over the drags {drag}")
        if cuda and not (drag["shearwarp_intermediate"] >= previews >= DRAGS and drag["tonemap"] >= previews):
            raise SystemExit(f"app: {previews} previews served with launches {drag}")

        for name in APP_SETTINGS:
            t0 = time.perf_counter()
            http(base, "/settings", {name: True})
            rec = next_served(served, t0, **{name: True})
            served_frame(base, width, height, f"{name} on")
            log(f"app: {name} on: frame {rec['frame']} served after the POST")
            http(base, "/settings", {name: False})
        next_served(served, time.perf_counter(), **dict.fromkeys(APP_SETTINGS, False))

        for mode in ("raymarch", "no_dda", "default"):
            t0 = time.perf_counter()
            http(base, "/input", {"type": "render_mode", "mode": mode})
            next_served(served, t0, mode=mode)
            served_frame(base, width, height, f"render_mode {mode}")
            log(f"app: render_mode {mode}: a frame served after the POST")

        http(base, "/benchmark", {"samples": SERVER_BENCH_SAMPLES})

        def result():
            b = json.loads(http(base, "/benchmark_result")[2])
            return b if b.get("running") is False and "time_per_sample_ms" in b else None

        bench = wait_until(result, "benchmark result")
        fingerprint = bench["device"]
        log(f"app: /benchmark of {SERVER_BENCH_SAMPLES} samples: {bench['done']} samples; device "
            f"{json.dumps(fingerprint['accelerator'])}, power limit {fingerprint.get('powerLimit')}")
        if cuda and (fingerprint["accelerator"]["kind"] != torch.cuda.get_device_name(0)
                     or not fingerprint.get("powerLimit")):
            raise SystemExit(f"app: the benchmark's device lacks the card or its power limit: {fingerprint}")
        state = json.loads(http(base, "/state")[2])
        if state["error"] is not None:
            raise SystemExit(f"app: the server reports {state['error']}")
    finally:
        s.stop()
    if s._render_thread.is_alive():
        raise SystemExit("app: the render thread outlived stop()")
    launches = dict(kernels.LAUNCHES)
    log(f"app: launches over the server's run {launches}")
    if cuda:
        for name in APP_KERNELS:
            if launches[name] <= 0:
                raise SystemExit(f"kernel {name} was not launched on the app path")
        hold_app_kernels(r, s.preview_scale)
    log(f"app: the server and its held kernels {time.perf_counter() - t_phase:.1f} s")


def gradient_and_debug_hits(grid, width: int, height: int) -> None:
    """Through the Renderer on the card at width x height: in each mode a
    gradient-shaded sample (one launch of each leg and of the shading),
    then one more with each kernel of the sample held bit for bit at every
    call (hold_frame_kernels); a debug-hits sample, which launches no leg
    and no LUT fetch, and its image() one K4."""
    import torch

    from volxel_tpu_torch import kernels

    legs = {name for names in MODE_LEGS.values() for name in names}
    for mode, (camera, shadow) in MODE_LEGS.items():
        r = bench_renderer(grid, width, height, "cuda", mode)
        r.settings.gradient_shading = True
        r.render_frame()
        before = dict(kernels.LAUNCHES)
        r.render_frame()
        sample = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
        log(f"gradient shading ({mode}, {width}x{height}): launches a sample {sample}")
        if (sample.get(camera), sample.get(shadow), sample.get("shade")) != (1, 1, 1):
            raise SystemExit(f"a gradient-shaded {mode} sample launched its legs and shading {sample}")
        hold_frame_kernels(r, "gradient shading")
        del r
        torch.cuda.empty_cache()
    r = bench_renderer(grid, width, height, "cuda")
    r.settings.debug_hits = True
    r.render_frame()
    before = dict(kernels.LAUNCHES)
    r.render_frame()
    frame = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
    before = dict(kernels.LAUNCHES)
    img = r.image()
    shown = {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}
    log(f"debug hits ({width}x{height}): launches {frame} (env_lookup: the environment behind the box); image() "
        f"launches {shown}")
    if (legs | {"lookup_transfer", "shearwarp_intermediate", "tonemap"}) & set(frame) or shown != {"tonemap": 1}:
        raise SystemExit(f"a debug-hits sample launched {frame} and its image() {shown}")
    check_image(img, width, height, "debug hits")


def cli_path(tmp: Path) -> None:
    """`python -m volxel_tpu_torch render` (CLI_RENDER) and `info` in
    subprocesses from this checkout, on the card; the PNG is decoded here."""
    from volxel_tpu_torch.utils.png import decode_png

    root = Path(__file__).resolve().parent
    out = tmp / "cli.png"
    for args in ((*CLI_RENDER, "--out", str(out)), ("info",)):
        run = subprocess.run([sys.executable, "-m", "volxel_tpu_torch", *args], cwd=root, capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            raise SystemExit(f"python -m volxel_tpu_torch {' '.join(args)} exited {run.returncode}:\n"
                             f"{run.stderr[-3000:]}")
        log(f"cli: {' '.join(args[:1])}: " + " | ".join(line.strip() for line in run.stdout.strip().splitlines()[-4:]))
    img = decode_png(out.read_bytes())
    size = tuple(int(v) for v in CLI_RENDER[CLI_RENDER.index("--size") + 1].split("x"))
    if img.shape != (size[1], size[0], 3) or not img.max() > 0:
        raise SystemExit(f"the CLI's PNG is {img.shape} with max {img.max()}")
    if "native ingest: available" not in run.stdout or '"platform": "gpu"' not in run.stdout:
        raise SystemExit(f"`info` did not report the card and the native library: {run.stdout}")


# phase 2d: the mesh (parallel/). A DistributedRenderer on a 2x2 mesh whose
# four positions name one card, in each mode; render_views; two processes
# joined over gloo; step statistics; the preview server over a
# DistributedRenderer and `serve --mesh 1,1,1`; positions on two cards
# where the machine has them.
MESH = (2, 2)  # sp, px
MESH_STEPS = 3  # steps a mode, each sp samples
VIEWS = 4
MESH_SERVER_SIZE = (960, 540)
MESH_BENCH_SAMPLES = 4
MESH_WORKER_TIMEOUT = 420.0  # seconds, each of the two processes
CLI_SERVE = ("serve", "--synthetic", "64", "--size", "320x180", "--mesh", "1,1,1")
# phase 2e's: the volume in two slabs, both positions on the one card
CLI_SERVE_SLABS = ("serve", "--synthetic", "64", "--size", "320x180", "--mesh", "1,1,2", "--device", "cuda:0")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_renderer(grid, width: int, height: int, mesh, mode: str = "default"):
    """A DistributedRenderer on `mesh` with bench.py's scene and look."""
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer

    r = DistributedRenderer(width, height, mesh=mesh)
    r.restart_from_grid(grid)
    r.render_mode = mode
    r.settings.bounces = 1
    bench_look(r)
    return r


def mesh_steps(grid, width: int, height: int, device="cuda") -> dict:
    """The 2x2 mesh on one device named four times, MESH_STEPS steps in
    each mode, with every launch counter at 0 before the first mode: the
    framebuffer bit-equal to the replayed single-position samples
    (tests/torch_mesh.py), each leg sp * px launches a step and the LUT
    fetch one a default step (one card), image() checked; then one more
    step with every kernel held at every call (hold_frame_kernels).
    Returns the path's launch counts."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.parallel import make_mesh

    cuda = torch.device(device).type == "cuda"
    sp, px = MESH
    mesh = make_mesh(sp=sp, px=px, devices=[device] * (sp * px))
    kernels.reset_launch_counts()
    for mode, legs in MODE_LEGS.items():
        r = mesh_renderer(grid, width, height, mesh, mode)
        before = dict(kernels.LAUNCHES)
        for _ in range(MESH_STEPS):
            r.render_frame()
        per_step = {k: (kernels.LAUNCHES[k] - before[k]) / MESH_STEPS for k in kernels.LAUNCHES}
        want = replayed_framebuffer(r, MESH_STEPS)
        if not bits_equal(r._framebuffer, want):
            raise SystemExit(f"mesh {sp}x{px} ({mode}): the framebuffer differs from the replayed single-position "
                             f"samples (max abs {max_abs([r._framebuffer], [want])})")
        check_image(r.image(), width, height, f"mesh {sp}x{px} ({mode}) image()")
        log(f"mesh {sp}x{px} on one device ({mode}, {width}x{height}): framebuffer bit-equal to the replayed "
            f"samples after {MESH_STEPS} steps ({r.samples_rendered()} samples); launches a step "
            f"{ {k: v for k, v in per_step.items() if v} }")
        if cuda and any(per_step[name] != sp * px * r.settings.bounces for name in legs):
            raise SystemExit(f"mesh ({mode}): the legs launched {[per_step[n] for n in legs]} times a step")
        if cuda and per_step["lookup_transfer"] != (1 if mode == "default" else 0):
            raise SystemExit(f"mesh ({mode}): the LUT fetch launched {per_step['lookup_transfer']} times a step")
        launches = dict(kernels.LAUNCHES)
        if cuda:
            hold_frame_kernels(r, f"mesh {sp}x{px} step")
        kernels.LAUNCHES.update(launches)  # the holds' launches are not the path's
        del r
    return dict(kernels.LAUNCHES)


def mesh_views(grid, width: int, height: int, device="cuda") -> None:
    """render_views of VIEWS views at width x height in the default mode:
    one wavefront, each leg one launch a call, each view bit-equal to
    render_sample at frame * VIEWS + view; then, after the counts are read,
    one more call with every kernel it launches held bit for bit against
    its plain version at every call, at the call's own shapes (VIEWS x
    width x height lanes; held_sample_kernels), bit-equal to the first."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.parallel.multiview import render_views
    from volxel_tpu_torch.render.pathtrace import render_sample

    cuda = torch.device(device).type == "cuda"
    r = bench_renderer(grid, width, height, device)
    config = r._config()
    cams = []
    for _ in range(VIEWS):
        r.camera.rotate_around_view(0.3, 0.0)
        cams.append(r._camera_operands(config))
    inv_views = torch.stack([c[0] for c in cams])
    inv_projs = torch.stack([c[1] for c in cams])
    ops = (r._device_grid, r.volume_params(), r._lut, r.environment.state)
    frame = 1
    before = dict(kernels.LAUNCHES)
    views = render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame)
    calls = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES if kernels.LAUNCHES[k] != before[k]}
    for v in range(VIEWS):
        one = render_sample(config, *ops, cams[v][0], cams[v][1], cams[v][2], frame * VIEWS + v)
        if not bits_equal(views[v], one):
            raise SystemExit(f"render_views: view {v} differs from render_sample at {frame * VIEWS + v} "
                             f"(max abs {max_abs([views[v]], [one])})")
    log(f"render_views ({VIEWS} views, {width}x{height}, default): every view bit-equal to render_sample at frame "
        f"* {VIEWS} + view; launches a call {calls}")
    if cuda and (calls.get("dda_leg_sample"), calls.get("dda_leg_shadow")) != (1, 1):
        raise SystemExit(f"render_views launched its legs {calls} times in one call")
    if cuda:
        held, tallies = held_sample_kernels(
            lambda: render_views(config, *ops, inv_views, inv_projs, cams[0][2], frame), "default")
        for name, tally in tallies:
            if tally["calls"] == 0:
                raise SystemExit(f"{name} was not called in the held render_views call")
            log(f"render_views ({VIEWS} views, {width}x{height}) held: {name} bit-equal at all {tally['calls']} "
                f"calls ({tally['lanes']} leg lanes in all)")
        if not bits_equal(held, views):
            raise SystemExit("render_views: the held call differs from the first")
        legs = dict(tallies)
        if legs["dda_leg_sample"]["lanes"] != VIEWS * width * height:
            raise SystemExit(f"render_views: the held camera leg ran {legs['dda_leg_sample']['lanes']} lanes")


def mesh_worker(addr: str, pid: int, size: int, width: int, height: int) -> None:
    """One of two processes on the card, joined over gloo: the bench scene,
    a DistributedRenderer whose sp = 2 spans the two processes (the mesh's
    default, every card of every process); its first step is bit-equal to
    the mean of samples 0 and 1 rendered here, and MESH_STEPS steps to the
    replayed samples. Prints one JSON line."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, process_info
    from volxel_tpu_torch.render.pathtrace import render_sample
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    if not initialize_multihost(addr, 2, pid, backend="gloo"):
        raise SystemExit("mesh worker: initialize_multihost did not join the group")
    info = process_info()
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    r = mesh_renderer(grid, width, height, make_mesh(sp=2, px=1))
    r.render_frame()
    ops = sample_operands(r)
    mean01 = (render_sample(*ops, 0) + render_sample(*ops, 1)) / 2
    first = bits_equal(r._framebuffer, mean01)
    for _ in range(MESH_STEPS - 1):
        r.render_frame()
    replayed = bits_equal(r._framebuffer, replayed_framebuffer(r, MESH_STEPS))
    print(json.dumps({"pid": pid, "info": info, "mesh": repr(r.mesh), "first_step_is_mean_of_0_1": first,
                      "replayed": replayed, "mean": float(r._framebuffer.mean())}), flush=True)
    torch.distributed.destroy_process_group()


def nccl_world_of_one(addr: str, width: int, height: int) -> None:
    """A process group of one process on NCCL (NCCL refuses two ranks on
    one card): multihost.all_gather of a frame-sized CUDA buffer of two
    positions goes through NCCL unstaged and returns it unchanged. Prints
    one JSON line."""
    import torch

    from volxel_tpu_torch.parallel import multihost

    torch.distributed.init_process_group("nccl", init_method=f"tcp://{addr}", world_size=1, rank=0)
    buf = torch.rand((2, width * height, 3), device="cuda")
    gathered = multihost.all_gather(buf)
    ok = (torch.distributed.get_backend() == "nccl" and len(gathered) == 1 and gathered[0].is_cuda
          and bits_equal(gathered[0], buf))
    print(json.dumps({"nccl_all_gather_equal": ok}), flush=True)
    torch.distributed.destroy_process_group()


def worker_pair(flags, size: int, width: int, height: int, timeout: float, what: str, count: int = 2) -> list[dict]:
    """Run `chip_smoke.py` with flags(addr, pid) for pids 0 .. count - 1
    (two by default) at once, joined at a free localhost port, each under
    `timeout`; fails unless all exit 0. Returns the JSON record each
    printed last."""
    addr = f"127.0.0.1:{free_port()}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), *flags(addr, pid), "--size", str(size),
                               "--width", str(width), "--height", str(height)],
                              cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(count)]
    outs = []
    try:
        for p in procs:
            outs.append((p, *p.communicate(timeout=timeout)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out, err in outs:
        if p.returncode != 0:
            raise SystemExit(f"{what} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def mesh_processes(size: int, width: int, height: int) -> None:
    """Two processes on the card (mesh_worker), over gloo: each reports 2
    processes, a first step equal to the mean of samples 0 and 1 and the
    replayed framebuffer after MESH_STEPS steps; then NCCL in a process
    group of one (nccl_world_of_one)."""
    root = Path(__file__).resolve().parent
    for rec in worker_pair(lambda addr, pid: ["--mesh-worker", addr, str(pid)], size, width, height,
                           MESH_WORKER_TIMEOUT, "mesh worker"):
        if not (rec["info"]["process_count"] == 2 and rec["info"]["distributed"] and rec["first_step_is_mean_of_0_1"]
                and rec["replayed"]):
            raise SystemExit(f"mesh worker {rec['pid']}: {rec}")
        log(f"two processes over gloo, sp=2 across them ({width}x{height}, default): process {rec['pid']} "
            f"{rec['info']}, {rec['mesh']}; first step bit-equal to the mean of samples 0 and 1, {MESH_STEPS} steps "
            f"to the replayed samples; mean radiance {rec['mean']:.6f}")
    run = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--mesh-nccl", f"127.0.0.1:{free_port()}",
                          "--width", str(width), "--height", str(height)], cwd=root, capture_output=True, text=True,
                         timeout=MESH_WORKER_TIMEOUT)
    if run.returncode != 0 or not json.loads(run.stdout.strip().splitlines()[-1])["nccl_all_gather_equal"]:
        raise SystemExit(f"NCCL at world size 1 (rc {run.returncode}): {run.stdout[-1000:]}\n{run.stderr[-3000:]}")
    log(f"NCCL, one process: the all_gather of a {width}x{height} two-position frame buffer returned it unchanged")


def mesh_step_statistics(grid, width: int, height: int, device="cuda") -> None:
    """step_statistics at width x height in the default and no_dda modes:
    the percentiles, each leg one launch; then once more with every kernel
    it launches held bit-equal at every call (held_sample_kernels: the
    legs, budgets and events included, and the default mode's LUT fetch)
    and the same statistics."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.utils.stepstats import step_statistics

    cuda = torch.device(device).type == "cuda"
    r = bench_renderer(grid, width, height, device)
    for mode, legs in (("default", ("dda_leg_sample", "dda_leg_shadow")),
                       ("no_dda", ("track_leg_sample", "track_leg_shadow"))):
        before = dict(kernels.LAUNCHES)
        stats = step_statistics(r, mode)
        calls = {k: kernels.LAUNCHES[k] - before[k] for k in legs}
        log(f"step_statistics ({mode}, {width}x{height}): sample {stats['sample']}; transmittance "
            f"{stats['transmittance']}; leg launches {calls}")
        if cuda and set(calls.values()) != {1}:
            raise SystemExit(f"step_statistics ({mode}) launched its legs {calls} times")
        if stats["sample"]["frac_at_cap"] or stats["transmittance"]["frac_at_cap"]:
            log(f"step_statistics ({mode}): lanes reached a cap")
        if cuda:
            held, tallies = held_sample_kernels(lambda: step_statistics(r, mode), mode)
            called = {name: tally["calls"] for name, tally in tallies if tally["calls"]}
            if held != stats or [called.get(name) for name in legs] != [1, 1]:
                raise SystemExit(f"step_statistics ({mode}) held: {held} against {stats}, calls {called}")
            log(f"step_statistics ({mode}): every kernel it launched bit-equal to its plain version at every call "
                f"({called}), budgets or events included")


def mesh_server(grid, device="cuda") -> None:
    """PreviewServer over a DistributedRenderer on the 2x2 mesh at
    MESH_SERVER_SIZE, stepped directly: progressive frames, the server's
    benchmark of MESH_BENCH_SAMPLES samples counted sp a step, a rotate
    command's drag preview (K7), then frames again; samples counted as
    frame_index * sp. Then, after the counts are read, on the server's
    renderer at the server's shapes: one frame (its four positions'
    calls) with every kernel held at every call and K4 at image()
    (hold_frame_kernels), and one drag preview at the server's scale with
    K7 and K4 held (hold_drag_preview)."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.api.server import PreviewServer
    from volxel_tpu_torch.parallel import make_mesh

    sp, px = MESH
    r = mesh_renderer(grid, *MESH_SERVER_SIZE, make_mesh(sp=sp, px=px, devices=[device] * (sp * px)))
    s = PreviewServer(r, port=0)
    outcomes = [s.step() for _ in range(3)]
    samples = r.frame_index * r.sp
    s._commands.put({"type": "benchmark", "samples": MESH_BENCH_SAMPLES})
    outcomes += [s.step() for _ in range(MESH_BENCH_SAMPLES // sp)]
    bench = s._benchmark
    before = kernels.LAUNCHES["shearwarp_intermediate"]
    s._commands.put({"type": "rotate", "by": [0.05, 0.02]})
    preview = s.step()
    k7 = kernels.LAUNCHES["shearwarp_intermediate"] - before
    wait_until(lambda: time.time() > s._motion_until + 0.05, "end of the rotate's motion")
    outcomes += [s.step() for _ in range(2)]
    log(f"server over the {sp}x{px} mesh ({MESH_SERVER_SIZE[0]}x{MESH_SERVER_SIZE[1]}): steps {outcomes}, "
        f"{samples} samples after 3 frames; benchmark {bench}; rotate: {preview}, K7 launches {k7}; then "
        f"{r.samples_rendered()} samples")
    if samples != 3 * sp:
        raise SystemExit(f"server over the mesh: {samples} samples after 3 frames of {sp}")
    if bench["running"] or bench["done"] != MESH_BENCH_SAMPLES or preview != "preview" or set(outcomes) != {"frame"}:
        raise SystemExit(f"server over the mesh: benchmark {bench}, rotate {preview}, steps {outcomes}")
    cuda = torch.device(device).type == "cuda"
    if cuda and k7 != 1:
        raise SystemExit(f"server over the mesh: the drag preview launched K7 {k7} times")
    check_image(r.image(), *MESH_SERVER_SIZE, "the mesh server's image()")
    if cuda:
        hold_frame_kernels(r, "mesh server")
        hold_drag_preview(r, s.preview_scale, "mesh server")


def serve_mesh_cli(cli: tuple = CLI_SERVE) -> None:
    """`python -m volxel_tpu_torch serve ... --mesh ...` (`cli`, by default
    CLI_SERVE's 1,1,1) in a subprocess on an ephemeral port: /state counts
    samples and /frame.png is a frame of the size asked for; the process
    is stopped."""
    from volxel_tpu_torch.utils.png import decode_png

    port = free_port()
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen([sys.executable, "-m", "volxel_tpu_torch", *cli, "--port", str(port)], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"

    def state():
        if proc.poll() is not None:
            raise SystemExit(f"serve --mesh exited {proc.returncode}: {proc.communicate()[1][-3000:]}")
        try:
            st = json.loads(http(base, "/state")[2])
        except OSError:
            return None
        return st if st["samples"] >= 2 else None

    try:
        st = wait_until(state, f"{' '.join(cli)}: the second sample")
        img = decode_png(http(base, "/frame.png")[2])
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    size = tuple(int(v) for v in cli[cli.index("--size") + 1].split("x"))
    if img.shape != (size[1], size[0], 3) or st["error"] is not None:
        raise SystemExit(f"serve --mesh: frame {img.shape}, state {st}")
    log(f"cli: {' '.join(cli)}: {st['samples']} samples served; /frame.png {img.shape}")


def mesh_two_cards(grid, width: int, height: int) -> None:
    """sp = 2 over cuda:0 and cuda:1 where the machine has two cards:
    MESH_STEPS steps bit-equal to the replayed single-card samples."""
    import torch

    from tests.torch_mesh import replayed_framebuffer
    from volxel_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        log("mesh over two cards: skipped, the machine has one card")
        return
    r = mesh_renderer(grid, width, height, make_mesh(sp=2, px=1, devices=["cuda:0", "cuda:1"]))
    for _ in range(MESH_STEPS):
        r.render_frame()
    torch.cuda.synchronize(1)
    if not bits_equal(r._framebuffer, replayed_framebuffer(r, MESH_STEPS)):
        raise SystemExit("mesh over two cards: the framebuffer differs from the replayed samples")
    log(f"mesh over cuda:0 and cuda:1 (sp=2, {width}x{height}): bit-equal to the replayed single-card samples")


def mesh_path(grid, size: int, width: int, height: int) -> None:
    """Phase 2d."""
    import torch

    t_phase = time.perf_counter()
    launches = mesh_steps(grid, width, height)
    log(f"mesh: launches over the 2x2 mesh's steps in three modes {launches}")
    torch.cuda.empty_cache()
    mesh_views(grid, width, height)
    torch.cuda.empty_cache()
    mesh_processes(size, width, height)
    mesh_step_statistics(grid, width, height)
    mesh_server(grid)
    torch.cuda.empty_cache()
    serve_mesh_cli()
    mesh_two_cards(grid, width, height)
    torch.cuda.empty_cache()
    log(f"phase 2d (the mesh): {time.perf_counter() - t_phase:.1f} s")


# phase 2e: render-time volume slabs (parallel/volshard.py). A
# DistributedRenderer whose SLAB_VZ positions along 'vz' name one card,
# loaded from the brick grid, beside a vz = 1 renderer on the same card.
SLAB_VZ = 4
SLAB_STEPS = 2  # steps a mode, each one sample (sp = 1)


def slab_renderer(grid, width: int, height: int, mesh, device):
    """A DistributedRenderer on `mesh` loaded by restart_from_grid (on a vz
    mesh the from-brick path), in bench.py's look; returns it and the peak
    of the card's allocated bytes during the load above what the renderer
    holds after it."""
    import torch

    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.utils.profiling import fence_device

    r = DistributedRenderer(width, height, mesh=mesh)
    fence_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    r.restart_from_grid(grid)
    fence_device(device)
    scratch = torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device)
    r.settings.bounces = 1
    bench_look(r)
    return r, scratch


def slab_load(grid, width: int, height: int, device) -> tuple:
    """The SLAB_VZ renderer's load: each slab's bytes and the load's peak
    above the slabs, which must stay below the whole field's bytes; then a
    vz = 1 renderer on the card. Returns both."""
    from volxel_tpu_torch.parallel import make_mesh

    bx, by, bz = grid.brick_count
    whole = bx * by * bz * 512 * 2
    r, scratch = slab_renderer(grid, width, height, make_mesh(sp=1, px=1, vz=SLAB_VZ, devices=[device] * SLAB_VZ),
                               device)
    slabs = sorted((v, tuple(s.shape), nbytes(s)) for (_, v), s in r._slabbed.slabs.items())
    if len(slabs) != SLAB_VZ or any(b >= whole for *_, b in slabs) or scratch >= whole:
        raise SystemExit(f"slabs: {slabs}, the load's peak above them {scratch} B, the whole field {whole} B")
    if r._device_grid.dense is not None:
        raise SystemExit("slabs: the renderer holds a whole dense field")
    rep, rep_scratch = slab_renderer(grid, width, height, make_mesh(sp=1, px=1, devices=[device]), device)
    log(f"slabs: vz={SLAB_VZ} on one card loaded from the brick grid; slabs "
        + ", ".join(f"{v}: {shape} {b} B" for v, shape, b in slabs)
        + f"; the load's peak above what it keeps {scratch} B ({scratch / whole:.4f} of the whole field's "
        f"{whole} B; vz = 1: {rep_scratch} B)")
    return r, rep


def slab_steps(r, rep) -> None:
    """SLAB_STEPS steps of `r` (the slabs) and `rep` (vz = 1) in each mode:
    r's framebuffer bit-equal to rep's, each leg launched in its slab form
    SLAB_VZ times a bounce and never in its dense form in r's steps. Then,
    after the counts are read, one step of each with every kernel held at
    every call (hold_frame_kernels), still bit-equal."""
    from volxel_tpu_torch import kernels

    launched = dict.fromkeys(kernels.LAUNCHES, 0)
    for mode, legs in MODE_LEGS.items():
        for x in (r, rep):
            x.render_mode = mode
        for _ in range(SLAB_STEPS):
            before = dict(kernels.LAUNCHES)
            r.render_frame()
            for k in launched:
                launched[k] += kernels.LAUNCHES[k] - before[k]
            rep.render_frame()
        if not bits_equal(r._framebuffer, rep._framebuffer):
            raise SystemExit(f"slabs ({mode}): the framebuffer differs from vz = 1's "
                             f"(max abs {max_abs([r._framebuffer], [rep._framebuffer])})")
        bounces = r.settings.bounces * SLAB_STEPS
        wrong = {leg: (launched[leg], launched[f"{leg}_slabs"]) for leg in legs
                 if launched[leg] or launched[f"{leg}_slabs"] != SLAB_VZ * bounces}
        if wrong:
            raise SystemExit(f"slabs ({mode}): legs launched (dense, slab form) {wrong}")
        check_image(r.image(), *r._render_dims(), f"slabs ({mode}) image()")
        log(f"slabs vz={SLAB_VZ} ({mode}, {'x'.join(map(str, r._render_dims()))}): framebuffer bit-equal to "
            f"vz = 1's after {SLAB_STEPS} steps; slab-form launches {[launched[f'{leg}_slabs'] for leg in legs]}")
        saved = dict(kernels.LAUNCHES)
        hold_frame_kernels(rep, "slabs, vz = 1")
        hold_frame_kernels(r, f"slabs, vz = {SLAB_VZ}")
        kernels.LAUNCHES.update(saved)  # the holds' launches are not the path's
        if not bits_equal(r._framebuffer, rep._framebuffer):
            raise SystemExit(f"slabs ({mode}): the held steps' framebuffers differ")


def slab_variants(grid, r, rep, width: int, height: int, device) -> None:
    """On the slabs: two gradient-shaded default steps bit-equal to vz =
    1's; one (sp=2, px=1, vz=2) step bit-equal to an sp = 2 one; vz = 2
    over cuda:0 and cuda:1 where the machine has two cards."""
    import torch

    from volxel_tpu_torch.parallel import make_mesh

    for x in (r, rep):
        x.render_mode = "default"
        x.settings.gradient_shading = True
    for _ in range(2):
        r.render_frame()
        rep.render_frame()
    if not bits_equal(r._framebuffer, rep._framebuffer):
        raise SystemExit("slabs: the gradient-shaded steps differ from vz = 1's")
    log(f"slabs vz={SLAB_VZ}: two gradient-shaded default steps bit-equal to vz = 1's")
    pairs = [("sp=2, vz=2", make_mesh(sp=2, px=1, vz=2, devices=[device] * 4),
              make_mesh(sp=2, px=1, devices=[device] * 2))]
    if torch.cuda.device_count() >= 2:
        pairs.append(("vz=2 over cuda:0 and cuda:1", make_mesh(sp=1, px=1, vz=2, devices=["cuda:0", "cuda:1"]),
                      make_mesh(sp=1, px=1, devices=["cuda:0"])))
    else:
        log("slabs over two cards: skipped, the machine has one card")
    for what, mesh, flat in pairs:
        a = slab_renderer(grid, width, height, mesh, device)[0]
        b = slab_renderer(grid, width, height, flat, device)[0]
        a.render_frame()
        b.render_frame()
        torch.cuda.synchronize()
        if not bits_equal(a._framebuffer, b._framebuffer):
            raise SystemExit(f"slabs ({what}): the step differs from the whole field's")
        log(f"slabs ({what}, default): one step bit-equal to the whole field's")
        del a, b


def slab_path(grid, width: int, height: int, device="cuda") -> None:
    """Phase 2e, with every launch counter at 0 before it."""
    import torch

    from volxel_tpu_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    r, rep = slab_load(grid, width, height, device)
    slab_steps(r, rep)
    slab_variants(grid, r, rep, width, height, device)
    del r, rep
    torch.cuda.empty_cache()
    serve_mesh_cli(CLI_SERVE_SLABS)
    log(f"phase 2e (render-time volume slabs): {time.perf_counter() - t_phase:.1f} s")


# phase 2f: a vz = 2 row across two processes of the node (one process a
# card, here both on the one card), joined over gloo: each process decodes
# its own slab and maps the other's through CUDA IPC (parallel/nodeshare.py)
NODE_STEPS = 2  # counted steps a mode across the processes, each one sample
NODE_SWAPS = 2  # timestep swaps, two steps each, with no host sync of the caller's between them
NODE_LANE_STRIDE = 16  # the held legs' lanes: every 16th lane of each call
NODE_WORKER_TIMEOUT = 300.0  # seconds, each of the two processes


@contextlib.contextmanager
def strided_holds(mode: str, stride: int):
    """While the block runs, each leg of a `mode` sample (modes.<leg>, as
    the sample calls it) also runs its CUDA wrapper and its plain version
    on every `stride`-th lane of each call: fails unless the two agree bit
    for bit on every output and the wrapper's equals the call's own on
    those lanes. The call itself returns what it returned. Yields {leg:
    tally}: the calls and the lanes held."""
    import torch

    import volxel_tpu_torch.render.modes as modes

    checks = [c for c in spec_sample_kernels(mode) if c[0] is modes]
    originals = {name: getattr(modes, name) for _, name, *_ in checks}
    tallies = {name: {"calls": 0, "lanes": 0} for name in originals}

    def held(name, cuda_fn, plain_fn, outputs):
        def call(*args):
            got = originals[name](*args)
            n = mask_lanes(args)
            sub = tuple(a[::stride].contiguous() if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n
                        else a for a in args)
            kernel, plain = cuda_fn(*sub), plain_fn(*sub)
            bad = [nm for nm, k, w, full in zip(outputs, kernel, plain, got)
                   if not (bits_equal(k, w) and bits_equal(k, full[::stride]))]
            if bad:
                raise SystemExit(f"{name} through a mapped slab, call {tallies[name]['calls']}: {bad} differ on every "
                                 f"{stride}th lane (max abs {max_abs(kernel, plain)})")
            tallies[name]["calls"] += 1
            tallies[name]["lanes"] += mask_lanes(sub)
            return got
        return call

    for _, name, cuda_fn, plain_fn, outputs in checks:
        setattr(modes, name, held(name, cuda_fn, plain_fn, outputs))
    try:
        yield tallies
    finally:
        for name, fn in originals.items():
            setattr(modes, name, fn)


def node_worker(addr: str, pid: int, size: int, width: int, height: int, cards: tuple) -> None:
    """One of phase 2f's two processes: process p on device cards[p],
    joined over gloo where the two share a card (NCCL refuses that) and
    over NCCL where each has its own, renders its part of a (1, 1, 2)
    mesh's row with its own slab and the other's mapped. Rank 0 holds a
    vz = 1 and a vz = 2 renderer of its own beside it. Prints one JSON
    line: the device bytes of the load, each mode's launches, frames
    bit-equal to vz = 1, the legs held on strided lanes through the mapped
    slab, and the timestep swaps."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.render.sampling import device_grid_from_brick
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
    from volxel_tpu_torch.utils.profiling import fence_device

    device = torch.device(cards[pid])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    if not initialize_multihost(addr, 2, pid, backend="gloo" if cards[0] == cards[1] else "nccl"):
        raise SystemExit("node worker: initialize_multihost did not join the group")
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    bx, by, bz = grid.brick_count
    mesh = make_mesh(sp=1, px=1, vz=2, devices=list(enumerate(cards)))
    r = DistributedRenderer(width, height, mesh=mesh, device=device)

    def allocated():
        return torch.cuda.memory_allocated(device) if cuda else 0

    fence_device(device)
    base = allocated()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    r.restart_from_grid(grid)
    fence_device(device)
    rec = {"pid": pid, "device": str(device), "backend": torch.distributed.get_backend(),
           "whole_bytes": bx * by * bz * 512 * 2, "slab_bytes": (-(-bz * 8 // 2) + 4) * by * bx * 128,
           "held_bytes": allocated() - base,
           "peak_bytes": torch.cuda.max_memory_allocated(device) - base if cuda else 0,
           "own": sorted([str(c), v, nbytes(t)] for (c, v), t in r._slabbed.slabs.items()
                         if (c, v) not in r._slabbed.mapped),
           "mapped": sorted((str(c), v) for c, v in r._slabbed.mapped)}
    r.settings.bounces = 1
    bench_look(r)
    reps = {}
    if pid == 0:
        for vz in (1, 2):
            reps[vz] = DistributedRenderer(width, height, mesh=make_mesh(sp=1, px=1, vz=vz, devices=[(0, device)] * vz),
                                           device=device)
            reps[vz].restart_from_grid(grid)
            reps[vz].settings.bounces = 1
            bench_look(reps[vz])
    rec["modes"] = {}
    for mode in MODE_LEGS:
        out = rec["modes"][mode] = {}
        for x in (r, *reps.values()):
            x.render_mode = mode
        kernels.reset_launch_counts()
        for _ in range(NODE_STEPS):
            r.render_frame()
        fence_device(device)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for _ in range(NODE_STEPS):
            for x in reps.values():
                x.render_frame()
        out["equal"] = pid != 0 or (bits_equal(r._framebuffer, reps[1]._framebuffer)
                                    and bits_equal(reps[2]._framebuffer, reps[1]._framebuffer))
        # each leg through the table holding the mapped slab, on strided lanes
        with strided_holds(mode, NODE_LANE_STRIDE) as held:
            r.render_frame()
        out["held"] = {leg: dict(t) for leg, t in held.items()}
        for x in reps.values():  # keep the step counts level with r's
            x.render_frame()
    # timestep swaps: each process cuts its slab from a whole field on its
    # card (time series), the old shared slabs released in between
    for x in (r, *reps.values()):
        x.render_mode = "default"
    fence_device(device)
    before_swaps = allocated()
    whole = device_grid_from_brick(grid, device)
    steps = [whole._replace(dense=(whole.dense.float() * (1.0 - 0.3 * t)).to(torch.bfloat16)) for t in (1, 2)]
    del whole
    frames = []
    for step in steps:
        for x in (r, *([reps[1]] if pid == 0 else [])):
            x._device_grid = step
            x.restart_rendering()
        for _ in range(2):
            r.render_frame()
            if pid == 0:
                reps[1].render_frame()
        frames.append((r._framebuffer.clone(), reps[1]._framebuffer.clone() if pid == 0 else None))
    fence_device(device)
    rec["swaps_equal"] = pid != 0 or all(bits_equal(a, b) for a, b in frames)
    rec["swaps_mapped"] = sorted((str(c), v) for c, v in r._slabbed.mapped)
    # what the swaps left beyond the new fields and the frames kept here:
    # about 0 where each swap freed the slab it replaced
    kept = sum(nbytes(step.dense) for step in steps) + sum(nbytes(*(f for f in pair if f is not None))
                                                            for pair in frames)
    rec["swaps_delta_bytes"] = allocated() - before_swaps - kept
    held_before_close = allocated()
    r.close()
    fence_device(device)
    rec["close_freed_bytes"] = held_before_close - allocated()
    print(json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()


def node_slab_path(size: int, width: int, height: int) -> None:
    """Phase 2f: a vz = 2 row across two processes on the card (and over
    cuda:0 and cuda:1 where the machine has two cards). Fails unless each
    process holds one slab of its own and maps the other's, holds less
    than the whole field after the load, rank 0's frames are bit-equal to
    vz = 1's (and vz = 2's in one process) in every mode, each process
    launched every leg of each mode in its slab form and none in its dense
    form, every held leg is bit-equal on its strided lanes, and the
    timestep swaps stay bit-equal and free the slabs they replace."""
    import torch

    t_phase = time.perf_counter()
    cuda = torch.cuda.is_available()
    runs = [("cuda:0", "cuda:0")] + ([("cuda:0", "cuda:1")] if torch.cuda.device_count() >= 2 else [])
    for cards in runs:
        for rec in worker_pair(lambda addr, pid: ["--node-worker", addr, str(pid), ",".join(cards)], size, width,
                               height, NODE_WORKER_TIMEOUT, f"node worker on {cards}"):
            pid, whole = rec["pid"], rec["whole_bytes"]
            where = f"vz = 2 across two processes on {cards[0]} and {cards[1]} ({rec['backend']}), process {pid}"
            if rec["own"] != [[cards[pid], pid, rec["slab_bytes"]]] or len(rec["mapped"]) != 1:
                raise SystemExit(f"{where}: own slabs {rec['own']} (expected one of {rec['slab_bytes']} B), mapped "
                                 f"{rec['mapped']}")
            if rec["held_bytes"] >= whole:
                raise SystemExit(f"{where}: holds {rec['held_bytes']} B after the load, the whole field is {whole} B")
            log(f"{where}: holds its slab {rec['own'][0][2]} B and maps {rec['mapped']}; device bytes after the load "
                f"{rec['held_bytes']} (torch.cuda.memory_allocated above the renderer's), the load's peak "
                f"{rec['peak_bytes']}; the whole field {whole} B")
            for mode, legs in MODE_LEGS.items():
                m = rec["modes"][mode]
                wrong = {leg: (m["launches"].get(leg, 0), m["launches"].get(f"{leg}_slabs", 0)) for leg in legs
                         if m["launches"].get(leg, 0) or m["launches"].get(f"{leg}_slabs", 0) != NODE_STEPS}
                if wrong or not m["equal"]:
                    raise SystemExit(f"{where} ({mode}): legs launched (dense, slab form) {wrong}, frames bit-equal "
                                     f"to vz = 1: {m['equal']}")
                if any(t["calls"] == 0 for t in m["held"].values()):
                    raise SystemExit(f"{where} ({mode}): a leg was not held: {m['held']}")
                log(f"{where} ({mode}, {width}x{height}): launches of its two steps {m['launches']}"
                    + ("; frames bit-equal to one-process vz = 1 and vz = 2 renderers'" if pid == 0 else ""))
                for leg, t in m["held"].items():
                    log(f"{where} ({mode}): {leg} through the table holding the mapped slab bit-equal to its plain "
                        f"version on every {NODE_LANE_STRIDE}th lane of all {t['calls']} calls ({t['lanes']} lanes)")
            if (not rec["swaps_equal"] or len(rec["swaps_mapped"]) != 1
                    or (cuda and not rec["swaps_delta_bytes"] < rec["slab_bytes"] <= rec["close_freed_bytes"])):
                raise SystemExit(f"{where}: the timestep swaps: bit-equal {rec['swaps_equal']}, mapped "
                                 f"{rec['swaps_mapped']}, device bytes they left {rec['swaps_delta_bytes']}, "
                                 f"close() freed {rec['close_freed_bytes']} (a slab is {rec['slab_bytes']})")
            log(f"{where}: {NODE_SWAPS} timestep swaps of two steps each, no host sync "
                + ("of the caller's, frames bit-equal to vz = 1's" if pid == 0 else "of the caller's")
                + f"; device bytes they left beyond the new fields and the kept frames {rec['swaps_delta_bytes']}"
                f" (each swap freed the slab it replaced); close() freed {rec['close_freed_bytes']}")
    if len(runs) == 1:
        log("vz = 2 across two processes on two cards: skipped, the machine has one card")
    log(f"phase 2f (slabs across the processes of a node): {time.perf_counter() - t_phase:.1f} s")


# phase 2g: a vz row across nodes (parallel/migrate.py), rehearsed on one
# machine: the processes are fed two node identities, so no process can load
# a slab of the other "node"; a lane that reaches one parks, moves to the
# slab's owner and is resumed there by the leg's park form
CROSS_NODES = ("host-A/fed", "host-B/fed")
CROSS_STEPS = 2  # counted steps a mode across the nodes, each one sample
CROSS_LANE_STRIDE = 16  # the held park forms' lanes: every 16th lane of each call
CROSS_WORKER_TIMEOUT = 300.0  # seconds, each process
MIXED_SIZE, MIXED_DIMS = 256, (960, 540)  # the [A, A, B, B] layout's volume and frame


@contextlib.contextmanager
def held_park_forms(stride: int):
    """While the block runs, each park form that parallel.migrate calls
    also runs its CUDA wrapper and its plain version on every `stride`-th
    lane of the call: fails unless the two agree bit for bit on every
    output and the wrapper's equals the call's own there. Yields {leg:
    tally}: calls, lanes held and lanes parked."""
    import torch

    from volxel_tpu_torch.parallel import migrate
    from volxel_tpu_torch.render import ddaleg, tilemarch, trackleg

    modules = {"dda": ddaleg, "track": trackleg, "tile": tilemarch}
    tallies = {name: {"calls": 0, "lanes": 0, "parked": 0} for name in migrate.LEGS}
    originals = {leg.park: getattr(migrate, leg.park) for leg in migrate.LEGS.values()}

    def held(name, leg):
        module = modules[name.split("_")[0]]
        cuda_fn, plain_fn = getattr(module, f"{leg.park}_cuda"), getattr(module, f"{leg.park}_plain")
        at = leg.park_args.index("ipos") + 1

        def call(*args):
            got = originals[leg.park](*args)
            n = args[at].shape[0]
            sub = tuple(a[::stride].contiguous() if i and isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n
                        else a for i, a in enumerate(args))
            kernel, plain = cuda_fn(*sub), plain_fn(*sub)
            bad = [nm for nm, k, w, full in zip(leg.outs, kernel, plain, got)
                   if not (bits_equal(k, w) and bits_equal(k, full[::stride]))]
            tally = tallies[name]
            if bad:
                raise SystemExit(f"{leg.park} across nodes, call {tally['calls']}: {bad} differ on every {stride}th "
                                 f"lane (max abs {max_abs(kernel, plain)})")
            tally["calls"] += 1
            tally["lanes"] += sub[at].shape[0]
            tally["parked"] += int((got[-1] >= 0).sum())
            return got
        return call

    for name, leg in migrate.LEGS.items():
        setattr(migrate, leg.park, held(name, leg))
    try:
        yield tallies
    finally:
        for park, fn in originals.items():
            setattr(migrate, park, fn)


def cross_worker(addr: str, pid: int, size: int, width: int, height: int, cards: tuple, nodes: tuple) -> None:
    """One of phase 2g's processes: process p on device cards[p], fed node
    identity nodes[p], joined over gloo where processes share a card (NCCL
    refuses that) and over NCCL where each has its own; it renders its part
    of a (1, 1, len(cards)) row whose slabs on the other node are absent.
    Rank 0 holds a vz = 1 renderer beside it. On two processes it also
    holds the park forms on strided lanes. Prints one JSON line: the load,
    each mode's launches and leg calls (lanes parked, moved and returned,
    rounds, bytes sent), frames bit-equal to vz = 1, the held park forms."""
    import torch

    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.parallel import initialize_multihost, make_mesh, migrate, multihost
    from volxel_tpu_torch.parallel.distributed import DistributedRenderer
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume
    from volxel_tpu_torch.utils.profiling import fence_device

    count = len(cards)
    device = torch.device(cards[pid])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    backend = "gloo" if len(set(cards)) < count else "nccl"
    if not initialize_multihost(addr, count, pid, backend=backend):
        raise SystemExit("cross worker: initialize_multihost did not join the group")
    found = list(multihost._node_ids)
    multihost._node_ids[:] = list(nodes)  # fed: every process runs on this one machine
    vol = synthetic_ct_volume((size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    mesh = make_mesh(sp=1, px=1, vz=count, devices=list(enumerate(cards)))
    r = DistributedRenderer(width, height, mesh=mesh, device=device)

    def allocated():
        return torch.cuda.memory_allocated(device) if cuda else 0

    fence_device(device)
    base = allocated()
    r.restart_from_grid(grid)
    fence_device(device)
    slab_grid = r._slabbed.local_grid()
    rec = {"pid": pid, "device": str(device), "backend": torch.distributed.get_backend(), "found_nodes": found,
           "fed_nodes": list(nodes), "held_bytes": allocated() - base,
           "absent": [v for v, s in enumerate(slab_grid.slabs) if s is None],
           "mapped": sorted((str(c), v) for c, v in r._slabbed.mapped), "row": slab_grid.row is not None}
    del slab_grid
    r.settings.bounces = 1
    bench_look(r)
    rep = None
    if pid == 0:
        rep = DistributedRenderer(width, height, mesh=make_mesh(sp=1, px=1, devices=[(0, device)]), device=device)
        rep.restart_from_grid(grid)
        rep.settings.bounces = 1
        bench_look(rep)
    rec["modes"] = {}
    for mode in MODE_LEGS:
        out = rec["modes"][mode] = {}
        for x in (r, rep):
            if x is not None:
                x.render_mode = mode
        kernels.reset_launch_counts()
        migrate.CALLS.clear()
        for _ in range(CROSS_STEPS):
            r.render_frame()
        fence_device(device)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["calls"] = [[c[k] for k in ("leg", "lanes", "running", "parked", "moved", "returned", "rounds", "bytes")]
                        for c in migrate.CALLS]
        if pid == 0:
            for _ in range(CROSS_STEPS):
                rep.render_frame()
        out["equal"] = pid != 0 or bits_equal(r._framebuffer, rep._framebuffer)
        if count != 2:
            continue
        saved = dict(kernels.LAUNCHES)
        with held_park_forms(CROSS_LANE_STRIDE) as held:
            r.render_frame()
        out["held"] = {leg: dict(t) for leg, t in held.items() if t["calls"]}
        kernels.LAUNCHES.update(saved)  # the holds' launches are not the path's
        if pid == 0:
            rep.render_frame()  # keep the step counts level with r's
    r.close()
    print(json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()


def cross_node_path(size: int, width: int, height: int) -> None:
    """Phase 2g: a vz = 2 row across two fed nodes on the card (and over
    cuda:0 and cuda:1 on NCCL where the machine has two cards), then four
    processes [A, A, B, B] at MIXED_SIZE and MIXED_DIMS on the card (and
    over cuda:0-3 on NCCL where the machine has four cards). Fails unless
    each process finds the other node's slabs absent and maps no slab
    across nodes (its node mate's only), launches every park form of each
    mode and no other form of its legs, rank 0's frames are bit-equal to
    vz = 1's in every mode, lanes moved, and every held park form is
    bit-equal to its plain version. Prints each leg call's lanes parked,
    moved and returned, rounds and bytes."""
    import torch

    t_phase = time.perf_counter()
    runs = [(("cuda:0", "cuda:0"), CROSS_NODES, size, width, height)]
    if torch.cuda.device_count() >= 2:
        runs.append((("cuda:0", "cuda:1"), CROSS_NODES, size, width, height))
    mixed = (CROSS_NODES[0],) * 2 + (CROSS_NODES[1],) * 2
    runs.append((("cuda:0",) * 4, mixed, MIXED_SIZE, *MIXED_DIMS))
    if torch.cuda.device_count() >= 4:
        runs.append((tuple(f"cuda:{i}" for i in range(4)), mixed, MIXED_SIZE, *MIXED_DIMS))
    for cards, nodes, sz, w, h in runs:
        count = len(cards)
        recs = worker_pair(lambda addr, pid: ["--cross-worker", addr, str(pid), ",".join(cards), ",".join(nodes)], sz,
                           w, h, CROSS_WORKER_TIMEOUT, f"cross worker on {cards}", count=count)
        moved = sum(c[4] for rec in recs for m in rec["modes"].values() for c in m["calls"])
        for rec in recs:
            pid = rec["pid"]
            where = f"vz = {count} across fed nodes {nodes} on {','.join(cards)} ({rec['backend']}), process {pid}"
            other = [v for v in range(count) if nodes[v] != nodes[pid]]
            mates = [v for v in range(count) if nodes[v] == nodes[pid] and v != pid]
            if (rec["absent"] != other or [v for _, v in rec["mapped"]] != mates or not rec["row"]
                    or len(set(rec["found_nodes"])) != 1):
                raise SystemExit(f"{where}: absent slabs {rec['absent']} (expected {other}), mapped {rec['mapped']} "
                                 f"(expected {mates}), row {rec['row']}, nodes found {rec['found_nodes']}")
            log(f"{where}: one machine ({rec['found_nodes'][0]}), node identities fed {rec['fed_nodes']}; slabs "
                f"absent {rec['absent']}, mapped within the node {rec['mapped']}; device bytes after the load "
                f"{rec['held_bytes']}")
            for mode, legs in MODE_LEGS.items():
                m = rec["modes"][mode]
                launched = m["launches"]
                wrong = {leg: [launched.get(f"{leg}{form}", 0) for form in ("", "_slabs", "_slabs_park")]
                         for leg in legs if launched.get(leg, 0) or launched.get(f"{leg}_slabs", 0)
                         or launched.get(f"{leg}_slabs_park", 0) < CROSS_STEPS}
                if wrong or not m["equal"]:
                    raise SystemExit(f"{where} ({mode}): legs launched (dense, slab, park form) {wrong}; frames "
                                     f"bit-equal to vz = 1: {m['equal']}")
                if count == 2 and (set(m["held"]) != set(legs) or any(t["calls"] == 0 for t in m["held"].values())):
                    raise SystemExit(f"{where} ({mode}): a park form was not held: {m['held']}")
                log(f"{where} ({mode}, {w}x{h}): launches of its {CROSS_STEPS} steps {launched}"
                    + ("; frames bit-equal to a one-process vz = 1 renderer's" if pid == 0 else ""))
                for leg, lanes, running, parked, sent, returned, rounds, nbytes_sent in m["calls"]:
                    log(f"{where} ({mode}) {leg} call: {lanes} lanes, {running} running, {parked} parked here "
                        f"({parked / max(running, 1):.4f} of the running), {sent} moved and {returned} returned by "
                        f"this process, {rounds} rounds, {nbytes_sent} bytes sent")
                for leg, t in m.get("held", {}).items():
                    log(f"{where} ({mode}): {leg}'s park form bit-equal to its plain version on every "
                        f"{CROSS_LANE_STRIDE}th lane of all {t['calls']} calls ({t['lanes']} lanes held, "
                        f"{t['parked']} lanes parked in those calls)")
        if moved == 0:
            raise SystemExit(f"vz = {count} across fed nodes on {cards}: no lane moved")
    if torch.cuda.device_count() < 2:
        log("vz = 2 across fed nodes on two cards: skipped, the machine has one card")
    if torch.cuda.device_count() < 4:
        log("[A, A, B, B] across fed nodes on four cards over NCCL: skipped, the machine has "
            f"{torch.cuda.device_count()} card(s)")
    log(f"phase 2g (slabs across nodes, fed identities on one machine): {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512, help="volume edge in voxels")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--parity-size", type=int, default=64)
    ap.add_argument("--mesh-worker", nargs=2, metavar=("ADDR", "PID"), help=argparse.SUPPRESS)
    ap.add_argument("--mesh-nccl", metavar="ADDR", help=argparse.SUPPRESS)
    ap.add_argument("--node-worker", nargs=3, metavar=("ADDR", "PID", "DEVICES"), help=argparse.SUPPRESS)
    ap.add_argument("--cross-worker", nargs=4, metavar=("ADDR", "PID", "DEVICES", "NODES"), help=argparse.SUPPRESS)
    ap.add_argument("--cross-nodes-only", action="store_true",
                    help="build the kernels and run phase 2g alone (its NCCL runs need two and four cards)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import volxel_tpu_torch

    # the kernels must be built from this checkout's sources, not from a copy
    # of the package installed elsewhere
    if Path(volxel_tpu_torch.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        print(f"chip_smoke: volxel_tpu_torch comes from {volxel_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    from volxel_tpu_torch import kernels
    from volxel_tpu_torch.grid import construct_brick_grid
    from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

    if args.mesh_worker:  # one of phase 2d's two processes
        mesh_worker(args.mesh_worker[0], int(args.mesh_worker[1]), args.size, args.width, args.height)
        return 0
    if args.mesh_nccl:  # phase 2d's NCCL process group of one
        nccl_world_of_one(args.mesh_nccl, args.width, args.height)
        return 0
    if args.node_worker:  # one of phase 2f's two processes
        addr, pid, cards = args.node_worker
        node_worker(addr, int(pid), args.size, args.width, args.height, tuple(cards.split(",")))
        return 0
    if args.cross_worker:  # one of phase 2g's processes
        addr, pid, cards, nodes = args.cross_worker
        cross_worker(addr, int(pid), args.size, args.width, args.height, tuple(cards.split(",")),
                     tuple(nodes.split(",")))
        return 0

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {path.name}")
    if args.cross_nodes_only:
        cross_node_path(args.size, args.width, args.height)
        print(json.dumps({"ok": True, "phases": ["2g"], "device": {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    check_sass()

    vol = synthetic_ct_volume((args.size,) * 3, bits_stored=12, seed=0)
    grid = construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
    del vol
    log(f"scene: {args.size}^3 synthetic CT volume")

    with tempfile.TemporaryDirectory(prefix="volxel_smoke_") as tmpdir:
        # phase 2b: ingest and the reference benchmark, through the entry points
        zip_path, env_path = ingest_and_reference_benchmark(args.size, ENV_SIZE, args.width, args.height,
                                                            REFERENCE_SPEC, Path(tmpdir))
        torch.cuda.empty_cache()
        # phase 2c: the app path, with the counters at 0 before the server's
        t0 = time.perf_counter()
        app_server(zip_path, env_path)
        torch.cuda.empty_cache()
        gradient_and_debug_hits(grid, args.width, args.height)
        cli_path(Path(tmpdir))
        log(f"phase 2c (the app path): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 2d: the mesh, with the counters at 0 before the 2x2 mesh's steps
    mesh_path(grid, args.size, args.width, args.height)
    # phase 2e: render-time volume slabs, with the counters at 0 before it
    slab_path(grid, args.width, args.height)
    torch.cuda.empty_cache()
    # phase 2f: a vz row across two processes, each with the counters at 0 before its steps
    node_slab_path(args.size, args.width, args.height)
    # phase 2g: a vz row across two fed nodes, each process with the counters at 0 before its steps
    cross_node_path(args.size, args.width, args.height)

    # phase 3: each kernel against its plain version at the main paths' shapes
    t0 = time.perf_counter()
    r = bench_renderer(grid, args.width, args.height, "cuda")
    check_neg_log1m()
    check_legs(r)
    check_track_legs(r)
    check_gather(r)
    check_pyramid(r)
    check_tonemap(r.settings.exposure, r.settings.gamma)
    check_shearwarp(r)
    check_rng(args.width, args.height)
    check_env(r, args.width, args.height)
    del r
    r = bench_renderer(grid, args.width, args.height, "cuda", "raymarch")
    check_tile_march(r)
    del r
    torch.cuda.empty_cache()
    log(f"phase 3 (each kernel against its plain version): {time.perf_counter() - t0:.1f} s")

    # phase 4: the main paths, each with the counters at 0 before it
    t0 = time.perf_counter()
    for mode in MODE_LEGS:
        main_path(grid, args.width, args.height, mode)
        torch.cuda.empty_cache()
    for mode in MODE_LEGS:
        leg_host_syncs(grid, args.width, args.height, mode)
    leg_host_syncs(grid, args.width, args.height, "default", bounces=3)
    preview_path(grid, args.width, args.height)
    torch.cuda.empty_cache()
    log(f"phase 4 (the main paths): {time.perf_counter() - t0:.1f} s")

    # phase 5: card against CPU at a small size, in every mode and the preview
    t0 = time.perf_counter()
    for mode in ("default", "raymarch", "no_dda"):
        parity(grid, args.parity_size, mode)
        parity(grid, args.parity_size, mode, "gradient_shading")
        parity(grid, args.parity_size, mode, "debug_hits")
    preview_parity(grid, args.parity_size)
    log(f"phase 5 (card against CPU): {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
