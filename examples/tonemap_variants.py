"""K4 (the display tonemap, csrc/tonemap.cu) beside other thread shapes, its
floors and a former design, on one card.

    python examples/tonemap_variants.py [--parent DIR] [--rounds 2]

Builds this checkout's csrc/tonemap.cu with the flags
volxel_tpu_torch.kernels gives it, together with probe kernels compiled
into the same translation unit (PROBE, which includes the file and so uses
its map), and, with --parent, DIR's volxel_tpu_torch/csrc/tonemap.cu with
--fmad=false (how the port built it before it took the file into
FMAD_SOURCES). The probes:

  * vec2, vec4, vec8: the same map with 2, 4 or 8 float4s a thread, all
    their loads issued first (each block maps V * 256 consecutive
    float4s), and a 16-byte copy in the same layout;
  * map_only: the map alone on inputs made from the thread's index, with
    no load and no store: what the map costs where memory is no limit;
  * cached: the map with plain loads and stores in place of the streaming
    ones.

Prints `-Xptxas -v` (registers, spills) and the SASS counts (FFMA, MUFU,
instructions) of each build's kernels, checks every variant bit-equal to
pallas_ops.tonemap_plain on a 1920x1080x3 buffer of seeded radiances (exit
1 otherwise), then, in turns over --rounds rounds (the order reversed every
other round), prints the CUDA-event time (mean of 50 launches,
chip_smoke.device_ms) of each variant on that buffer and on a quarter of
it, with its 16-byte copy where it has one, and torch's copy_. The card's
name and power limit come first, then one JSON line per build, and one
per variant and round.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from volxel_tpu_torch import kernels  # noqa: E402
from volxel_tpu_torch.render.pallas_ops import tonemap_plain  # noqa: E402

VECS = (2, 4, 8)
REPS = 50
PROBE = r"""
#include "%s"

namespace {

template <int V>
__global__ void __launch_bounds__(kThreads) vec_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                                                       long long n4, float exposure, float inv_gamma) {
  const float white = hable(11.2f);
  const long long first = static_cast<long long>(blockIdx.x) * V * kThreads + threadIdx.x;
  float4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long j = first + static_cast<long long>(k) * kThreads;
    if (j < n4) v[k] = __ldcs(src + j);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long j = first + static_cast<long long>(k) * kThreads;
    if (j < n4) __stcs(dst + j, map4(v[k], exposure, white, inv_gamma));
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) vec_copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                                                            long long n4) {
  const long long first = static_cast<long long>(blockIdx.x) * V * kThreads + threadIdx.x;
  float4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long j = first + static_cast<long long>(k) * kThreads;
    if (j < n4) v[k] = __ldcs(src + j);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long j = first + static_cast<long long>(k) * kThreads;
    if (j < n4) __stcs(dst + j, v[k]);
  }
}

// no map of inputs >= 0 gives -1, so nothing is stored
__global__ void __launch_bounds__(kThreads) map_only_kernel(float4* __restrict__ dst, long long n4, float exposure,
                                                            float inv_gamma) {
  const long long j = thread_index();
  if (j >= n4) return;
  const float b = __fmul_rn(static_cast<float>(j), 2.5e-6f);
  const float4 r = map4(make_float4(b, __fadd_rn(b, 1e-7f), __fadd_rn(b, 2e-7f), __fadd_rn(b, 3e-7f)), exposure,
                        hable(11.2f), inv_gamma);
  if (r.x == -1.0f && r.y == -1.0f && r.z == -1.0f && r.w == -1.0f) dst[j] = r;
}

__global__ void __launch_bounds__(kThreads) cached_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                                                          long long n4, float exposure, float inv_gamma) {
  const long long j = thread_index();
  if (j < n4) dst[j] = map4(src[j], exposure, hable(11.2f), inv_gamma);
}

template <int V>
int launch_vec(const float* src, float* dst, long long n4, float exposure, float inv_gamma, bool copy,
               cudaStream_t stream) {
  const int blocks = static_cast<int>((n4 + V * kThreads - 1) / (V * kThreads));
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  if (copy) {
    vec_copy_kernel<V><<<blocks, kThreads, 0, stream>>>(s, d, n4);
  } else {
    vec_kernel<V><<<blocks, kThreads, 0, stream>>>(s, d, n4, exposure, inv_gamma);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 2, 4 or 8 float4s a thread (copy: their 16-byte copy), 0 the
// map alone, 1 the map with plain loads and stores
extern "C" int vx_probe(int variant, int copy, const float* src, float* dst, long long n4, float exposure,
                        float inv_gamma, cudaStream_t stream) {
  switch (variant) {
    case 2: return launch_vec<2>(src, dst, n4, exposure, inv_gamma, copy, stream);
    case 4: return launch_vec<4>(src, dst, n4, exposure, inv_gamma, copy, stream);
    case 8: return launch_vec<8>(src, dst, n4, exposure, inv_gamma, copy, stream);
    case 0:
      map_only_kernel<<<blocks_for(n4), kThreads, 0, stream>>>(reinterpret_cast<float4*>(dst), n4, exposure,
                                                                inv_gamma);
      break;
    default:
      cached_kernel<<<blocks_for(n4), kThreads, 0, stream>>>(reinterpret_cast<const float4*>(src),
                                                              reinterpret_cast<float4*>(dst), n4, exposure,
                                                              inv_gamma);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
PROBES = {"vec2": 2, "vec4": 4, "vec8": 8, "map_only": 0, "cached": 1}


def build(src: Path, flags: list[str], out_dir: Path, tag: str) -> ctypes.CDLL:
    """Compile `src` into a library, print its ptxas report and SASS counts,
    and return it loaded."""
    nvcc = kernels._nvcc()
    obj, lib, cubin = (str(out_dir / f"{tag}.{ext}") for ext in ("o", "so", "cubin"))
    ptxas = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", cubin, str(src)], capture_output=True,
                           text=True, check=True, timeout=300).stderr
    subprocess.run([nvcc, *flags, "-c", "-o", obj, str(src)], check=True, timeout=300)
    subprocess.run([nvcc, "-shared", *kernels.ARCH, "-o", lib, obj], check=True, timeout=300)
    sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    report = [line.strip() for line in ptxas.splitlines() if "entry function" in line or "Used" in line]
    print(json.dumps({"build": tag, "ptxas": report, "sass": chip_smoke.sass_counts(sass)}), flush=True)
    handle = ctypes.CDLL(lib)
    handle.vx_tonemap.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_void_p]
    if hasattr(handle, "vx_probe"):
        handle.vx_copy16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        handle.vx_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return handle


def run(handle, variant, image, exposure, inv_gamma, copy=False):
    """One launch of `variant` ("tonemap", "copy16" or a PROBES key) over
    `image`; returns its output."""
    out = torch.empty_like(image)
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "tonemap":
        code = handle.vx_tonemap(image.data_ptr(), out.data_ptr(), image.numel(), exposure, inv_gamma, stream)
    elif variant == "copy16":
        code = handle.vx_copy16(image.data_ptr(), out.data_ptr(), image.numel() // 4, stream)
    else:
        code = handle.vx_probe(PROBES[variant], int(copy), image.data_ptr(), out.data_ptr(), image.numel() // 4,
                               exposure, inv_gamma, stream)
    if code:
        raise RuntimeError(f"{variant} failed with cudaError {code}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/tonemap.cu to time beside this one's")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    exposure, gamma = 5.5, 2.2
    inv_gamma = float(1.0 / torch.tensor(gamma, dtype=torch.float32))
    fb = np.random.default_rng(1).uniform(0.0, 4.0, (1920 * 1080, 3)).astype(np.float32)
    fb = torch.from_numpy(fb).cuda()
    quarter = fb[: fb.shape[0] // 4].clone()
    want = tonemap_plain(fb, exposure, gamma).view(torch.int32)
    src = kernels.CSRC / "tonemap.cu"
    with tempfile.TemporaryDirectory() as tmp:
        probe_src = Path(tmp) / "tonemap_probe.cu"
        probe_src.write_text(PROBE % src)
        here = build(probe_src, list(kernels._flags(src)), Path(tmp), "this")
        variants = {"tonemap": (here, "copy16"), **{v: (here, v) for v in PROBES if v.startswith("vec")},
                    "cached": (here, None), "map_only": (here, None)}
        if args.parent:
            parent = Path(args.parent) / "volxel_tpu_torch" / "csrc" / "tonemap.cu"
            variants["parent"] = (build(parent, [*kernels.NVCC_FLAGS, "--fmad=false"], Path(tmp), "parent"), None)
        for name, (handle, _) in variants.items():
            if name != "map_only":
                got = run(handle, "tonemap" if name == "parent" else name, fb, exposure, inv_gamma)
                if not torch.equal(got.view(torch.int32), want):
                    print(json.dumps({"variant": name, "bit_equal": False}), flush=True)
                    return 1
        out = torch.empty_like(fb)
        _, torch_copy_ms = chip_smoke.device_ms(lambda: out.copy_(fb), REPS)
        order = list(variants)
        for i in range(args.rounds):
            for name in order[:: 1 if i % 2 == 0 else -1]:
                handle, copy = variants[name]
                kernel = "tonemap" if name == "parent" else name
                row = {"variant": name, "round": i, "bit_equal": name != "map_only"}
                for label, image in (("1080p", fb), ("quarter", quarter)):
                    row[f"{label}_ms"] = chip_smoke.device_ms(
                        lambda: run(handle, kernel, image, exposure, inv_gamma), REPS)[1]
                    if copy is not None:
                        row[f"{label}_copy_ms"] = chip_smoke.device_ms(
                            lambda: run(handle, copy, image, exposure, inv_gamma, copy=True), REPS)[1]
                row["torch_copy_1080p_ms"] = torch_copy_ms
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
