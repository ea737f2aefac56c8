"""Build, load and count the port's hand-written CUDA kernels.

The sources are `csrc/*.cu`, and the headers they include `csrc/*.cuh`. At
first use each source is compiled by its own `nvcc`, all at once, and the
objects are linked into one shared library with a plain C interface under
`build/` (keyed by a hash of the sources, the headers and the flags, so an
edited source or header rebuilds), loaded with ctypes. Each entry point is
bound with the ctypes types of its `extern "C"` declaration in the
sources (`signatures`), the one record of its interface. Nothing is
compiled or loaded at import: the CPU tests import every module on
machines without `nvcc` or a card.

Each C entry point launches on the stream it is given, never
synchronises, and returns `cudaGetLastError()`. The wrappers call it
through `launch`, which enters the operands' device (a device guard, so
that the launch and whatever the entry point asks of the current device go
to the card the tensors lie on), passes that device's current stream and
turns a non-zero code into an exception.
`--fmad=false` keeps every multiply and add separately rounded, as eager
PyTorch ops are, so a kernel can be held bit-equal to its plain version.
The sources in FMAD_SOURCES are built with nvcc's default `--fmad=true`
instead, so that the math library's functions (logf, powf, and in env.cu
atan2f, acosf, sinf, cosf) round as they do in ATen's kernels; those
sources write every f32 sum and product with the `__fadd_rn` /
`__fmul_rn` intrinsics, which are never contracted.

`LAUNCHES` counts kernel launches by name. Only the wrappers add to it,
once per launch, so a run can show which kernels its path went through.
The per-ray RNG (render/rng.py, csrc/rng.cu) counts `rng_seed` once a
seeding and `rng_draw` once a draw call, whatever the draws a lane; both
stay 0 where the words are drawn on the CPU.
The environment (scene/environment.py, csrc/env.cu) counts `env_sample`
once a warp sample and `env_lookup` once a lookup, a pdf or both; both
stay 0 for an environment on the CPU.
Gradient shading (render/shading.py, csrc/shade.cu) counts `shade` once a
shaded wavefront, over a dense field or slabs alike; it stays 0 on the CPU
and for a row across nodes, which shade through the plain version.
A leg launched over z-slabs (render-time volume slabs: the field read
through a table of the slabs' pointers) counts under its name with
`_slabs` appended, apart from its launches over a dense field, and its
park form (a 'vz' row across nodes, parallel/migrate.py) with
`_slabs_park`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)
FMAD_SOURCES = ("dda_leg.cu", "track_leg.cu", "tonemap.cu", "env.cu", "shade.cu")

LAUNCHES = {
    "dda_leg_sample": 0, "dda_leg_shadow": 0, "track_leg_sample": 0, "track_leg_shadow": 0, "importance_pyramid": 0,
    "tonemap": 0, "tile_march_sample": 0, "tile_march_transmittance": 0, "tile_march_sums": 0,
    "shearwarp_intermediate": 0, "gather_f32": 0, "lookup_transfer": 0,
    "dda_leg_sample_slabs": 0, "dda_leg_shadow_slabs": 0, "track_leg_sample_slabs": 0, "track_leg_shadow_slabs": 0,
    "tile_march_sample_slabs": 0, "tile_march_transmittance_slabs": 0,
    "dda_leg_sample_slabs_park": 0, "dda_leg_shadow_slabs_park": 0, "track_leg_sample_slabs_park": 0,
    "track_leg_shadow_slabs_park": 0, "tile_march_sample_slabs_park": 0, "tile_march_transmittance_slabs_park": 0,
    "rng_seed": 0, "rng_draw": 0, "env_sample": 0, "env_lookup": 0, "shade": 0,
}

# the ctypes type of each C parameter type of an entry point's declaration
# (a pointer, whatever it points to, and a stream are void pointers)
_C_TYPES = {"long long": ctypes.c_longlong, "unsigned": ctypes.c_uint, "float": ctypes.c_float, "int": ctypes.c_int}
_DECLARATION = re.compile(r'extern "C" int (vx_\w+)\(([^)]*)\)')

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(src: Path) -> tuple[str, ...]:
    return (*NVCC_FLAGS, "--fmad=true" if src.name in FMAD_SOURCES else "--fmad=false")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(" ".join(_flags(src)).encode())
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD / f"libvolxel_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) on {cmd[-1]}:\n{err}")


def build() -> Path:
    """Compile csrc/*.cu into the keyed shared library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmpdir:
        objs = [str(Path(tmpdir) / f"{src.stem}.o") for src in _sources()]
        _run([[nvcc, *_flags(src), "-c", "-o", obj, str(src)] for obj, src in zip(objs, _sources())])
        lib_tmp = str(Path(tmpdir) / out.name)
        _run([[nvcc, "-shared", *ARCH, "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)
    return out


def _argtype(name: str, param: str):
    kind = " ".join(param.split()[:-1])  # the declared type, without the parameter's name
    if "*" in param or kind == "cudaStream_t":
        return ctypes.c_void_p
    if kind not in _C_TYPES:
        raise TypeError(f"{name}: no ctypes type for the parameter {param.strip()!r}")
    return _C_TYPES[kind]


def signatures() -> dict[str, list]:
    """{entry point: the ctypes types of its parameters}, read from the
    `extern "C" int vx_...(...)` declarations in csrc/*.cu."""
    found = {}
    for src in _sources():
        for name, params in _DECLARATION.findall(src.read_text()):
            found[name] = [_argtype(name, p) for p in params.split(",") if p.strip()]
    return found


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, each entry point
    bound as its declaration has it (`signatures`)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in signatures().items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(symbol: str, on, *args, counter: str | None = None) -> None:
    """Call the library's `symbol` with `args` and the current stream of the
    device of `on` (a tensor or a device), under a device guard of that
    device; raise on a non-zero return; add one to LAUNCHES[counter] when
    a counter is named."""
    import torch

    device = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    with torch.cuda.device(device):
        code = getattr(lib(), symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {code}")
    if counter is not None:
        LAUNCHES[counter] += 1


def enable_peer_access(device, peer) -> None:
    """Let kernels on card `device` load from card `peer` (nothing to do
    for one card, or where it is enabled already); raise where the cards
    cannot reach each other. CPU devices need nothing."""
    import torch

    device, peer = torch.device(device), torch.device(peer)
    if device.type == "cpu" and peer.type == "cpu":
        return
    if device.type != "cuda" or peer.type != "cuda":
        raise ValueError(f"peer access from {device} to {peer}: both must be CUDA devices")
    if device == peer:
        return
    with torch.cuda.device(device):
        code = lib().vx_enable_peer_access(peer.index)
    if code != 0:
        raise RuntimeError(f"vx_enable_peer_access: {device} cannot load from {peer} (cudaError {code})")


def resident_warps(symbol: str, kernel: int, device, *extra: int) -> int:
    """The warps that kernel `kernel` of the occupancy query `symbol` (a C
    entry point `int symbol(int kernel, int... extra, int* warps)`) keeps
    resident on one SM of `device`."""
    import torch

    warps = ctypes.c_int()
    with torch.cuda.device(device):
        code = getattr(lib(), symbol)(kernel, *extra, ctypes.byref(warps))
    if code:
        raise RuntimeError(f"{symbol}: cudaError {code}")
    return warps.value


def require_cuda(name: str, *tensors, dtype=None, device=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (`device`, when given) and of `dtype`, when given."""
    dev = tensors[0].device if device is None else device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
