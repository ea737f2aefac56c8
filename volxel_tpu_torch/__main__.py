"""volxel_tpu_torch command-line app — the counterpart of the reference demo
page, and of `python -m volxel_tpu`, on PyTorch.

Subcommands:
  render     render a DICOM volume to PNG (progressive path tracing)
  ingest     parse a volume and print grid/histogram statistics
  benchmark  run a benchmark.json-compatible spec, save results JSON
  serve      interactive preview server (live orbit/zoom/clip over HTTP)
  info       device report

The embed contract of the reference (`data-urls`, `data-zip-url`,
`data-settings-url`, `data-env-url`, `data-render-mode`,
`data-benchmark-url`; index.html:24-33) maps to the corresponding flags.
Every renderer runs on `--device` (default `cuda`, the card); PNGs are
written by utils/png.py, so no imaging library is needed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _apply_setting_override(settings, kv: str) -> None:
    """--set key=value with type coercion from the field's current type."""
    import dataclasses

    key, eq, raw = kv.partition("=")
    field_names = {f.name for f in dataclasses.fields(settings)}
    if not eq or key not in field_names:
        raise SystemExit(f"unknown setting override {kv!r}")
    current = getattr(settings, key)
    if isinstance(current, bool):
        value = raw.lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int):
        value = int(raw)
    elif isinstance(current, float):
        value = float(raw)
    elif isinstance(current, (list, tuple)):
        value = [float(v) for v in raw.split(",")]
    else:
        value = raw
    setattr(settings, key, value)


def _load_volume(args, renderer) -> None:
    if args.zip:
        renderer.restart_from_zip(Path(args.zip).read_bytes())
    elif args.files:
        paths = sorted(Path(args.files).glob("*"))
        paths = [p for p in paths if p.is_file()]
        if not paths:
            sys.exit(f"no files in {args.files}")
        renderer.restart_from_files(paths)
    elif args.synthetic:
        from volxel_tpu_torch.grid import construct_brick_grid
        from volxel_tpu_torch.utils.fixtures import synthetic_ct_volume

        size = args.synthetic
        vol = synthetic_ct_volume((size, size, size), bits_stored=12)
        renderer.restart_from_grid(
            construct_brick_grid(vol.astype(np.float32) / vol.max(), transform=np.eye(4, dtype=np.float32))
        )
    else:
        sys.exit("one of --zip, --files, --synthetic is required")


def _add_volume_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--zip", help="ZIP archive of DICOM slices")
    p.add_argument("--files", help="directory of DICOM files")
    p.add_argument("--synthetic", type=int, metavar="N", help="procedural N^3 test volume")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device to render on (default: cuda, the card)")


def cmd_render(args) -> None:
    import torch

    from volxel_tpu_torch import Renderer
    from volxel_tpu_torch.api.settings import load_settings
    from volxel_tpu_torch.utils.png import write_png

    w, h = (int(v) for v in args.size.split("x"))
    r = Renderer(width=w, height=h, device=args.device)
    _load_volume(args, r)
    if args.env:
        r.load_env(Path(args.env).read_bytes())
    if args.settings:
        r.restore_settings(load_settings(Path(args.settings)))
    if args.mode:
        r.render_mode = args.mode
    if args.samples:
        r.settings.max_samples = args.samples
    for kv in args.set:
        _apply_setting_override(r.settings, kv)
    if args.camera_orbit:
        yaw, pitch, zoom = (float(v) for v in args.camera_orbit.split(","))
        r.camera.rotate_around_view(yaw, pitch)
        r.camera.zoom(zoom)

    total = r.settings.max_samples
    t0 = time.time()
    for i in range(total):
        r.render_frame()
        if args.progress and (i + 1) % 100 == 0:
            print(f"rendered sample {i + 1} of {total}", file=sys.stderr)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    dt = time.time() - t0
    write_png(args.out, (np.clip(r.image(), 0.0, 1.0) * 255).astype(np.uint8))
    print(f"wrote {args.out}: {w}x{h}, {total} samples in {dt:.1f}s ({dt / total * 1000:.2f} ms/sample)")


def cmd_ingest(args) -> None:
    from volxel_tpu_torch.ingest import read_dicom_series, read_zip_series
    from volxel_tpu_torch.ingest.series import series_to_grid

    t0 = time.time()
    if args.zip:
        series = read_zip_series(Path(args.zip).read_bytes())
    elif args.files:
        paths = [p for p in sorted(Path(args.files).glob("*")) if p.is_file()]
        series = read_dicom_series(paths)
    else:
        sys.exit("one of --zip, --files is required")
    t_parse = time.time() - t0

    t0 = time.time()
    grid = series_to_grid(series)
    t_build = time.time() - t0

    z, y, x = series.data.shape
    bx, by, bz = grid.brick_count
    print(f"grid resolution: {x} {y} {z}")
    print(f"value range: [{series.min}, {series.max}], bins: {len(series.histogram)}")
    print(f"transform diag: {np.diag(series.transform)[:3].tolist()}")
    print(f"bricks: {bx}x{by}x{bz}, occupied {grid.brick_counter}")
    print(f"atlas: {grid.atlas.shape}, total {grid.size_bytes / 1e6:.1f} MB")
    print(f"parse {t_parse:.2f}s, brick build {t_build:.2f}s")


def cmd_benchmark(args) -> None:
    from volxel_tpu_torch import Renderer
    from volxel_tpu_torch.api.benchmark import run_benchmark_collection, save_benchmark

    spec = json.loads(Path(args.spec).read_text())
    w, h = (int(v) for v in args.size.split("x"))
    r = Renderer(width=w, height=h, device=args.device)
    base = Path(args.spec).parent

    def load_resource(name: str) -> bytes | None:
        p = base / name
        if not p.exists():
            print(f"warning: resource {name} not found, keeping current scene", file=sys.stderr)
            return None
        return p.read_bytes()

    if args.synthetic:
        _load_volume(args, r)
    results = run_benchmark_collection(spec, r, load_zip=load_resource, load_env=load_resource)
    save_benchmark(results, args.out)
    for res in results:
        print(f"{res['name'] or 'benchmark'}: {res['timePerSample']:.2f} ms/sample")
    print(f"wrote {args.out}")


def cmd_serve(args) -> None:
    from volxel_tpu_torch import Renderer
    from volxel_tpu_torch.api.server import PreviewServer
    from volxel_tpu_torch.api.settings import load_settings

    w, h = (int(v) for v in args.size.split("x"))
    if args.mesh:
        from volxel_tpu_torch.parallel.distributed import DistributedRenderer
        from volxel_tpu_torch.parallel.mesh import make_mesh

        sp, px, vz = (int(v) for v in args.mesh.split(","))
        # the default device spans every card; a named one holds every position
        devices = None if args.device == "cuda" else [args.device] * (sp * px * vz)
        r = DistributedRenderer(width=w, height=h, mesh=make_mesh(sp=sp, px=px, vz=vz, devices=devices))
    else:
        r = Renderer(width=w, height=h, device=args.device)
    _load_volume(args, r)
    if args.env:
        r.load_env(Path(args.env).read_bytes())
    if args.settings:
        r.restore_settings(load_settings(Path(args.settings)))
    PreviewServer(r, host=args.host, port=args.port).serve_forever()


def cmd_info(args) -> None:
    import torch

    from volxel_tpu_torch.api.benchmark import device_fingerprint
    from volxel_tpu_torch.native.loader import native_available

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"no CUDA device (torch {torch.__version__}); `info --device cpu` reports the CPU")
    print(json.dumps(device_fingerprint(device), indent=2))
    print(f"native ingest: {'available' if native_available() else 'unavailable'}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, card available: {torch.cuda.is_available()}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="volxel_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a volume to PNG")
    _add_volume_args(p)
    _add_device_arg(p)
    p.add_argument("--env", help="HDR environment map")
    p.add_argument("--settings", help="settings JSON (V3 export)")
    p.add_argument("--mode", choices=["default", "no_dda", "raymarch"])
    p.add_argument("--size", default="512x512", help="WxH viewport")
    p.add_argument("--samples", type=int, help="override sample count")
    p.add_argument("--camera-orbit", help="yaw,pitch,zoom")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any ViewerSettings field, incl. the extension "
        "flags (e.g. --set physical_majorant=true --set bounces=3)",
    )
    p.add_argument("--out", default="render.png")
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("ingest", help="parse a volume, print statistics")
    _add_volume_args(p)
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("benchmark", help="run a benchmark spec")
    p.add_argument("--spec", required=True, help="benchmark.json path")
    p.add_argument("--size", default="1920x1080")
    p.add_argument("--out", default="benchmark_results.json")
    _add_volume_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("serve", help="interactive preview server (live orbit/zoom/clip)")
    _add_volume_args(p)
    _add_device_arg(p)
    p.add_argument("--size", default="960x540", help="render size WxH")
    p.add_argument("--env", help="HDR/EXR environment map")
    p.add_argument("--settings", help="settings JSON (v1-v3 exports)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mesh", help="sp,px,vz mesh of a DistributedRenderer: over every card by default, or "
                   "every position on --device when it names one; vz > 1 holds the volume in z-slabs over the "
                   "vz axis (no drag previews then)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("info", help="device report")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
