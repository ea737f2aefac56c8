"""Renderer facade: the PyTorch counterpart of volxel_tpu.api.renderer.

Owns the scene (volume, camera, environment, transfer LUT), the viewer
settings and the progressive accumulation loop, with the reference web
component's surface (viewer.ts:111+):

  from_attributes (local paths or URLs)     (viewer.ts:112, 840-848)
  restart_from_files / restart_from_zip / restart_from_grid
                                            (viewer.ts:963-1017)
  load_env / load_env_default               (viewer.ts:1019-1040)
  restore_settings / export_settings        (viewer.ts:626-762)
  render_frame / render / image / raw_image (viewer.ts:1183-1293)
  render_mode property                      (viewer.ts:1442-1452)
  handle_error / clear_error / suspend      (viewer.ts:797-821)
  image(show_clipping=) / make_clip_controller
                                            (viewer.ts:1267-1288, 1359-1440)
  render_dvr / render_preview               (shear-warp preview, an extension)

Progressive semantics: samples 0..4 are warm-up (weight 0, each overwrites
the buffer — viewer.ts:132,1356), accumulation starts at sample 5 as a
running average. With settings.warmup_low_res the warm-up samples render at
0.33 resolution into a display-only preview instead (viewer.ts:132,
1185-1188).

Every tensor lives on the `device` the renderer was made for: the card
(`"cuda"`) unless the caller names another, such as the CPU, where every
kernel takes its plain version. ZIP/DICOM series and HDR/EXR environments
are decoded on the host (`ingest/`, with the native library of `native/`
where it builds) and uploaded to that device; `zip_url` and `env_url` are
fetched with urllib. A failed load puts the renderer in its error state,
which gates restarts and render_frame until clear_error().
"""

from __future__ import annotations

import numpy as np
import torch

from volxel_tpu_torch.api.settings import ViewerSettings, make_settings_export
from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.ingest.hdr import decode_env_bytes
from volxel_tpu_torch.ingest.series import read_dicoms_to_grid
from volxel_tpu_torch.ingest.ziploader import read_zip_to_grid
from volxel_tpu_torch.render import shearwarp
from volxel_tpu_torch.render.pallas_ops import tonemap_display
from volxel_tpu_torch.render.pathtrace import (
    WARMUP_SAMPLES,
    RenderConfig,
    accumulate_progressive,
    render_sample,
)
from volxel_tpu_torch.render.sampling import VolumeParams, device_grid_from_brick
from volxel_tpu_torch.scene.camera import Camera
from volxel_tpu_torch.scene.environment import Environment, default_environment
from volxel_tpu_torch.scene.interaction import ClipBoxController
from volxel_tpu_torch.scene.volume import Volume
from volxel_tpu_torch.transfer.function import (
    DEFAULT_COLOR_STOPS,
    generate_transfer_function,
    parse_transfer_function,
)
from volxel_tpu_torch.utils.overlay import draw_clip_box
from volxel_tpu_torch.utils.profiling import span

def _fetch_url(url: str) -> bytes:
    """GET a resource — the fetch() behind restartFromZipUrl /
    loadEnvFromUrl (viewer.ts:991-1003,1035-1040). Raises on non-2xx
    like the reference's response.ok check."""
    from urllib.request import urlopen

    with urlopen(url) as resp:  # noqa: S310 — caller-provided URL by design
        return resp.read()


class Renderer:
    def __init__(self, width: int = 1920, height: int = 1080, *, device="cuda",
                 settings: ViewerSettings | None = None):
        """A renderer on `device`: the card unless the caller names another
        device (the CPU takes every kernel's plain version)."""
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        self.settings = settings or ViewerSettings()

        self.camera = Camera(1.0)
        self.environment: Environment = default_environment(self.device)
        self.volume: Volume | None = None
        self.density_scale: float = 1.0
        self.grid: BrickGrid | None = None
        self._device_grid = None

        self._transfer_colors = [dict(c) for c in DEFAULT_COLOR_STOPS]
        self._transfer_type = "color_stops"
        self._lut = self._to_device(generate_transfer_function(self._transfer_colors))

        self.frame_index = 0
        self._framebuffer = torch.zeros((self.height * self.width, 3), dtype=torch.float32, device=self.device)
        # the preview's permuted volumes per (perm, flip), for one dense field
        self._preview_vol_cache: tuple | None = None
        # the low-res warm-up's last sample, (width, height, sample)
        self._warmup_preview: tuple | None = None

        # error handling (viewer.ts:797-821): a failed load suspends
        # rendering and gates further restarts until cleared
        self.errored: bool = False
        self.last_error: Exception | None = None
        self.suspend: bool = False
        # the clip-box controller image(show_clipping=True) highlights
        self.clip_controller = None  # made by make_clip_controller()

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, dtype=np.float32)).to(self.device)

    @classmethod
    def from_attributes(
        cls,
        width: int = 1920,
        height: int = 1080,
        zip_path=None,
        files_dir=None,
        settings_path=None,
        env_path=None,
        render_mode: str | None = None,
        benchmark_path=None,
        zip_url: str | None = None,
        env_url: str | None = None,
        *,
        device="cuda",
    ) -> "Renderer":
        """Declarative construction — the embed-attribute contract
        (data-zip-url / data-urls / data-settings-url / data-env-url /
        data-render-mode / data-benchmark-url, viewer.ts:112,
        index.html:24-33), with local paths OR http(s) URLs.

        `zip_url` / `env_url` fetch over HTTP like the reference's
        restartFromZipUrl / loadEnvFromUrl (viewer.ts:991-1003,1035-1040);
        the corresponding `*_path` argument wins if both are given.

        `benchmark_path` mirrors `attributeBenchmark` (viewer.ts:840-848):
        after construction the benchmark collection is run immediately and
        the results are stored on the renderer as `last_benchmark`; a spec
        entry's `zip` and `env` name files beside the spec."""
        from pathlib import Path

        r = cls(width=width, height=height, device=device)
        if zip_path is not None:
            r.restart_from_zip(Path(zip_path).read_bytes())
        elif files_dir is not None:
            paths = sorted(p for p in Path(files_dir).iterdir() if p.is_file())
            r.restart_from_files(paths)
        elif zip_url is not None:
            r.restart_from_zip(_fetch_url(zip_url))
        if env_path is not None:
            r.load_env(Path(env_path).read_bytes())
        elif env_url is not None:
            r.load_env(_fetch_url(env_url))
        if settings_path is not None:
            from volxel_tpu_torch.api.settings import load_settings

            r.restore_settings(load_settings(Path(settings_path)))
        if render_mode is not None:
            r.render_mode = render_mode
        if benchmark_path is not None:
            import json

            from volxel_tpu_torch.api.benchmark import run_benchmark_collection

            spec = json.loads(Path(benchmark_path).read_text())
            base = Path(benchmark_path).parent

            def _load(rel):
                p = base / rel
                return p.read_bytes() if p.exists() else None

            r.last_benchmark = run_benchmark_collection(spec, r, load_zip=_load, load_env=_load)
        return r

    # -- volume loading (viewer.ts:963-1017, 1080-1145) ------------------------

    def handle_error(self, error: Exception) -> None:
        """Central error sink: suspend rendering, keep the error
        (reference handleError, viewer.ts:797-821)."""
        self.errored = True
        self.last_error = error
        self.suspend = True

    def clear_error(self) -> None:
        self.errored = False
        self.last_error = None
        self.suspend = False

    def restart_from_grid(self, grid: BrickGrid) -> None:
        """setupFromGrid: reset clip/scale, unit-cube rescale, upload."""
        if self.errored:
            return  # restarts are gated while errored (viewer.ts:1156)
        self.grid = grid
        self.density_scale = 1.0
        self.settings.volume_clip_min = [0.0, 0.0, 0.0]
        self.settings.volume_clip_max = [1.0, 1.0, 1.0]
        self.volume = Volume.from_grid(grid)
        self.density_scale *= self.volume.rescale_to_unit_cube()
        self._device_grid = self._upload_grid(grid)
        self.restart_rendering()

    def _upload_grid(self, grid: BrickGrid):
        """The device grid of a host brick grid: its dense field decoded on
        the renderer's device."""
        with span("vx::grid.upload"):
            return device_grid_from_brick(grid, self.device)

    def restart_from_files(self, sources: list) -> None:
        """DICOM slices (paths or bytes), in the order given. A failure
        puts the renderer in its error state and propagates."""
        try:
            self.restart_from_grid(read_dicoms_to_grid(sources))
        except Exception as e:
            self.handle_error(e)
            raise

    def restart_from_zip(self, source) -> None:
        """A single-folder ZIP of DICOM slices (path or bytes). A failure
        puts the renderer in its error state and propagates."""
        try:
            self.restart_from_grid(read_zip_to_grid(source))
        except Exception as e:
            self.handle_error(e)
            raise

    # -- environment (viewer.ts:1019-1040, 1074-1078) --------------------------

    def load_env(self, data: bytes, strength: float | None = None) -> None:
        """An HDR or EXR environment map, built on the renderer's device;
        the current strength carries over unless `strength` is given."""
        image = decode_env_bytes(data)
        self.environment = Environment(
            image, strength if strength is not None else self.environment.strength, device=self.device
        )
        self.restart_rendering()

    def load_env_default(self) -> None:
        self.environment = default_environment(self.device)
        self.restart_rendering()

    @property
    def env_strength(self) -> float:
        return self.environment.strength

    @env_strength.setter
    def env_strength(self, value: float) -> None:
        self.environment.with_strength(float(value))
        self.restart_rendering()

    # -- transfer function ------------------------------------------------------

    def set_transfer_colors(self, colors: list[dict]) -> None:
        self._transfer_colors = [dict(c) for c in colors]
        self._transfer_type = "color_stops"
        self._lut = self._to_device(generate_transfer_function(self._transfer_colors))
        self.restart_rendering()

    def set_transfer_full(self, rgba_rows) -> None:
        self._transfer_colors = [list(r) for r in rgba_rows]
        self._transfer_type = "full"
        self._lut = self._to_device(rgba_rows)
        self.restart_rendering()

    def load_transfer_function(self, text: str) -> None:
        """Load an `r g b density` text transfer function (data.ts:5-14)."""
        rows = parse_transfer_function(text)
        if not rows:
            raise ValueError("No transfer function rows parsed")
        self.set_transfer_full(rows)

    # -- render mode (viewer.ts:1442-1452) --------------------------------------

    @property
    def render_mode(self) -> str:
        return self.settings.render_mode

    @render_mode.setter
    def render_mode(self, mode: str) -> None:
        if mode not in ("default", "no_dda", "raymarch"):
            raise ValueError(f"Unknown render mode: {mode}")
        self.settings.render_mode = mode
        self.restart_rendering()

    # -- progressive loop (viewer.ts:1155-1293) ---------------------------------

    def restart_rendering(self) -> None:
        self.frame_index = 0

    def _render_dims(self) -> tuple[int, int]:
        factor = float(self.settings.resolution_factor)
        return max(1, round(self.width * factor)), max(1, round(self.height * factor))

    def _render_warmup_preview(self) -> None:
        """One low-res warm-up sample (0.33 resolutionFactor) into the
        display-only preview buffer; each frame replaces the previous
        (the reference's warm-up frames have sample_weight 0)."""
        full = self._config()
        w = max(1, round(full.width * 0.33))
        h = max(1, round(full.height * 0.33))
        with span("vx::operands"):
            inv_view, inv_proj, light_dir = self._camera_operands(full)  # the full frame's aspect
            params = self.volume_params()
        sample = render_sample(
            full._replace(width=w, height=h), self._device_grid, params, self._lut,
            self.environment.state, inv_view, inv_proj, light_dir, self.frame_index,
        )
        self._warmup_preview = (w, h, sample)

    def _config(self) -> RenderConfig:
        w, h = self._render_dims()
        return RenderConfig(
            width=w,
            height=h,
            mode=self.settings.render_mode,
            bounces=int(self.settings.bounces),
            show_environment=bool(self.settings.show_environment),
            use_env=bool(self.settings.use_env),
            debug_hits=bool(self.settings.debug_hits),
            gradient_shading=bool(self.settings.gradient_shading),
            physical_shadows=bool(self.settings.physical_shadows),
            physical_majorant=bool(self.settings.physical_majorant),
            physical_pdf=bool(self.settings.physical_pdf),
        )

    def volume_params(self) -> VolumeParams:
        """bindUniforms volume block (viewer.ts:1324-1345)."""
        if self.volume is None:
            raise RuntimeError("No volume loaded")
        lo, hi = self.volume.aabb_clipped(self.settings.volume_clip_min, self.settings.volume_clip_max)
        vmin, vmaj = self.volume.min_maj
        scale = self.density_scale * self.settings.density_multiplier
        maj = vmaj * scale

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=self.device)

        return VolumeParams(
            aabb_lo=self._to_device(lo),
            aabb_hi=self._to_device(hi),
            transform_inv=self._to_device(np.linalg.inv(self.volume.combined_transform()).astype(np.float32)),
            vol_min=scalar(vmin * scale),
            vol_maj=scalar(maj),
            inv_maj=scalar(1.0 / maj),
            density_scale=scalar(scale),
            albedo=torch.full((3,), 0.9, dtype=torch.float32, device=self.device),  # viewer.ts:1337
            phase_g=scalar(0.0),  # viewer.ts:1338
            sample_range=self._to_device(self.settings.sample_range),
        )

    def _camera_operands(self, config: RenderConfig):
        inv_view = self._to_device(np.linalg.inv(self.camera.view_matrix()).astype(np.float32))
        inv_proj = self._to_device(
            np.linalg.inv(self.camera.proj_matrix(config.width / config.height)).astype(np.float32)
        )
        return inv_view, inv_proj, self._to_device(self.settings.light_dir)

    def maybe_sync_light(self) -> None:
        """Backlight mode (viewer.ts:789-795): when syncLightDir is on,
        the light points from the camera toward the look-at target."""
        if self.settings.sync_light_dir:
            diff = self.camera.view - self.camera.pos
            self.settings.light_dir = [float(-v) for v in diff]
            self.restart_rendering()

    def sample_weight(self) -> float:
        """viewer.ts:1356"""
        f = self.frame_index
        if f < WARMUP_SAMPLES:
            return 0.0
        return (f - WARMUP_SAMPLES) / (f - WARMUP_SAMPLES + 1)

    def render_frame(self) -> torch.Tensor:
        """Render one progressive sample and fold it into the accumulator.

        Returns the accumulated (linear, pre-tonemap) framebuffer. Raises
        while errored; while suspended, renders nothing. With
        warmup_low_res the warm-up frames render the low-res preview and
        leave the accumulator alone (they have zero weight).
        """
        if self._device_grid is None:
            raise RuntimeError("No volume loaded")
        if self.errored:
            raise RuntimeError("Renderer is in an error state (clear_error() to resume)") from self.last_error
        if self.suspend:
            return self._framebuffer
        with span("vx::render_frame", frame=self.frame_index, mode=self.settings.render_mode):
            if self.settings.warmup_low_res and self.frame_index < WARMUP_SAMPLES:
                self._render_warmup_preview()
                self.frame_index += 1
                return self._framebuffer
            self._warmup_preview = None
            return self._accumulate_frame()

    def _accumulate_frame(self) -> torch.Tensor:
        """One full-resolution sample folded into the accumulator."""
        config = self._config()
        n = config.width * config.height
        with span("vx::operands"):
            if self._framebuffer.shape[0] != n:
                self._framebuffer = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
            inv_view, inv_proj, light_dir = self._camera_operands(config)
            params = self.volume_params()
        sample = render_sample(
            config, self._device_grid, params, self._lut, self.environment.state,
            inv_view, inv_proj, light_dir, self.frame_index,
        )
        self._framebuffer = accumulate_progressive(self._framebuffer, sample, self.frame_index)
        self.frame_index += 1
        return self._framebuffer

    def render(self, samples: int | None = None) -> np.ndarray:
        """Render `samples` progressive frames (or maxSamples) and return the
        tonemapped image, as the JAX package's Renderer.render does.

        Up to WARMUP_SAMPLES + 1 frames, that many more frames are rendered
        from the current frame index. Beyond that the image is the mean of
        frames [WARMUP_SAMPLES, samples), whatever was rendered before:
        warm-up frames carry zero weight and frame WARMUP_SAMPLES overwrites
        the accumulator (viewer.ts:1356), so rendering those frames in order
        gives that mean, at full resolution whatever warmup_low_res says
        (as the JAX package's batches do, which also pass by the error and
        suspend gates). The frame index then stands at `samples`.
        """
        total = samples if samples is not None else self.settings.max_samples
        if total <= WARMUP_SAMPLES + 1:
            for _ in range(total):
                self.render_frame()
            return self.image()
        if self._device_grid is None:
            raise RuntimeError("No volume loaded")
        self.frame_index = WARMUP_SAMPLES
        while self.frame_index < total:
            self._accumulate_frame()
        return self.image()

    def image(self, show_clipping: bool = False) -> np.ndarray:
        """Tonemapped (height, width, 3) float32 image, row 0 = top.

        During the low-res warm-up it is the preview, upsampled to full
        size. show_clipping overlays the clip-box wireframe with the
        hovered/held face highlighted (the reference's clipping cube pass,
        viewer.ts:1267-1288).
        """
        w, h = self._render_dims()
        preview = self._warmup_preview
        if preview is not None and self.frame_index <= WARMUP_SAMPLES:
            pw, ph, sample = preview
            img = tonemap_display(sample, self.settings.exposure, self.settings.gamma)
            img = img.cpu().numpy().reshape(ph, pw, 3)[::-1]
            img = np.repeat(np.repeat(img, -(-h // ph), axis=0), -(-w // pw), axis=1)[:h, :w]
        else:
            img = tonemap_display(self._framebuffer, self.settings.exposure, self.settings.gamma)
            img = img.cpu().numpy().reshape(h, w, 3)[::-1]  # GL row 0 is the bottom
        if show_clipping and self.volume is not None:
            lo, hi = self.volume.aabb_clipped(self.settings.volume_clip_min, self.settings.volume_clip_max)
            ctl = self.clip_controller
            img = draw_clip_box(
                img, lo, hi, self.camera.view_matrix(), self.camera.proj_matrix(w / h),
                selected_face=ctl._last_face if ctl else None,
                adjusting=ctl.adjusting if ctl else False,
            )
        return img

    def make_clip_controller(self):
        """Attach and return a ClipBoxController for interactive editing."""
        self.clip_controller = ClipBoxController(self)
        return self.clip_controller

    def raw_image(self) -> np.ndarray:
        """Linear accumulated radiance, (height, width, 3), row 0 = top."""
        w, h = self._render_dims()
        return self._framebuffer.cpu().numpy().reshape(h, w, 3)[::-1]

    # -- shear-warp preview (an extension: render/shearwarp.py) ------------------

    def _index_view_dir(self) -> np.ndarray:
        """The camera's forward axis in index space."""
        forward = self.camera.view - self.camera.pos
        minv = np.linalg.inv(self.volume.combined_transform().astype(np.float64))
        return minv[:3, :3] @ forward

    def _occupied_mid(self):
        """(Z, Y, X) voxel centre of the occupied bricks, or None: keeps the
        warp's reference plane on the data when mip alignment pads the
        index box far past it."""
        occ = np.asarray(self.grid.range_hi) > 0
        if not occ.any():
            return None
        zs, ys, xs = np.nonzero(occ)
        return np.array(
            [
                (zs.min() + zs.max() + 1) * 4.0,  # brick -> voxel mid
                (ys.min() + ys.max() + 1) * 4.0,
                (xs.min() + xs.max() + 1) * 4.0,
            ]
        )

    def render_dvr(self, screen: bool = False) -> np.ndarray:
        """Deterministic shear-warp DVR preview of the current view.

        With screen=False returns the tonemapped intermediate (sheared-space)
        image; with screen=True applies the warp half of shear-warp and
        returns a (height, width, 3) image aligned with the camera (row 0 =
        top). The canvas follows this view's shear (the static canvas)."""
        if self._device_grid is None or self._device_grid.dense is None:
            raise RuntimeError("DVR preview needs a loaded dense volume (a volume in slabs has none)")
        dense = self._device_grid.dense
        d_index = self._index_view_dir()
        scale = float(self.density_scale * self.settings.density_multiplier)
        c, t = shearwarp.render_dvr(dense, self._lut, d_index, vol_maj=1.0, density_scale=scale)
        if screen:
            w, h = self._render_dims()
            c = shearwarp.warp_to_screen(
                c, t, d_index, tuple(int(v) for v in dense.shape),
                self.volume.combined_transform().astype(np.float64),
                self.camera.view_matrix().astype(np.float64),
                self.camera.proj_matrix(w / h).astype(np.float64),
                w, h, occupied_mid=self._occupied_mid(),
            )
        return shearwarp.display(c, self.settings.exposure, self.settings.gamma).cpu().numpy()

    def _preview_volume(self, perm, flip: bool) -> torch.Tensor:
        """The permuted, flipped contiguous volume for (perm, flip), made at
        the first preview of its principal axis and direction, then reused."""
        dense = self._device_grid.dense
        if self._preview_vol_cache is None or self._preview_vol_cache[0] is not dense:
            self._preview_vol_cache = (dense, {})
        volumes = self._preview_vol_cache[1]
        if (perm, flip) not in volumes:
            volumes[(perm, flip)] = shearwarp.permuted_volume(dense, perm, flip)
        return volumes[(perm, flip)]

    def render_preview(self, scale: float = 1.0) -> np.ndarray:
        """Interactive shear-warp preview: camera-aligned, tonemapped,
        (height, width, 3), row 0 = top.

        The intermediate canvas is fixed at the worst-case shear, so every
        view of one principal axis and direction uses one cached permuted
        volume and one canvas size (at most 6 of each)."""
        if self._device_grid is None or self._device_grid.dense is None:
            raise RuntimeError("preview needs a loaded dense volume (a volume in slabs has none)")
        w, h = self._render_dims()
        if scale != 1.0:
            w, h = max(1, round(w * scale)), max(1, round(h * scale))
        dense = self._device_grid.dense
        perm, flip, sx, sy, h_mat = shearwarp.preview_homography(
            self._index_view_dir(), tuple(int(v) for v in dense.shape),
            self.volume.combined_transform().astype(np.float64),
            self.camera.view_matrix().astype(np.float64),
            self.camera.proj_matrix(w / h).astype(np.float64),
            w, h, occupied_mid=self._occupied_mid(),
        )
        density = float(self.density_scale * self.settings.density_multiplier)
        sigma_dt = density * float(np.sqrt(1.0 + sx * sx + sy * sy))
        img = shearwarp.preview_image(
            self._preview_volume(perm, flip), self._lut, sx, sy, 1.0, sigma_dt, h_mat,
            self.settings.exposure, self.settings.gamma, w, h,
        )
        return img.cpu().numpy()

    # -- settings import/export (viewer.ts:626-762) ------------------------------

    def export_settings(self) -> dict:
        return make_settings_export(
            self.settings,
            transfer_colors=self._transfer_colors,
            transfer_type=self._transfer_type,
            histogram_range=self.settings.sample_range,
            env_strength=self.environment.strength,
            camera_pos=self.camera.pos,
            camera_look_at=self.camera.view,
        )

    def restore_settings(self, export: dict) -> None:
        """Apply a verified V3 SettingsExport (viewer.ts restoreSettings)."""
        from volxel_tpu_torch.api.settings import verify_settings

        export = verify_settings(export)
        tr = export["transfer"]
        self.settings.density_multiplier = tr["densityMultiplier"]
        self.settings.sample_range = list(tr["histogramRange"])
        if tr["transfer"]["type"] == "color_stops":
            self.set_transfer_colors(tr["transfer"]["colors"])
        else:
            self.set_transfer_full(tr["transfer"]["colors"])

        disp = export["display"]
        self.settings.max_samples = int(disp["samples"])
        self.settings.bounces = int(disp["bounces"])
        self.settings.gamma = disp["gamma"]
        self.settings.exposure = disp["exposure"]
        self.settings.debug_hits = disp["debugHits"]
        self.settings.render_mode = disp["renderMode"]
        self.settings.resolution_factor = disp["resolutionFactor"]

        light = export["lighting"]
        self.settings.use_env = light["useEnv"]
        self.settings.show_environment = light["showEnv"]
        self.environment.with_strength(light["envStrength"])
        self.settings.sync_light_dir = light["syncLightDir"]
        self.settings.light_dir = list(light["lightDir"])

        other = export["other"]
        self.camera.pos = np.asarray(other["cameraPos"], np.float64)
        self.camera.view = np.asarray(other["cameraLookAt"], np.float64)
        self.settings.volume_clip_min = list(other["clipMin"])
        self.settings.volume_clip_max = list(other["clipMax"])
        self.restart_rendering()
