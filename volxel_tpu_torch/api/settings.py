"""Versioned scene-settings JSON: export / import / structural validation.

Interop with the reference settings system (volxel-3d-viewer/src/
settings.ts:62-165): the V3 `SettingsExport` schema is accepted verbatim, so
settings JSON exported from the reference viewer drives renders here. The
in-memory `ViewerSettings` mirrors settings.ts:45-61 with the reference
defaults (viewer.ts:147-163).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Any

import numpy as np

RENDER_MODES = ("default", "no_dda", "raymarch")

SETTINGS_VERSIONS = ("v1", "v2", "v3")

TRANSFER_COLOR_STOPS = "color_stops"
TRANSFER_FULL = "full"


def _normalize(v):
    n = np.asarray(v, dtype=np.float64)
    return (n / np.linalg.norm(n)).tolist()


@dataclass
class ViewerSettings:
    """Runtime view state (reference defaults, viewer.ts:147-163)."""

    density_multiplier: float = 1.0
    max_samples: int = 2000
    debug_hits: bool = False
    volume_clip_min: list = field(default_factory=lambda: [0.0, 0.0, 0.0])
    volume_clip_max: list = field(default_factory=lambda: [1.0, 1.0, 1.0])
    show_environment: bool = True
    use_env: bool = True
    light_dir: list = field(default_factory=lambda: _normalize([-1.0, -1.0, -1.0]))
    sync_light_dir: bool = False
    bounces: int = 3
    gamma: float = 2.2
    exposure: float = 5.5
    sample_range: list = field(default_factory=lambda: [0.0, 1.0])
    render_mode: str = "default"
    resolution_factor: float = 1.0
    # extension beyond the reference (BASELINE config 4): first-hit
    # central-difference gradient Blinn-Phong shading
    gradient_shading: bool = False
    # extension: unbiased ratio-tracking shadow transmittance (soft
    # shadows) instead of the reference's binary-shadow quirk
    physical_shadows: bool = False
    physical_majorant: bool = False
    # replicate the reference's warm-up responsiveness drop: the first 5
    # samples render at 0.33 resolution (viewer.ts:132,1185-1188). They
    # carry zero accumulation weight either way, so the converged image
    # is identical; off by default (the DVR drag preview covers
    # interactivity, and enabling costs one extra jit specialization)
    warmup_low_res: bool = False
    # extension: true equirect solid-angle env pdf on both MIS sides
    # (consistent NEE estimator) instead of the reference's 1/(4*pi)
    physical_pdf: bool = False

    def to_json_dict(self) -> dict:
        """camelCase dict matching the reference ViewerSettings shape."""
        return {
            "densityMultiplier": self.density_multiplier,
            "maxSamples": self.max_samples,
            "debugHits": self.debug_hits,
            "volumeClipMin": list(self.volume_clip_min),
            "volumeClipMax": list(self.volume_clip_max),
            "showEnvironment": self.show_environment,
            "useEnv": self.use_env,
            "lightDir": list(self.light_dir),
            "syncLightDir": self.sync_light_dir,
            "bounces": self.bounces,
            "gamma": self.gamma,
            "exposure": self.exposure,
            "sampleRange": list(self.sample_range),
            "renderMode": self.render_mode,
            "resolutionFactor": self.resolution_factor,
        }


# A SettingsExport is handled as a plain dict with the V3 reference schema.
SettingsExport = dict


class MalformedSettingsError(ValueError):
    pass


def _require_number(value, what: str):
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        raise MalformedSettingsError(f"Malformed {what}: expected a number")


def _require_bool(value, what: str):
    if not isinstance(value, bool):
        raise MalformedSettingsError(f"Malformed {what}: expected a boolean")


def verify_vector(vector: Any):
    """settings.ts:107-111"""
    if (
        not isinstance(vector, (list, tuple))
        or len(vector) != 3
        or any(isinstance(e, bool) or not isinstance(e, (int, float)) for e in vector)
    ):
        raise MalformedSettingsError("Malformed Vector in Settings detected.")


def verify_transfer_settings(settings: dict) -> dict:
    """settings.ts:75-93"""
    try:
        _require_number(settings["densityMultiplier"], "Transfer Settings")
        hr = settings["histogramRange"]
        if not isinstance(hr, (list, tuple)) or len(hr) != 2:
            raise MalformedSettingsError("Malformed Transfer Settings detected.")
        for v in hr:
            _require_number(v, "Transfer Settings")
        transfer = settings["transfer"]
        ttype = transfer["type"]
        if ttype == TRANSFER_COLOR_STOPS:
            for stop in transfer["colors"]:
                _require_number(stop["stop"], "Transfer Settings")
                for c in stop["color"]:
                    _require_number(c, "Transfer Settings")
        elif ttype == TRANSFER_FULL:
            for entry in transfer["colors"]:
                for c in entry:
                    _require_number(c, "Transfer Settings")
        else:
            raise MalformedSettingsError("Malformed Transfer Settings detected.")
    except (KeyError, TypeError) as e:
        raise MalformedSettingsError("Malformed Transfer Settings detected.") from e
    return settings


def verify_display_settings(settings: dict):
    """settings.ts:95-105"""
    try:
        for key in ("samples", "bounces", "gamma", "exposure", "resolutionFactor"):
            _require_number(settings[key], "Display Settings")
        _require_bool(settings["debugHits"], "Display Settings")
        if settings["renderMode"] not in RENDER_MODES:
            raise MalformedSettingsError("Malformed Display Settings detected.")
    except (KeyError, TypeError) as e:
        raise MalformedSettingsError("Malformed Display Settings detected.") from e


def verify_lighting_settings(settings: dict):
    """settings.ts:113-118"""
    try:
        _require_number(settings["envStrength"], "Lighting Settings")
        for key in ("showEnv", "useEnv", "syncLightDir"):
            _require_bool(settings[key], "Lighting Settings")
        verify_vector(settings["lightDir"])
    except (KeyError, TypeError) as e:
        raise MalformedSettingsError("Malformed Lighting Settings detected.") from e


def verify_settings(settings: dict) -> dict:
    """Structural validation of a V3 SettingsExport (settings.ts:120-132)."""
    version = settings.get("version")
    if version != "v3":
        raise MalformedSettingsError(f"Unsupported Settings Format Version: {version}")
    verify_transfer_settings(settings["transfer"])
    verify_display_settings(settings["display"])
    verify_lighting_settings(settings["lighting"])
    other = settings["other"]
    verify_vector(other["cameraLookAt"])
    verify_vector(other["cameraPos"])
    verify_vector(other["clipMax"])
    verify_vector(other["clipMin"])
    return settings


def load_settings(source) -> dict:
    """Load + verify a settings export from a path, JSON string, or dict."""
    if isinstance(source, dict):
        return verify_settings(source)
    if isinstance(source, (str, Path)) and Path(str(source)).exists():
        text = Path(source).read_text()
    else:
        text = str(source)
    return verify_settings(json.loads(text))


def save_settings(settings: dict, path) -> None:
    verify_settings(settings)
    Path(path).write_text(json.dumps(settings))


def make_settings_export(
    viewer: ViewerSettings,
    transfer_colors,
    transfer_type: str,
    histogram_range,
    env_strength: float,
    camera_pos,
    camera_look_at,
) -> dict:
    """Assemble a V3 SettingsExport from runtime state (viewer.ts export path)."""
    export = {
        "version": "v3",
        "transfer": {
            "densityMultiplier": viewer.density_multiplier,
            "transfer": {"type": transfer_type, "colors": transfer_colors},
            "histogramRange": list(histogram_range),
        },
        "display": {
            "samples": viewer.max_samples,
            "bounces": viewer.bounces,
            "gamma": viewer.gamma,
            "exposure": viewer.exposure,
            "debugHits": viewer.debug_hits,
            "renderMode": viewer.render_mode,
            "resolutionFactor": viewer.resolution_factor,
        },
        "lighting": {
            "useEnv": viewer.use_env,
            "showEnv": viewer.show_environment,
            "envStrength": env_strength,
            "syncLightDir": viewer.sync_light_dir,
            "lightDir": list(viewer.light_dir),
        },
        "other": {
            "cameraPos": [float(v) for v in camera_pos],
            "cameraLookAt": [float(v) for v in camera_look_at],
            "clipMin": [float(v) for v in viewer.volume_clip_min],
            "clipMax": [float(v) for v in viewer.volume_clip_max],
        },
    }
    return verify_settings(export)
