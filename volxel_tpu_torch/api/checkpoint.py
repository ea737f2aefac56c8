"""Checkpoint / resume of a progressive render (SURVEY §5): the PyTorch
counterpart of volxel_tpu.api.checkpoint, in the same file format.

The reference checkpoints only scene settings (versioned JSON,
settings.ts:62-73) and intentionally discards the accumulation buffer on
any change (restartRendering, viewer.ts:1155-1181). This module keeps that
settings checkpointing (api/settings.py) and adds the accumulation state
itself, so a many-thousand-sample render survives preemption and resumes
exactly where it stopped.

Format: a single .npz with the linear framebuffer, frame index, render
dimensions, and the full V3 settings export embedded as JSON. A file
either package writes loads into the other's Renderer; the framebuffer
goes onto the renderer's device.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

CHECKPOINT_VERSION = 1


def save_checkpoint(renderer, path) -> None:
    """Snapshot accumulation state + settings to an .npz."""
    export = renderer.export_settings()
    w, h = renderer._render_dims()
    np.savez_compressed(
        Path(path),
        version=CHECKPOINT_VERSION,
        framebuffer=renderer._framebuffer.cpu().numpy(),
        frame_index=renderer.frame_index,
        width=w,
        height=h,
        settings_json=json.dumps(export),
    )


def load_checkpoint(renderer, path) -> None:
    """Restore settings + accumulation state; rendering resumes at the
    saved frame index with identical convergence (RNG is keyed by frame)."""
    with np.load(Path(path), allow_pickle=False) as data:
        version = int(data["version"])
        if version != CHECKPOINT_VERSION:
            raise ValueError(f"Unsupported checkpoint version: {version}")
        settings = json.loads(str(data["settings_json"]))
        framebuffer = data["framebuffer"]
        frame_index = int(data["frame_index"])
        w, h = int(data["width"]), int(data["height"])

    renderer.restore_settings(settings)
    cur_w, cur_h = renderer._render_dims()
    if (cur_w, cur_h) != (w, h):
        raise ValueError(f"Checkpoint resolution {w}x{h} != renderer {cur_w}x{cur_h}")
    renderer._framebuffer = torch.from_numpy(np.asarray(framebuffer, np.float32)).to(renderer.device)
    renderer.frame_index = frame_index
