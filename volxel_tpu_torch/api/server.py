"""Interactive preview server: live frames + orbit/zoom/pan/clip over HTTP.
The PyTorch counterpart of volxel_tpu.api.server, with the same page,
routes and commands.

The reference is a live browser component (viewer.ts:1183-1293 rAF loop,
input wiring util.ts:30-143). Here the renderer runs server-side on its
device (the card unless the caller names another) and any browser is the
display: a background thread renders progressive samples continuously and
encodes PNGs (utils/png.py: no imaging library is needed); HTTP serves

  GET  /                 the embedded viewer page (drag = orbit, shift-drag
                         = pan, wheel = zoom, right-drag = clip planes — the
                         reference's exact input mapping incl. the
                         pi/max(w,h) drag scale and 0.9/1.1 wheel factors)
  GET  /frame.png        latest tonemapped frame
  GET  /stream           multipart/x-mixed-replace live stream of frames
  GET  /state            JSON: samples rendered, size, settings export
  GET  /transfer         JSON: the transfer function's colour stops
  GET  /settings.json    the settings export, as a download
  GET  /histogram        JSON: the density histogram's display bars
  GET  /benchmark_result JSON: the last benchmark's progress or result
  POST /input            {"type": rotate|pan|zoom|clip_*, ...} input commands
  POST /settings         partial ViewerSettings update
  POST /transfer         colour-ramp editor commit
  POST /settings_import  a settings export, verified before it is queued
  POST /benchmark        time the next N samples of the current scene

All renderer access happens on the render thread (the renderer is not
thread-safe); handlers enqueue commands and read the cached PNG. Every
scene change resets accumulation — the reference's restartRendering
contract (viewer.ts:1155-1181). The render thread runs `step()`, one
iteration of the loop, until the server stops; tests call `step()`
directly instead of starting the thread.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from volxel_tpu_torch.render.sampling import decode_dense_rows_device
from volxel_tpu_torch.utils.png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>volxel_tpu preview</title><style>
body { margin: 0; background: #111; color: #ddd; font: 13px sans-serif; }
#wrap { display: flex; flex-direction: column; align-items: center; gap: 8px; padding: 12px; }
#view { cursor: grab; touch-action: none; max-width: 96vw; }
#bar { opacity: 0.8 }
</style></head><body><div id="wrap">
<img id="view" src="/stream" draggable="false">
<div id="bar">drag orbit &middot; shift-drag pan &middot; wheel zoom &middot; right-drag clip &middot; <span id="stat"></span></div>
<div id="panel" style="display:flex;flex-wrap:wrap;gap:10px;align-items:center;max-width:720px">
  <label>mode <select id="mode">
    <option value="default">default (DDA)</option>
    <option value="no_dda">no_dda (tracking)</option>
    <option value="raymarch">raymarch</option>
  </select></label>
  <label>density <input type="range" id="density_multiplier" min="0.1" max="10" step="0.1" value="1"></label>
  <label>exposure <input type="range" id="exposure" min="0.1" max="20" step="0.1" value="5.5"></label>
  <label>gamma <input type="range" id="gamma" min="1" max="4" step="0.05" value="2.2"></label>
  <label>bounces <input type="range" id="bounces" min="1" max="8" step="1" value="3"></label>
  <label>samples <input type="range" id="max_samples" min="10" max="5000" step="10" value="2000"></label>
</div>
<canvas id="hist" width="512" height="80" style="background:#000;cursor:col-resize"></canvas>
<div style="display:flex;gap:10px;align-items:center">
  <canvas id="ramp" width="512" height="48" style="background:#000;cursor:pointer"></canvas>
  <input type="color" id="stopcolor" value="#ffffff" title="stop color">
  <label>a <input type="range" id="stopalpha" min="0" max="1" step="0.01" value="1" style="width:70px"></label>
</div>
<div id="rampbar" style="opacity:.7">transfer: drag stop &middot; click empty = add &middot; dblclick = remove &middot; pick color/alpha for selected</div>
<div style="display:flex;gap:14px;align-items:center">
  <canvas id="lightpad" width="96" height="96" style="background:#000;border-radius:8px;cursor:move" title="drag to aim the light"></canvas>
  <label><input type="checkbox" id="synclight"> light follows camera</label>
  <button id="exportbtn">export settings</button>
  <label style="border:1px solid #555;padding:2px 6px;cursor:pointer">import<input type="file" id="importfile" style="display:none"></label>
  <button id="benchbtn">benchmark</button><span id="benchstat"></span>
</div>
</div><script>
const view = document.getElementById('view');
const stat = document.getElementById('stat');
let dragging = false, moving = false, right = false, last = null;
function post(cmd) { fetch('/input', {method: 'POST', body: JSON.stringify(cmd)}); }
function ndc(e) {
  const r = view.getBoundingClientRect();
  return [ (e.clientX - r.left) / r.width * 2 - 1,
           -((e.clientY - r.top) / r.height * 2 - 1) ];
}
view.addEventListener('contextmenu', e => e.preventDefault());
// touch: 1-finger rotate, 2-finger pinch zoom, 3-finger pan — the
// reference's unified input layer (util.ts:43-133). touchstart
// preventDefault() suppresses synthesized mouse events; pointer events
// from touch are ignored below so the two paths don't double-fire.
let touchMode = null, lastDist = 0;
view.addEventListener('touchstart', e => {
  e.preventDefault();
  if (e.touches.length === 1 || e.touches.length === 3) {
    touchMode = e.touches.length === 1 ? 'rotate' : 'pan';
    last = [e.touches[0].clientX, e.touches[0].clientY];
  } else if (e.touches.length === 2) {
    touchMode = 'pinch';
    lastDist = Math.hypot(e.touches[0].clientX - e.touches[1].clientX,
                          e.touches[0].clientY - e.touches[1].clientY);
  }
}, {passive: false});
view.addEventListener('touchmove', e => {
  const r = view.getBoundingClientRect();
  if (touchMode === 'rotate') {
    if (e.touches.length !== 1) { touchMode = null; return; }
    const s = Math.max(r.width, r.height);
    const d = [e.touches[0].clientX - last[0], e.touches[0].clientY - last[1]];
    last = [e.touches[0].clientX, e.touches[0].clientY];
    post({type: 'rotate', by: [d[0] * Math.PI / s, d[1] * Math.PI / s]});
  } else if (touchMode === 'pinch') {
    if (e.touches.length !== 2) { touchMode = null; return; }
    const cur = Math.hypot(e.touches[0].clientX - e.touches[1].clientX,
                           e.touches[0].clientY - e.touches[1].clientY);
    if (cur > 0 && lastDist > 0) post({type: 'zoom', by: lastDist / cur});
    lastDist = cur;
  } else if (touchMode === 'pan') {
    if (e.touches.length !== 3) { touchMode = null; return; }
    const d = [(e.touches[0].clientX - last[0]) / r.width,
               (e.touches[0].clientY - last[1]) / r.height];
    last = [e.touches[0].clientX, e.touches[0].clientY];
    post({type: 'pan', by: d});
  }
}, {passive: false});
function touchStop() { touchMode = null; }
view.addEventListener('touchend', touchStop);
view.addEventListener('touchcancel', touchStop);
view.addEventListener('pointerdown', e => {
  if (e.pointerType === 'touch') return;
  e.preventDefault(); view.setPointerCapture(e.pointerId);
  right = e.button === 2;
  if (e.shiftKey && !right) moving = true; else dragging = true;
  last = [e.clientX, e.clientY];
  if (right) post({type: 'clip_begin', ndc: ndc(e)});
});
view.addEventListener('pointermove', e => {
  if (e.pointerType === 'touch') return;
  const r = view.getBoundingClientRect();
  if (!dragging && !moving) { post({type: 'clip_hover', ndc: ndc(e)}); return; }
  const d = [e.clientX - last[0], e.clientY - last[1]];
  last = [e.clientX, e.clientY];
  const s = Math.max(r.width, r.height);
  if (moving) post({type: 'pan', by: [d[0] / s, d[1] / s]});
  else if (right) post({type: 'clip_drag', ndc: ndc(e)});
  else post({type: 'rotate', by: [d[0] * Math.PI / s, d[1] * Math.PI / s]});
});
function stop(e) {
  if (right) post({type: 'clip_end'});
  dragging = moving = right = false;
}
view.addEventListener('pointerup', stop);
view.addEventListener('pointercancel', stop);
view.addEventListener('wheel', e => {
  e.preventDefault();
  post({type: 'zoom', by: e.deltaY < 0 ? 0.9 : (e.deltaY > 0 ? 1.1 : 1.0)});
}, {passive: false});
setInterval(async () => {
  const s = await (await fetch('/state')).json();
  stat.textContent = s.samples + ' samples';
}, 1000);
// settings controls (elements/slider.ts role: value -> ViewerSettings)
for (const id of ['density_multiplier','exposure','gamma','bounces','max_samples']) {
  document.getElementById(id).addEventListener('input', e => {
    fetch('/settings', {method: 'POST',
      body: JSON.stringify({[id]: parseFloat(e.target.value)})});
  });
}
document.getElementById('mode').addEventListener('change', e => {
  post({type: 'render_mode', mode: e.target.value});
});
// histogram viewer (elements/histogramViewer.ts role): log bars + gradient
// heat + draggable sample range
const hist = document.getElementById('hist');
const hctx = hist.getContext('2d');
let hdata = null, range = [0, 1], hdrag = null;
async function drawHist() {
  if (!hdata) {
    const resp = await fetch('/histogram');
    if (!resp.ok) return;
    hdata = await resp.json();
    range = hdata.range;
  }
  const n = hdata.bars.length, W = hist.width, H = hist.height;
  hctx.clearRect(0, 0, W, H);
  for (let i = 0; i < n; i++) {
    const x = i / n * W, w = W / n + 1;
    hctx.fillStyle = `rgba(255,${255 - 255 * hdata.alpha[i]},64,1)`;
    hctx.fillRect(x, H - hdata.bars[i] * H, w, hdata.bars[i] * H);
  }
  hctx.fillStyle = 'rgba(100,160,255,0.25)';
  hctx.fillRect(range[0] * W, 0, (range[1] - range[0]) * W, H);
}
hist.addEventListener('pointerdown', e => {
  const x = (e.clientX - hist.getBoundingClientRect().left) / hist.clientWidth;
  hdrag = Math.abs(x - range[0]) < Math.abs(x - range[1]) ? 0 : 1;
  hist.setPointerCapture(e.pointerId);
});
hist.addEventListener('pointermove', e => {
  if (hdrag === null) return;
  const x = (e.clientX - hist.getBoundingClientRect().left) / hist.clientWidth;
  range[hdrag] = Math.min(1, Math.max(0, x));
  if (range[0] > range[1]) range = [range[1], range[0]];
  drawHist();
});
hist.addEventListener('pointerup', () => {
  if (hdrag === null) return;
  hdrag = null;
  fetch('/settings', {method: 'POST', body: JSON.stringify({sample_range: range})});
});
drawHist();
// transfer-function ramp editor (elements/colorramp.ts role): draggable
// stops on a gradient strip, click to add, dblclick to remove
const ramp = document.getElementById('ramp');
const rctx = ramp.getContext('2d');
let stops = [], sel = -1, sdrag = false;
function hex(c) { return '#' + c.slice(0,3).map(v => Math.round(v*255).toString(16).padStart(2,'0')).join(''); }
function unhex(h) { return [1,3,5].map(i => parseInt(h.slice(i,i+2),16)/255); }
function drawRamp() {
  const W = ramp.width, H = ramp.height;
  const g = rctx.createLinearGradient(0, 0, W, 0);
  for (const s of stops) g.addColorStop(s.stop, hex(s.color));
  rctx.fillStyle = '#000'; rctx.fillRect(0,0,W,H);
  rctx.fillStyle = g; rctx.fillRect(0, 0, W, H*0.6);
  rctx.strokeStyle = '#8cf'; rctx.beginPath();
  for (let i = 0; i < stops.length; i++) {
    const x = stops[i].stop*W, y = H - stops[i].color[3]*H*0.38 - H*0.02;
    if (i === 0) rctx.moveTo(x, y); else rctx.lineTo(x, y);
  }
  rctx.stroke();
  for (let i = 0; i < stops.length; i++) {
    const x = stops[i].stop*W;
    rctx.fillStyle = i === sel ? '#fff' : '#999';
    rctx.fillRect(x-3, 0, 6, H);
    rctx.fillStyle = hex(stops[i].color);
    rctx.fillRect(x-2, 1, 4, H-2);
  }
}
function pushTransfer() {
  fetch('/transfer', {method:'POST', body: JSON.stringify({colors: stops})});
}
async function loadTransfer() {
  const t = await (await fetch('/transfer')).json();
  if (t.colors && t.colors.length) stops = t.colors;
  else stops = [{color:[1,1,1,0],stop:0},{color:[1,1,1,1],stop:1}];
  drawRamp();
}
function rampX(e) {
  const r = ramp.getBoundingClientRect();
  return Math.min(1, Math.max(0, (e.clientX - r.left) / r.width));
}
ramp.addEventListener('pointerdown', e => {
  const x = rampX(e);
  let best = -1, bd = 0.02;
  for (let i = 0; i < stops.length; i++) {
    const d = Math.abs(stops[i].stop - x);
    if (d < bd) { bd = d; best = i; }
  }
  if (best < 0) {  // add a stop with the interpolated color
    stops.push({color: [1,1,1,0.5], stop: x});
    stops.sort((a,b) => a.stop - b.stop);
    best = stops.findIndex(s => s.stop === x);
    pushTransfer();
  }
  sel = best; sdrag = true;
  document.getElementById('stopcolor').value = hex(stops[sel].color);
  document.getElementById('stopalpha').value = stops[sel].color[3];
  ramp.setPointerCapture(e.pointerId);
  drawRamp();
});
ramp.addEventListener('pointermove', e => {
  if (!sdrag || sel < 0) return;
  stops[sel].stop = rampX(e);
  drawRamp();
});
ramp.addEventListener('pointerup', () => {
  if (sdrag && sel >= 0) { stops.sort((a,b)=>a.stop-b.stop); pushTransfer(); drawRamp(); }
  sdrag = false;
});
ramp.addEventListener('dblclick', e => {
  if (sel >= 0 && stops.length > 2) {
    stops.splice(sel, 1); sel = -1; pushTransfer(); drawRamp();
  }
});
document.getElementById('stopcolor').addEventListener('input', e => {
  if (sel < 0) return;
  const a = stops[sel].color[3];
  stops[sel].color = [...unhex(e.target.value), a];
  pushTransfer(); drawRamp();
});
document.getElementById('stopalpha').addEventListener('input', e => {
  if (sel < 0) return;
  stops[sel].color[3] = parseFloat(e.target.value);
  pushTransfer(); drawRamp();
});
loadTransfer();
// light-direction pad (elements/cubeDirection.ts role): pixel drags map to
// yaw/pitch server-side with the reference's 0.5 deg/px scale
const pad = document.getElementById('lightpad');
const pctx = pad.getContext('2d');
let ldrag = null;
function drawPad() {
  pctx.clearRect(0,0,96,96);
  pctx.strokeStyle = '#555'; pctx.beginPath(); pctx.arc(48,48,40,0,7); pctx.stroke();
  pctx.fillStyle = '#fd5'; pctx.beginPath(); pctx.arc(48,48,5,0,7); pctx.fill();
  pctx.fillText('light', 36, 90);
}
drawPad();
pad.addEventListener('pointerdown', e => { ldrag = [e.clientX, e.clientY]; pad.setPointerCapture(e.pointerId); });
pad.addEventListener('pointermove', e => {
  if (!ldrag) return;
  post({type: 'light_drag', by: [e.clientX - ldrag[0], e.clientY - ldrag[1]]});
  ldrag = [e.clientX, e.clientY];
});
pad.addEventListener('pointerup', () => ldrag = null);
document.getElementById('synclight').addEventListener('change', e => {
  fetch('/settings', {method:'POST', body: JSON.stringify({sync_light_dir: e.target.checked})});
});
// settings export / import / benchmark (template.ts:279-396, viewer.ts:864)
document.getElementById('exportbtn').addEventListener('click', () => {
  window.location = '/settings.json';
});
document.getElementById('importfile').addEventListener('change', async e => {
  const text = await e.target.files[0].text();
  const resp = await fetch('/settings_import', {method:'POST', body: text});
  if (!resp.ok) alert('import failed: ' + await resp.text());
  else loadTransfer();
});
document.getElementById('benchbtn').addEventListener('click', async () => {
  await fetch('/benchmark', {method:'POST', body: JSON.stringify({samples: 100})});
  const stat = document.getElementById('benchstat');
  const poll = setInterval(async () => {
    const b = await (await fetch('/benchmark_result')).json();
    if (b.running === false && b.time_per_sample_ms !== undefined) {
      clearInterval(poll);
      stat.textContent = b.time_per_sample_ms + ' ms/sample';
      const a = document.createElement('a');
      a.href = URL.createObjectURL(new Blob([JSON.stringify(b, null, 2)]));
      a.download = 'volxel-benchmark.json'; a.click();
    } else stat.textContent = (b.done || 0) + '/' + (b.samples || '?');
  }, 500);
});
</script></body></html>"""

class PreviewServer:
    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000):
        self.renderer = renderer
        self.host = host
        self.port = port
        self._commands: queue.Queue = queue.Queue()
        self._png: bytes = b""
        self._png_version = 0
        self._png_cond = threading.Condition()
        self._running = False
        self._render_thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._clip = None
        self._light = None  # LightDirectionCube, created on first drag
        self.last_error: str | None = None  # surfaced at /state
        self._benchmark: dict | None = None  # {"samples": N, ...} job/result
        self._hist_cache = None
        # the last settings that rendered: a render error reverts to them
        self._snapshot = dict(vars(renderer.settings))
        # while camera commands stream in, serve shear-warp DVR previews
        # (the K7 kernel on the card) instead of 1-sample MC noise;
        # progressive accumulation resumes when the interaction stops
        self.dvr_preview = True
        self.preview_scale = 0.5  # drag previews at half res (latency)
        self._motion_until = 0.0

    # -- render thread ---------------------------------------------------------

    def _apply(self, cmd: dict) -> bool:
        """Apply one input command; returns True if the scene changed
        (accumulation must restart — viewer.ts:443-464)."""
        r = self.renderer
        t = cmd.get("type")
        if t in ("rotate", "pan", "zoom"):
            self._motion_until = time.time() + 0.3
        if t == "rotate":
            bx, by = cmd["by"]
            r.camera.rotate_around_view(float(bx), float(by))
            r.maybe_sync_light()
            return True
        if t == "pan":
            bx, by = cmd["by"]
            r.camera.translate_on_plane(float(bx), float(by))
            return True
        if t == "zoom":
            return bool(r.camera.zoom(float(cmd["by"])))
        if t == "clip_hover":
            if self._clip is None:
                self._clip = r.make_clip_controller()
            w, h = r.width, r.height
            face = self._clip.hover(np.asarray(cmd["ndc"], np.float32), aspect=w / h)
            return face is not None  # highlight change re-renders overlay
        if t == "clip_begin":
            if self._clip is None:
                self._clip = r.make_clip_controller()
            w, h = r.width, r.height
            self._clip.hover(np.asarray(cmd["ndc"], np.float32), aspect=w / h)
            return self._clip.begin_drag()
        if t == "clip_drag":
            if self._clip is None:
                return False
            w, h = r.width, r.height
            self._clip.drag(np.asarray(cmd["ndc"], np.float32), aspect=w / h)
            return True
        if t == "clip_end":
            if self._clip is not None:
                self._clip.end_drag()
            return False
        if t == "render_mode":
            r.render_mode = cmd["mode"]
            return True
        if t == "settings":
            for key, value in cmd.get("values", {}).items():
                if not hasattr(r.settings, key):
                    raise ValueError(f"unknown setting {key!r}")
                setattr(r.settings, key, value)
            return True
        if t == "transfer":
            # color-ramp editor commit (colorramp.ts:235-243)
            r.set_transfer_colors(cmd["colors"])
            return True
        if t == "light_drag":
            # light-direction cube drag (cubeDirection.ts:245-258)
            from volxel_tpu_torch.utils.lightcube import LightDirectionCube

            if self._light is None:
                self._light = LightDirectionCube()
                try:
                    self._light.direction = r.settings.light_dir
                except ValueError:
                    pass
            dx, dy = cmd["by"]
            self._light.drag(float(dx), float(dy))
            r.settings.light_dir = list(self._light.direction)
            return True
        if t == "settings_import":
            r.restore_settings(cmd["export"])
            return True
        if t == "benchmark":
            # startBenchmark (viewer.ts:864): time the next N samples of
            # the current scene on the render thread
            self._benchmark = {
                "samples": int(cmd.get("samples", 100)),
                "done": 0,
                "t0": time.perf_counter(),
                "running": True,
            }
            return True
        raise ValueError(f"unknown input command {t!r}")

    def _encode_frame(self, img: np.ndarray | None = None) -> None:
        if img is None:
            img = self.renderer.image(show_clipping=True)
        png = encode_png((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
        with self._png_cond:
            self._png = png
            self._png_version += 1
            self._png_cond.notify_all()

    def _maybe_dvr_preview(self) -> bool:
        """During camera interaction, stream a deterministic shear-warp
        preview instead of 1-sample MC noise. Returns True when a preview
        frame was served this tick."""
        r = self.renderer
        if not self.dvr_preview or time.time() >= self._motion_until:
            return False
        if r._device_grid is None or r._device_grid.dense is None:
            return False  # nothing loaded, or a volume in slabs: no preview
        try:
            self._encode_frame(r.render_preview(scale=self.preview_scale))
            return True
        except Exception as e:  # noqa: BLE001 — preview is best-effort
            self.last_error = f"dvr preview error: {e}"
            self._motion_until = 0.0  # stop retrying this interaction
            return False

    def step(self) -> str:
        """One iteration of the render loop: apply the queued commands,
        then serve a drag preview, or render and encode one progressive
        frame, or nothing once converged. Returns "preview", "frame",
        "error" (a render error: the settings are reverted to the last
        that rendered and the error is kept at /state) or "idle"."""
        r = self.renderer
        changed = False
        try:
            while True:
                cmd = self._commands.get_nowait()
                try:
                    changed |= self._apply(cmd)
                except Exception as e:  # bad input must not kill the loop
                    self.last_error = f"input error: {e}"
                    print(f"preview: {self.last_error}")
        except queue.Empty:
            pass
        if changed:
            r.restart_rendering()
        if self._maybe_dvr_preview():
            return "preview"
        bench = self._benchmark
        if not (r.frame_index * getattr(r, "sp", 1) < r.settings.max_samples or (bench and bench["running"])):
            return "idle"  # converged; idle until input
        # a raise here (e.g. a settings value that passes setattr but fails
        # when the frame renders) must not silently kill the stream: revert
        # to the last good settings and surface the error at /state
        # (reference handleError, viewer.ts:797-821)
        try:
            r.render_frame()
            self._encode_frame()
            self.last_error = None
            self._snapshot = dict(vars(r.settings))
        except Exception as e:  # noqa: BLE001
            self.last_error = f"render error: {e}"
            print(f"preview: {self.last_error}")
            vars(r.settings).update(self._snapshot)
            r.restart_rendering()
            return "error"
        if bench and bench["running"]:
            bench["done"] += getattr(r, "sp", 1)
            if bench["done"] >= bench["samples"]:
                total = time.perf_counter() - bench["t0"]
                from volxel_tpu_torch.api.benchmark import device_fingerprint

                bench.update(
                    running=False,
                    total_time_s=round(total, 4),
                    time_per_sample_ms=round(total / max(bench["done"], 1) * 1000.0, 4),
                    viewport=[r.width, r.height],
                    device=device_fingerprint(r.device),
                )
        return "frame"

    def _render_loop(self) -> None:
        fb = self.renderer._framebuffer
        if fb.is_cuda:
            torch.cuda.set_device(fb.device)  # the renderer's card, for this thread
        while self._running:
            outcome = self.step()
            if outcome == "error":
                time.sleep(0.1)
            elif outcome == "idle":
                time.sleep(0.02)

    def _fallback_histogram(self):
        """256-bin histogram + smoothed first-difference gradient of the
        decoded density field (dicom.rs:39-66 semantics) for grids that
        were built without the ingest pipeline. The bf16 field is copied
        to the host as f32 once (a volume in slabs is decoded there); the
        result is kept."""
        if self._hist_cache is not None:
            return self._hist_cache
        dense = self.renderer._device_grid.dense
        if dense is not None:
            hist, _ = np.histogram(dense.float().cpu().numpy().ravel(), bins=256, range=(0.0, 1.0))
        else:  # a volume in slabs: the same bf16 field, decoded on the host eight brick rows at a time
            grid = self.renderer.grid
            bz = grid.brick_count[2]
            hist = sum(np.histogram(decode_dense_rows_device(grid, b, min(b + 8, bz), "cpu").float().numpy().ravel(),
                                    bins=256, range=(0.0, 1.0))[0]
                       for b in range(0, bz, 8))
        hist = hist.astype(np.uint32)
        diff = np.diff(hist.astype(np.int64), prepend=0)
        grad = ((np.roll(diff, 1) + diff + np.roll(diff, -1)) // 3).astype(np.int64)
        gmax = int(max(abs(grad.min()), abs(grad.max()), 1))
        self._hist_cache = (hist, grad, gmax)
        return self._hist_cache

    # -- HTTP ------------------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/frame.png":
                    with server._png_cond:
                        png = server._png
                    if not png:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif self.path == "/state":
                    r = server.renderer
                    state = {
                        "samples": r.frame_index * getattr(r, "sp", 1),
                        "width": r.width,
                        "height": r.height,
                        "settings": r.export_settings(),
                        "error": server.last_error,
                    }
                    self._send(200, "application/json", json.dumps(state).encode())
                elif self.path == "/transfer":
                    r = server.renderer
                    body = json.dumps(
                        {
                            "type": r._transfer_type,
                            "colors": r._transfer_colors if r._transfer_type == "color_stops" else [],
                        }
                    ).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/settings.json":
                    # settings export download (template.ts:279-396 button,
                    # settings.ts:145-147)
                    body = json.dumps(server.renderer.export_settings(), indent=2).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Disposition", 'attachment; filename="volxel-settings.json"')
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/benchmark_result":
                    b = server._benchmark
                    body = json.dumps(b if b else {"running": False}).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/histogram":
                    r = server.renderer
                    grid = r.grid
                    if grid is None:
                        self._send(404, "text/plain", b"no volume")
                        return
                    from volxel_tpu_torch.utils.histview import histogram_view_data

                    if grid.histogram.size:
                        hist = grid.histogram
                        hgrad = grid.histogram_gradient
                        gmax = max(abs(grid.histogram_gradient_range[0]), abs(grid.histogram_gradient_range[1]))
                    else:
                        # grids built without ingest (synthetic/test volumes)
                        # carry no histogram; derive one from the decoded field
                        hist, hgrad, gmax = server._fallback_histogram()
                    bars, alpha = histogram_view_data(hist, hgrad, gmax)
                    # downsample to 256 display bins like the canvas widget
                    step = max(1, len(bars) // 256)
                    body = json.dumps(
                        {
                            "bars": [round(float(v), 4) for v in bars[::step]],
                            "alpha": [round(float(v), 4) for v in alpha[::step]],
                            "range": list(r.settings.sample_range),
                        }
                    ).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    version = -1
                    try:
                        while server._running:
                            with server._png_cond:
                                server._png_cond.wait_for(
                                    lambda: server._png_version != version or not server._running,
                                    timeout=1.0,
                                )
                                png = server._png
                                version = server._png_version
                            if not png:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n\r\n".encode()
                            )
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, "text/plain", b"bad json")
                    return
                if self.path == "/input":
                    server._commands.put(body)
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/settings":
                    server._commands.put({"type": "settings", "values": body})
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/transfer":
                    server._commands.put({"type": "transfer", "colors": body.get("colors", [])})
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/settings_import":
                    # verify BEFORE enqueueing so the client sees schema errors
                    from volxel_tpu_torch.api.settings import verify_settings

                    try:
                        verify_settings(body)
                    except Exception as e:  # noqa: BLE001
                        self._send(400, "text/plain", str(e).encode())
                        return
                    server._commands.put({"type": "settings_import", "export": body})
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/benchmark":
                    server._commands.put({"type": "benchmark", **body})
                    self._send(200, "application/json", b'{"ok": true}')
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> int:
        """Start render thread + HTTP server (non-blocking). Returns port."""
        self._running = True
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler_class())
        self.port = self._httpd.server_address[1]
        self._render_thread = threading.Thread(target=self._render_loop, name="preview-render", daemon=True)
        self._render_thread.start()
        threading.Thread(target=self._httpd.serve_forever, name="preview-http", daemon=True).start()
        return self.port

    def stop(self) -> None:
        self._running = False
        with self._png_cond:
            self._png_cond.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._render_thread is not None:
            self._render_thread.join(timeout=10)

    def serve_forever(self) -> None:
        self.start()
        print(f"preview server on http://{self.host}:{self.port}/")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()
