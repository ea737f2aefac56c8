"""volxel_tpu_torch — the PyTorch/CUDA port of volxel_tpu.

The progressive Monte-Carlo volume path tracer in its three render modes
(default, no_dda, raymarch), written in PyTorch, with the TPU package's
Pallas kernels on those paths replaced by
hand-written CUDA kernels for Hopper (csrc/, built by kernels.py at first
use on the card). The JAX package volxel_tpu stays the reference; this
package imports neither JAX nor volxel_tpu.

Layer map (the module names follow volxel_tpu):
  grid/       numpy brick-grid builder (copy of volxel_tpu.grid)
  ingest/     DICOM, ZIP, HDR and EXR decoders (numpy copies); native/
              their C++ helpers
  scene/      camera, volume transforms and clip-box interaction (numpy
              copies), environment
  transfer/   1D RGBA transfer-function LUTs and the colour ramp (numpy
              copies)
  render/     rng, rays, sampling, the three modes and their legs
              (ddaleg, trackleg, tilemarch), path tracer, gradient
              shading, preview, tonemap
  api/        Renderer facade, settings JSON (numpy copy), JAX-state
              import, benchmark, checkpoint, time series, preview server
  utils/      fixtures, profiling, overlay, light cube, histogram view
              (numpy copies), PNG writer
  __main__    the CLI: render, ingest, benchmark, serve, info
  csrc/       CUDA sources: dda_leg and track_leg (sharing
              leg_common.cuh), tile_march, gather, importance_pyramid,
              tonemap, shearwarp, rng, env
"""

__version__ = "0.1.0"

from volxel_tpu_torch.api.renderer import Renderer  # noqa: F401,E402
