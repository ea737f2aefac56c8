"""Async ingest pipeline — the reference's Web-Worker bridge, host-side.

The reference moves DICOM/ZIP/EXR decoding off the main thread through a
dedicated Worker with a typed postMessage protocol (worker.ts:92-139,
common.ts:1-88) and zero-copy transferable buffers (worker.ts:55-57).
Here the same roles map to a thread pool + futures: parsing and brick
construction run off the caller's thread (the C++ builder releases the
GIL inside ctypes calls), and the "transfer" is the Renderer's upload of
the finished grid buffers to its device.

Message-type parity (common.ts WasmWorkerMessageType):
  LOAD_FROM_FILES / LOAD_FROM_URLS -> load_files
  LOAD_FROM_ZIP / LOAD_FROM_ZIP_URL -> load_zip
  LOAD_FROM_BYTES -> load_bytes
  LOAD_ENV -> load_env
  RETURN_DICOM / RETURN_ENV -> Future results
  ERROR -> exceptions re-raised on .result() (worker.ts:132-138 role)
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from volxel_tpu_torch.grid.brick import BrickGrid
from volxel_tpu_torch.ingest.hdr import decode_env_bytes
from volxel_tpu_torch.ingest.series import read_dicoms_to_grid
from volxel_tpu_torch.ingest.ziploader import read_zip_to_grid


class IngestWorker:
    """Background decoder: submit sources, receive Futures.

    progress_callback(stage: str) mirrors the reference's staged loading
    overlay messages (viewer.ts:443-464 call sites).
    """

    def __init__(self, max_workers: int = 2, progress_callback=None):
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="volxel-ingest"
        )
        self._progress = progress_callback or (lambda stage: None)

    # -- volume loading --------------------------------------------------------

    def load_files(self, sources: list) -> "Future[BrickGrid]":
        """Paths or byte blobs of individual DICOM slices."""

        def work():
            self._progress("Reading DICOM files...")
            grid = read_dicoms_to_grid(sources)
            self._progress("Brick grid ready")
            return grid

        return self._pool.submit(work)

    def load_bytes(self, blobs: list[bytes]) -> "Future[BrickGrid]":
        return self.load_files(blobs)

    def load_zip(self, source) -> "Future[BrickGrid]":
        """ZIP path or bytes."""

        def work():
            self._progress("Unpacking ZIP...")
            data = source if isinstance(source, (bytes, bytearray)) else Path(
                source
            ).read_bytes()
            grid = read_zip_to_grid(data)
            self._progress("Brick grid ready")
            return grid

        return self._pool.submit(work)

    # -- environment -----------------------------------------------------------

    def load_env(self, source) -> "Future[np.ndarray]":
        """HDR/EXR path or bytes -> (H, W, 4) float32."""

        def work():
            self._progress("Decoding environment...")
            data = source if isinstance(source, (bytes, bytearray)) else Path(
                source
            ).read_bytes()
            return decode_env_bytes(bytes(data))

        return self._pool.submit(work)

    # -- lifecycle ---------------------------------------------------------------

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
