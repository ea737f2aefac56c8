"""ingest_parse_s: host seconds of the program's vx::ingest.parse span
(ingest/ziploader.read_zip_series: every entry of the DICOM ZIP inflated
and parsed), in the ingest of the cell's set-up repeated with spans on
(vxbench/stages.py). Only a cell that loads a ZIP has it."""

from vxbench import stages

UNIT, LAYER, MOVES, SOURCE = "s", "ingest", "setup_s", "program_span"


def read(run):
    staged = stages.of(run)
    if staged is None:
        return None
    seconds = [(t1 - t0) / 1e9 for name, _, _, t0, t1 in staged.setup_spans if name == "vx::ingest.parse"]
    return sum(seconds) if seconds else None
