"""ingest_s: host clock around Renderer.restart_from_zip on the ZIP's bytes
(ingest/: the ZIP, DICOM parse, the native scan; grid/brick.py; the
field decoded on the card), fenced, during set-up."""

UNIT, LAYER, MOVES, SOURCE = "s", "ingest", "setup_s", "host_clock"


def read(run):
    return run.setup.get("ingest_s")
