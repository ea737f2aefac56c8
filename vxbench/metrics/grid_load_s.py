"""grid_load_s: host clock from the brick grid's build (grid/brick.py and
its native builder) to the grid decoded on the card by
Renderer.restart_from_grid (the dense bf16 field, the majorant pyramid),
fenced, during set-up."""

UNIT, LAYER, MOVES, SOURCE = "s", "volume load", "setup_s", "host_clock"


def read(run):
    return run.setup.get("grid_load_s")
