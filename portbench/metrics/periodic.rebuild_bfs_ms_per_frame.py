"""ms of the ``rebuild_bfs`` span a frame (the native BFS calls of the
rebuild, summed), over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "rebuild_bfs", "frames", 1e3)
