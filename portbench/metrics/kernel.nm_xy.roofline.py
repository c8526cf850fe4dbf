"""Share of its roofline that nm_xy reaches on one chunk's calls, %."""

from portbench.metrics._lib import roofline


def read(r):
    return roofline(r, "nm_xy")
