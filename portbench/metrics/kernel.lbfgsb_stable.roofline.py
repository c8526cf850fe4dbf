"""Share of its roofline that lbfgsb_stable reaches on one chunk's calls, %."""

from portbench.metrics._lib import roofline


def read(r):
    return roofline(r, "lbfgsb_stable")
