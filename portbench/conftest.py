"""The tiny CPU size of the ``mibqar_md.sweep`` cell, in the tests'
shared table (``tests/_tiny.py``) before any test module of the folder
is collected, so that every parametrised test of
``tests/test_portbench_drivers.py`` runs the cell however the tests are
selected: a multiple of the fixture's 20 frames, in chunks of 10."""

import pathlib
import sys

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

import _tiny  # noqa: E402

_tiny.TINY.setdefault("mibqar_md.sweep", {"trajectory_frames": 20, "batch_size": 10, "sample": 4,
                                          "trace_units": 1, "roofline_frames": 10})
