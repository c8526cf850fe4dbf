"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: the top-level name of every
loaded module (the part before the first dot), compared whole."""

from __future__ import annotations

from _tiny import TINY, fresh

JAX = {"jax", "jaxlib", "flax", "pywindow_tpu"}
PROGRAM = {"pywindow_torch", "chip_smoke", "bench_torch"}

_HARNESS = """
import json, sys
from portbench import run
out = run.run_cell("cc3_md.sweep", 5, 0.2, False, device="cpu", overrides={tiny})
print(json.dumps({{"correct": out["correct"], "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REFERENCE = """
import json, sys
import numpy as np
from portbench.reference import pipeline, molecules
from portbench import compare
from portbench.inputs import history, periodic, structures, fixtures
els = molecules.elements(["ni"] * 4, None, "OPLS")
xyz = np.array([[0.0, 0, 0], [3, 0, 0], [0, 3, 0], [0, 0, 3]])
pipeline.analyse([(els, xyz)], (64, 64, 8, 8), "cpu")
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_harness_loads_no_jax():
    got = fresh(_HARNESS.format(tiny=repr(TINY["cc3_md.sweep"])))
    assert got["correct"]
    assert not JAX & set(got["tops"])
    assert "pywindow_torch" in got["tops"]


def test_reference_loads_neither_jax_nor_the_program():
    got = fresh(_REFERENCE)
    assert not (JAX | PROGRAM) & set(got["tops"])
    assert "portbench" in got["tops"]

