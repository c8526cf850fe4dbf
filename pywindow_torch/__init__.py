"""pywindow_torch — structural analysis of porous molecules in PyTorch,
with hand-written CUDA kernels for the ray and clustering stages.

The port of ``pywindow_tpu`` (the JAX package beside it, which stays
the reference).  It covers the single-molecule analysis,
``MolecularSystem.load_file(path).system_to_molecule().full_analysis()``,
and the batched sweep of a DL_POLY trajectory,
``DLPOLY(path).analysis_batched(...)``; both run on the card unless the
caller passes ``device="cpu"``.  Importing the package loads torch and
numpy only and builds nothing; the CUDA kernels are built on their first
launch.
"""

from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig
from pywindow_torch.io.inputs import Input
from pywindow_torch.molecular import MolecularSystem, Molecule
from pywindow_torch.tables import periodic_table
from pywindow_torch.trajectory import DLPOLY

__version__ = "0.1.0"

__all__ = [
    "AnalysisConfig",
    "DEFAULT_CONFIG",
    "DLPOLY",
    "Input",
    "MolecularSystem",
    "Molecule",
    "periodic_table",
]
