"""pywindow_torch — structural analysis of porous molecules in PyTorch,
with hand-written CUDA kernels for the ray, clustering and optimiser
stages.

The port of ``pywindow_tpu`` (the JAX package beside it, which stays
the reference).  It covers the single-molecule analysis,
``MolecularSystem.load_file(path).system_to_molecule().full_analysis()``,
periodic systems, ``MolecularSystem.load_file(path).make_modular(
rebuild=True)`` then ``analyze_molecules()``, and batched sweeps of
DL_POLY, XYZ and PDB trajectories, ``DLPOLY(path).analysis_batched(...)``
(``modular=True, rebuild=True`` for periodic frames), the
reference-compatible function API (:mod:`pywindow_torch.utilities`)
and a command line, ``python -m pywindow_torch analyze|trajectory``.
Every analysis runs on the card unless the caller passes
``device="cpu"``.  Importing
the package loads torch and numpy only and builds nothing: the CUDA
kernels are built on their first launch, the native host library
(``g++``) on its first call.
"""

from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig
from pywindow_torch.io.inputs import Input
from pywindow_torch.io.outputs import Output
from pywindow_torch.molecular import MolecularSystem, Molecule
from pywindow_torch.tables import periodic_table
from pywindow_torch.trajectory import DLPOLY, PDB, XYZ, make_supercell
from pywindow_torch.utilities import compare_properties_dict

__version__ = "0.1.0"

__all__ = [
    "AnalysisConfig",
    "DEFAULT_CONFIG",
    "DLPOLY",
    "Input",
    "MolecularSystem",
    "Molecule",
    "Output",
    "PDB",
    "XYZ",
    "compare_properties_dict",
    "make_supercell",
    "periodic_table",
]
