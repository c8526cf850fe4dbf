"""User-facing object model: :class:`MolecularSystem` and :class:`Molecule`
(counterpart of ``pywindow_tpu.molecular``; reference:
molecular.py:60-955).

The port carries loading (``load_file``, ``load_system``), the
force-field key helpers (``swap_atom_keys``, ``decipher_atom_keys``),
the whole system as one molecule (``system_to_molecule``) and the
per-molecule analysis (``full_analysis`` and the ``calculate_*``
getters).  Every analysis runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig
from pywindow_torch.io.forcefield import decipher_all
from pywindow_torch.io.inputs import Input
from pywindow_torch.ops import analysis as _analysis


class Molecule:
    """A single discrete molecule and its analysis results; the
    ``properties`` dict follows the reference schema (reference:
    molecular.py:60-131)."""

    def __init__(
        self,
        mol: dict,
        system_name: str = "molecule",
        mol_id: int = 0,
        config: AnalysisConfig = DEFAULT_CONFIG,
        device: torch.device | str = "cuda",
    ) -> None:
        self.mol = mol
        self.no_of_atoms = len(mol["elements"])
        self.elements = mol["elements"]
        if "atom_ids" in mol:
            self.atom_ids = mol["atom_ids"]
        self.coordinates = mol["coordinates"]
        self.parent_system = system_name
        self.molecule_id = mol_id
        self.config = config
        #: the device the ``calculate_*`` getters analyse on (the last
        #: ``full_analysis`` call's)
        self.device = device
        self.properties: dict = {"no_of_atoms": self.no_of_atoms}
        self._analysed = False

    def full_analysis(
        self,
        ncpus: int = 1,
        device: torch.device | str = "cuda",
        **kwargs,
    ) -> dict:
        """Run the complete analysis on ``device`` (the card unless the
        caller asks for the CPU; raises when there is no card).

        ``ncpus`` is accepted for reference API compatibility and
        ignored (parallelism is the device's job).
        """
        del ncpus
        self.device = device
        res = _analysis.analyze(
            self.elements, self.coordinates, cfg=self.config, device=device,
            **kwargs,
        )
        self.MW = res.pop("molecular_weight")
        self.properties.update(res)
        self._sync_attributes()
        self._analysed = True
        return self.properties

    def _sync_attributes(self) -> None:
        p = self.properties
        if "centre_of_mass" in p:
            self.centre_of_mass = p["centre_of_mass"]
        if "maximum_diameter" in p:
            self.maximum_diameter = p["maximum_diameter"]["diameter"]
            self.maxd_atom_1 = p["maximum_diameter"]["atom_1"]
            self.maxd_atom_2 = p["maximum_diameter"]["atom_2"]
        if "average_diameter" in p:
            self.average_diameter = p["average_diameter"]
        if "pore_diameter" in p:
            self.pore_diameter = p["pore_diameter"]["diameter"]
            self.pore_closest_atom = p["pore_diameter"]["atom"]
        if "pore_volume" in p:
            self.pore_volume = p["pore_volume"]
        if "pore_diameter_opt" in p:
            self.pore_diameter_opt = p["pore_diameter_opt"]["diameter"]
            self.pore_opt_closest_atom = p["pore_diameter_opt"]["atom_1"]
            self.pore_opt_COM = p["pore_diameter_opt"]["centre_of_mass"]
        if "pore_volume_opt" in p:
            self.pore_volume_opt = p["pore_volume_opt"]

    # -- individual properties (reference: molecular.py:215-352) ------

    def _ensure_analysis(self) -> None:
        if not self._analysed:
            self.full_analysis(device=self.device)

    def calculate_maximum_diameter(self) -> float:
        """Largest interatomic distance plus vdW radii, in Å."""
        self._ensure_analysis()
        return self.maximum_diameter

    def calculate_average_diameter(self) -> float:
        """Mean vdW-surface diameter over the sampling rays, in Å."""
        self._ensure_analysis()
        return self.average_diameter

    def calculate_pore_diameter(self) -> float:
        """Intrinsic pore diameter about the centre of mass, in Å."""
        self._ensure_analysis()
        return self.pore_diameter

    def calculate_pore_volume(self) -> float:
        """Spherical volume of the COM pore, in Å³."""
        self._ensure_analysis()
        return self.pore_volume

    def calculate_pore_diameter_opt(self) -> float:
        """Pore diameter after optimising the centre, in Å."""
        self._ensure_analysis()
        return self.pore_diameter_opt

    def calculate_pore_volume_opt(self) -> float:
        """Spherical volume of the optimised pore, in Å³."""
        self._ensure_analysis()
        return self.pore_volume_opt

    def calculate_windows(self, ncpus: int = 1) -> np.ndarray | None:
        """Window diameters in Å, or ``None`` when no windows are found."""
        del ncpus
        self._ensure_analysis()
        return self.properties["windows"]["diameters"]


class MolecularSystem:
    """Container for a loaded molecular system (reference:
    molecular.py:554-955)."""

    def __init__(self) -> None:
        self._Input = Input()
        self.system_id: str | int = 0
        self.system: dict = {}

    @classmethod
    def load_file(cls, filepath: pathlib.Path | str) -> MolecularSystem:
        filepath = pathlib.Path(filepath)
        obj = cls()
        obj.system = obj._Input.load_file(filepath)
        obj.filename = filepath.name
        obj.system_id = obj.filename.split(".")[0]
        obj.name = obj.system_id
        return obj

    @classmethod
    def load_system(
        cls, dict_: dict, system_id: str | int = "system"
    ) -> MolecularSystem:
        """Wrap an already-decoded system dict (reference:
        molecular.py:610-626)."""
        obj = cls()
        obj.system = dict_
        obj.system_id = system_id
        return obj

    def swap_atom_keys(self, swap_dict: dict, dict_key: str = "atom_ids") -> None:
        """Replace force-field atom ids by user-defined values
        (reference: molecular.py:710-749)."""
        if "atom_ids" not in self.system:
            dict_key = "elements"
        arr = np.asarray(self.system[dict_key], dtype="<U8")
        for key, value in swap_dict.items():
            arr[arr == key] = value
        self.system[dict_key] = arr

    def decipher_atom_keys(
        self, forcefield: str = "DLF", dict_key: str = "atom_ids"
    ) -> None:
        """Force-field atom ids -> element symbols (reference:
        molecular.py:751-796)."""
        if "atom_ids" not in self.system:
            dict_key = "elements"
        self.system["elements"] = decipher_all(self.system[dict_key], forcefield)

    def system_to_molecule(self) -> Molecule:
        """Treat the whole system as one :class:`Molecule`
        (reference: molecular.py:818)."""
        return Molecule(self.system, str(self.system_id), 0)
