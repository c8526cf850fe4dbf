"""User-facing object model: :class:`MolecularSystem` and :class:`Molecule`
(counterpart of ``pywindow_tpu.molecular``; reference:
molecular.py:60-955).

The port carries loading (``load_file``, ``load_system``), the
force-field key helpers (``swap_atom_keys``, ``decipher_atom_keys``),
the periodic rebuild and the split into molecules (``rebuild_system``,
``make_modular``; host numpy and the native BFS,
:mod:`pywindow_torch.ops.rebuild`), the whole system as one molecule
(``system_to_molecule``), the per-molecule analysis (``full_analysis``,
the ``calculate_*`` getters, and ``analyze_molecules``, one batch of
every molecule of the system), the shape descriptors and the
principal-axes alignment, rdkit molecules (``load_rdkit_mol``) and the
writers.  Every analysis runs on the card unless the caller passes
``device="cpu"``.  ``Molecule._update`` of the reference
(molecular.py:548-551) is not provided, as in the JAX package.
"""

from __future__ import annotations

import pathlib
from copy import deepcopy

import numpy as np
import torch

from pywindow_torch import profiling, tables
from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig, resolve_device
from pywindow_torch.io.forcefield import decipher_all
from pywindow_torch.io.inputs import Input
from pywindow_torch.io.outputs import Output, to_list
from pywindow_torch.ops import analysis as _analysis
from pywindow_torch.ops.cell import create_supercell
from pywindow_torch.ops.rebuild import discrete_molecules


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
        device: torch.device | str | None = None,
    ) -> None:
        self._Output = Output()
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
        #: ``full_analysis`` call's; ``None``: the default device, resolved
        #: at each call)
        self.device = device
        self.properties: dict = {"no_of_atoms": self.no_of_atoms}
        self._analysed = False

    @classmethod
    def load_rdkit_mol(cls, mol, system_name: str = "rdkit", mol_id: int = 0) -> Molecule:
        """A molecule from an rdkit ``Mol`` (or any object with its atom
        and conformer accessors, see
        :func:`~pywindow_torch.io.inputs.rdkit_like_mol`)."""
        return cls(Input().load_rdkit_mol(mol), system_name, mol_id)

    @profiling.entry_point("full_analysis", "request")
    def full_analysis(
        self,
        ncpus: int = 1,
        device: torch.device | str | None = None,
        **kwargs,
    ) -> dict:
        """Run the complete analysis on ``device`` (default: this
        molecule's, else the default device, the card unless the caller
        names the CPU; raises when there is no card).

        ``ncpus`` is accepted for reference API compatibility and
        ignored (parallelism is the device's job).
        """
        del ncpus
        if device is None:
            device = self.device
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

    def molecular_weight(self) -> float:
        """Sum of atomic masses in g/mol (reference: molecular.py:268)."""
        self.MW = float(tables.ELEMENT_MASS[tables.element_ids(self.elements)].sum())
        return self.MW

    def calculate_centre_of_mass(self) -> np.ndarray:
        """Mass-weighted centroid; stored under ``centre_of_mass``
        (reference: molecular.py:277)."""
        m = tables.ELEMENT_MASS[tables.element_ids(self.elements)]
        com = (np.asarray(self.coordinates) * m[:, None]).sum(0) / m.sum()
        self.centre_of_mass = com
        self.properties["centre_of_mass"] = com
        return com

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

    def _align_to_principal_axes(self, align_molsys: bool = False) -> None:
        """Rotate the molecule onto its principal axes
        (:func:`pywindow_torch.utilities.align_principal_ax`; the
        reference assigned to ``coordinates[0]``, molecular.py:204-213)."""
        if align_molsys:
            raise NotImplementedError
        from pywindow_torch.utilities import align_principal_ax

        self.coordinates, _ = align_principal_ax(self.elements, self.coordinates)
        self.mol["coordinates"] = self.coordinates
        self.aligned_to_principal_axes = True

    def calculate_shape_descriptors(self, device: torch.device | str | None = None) -> dict:
        """Asphericity, acylindricity and relative shape anisotropy from
        the inertia tensor's eigenvalues (reference: utilities.py:626-650),
        computed in float64 on ``device`` (default: this molecule's);
        stored under ``shape_descriptors``."""
        from pywindow_torch.ops import geometry
        from pywindow_torch.ops.encoding import encode

        mol = encode(
            self.elements, self.coordinates, dtype=torch.float64,
            device=resolve_device(self.device if device is None else device),
        )
        eig = geometry.sorted_eigenvalues(geometry.inertia_tensor(mol))
        descriptors = {
            "asphericity": float(geometry.asphericity(eig)),
            "acylidricity": float(geometry.acylindricity(eig)),
            "relative_shape_anisotropy": float(geometry.relative_shape_anisotropy(eig)),
        }
        self.properties["shape_descriptors"] = descriptors
        return descriptors

    def shift_to_origin(self) -> None:
        """Translate so the COM coincides with the origin
        (reference: molecular.py:354-366).  Diameters do not change;
        the positional properties (COM, optimised pore centre, window
        centres) are translated in place rather than recomputed."""
        com = self.calculate_centre_of_mass()
        self.coordinates = np.asarray(self.coordinates) - com
        self.mol["coordinates"] = self.coordinates
        self.properties["centre_of_mass"] = np.zeros(3)
        self.centre_of_mass = self.properties["centre_of_mass"]
        if "pore_diameter_opt" in self.properties:
            opt = self.properties["pore_diameter_opt"]
            opt["centre_of_mass"] = np.asarray(opt["centre_of_mass"]) - com
            self.pore_opt_COM = opt["centre_of_mass"]
        wins = self.properties.get("windows", {})
        if wins.get("centre_of_mass") is not None:
            wins["centre_of_mass"] = np.asarray(wins["centre_of_mass"]) - com

    # -- output (reference: molecular.py:398-546) ------------------------

    def dump_properties_json(
        self,
        filepath: pathlib.Path | str | None = None,
        molecular: bool = False,
        override: bool = False,
    ) -> None:
        """Write ``properties`` (plus the molecule dict when
        ``molecular=True``) as JSON."""
        dict_obj = deepcopy(self.properties)
        if molecular:
            dict_obj.update(self.mol)
        if filepath is None:
            filepath = pathlib.Path.cwd() / f"{self.parent_system}_{self.molecule_id}"
        self._Output.dump2json(
            dict_obj, pathlib.Path(filepath), default=to_list, override=override
        )

    def dump_molecule(
        self,
        filepath: pathlib.Path | str | None = None,
        include_coms: bool = False,
        override: bool = False,
        **kwargs,
    ) -> None:
        """Write the molecule to PDB or XYZ, optionally with He (COM), Ne
        (optimised pore centre) and Ar (window centres) markers; with
        markers it runs the analysis first if it has not run."""
        if filepath is None:
            filepath = pathlib.Path.cwd() / f"{self.parent_system}_{self.molecule_id}.pdb"
        atom_ids_key = "elements" if "atom_ids" not in self.mol else "atom_ids"
        mmol = deepcopy(self.mol)
        if include_coms:
            self._ensure_analysis()

            def overlay(element, atom_id, xyz):
                mmol["elements"] = np.concatenate((mmol["elements"], np.array([element])))
                if "atom_ids" in mmol:
                    mmol["atom_ids"] = np.concatenate((mmol["atom_ids"], np.array([atom_id])))
                mmol["coordinates"] = np.concatenate((mmol["coordinates"], np.array([xyz])))

            overlay("He", "He", self.properties["centre_of_mass"])
            overlay("Ne", "Ne", self.properties["pore_diameter_opt"]["centre_of_mass"])
            wcoms = self.properties["windows"]["centre_of_mass"]
            if wcoms is not None:
                for k, com in enumerate(wcoms):
                    overlay("Ar", f"Ar{k + 1}", com)
        self._Output.dump2file(
            mmol, pathlib.Path(filepath), atom_ids_key=atom_ids_key,
            override=override, **kwargs,
        )


class MolecularSystem:
    """Container for a loaded molecular system (reference:
    molecular.py:554-955)."""

    def __init__(self) -> None:
        self._Input = Input()
        self._Output = Output()
        self.system_id: str | int = 0
        self.system: dict = {}
        self.molecules: dict = {}

    @classmethod
    @profiling.entry_point("load_file", "load")
    def load_file(cls, filepath: pathlib.Path | str) -> MolecularSystem:
        filepath = pathlib.Path(filepath)
        obj = cls()
        obj.system = obj._Input.load_file(filepath)
        obj.filename = filepath.name
        obj.system_id = obj.filename.split(".")[0]
        obj.name = obj.system_id
        return obj

    @classmethod
    def load_rdkit_mol(cls, mol) -> MolecularSystem:
        """A system from an rdkit ``Mol`` (or an object with its accessors)."""
        obj = cls()
        obj.system = obj._Input.load_rdkit_mol(mol)
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

    def rebuild_system(self, override: bool = False, **kwargs) -> MolecularSystem:
        """The system with the molecules that cross the periodic boundary
        made whole, as a new :class:`MolecularSystem` (reference:
        molecular.py:672-708); ``override`` also replaces this system's
        atoms.  ``kwargs`` go to
        :func:`~pywindow_torch.ops.rebuild.discrete_molecules`
        (``use_native``, ``tol``)."""
        discrete = discrete_molecules(
            self.system, rebuild=create_supercell(self.system), **kwargs
        )
        coordinates = np.array([], dtype=np.float64).reshape(0, 3)
        atom_ids = np.array([])
        elements = np.array([])
        have_ids = all("atom_ids" in mol for mol in discrete) and discrete
        for mol in discrete:
            coordinates = np.concatenate([coordinates, mol["coordinates"]], axis=0)
            elements = np.concatenate([elements, mol["elements"]])
            if have_ids:
                atom_ids = np.concatenate([atom_ids, mol["atom_ids"]])
        rebuilt = {"coordinates": coordinates, "elements": elements}
        if have_ids:
            rebuilt["atom_ids"] = atom_ids
        if override:
            self.system.update(rebuilt)
        return self.load_system(rebuilt)

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

    def make_modular(self, rebuild: bool = False, use_native: bool = True) -> None:
        """Split the system into :class:`Molecule` s keyed 0, 1, ...
        (reference: molecular.py:798-824); ``rebuild`` first makes whole
        the molecules that cross the periodic boundary."""
        supercell = None
        if rebuild:
            with profiling.stage("rebuild_supercell"):
                supercell = create_supercell(self.system)
        dis = discrete_molecules(self.system, rebuild=supercell, use_native=use_native)
        self.no_of_discrete_molecules = len(dis)
        self.molecules = {
            i: Molecule(dis[i], str(self.system_id), i) for i in range(len(dis))
        }

    def system_to_molecule(self) -> Molecule:
        """Treat the whole system as one :class:`Molecule`
        (reference: molecular.py:818)."""
        return Molecule(self.system, str(self.system_id), 0)

    def analyze_molecules(self, device: torch.device | str | list | None = None) -> dict:
        """Full analysis of every molecule of :meth:`make_modular` as one
        batch on ``device`` (every local card unless the caller asks for
        others or the CPU; see
        :func:`~pywindow_torch.parallel.mesh.frame_devices`) -> ``{molecule
        key: properties}``; each :class:`Molecule`'s ``properties`` are
        filled in place, and its getters analyse on ``device`` (the
        first device of a list)."""
        if not self.molecules:
            msg = "no molecules; run make_modular() first"
            raise RuntimeError(msg)
        from pywindow_torch.parallel.batch import analyze_batch
        from pywindow_torch.parallel.mesh import frame_devices

        keys = list(self.molecules)
        own = frame_devices(device)[0] if isinstance(device, (list, tuple)) else device
        results = analyze_batch(
            [(self.molecules[k].elements, self.molecules[k].coordinates) for k in keys],
            device=device,
        )
        for key, props in zip(keys, results):
            mol = self.molecules[key]
            mol.MW = props.pop("molecular_weight")
            mol.properties.update(props)
            mol._sync_attributes()
            mol.device = own
            mol._analysed = True
        return {k: self.molecules[k].properties for k in keys}

    # -- output (reference: molecular.py:849-955) ------------------------

    def dump_system(
        self,
        filepath: pathlib.Path | str | None = None,
        modular: bool = False,
        override: bool = False,
        **kwargs,
    ) -> None:
        """Write the system to PDB or XYZ; ``modular=True`` writes the
        molecules of :meth:`make_modular` one after another instead."""
        if filepath is None:
            filepath = pathlib.Path.cwd() / f"{self.system_id}.pdb"
        system_dict = deepcopy(self.system)
        if modular:
            elements = np.array([])
            atom_ids = np.array([])
            coor = np.array([]).reshape(0, 3)
            have_ids = self.molecules and all(
                "atom_ids" in m.mol for m in self.molecules.values()
            )
            for mol_ in self.molecules.values():
                elements = np.concatenate((elements, mol_.mol["elements"]))
                if have_ids:
                    atom_ids = np.concatenate((atom_ids, mol_.mol["atom_ids"]))
                coor = np.concatenate((coor, mol_.mol["coordinates"]), axis=0)
            system_dict["elements"] = elements
            system_dict["coordinates"] = coor
            if have_ids:
                system_dict["atom_ids"] = atom_ids
            else:
                system_dict.pop("atom_ids", None)
        atom_ids_key = "elements" if "atom_ids" not in system_dict else "atom_ids"
        self._Output.dump2file(
            system_dict, pathlib.Path(filepath), atom_ids_key=atom_ids_key,
            override=override, **kwargs,
        )

    def dump_system_json(
        self,
        filepath: pathlib.Path | str | None = None,
        modular: bool = False,
        override: bool = False,
    ) -> None:
        """Write the system dict (or, with ``modular=True``, the
        molecule dicts) as JSON."""
        dict_obj = deepcopy(self.system)
        if modular:
            if not self.molecules:
                msg = "this system is not modular; run make_modular() first"
                raise RuntimeError(msg)
            dict_obj = {key: mol_.mol for key, mol_ in self.molecules.items()}
        if filepath is None:
            filepath = pathlib.Path.cwd() / f"{self.system_id}"
        self._Output.dump2json(
            dict_obj, pathlib.Path(filepath), default=to_list, override=override
        )
