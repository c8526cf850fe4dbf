"""The documentation walkthroughs, executed on the port.

``tests/test_walkthroughs.py`` runs every fenced ``python`` block of
``docs/walkthroughs/*.md`` against ``pywindow_tpu``; this file runs the
same blocks against ``pywindow_torch`` (the package name replaced in
memory, the documents untouched), per file in one shared namespace, in
a scratch cwd where ``tests/data`` resolves to the real fixtures.  The
blocks call the entry points without a device, so the default device is
named once, ``PYWINDOW_TORCH_DEVICE=cpu``: the port's float64 CPU path
with the classic optimisers, the parity leg.  Each test asserts exactly
the values and tolerances of its ``test_walkthroughs.py`` twin, with the
same stand-ins (rdkit, the forcefield aside of 05, the two-frame
periodic trajectory of 08).
"""

import pathlib
import re
import sys
import types

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
WALKTHROUGHS = REPO / "docs" / "walkthroughs"

_BLOCK_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _blocks(name: str) -> list[str]:
    text = (WALKTHROUGHS / name).read_text()
    blocks = _BLOCK_RE.findall(text)
    assert blocks, f"{name} has no python blocks"
    return [b.replace("pywindow_tpu", "pywindow_torch") for b in blocks]


def _run(name, tmp_path, monkeypatch, skip_blocks=(), preamble=None):
    """Execute the file's python blocks on the port, on the CPU,
    sequentially in one namespace."""
    (tmp_path / "tests").symlink_to(REPO / "tests")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYWINDOW_TORCH_DEVICE", "cpu")
    ns: dict = {}
    if preamble:
        preamble(ns, tmp_path)
    for i, block in enumerate(_blocks(name)):
        if i in skip_blocks:
            continue
        exec(compile(block, f"{name}[block {i}]", "exec"), ns)
    assert "pywindow_tpu" not in ns and ns["pw"].__name__ == "pywindow_torch"
    return ns


def test_walkthrough_01_structural_properties(tmp_path, monkeypatch):
    ns = _run("01_structural_properties.md", tmp_path, monkeypatch)
    props = ns["props"]
    assert props["pore_diameter_opt"]["diameter"] == pytest.approx(
        5.397020177310022, abs=1e-6
    )
    assert len(props["windows"]["diameters"]) == 4
    # the dump block wrote both artifacts into the scratch cwd
    assert (tmp_path / "PUDXES_properties.json").exists()
    assert (tmp_path / "PUDXES_out.pdb").exists()
    out = (tmp_path / "PUDXES_out.pdb").read_text()
    for dummy in ("HE", "NE", "AR"):
        assert dummy in out.upper()


def test_walkthrough_02_rdkit_input(tmp_path, monkeypatch):
    # without a real rdkit the loader path is driven through the
    # duck-typed Mol of the port's io layer (the stand-in of
    # test_walkthroughs.py), capability-checked as there
    def preamble(ns, _):
        try:
            import rdkit

            usable = hasattr(rdkit.Chem, "MolFromMol2File")
        except (ImportError, AttributeError):
            usable = False
        if not usable:
            from pywindow_torch.io.inputs import Input, rdkit_like_mol

            chem = types.ModuleType("rdkit.Chem")
            chem.MolFromMol2File = lambda path, removeHs=False: (
                rdkit_like_mol(Input().load_file(path))
            )
            rk = types.ModuleType("rdkit")
            rk.Chem = chem
            monkeypatch.setitem(sys.modules, "rdkit", rk)
            monkeypatch.setitem(sys.modules, "rdkit.Chem", chem)

    ns = _run("02_rdkit_input.md", tmp_path, monkeypatch, preamble=preamble)
    # 84 heavy atoms; pore golden from reference examples/example_2.py
    assert ns["mol"].no_of_atoms == 84
    assert ns["props"]["pore_diameter"]["diameter"] == pytest.approx(
        5.39702, abs=1e-4
    )


def test_walkthrough_03_average_diameter(tmp_path, monkeypatch):
    ns = _run("03_average_diameter.md", tmp_path, monkeypatch)
    assert ns["avg"] == pytest.approx(13.832017514255472, abs=1e-9)


def test_walkthrough_04_mof(tmp_path, monkeypatch):
    ns = _run("04_mof.md", tmp_path, monkeypatch)
    props = ns["props"]
    assert props["pore_diameter_opt"]["diameter"] == pytest.approx(
        12.2772, abs=1e-3
    )
    assert len(props["windows"]["diameters"]) == 6


def test_walkthrough_05_metal_organic_cage(tmp_path, monkeypatch):
    # the final block is the "if your PDB used forcefield names" aside:
    # SAYGOR already carries element symbols
    ns = _run(
        "05_metal_organic_cage.md", tmp_path, monkeypatch, skip_blocks={1}
    )
    props = ns["props"]
    assert props["pore_diameter_opt"]["diameter"] == pytest.approx(
        9.4050, abs=1e-3
    )
    got = np.sort(np.asarray(props["windows"]["diameters"], dtype=float))
    assert got == pytest.approx(
        [5.9568, 6.8087, 7.8919, 8.2966], abs=1e-3
    )


def test_walkthrough_06_periodic_system(tmp_path, monkeypatch):
    ns = _run("06_periodic_system.md", tmp_path, monkeypatch)
    assert len(ns["molsys"].molecules) == 8
    assert ns["props"]["pore_diameter_opt"]["diameter"] == pytest.approx(
        5.397, abs=2e-3
    )
    assert len(ns["results"]) == 8


def test_walkthrough_07_trajectory_single_molecule(tmp_path, monkeypatch):
    ns = _run("07_trajectory_single_molecule.md", tmp_path, monkeypatch)
    assert ns["traj"].no_of_frames == 20
    assert len(ns["traj"].analysis_output) == 20
    assert ns["props"]["pore_diameter_opt"]["diameter"] > 3.0
    # the save/reload block round-tripped into traj2
    assert len(ns["traj2"].analysis_output) == 20


def test_walkthrough_08_trajectory_periodic(tmp_path, monkeypatch):
    # the walkthrough opens "periodic_traj.pdb": two frames of the
    # periodic test system, as test_walkthroughs.py synthesises it
    def preamble(_, cwd):
        base = (REPO / "tests" / "data" / "system_periodic.pdb").read_text()
        frame = base[: base.rindex("END")] + "END\n"
        (cwd / "periodic_traj.pdb").write_text(frame * 2)

    ns = _run("08_trajectory_periodic.md", tmp_path, monkeypatch,
              preamble=preamble)
    mols = ns["mols"]
    assert len(mols) == 8
    assert 3.0 < mols[0]["pore_diameter_opt"]["diameter"] < 7.0
    # the batched block analysed both frames
    assert set(ns["traj"].analysis_output) == {0, 1}
