"""The device of pywindow_torch's batch layer (``parallel/mesh.py``), on
the CPU.

- ``frame_device``: the CPU, an unindexed ``"cuda"`` (the rank's card,
  else ``cuda:0``), a named card, no card, and lists refused.
- The memory budget split between the ranks on a device.
- Every entry point that takes ``device`` refuses a list or tuple with
  a ``ValueError`` that names ``parallel.distributed``, before any work:
  one process runs on one device, several cards run as ranks.
"""

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops import analysis
from pywindow_torch.parallel import batch, distributed, mesh
from pywindow_torch.trajectory import Trajectory
from tests.conftest import DATA, load_structure

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}


def _frames(idx):
    fr = pt.DLPOLY(HISTORY).get_frames(idx, **FF)
    return [(np.asarray(m.system["elements"]), m.system["coordinates"]) for m in fr.values()]


def test_frame_devices_on_the_cpu_and_lists():
    """The CPU is the CPU; a list or tuple, of any length, is refused."""
    cpu = torch.device("cpu")
    assert mesh.frame_device("cpu") == cpu
    assert mesh.frame_device(cpu) == cpu
    for device in (["cpu", cpu, "cpu"], ("cpu",), []):
        with pytest.raises(ValueError, match="one process runs on one device"):
            mesh.frame_device(device)


def test_frame_devices_refuse_mixed_types(monkeypatch):
    """A list is refused whatever it holds, cards of one type or of two
    (a card is faked present: nothing runs on it); a named card is that
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.frame_device("cuda:1") == torch.device("cuda", 1)
    for device in (["cuda:0", "cuda:1"], ["cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="parallel.distributed"):
            mesh.frame_device(device)


@pytest.mark.parametrize("device", ["cuda", "cuda:1", torch.device("cuda"), "cuda:0"])
def test_frame_devices_raise_without_a_card(monkeypatch, device):
    """No fallback to the CPU: asking for a card that is not there
    raises, in the batch entry points too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.frame_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.analyze_batch(_frames([2]), device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DLPOLY(HISTORY).analysis_batched(frames=[2], device=device, **FF)


def test_budget_splits_between_shards_and_ranks(monkeypatch):
    """A device's budget is split between the ranks of the process group
    that run on it."""
    elements, coords = _frames([2])[0]
    maxd = 23.2
    budget = 10**9

    def safe(device, b=budget):
        return batch.max_safe_batch(len(elements), maxd, device=device, budget=b)

    half, quarter = safe("cpu", budget // 2), safe("cpu", budget // 4)
    assert 1 < quarter < half < safe("cpu")
    assert mesh.ranks_on(torch.device("cpu")) == 1
    monkeypatch.setitem(mesh.RANKS_ON, mesh.device_key(torch.device("cpu")), 2)
    assert mesh.ranks_on(torch.device("cpu")) == 2
    assert safe("cpu") == half
    monkeypatch.setitem(mesh.RANKS_ON, mesh.device_key(torch.device("cpu")), 4)
    assert safe("cpu") == quarter


def _fake_cards(monkeypatch, n: int) -> None:
    """``n`` cards that are said to be there: only device objects are
    made, nothing runs on them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_unindexed_cuda_shards_on_one_card(monkeypatch):
    """On four cards an unindexed "cuda" is the first card, or a rank's
    own card once ``distributed.initialize`` has set it; a named card is
    that card."""
    _fake_cards(monkeypatch, 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.frame_device("cuda") == cards[0]
    assert mesh.frame_device(torch.device("cuda")) == cards[0]
    assert mesh.frame_device("cuda:2") == cards[2]
    assert mesh.frame_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(mesh, "LOCAL_DEVICE", cards[1])
    assert mesh.frame_device("cuda") == cards[1]
    assert mesh.frame_device("cuda:3") == cards[3]


def test_budget_plans_the_default_on_one_card(monkeypatch):
    """An unindexed "cuda" over four cards plans one card's batch, as
    a named card does, and as the rank's own card does."""
    _fake_cards(monkeypatch, 4)
    elements, _ = _frames([2])[0]

    def safe(device):
        return batch.max_safe_batch(len(elements), 23.2, device=device, budget=10**9)

    assert safe("cuda") == safe("cuda:0") == safe("cuda:3") > 1
    monkeypatch.setattr(mesh, "LOCAL_DEVICE", torch.device("cuda", 2))
    assert safe("cuda") == safe("cuda:2")


def _system():
    system = pt.MolecularSystem.load_file(DATA / "YAQHOQ.xyz")
    system.make_modular()
    return system


def _sweep_stream(device):
    elements, coords = load_structure("YAQHOQ")

    def decode_slab(lo, hi, out64=None, out32=None):
        raise AssertionError("a frame was decoded")

    batch.sweep_stream(elements, 1, decode_slab, lambda pos, res: None, device=device)


def _sweep_uniform(device):
    elements, coords = load_structure("YAQHOQ")
    batch.sweep_uniform(
        elements, coords[None], np.array([23.2]), lambda pos, res: None, device=device
    )


#: every public entry point that takes ``device``, called with it
LIST_ENTRY_POINTS = {
    "mesh.frame_device": mesh.frame_device,
    "batch.max_safe_batch": lambda d: batch.max_safe_batch(168, 23.2, device=d),
    "batch.frame_max_diameters": lambda d: batch.frame_max_diameters(
        load_structure("YAQHOQ")[0], load_structure("YAQHOQ")[1][None], d
    ),
    "batch.dispatch_batch": lambda d: batch.dispatch_batch([load_structure("YAQHOQ")], device=d),
    "batch.analyze_batch": lambda d: batch.analyze_batch([load_structure("YAQHOQ")], device=d),
    "batch.sweep_uniform": _sweep_uniform,
    "batch.sweep_stream": _sweep_stream,
    "Trajectory.analysis_batched": lambda d: pt.DLPOLY(HISTORY).analysis_batched(
        frames=[2], device=d, **FF
    ),
    "MolecularSystem.analyze_molecules": lambda d: _system().analyze_molecules(device=d),
    "distributed.analysis_batched_distributed": lambda d: distributed.analysis_batched_distributed(
        pt.DLPOLY(HISTORY), frames=[2], device=d, **FF
    ),
}


def _no_work(*args, **kwargs):
    raise AssertionError("work started before the device was checked")


@pytest.mark.parametrize("device", [["cpu"], ("cpu", "cpu")], ids=["list_of_one", "tuple_of_two"])
@pytest.mark.parametrize("name", LIST_ENTRY_POINTS)
def test_a_device_list_is_refused_before_any_work(monkeypatch, name, device):
    """One process runs on one device: a list or tuple raises a
    ``ValueError`` naming ``parallel.distributed`` (how several cards
    run), before any frame is resolved, decoded, encoded or analysed."""
    for owner, attr in (
        (analysis, "run_pipeline"), (batch, "encode_batch"), (batch, "encode_host"),
        (batch, "pairwise_distances"), (batch, "static_sizes"), (batch, "max_dim_bound"),
        (Trajectory, "_resolve_frames"), (Trajectory, "_decode_uniform"),
    ):
        monkeypatch.setattr(owner, attr, _no_work)
    with pytest.raises(ValueError, match=r"one process runs on one device.*parallel\.distributed"):
        LIST_ENTRY_POINTS[name](device)
