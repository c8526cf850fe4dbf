"""The frame mesh of pywindow_torch (``parallel/mesh.py``) and batches
sharded over several devices, on the CPU.

- ``pad_batch_to_devices``, ``shard_bounds`` and ``host_device_grid``
  against the JAX package's mesh on the conftest's 8 virtual devices
  (exact: integers).
- ``frame_devices``: the CPU, lists, and no card.
- The memory budget split between the shards and the ranks on a device.
- ``analyze_batch`` and ``sweep_uniform`` over several CPU "devices"
  (shards with padding, a shard that is all padding) against one
  device: every value equal, bit for bit; ``analyze_batch`` against the
  JAX package's, which shards over the 8 virtual devices, at 1e-8 Å
  where no optimiser runs and 1e-4 Å for optimised values (the
  tolerances of tests/test_torch_batch.py, on its JAX-parity frames).
"""

import jax
import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.parallel import batch, mesh
from pywindow_tpu.parallel import batch as jbatch
from pywindow_tpu.parallel import mesh as jmesh
from tests.conftest import DATA
from tests.test_torch_batch import _assert_props_close
from tests.test_torch_stream import _assert_identical

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
#: frames on which both packages' float64 drivers stop at the same kink
#: (tests/test_torch_batch.py)
PARITY_FRAMES = [2, 4, 10, 15, 19]


def _frames(idx):
    fr = pt.DLPOLY(HISTORY).get_frames(idx, **FF)
    return [(np.asarray(m.system["elements"]), m.system["coordinates"]) for m in fr.values()]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 7, 8])
def test_pad_batch_to_devices_matches_jax(n_dev):
    for n in range(0, 40):
        assert mesh.pad_batch_to_devices(n, n_dev) == jmesh.pad_batch_to_devices(n, n_dev)


@pytest.mark.parametrize("b_pad", [8, 16, 24, 1440])
def test_shard_bounds_match_the_jax_frames_sharding(b_pad):
    """The (lo, hi) of each device's shard equal the index ranges of the
    addressable shards of a frames-sharded array, in mesh order."""
    fmesh = jmesh.frame_mesh()
    assert fmesh.devices.size == 8
    arr = jax.device_put(np.arange(b_pad), jmesh.batch_sharding(fmesh))
    by_device = {s.device.id: s.index[0] for s in arr.addressable_shards}
    ref = [(by_device[d.id].start, by_device[d.id].stop) for d in fmesh.devices.flat]
    assert mesh.shard_bounds(b_pad, 8) == ref


def test_shard_bounds_refuse_an_uneven_batch():
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_bounds(10, 4)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 8])
def test_host_device_grid_matches_host_device_mesh(n_hosts):
    """Row h of the grid holds the devices of host h, as the JAX mesh's
    ('hosts', 'frames') axes (devices compared by id; 3 hosts drop the
    devices that do not fill a row)."""
    jgrid = jmesh.host_device_mesh(n_hosts=n_hosts).devices
    ids = [d.id for d in jax.devices()]
    assert mesh.host_device_grid(ids, n_hosts=n_hosts) == [[d.id for d in row] for row in jgrid]


def test_host_device_grid_defaults_to_one_host():
    assert mesh.host_device_grid(["a", "b", "c"]) == [["a", "b", "c"]]


def test_frame_devices_on_the_cpu_and_lists():
    cpu = torch.device("cpu")
    assert mesh.frame_devices("cpu") == [cpu]
    assert mesh.frame_devices(cpu) == [cpu]
    assert mesh.frame_devices(["cpu", cpu, "cpu"]) == [cpu, cpu, cpu]
    assert mesh.frame_devices(("cpu",)) == [cpu]
    with pytest.raises(ValueError, match="empty"):
        mesh.frame_devices([])


def test_frame_devices_refuse_mixed_types(monkeypatch):
    """A batch shards over devices of one type (a card is faked present:
    nothing runs on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.frame_devices(["cuda:0", "cuda:1"]) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="one device type"):
        mesh.frame_devices(["cpu", "cuda:0"])


@pytest.mark.parametrize("device", ["cuda", "cuda:1", torch.device("cuda"), ["cpu", "cuda:0"]])
def test_frame_devices_raise_without_a_card(monkeypatch, device):
    """No fallback to the CPU: asking for a card that is not there
    raises, in the batch entry points too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.frame_devices(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.analyze_batch(_frames([2]), device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.DLPOLY(HISTORY).analysis_batched(frames=[2], device=device, **FF)


def test_budget_splits_between_shards_and_ranks(monkeypatch):
    """A device's budget is split between the shards it runs and the
    ranks of the process group on it; the batch is a shard's frames
    times the shard count."""
    elements, coords = _frames([2])[0]
    maxd = 23.2
    budget = 10**9

    def safe(device, b=budget):
        return batch.max_safe_batch(len(elements), maxd, device=device, budget=b)

    half, quarter = safe("cpu", budget // 2), safe("cpu", budget // 4)
    assert 1 < quarter < half < safe("cpu")
    assert safe(["cpu", "cpu"]) == 2 * half
    assert safe(["cpu"] * 4) == 4 * quarter
    assert mesh.ranks_on(torch.device("cpu")) == 1
    monkeypatch.setitem(mesh.RANKS_ON, mesh.device_key(torch.device("cpu")), 2)
    assert mesh.ranks_on(torch.device("cpu")) == 2
    assert safe("cpu") == half
    assert safe(["cpu", "cpu"]) == 2 * quarter


def test_analyze_batch_over_three_devices():
    """Five frames over three CPU devices (padded to six, shards of two)
    equal the single-device call bit for bit, and the JAX package's
    analyze_batch over its 8 virtual devices within 1e-8 / 1e-4 Å."""
    systems = _frames(PARITY_FRAMES)
    sharded = batch.analyze_batch(systems, device=["cpu"] * 3)
    single = batch.analyze_batch(systems, device="cpu")
    ref = jbatch.analyze_batch(systems)
    assert len(sharded) == len(single) == len(ref) == 5
    for s, o, r in zip(sharded, single, ref):
        _assert_identical(s, o)
        _assert_props_close(s, r)


@pytest.mark.parametrize(("n_dev", "chunk"), [(2, 3), (3, 3)])
def test_sweep_uniform_over_devices_equals_one_device(n_dev, chunk):
    """Four frames in chunks of three over two or three CPU devices
    (each chunk padded with its first frame; over three devices the
    one-frame last chunk leaves two shards all padding) equal the
    single-device sweep bit for bit, delivered in frame order."""
    systems = _frames([2, 4, 10, 15])
    elements = systems[0][0]
    coords = np.stack([c for _, c in systems])
    maxd = batch.frame_max_diameters(elements, coords, "cpu")

    def run(device):
        got: dict = {}
        order: list = []

        def on_batch(pos, res):
            order.extend(pos.tolist())
            got.update(zip(pos.tolist(), res))

        batch.LEARNED_CAPS._caps.clear()
        batch.sweep_uniform(elements, coords, maxd, on_batch, batch_size=chunk, device=device)
        return got, order

    sharded, order = run(["cpu"] * n_dev)
    single, _ = run("cpu")
    assert order == [0, 1, 2, 3]
    assert sorted(sharded) == sorted(single) == [0, 1, 2, 3]
    for f in single:
        _assert_identical(sharded[f], single[f])


def _fake_cards(monkeypatch, n: int) -> None:
    """``n`` cards that are said to be there: only device objects are
    made, nothing runs on them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_unindexed_cuda_shards_on_one_card(monkeypatch):
    """On four cards an unindexed "cuda" runs a batch on the first card
    (or a rank's first own card); a named card or a list is taken as
    given."""
    _fake_cards(monkeypatch, 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.frame_devices("cuda") == cards
    assert mesh.shard_devices("cuda") == [cards[0]]
    assert mesh.shard_devices(torch.device("cuda")) == [cards[0]]
    assert mesh.shard_devices("cuda:2") == [cards[2]]
    assert mesh.shard_devices([f"cuda:{i}" for i in range(4)]) == cards
    assert mesh.shard_devices(["cuda:0", "cuda:0"]) == [cards[0], cards[0]]
    assert mesh.shard_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    assert mesh.shard_devices("cpu") == [torch.device("cpu")]
    own = [cards[1], cards[3]]
    monkeypatch.setattr(mesh, "LOCAL_DEVICES", own)
    assert mesh.frame_devices("cuda") == own
    assert mesh.shard_devices("cuda") == [cards[1]]


def test_budget_plans_the_default_on_one_card(monkeypatch):
    """An unindexed "cuda" over four cards plans one card's batch; a
    list of the four plans four shards of one card's batch each."""
    _fake_cards(monkeypatch, 4)
    elements, _ = _frames([2])[0]

    def safe(device):
        return batch.max_safe_batch(len(elements), 23.2, device=device, budget=10**9)

    assert safe("cuda") == safe("cuda:0") == safe("cuda:3") > 1
    assert safe([f"cuda:{i}" for i in range(4)]) == 4 * safe("cuda:0")


class _Span:
    def __init__(self, seconds):
        self.seconds = seconds

    def settle(self):
        return self.seconds


def test_settle_shards_books_the_busiest_device(monkeypatch):
    """One span a chunk: the shards of one device add up, the devices
    run at once; spans opened with profiling off book nothing."""
    from pywindow_torch import profiling

    booked: list = []
    monkeypatch.setattr(profiling.METRICS, "add_stage", lambda name, s: booked.append((name, s)))
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    profiling.settle_shards("sweep_step", [(a, _Span(0.25)), (a, _Span(0.5)), (b, _Span(0.625))])
    profiling.settle_shards("sweep_step", [(a, _Span(0.125))])
    profiling.settle_shards("sweep_step", [(a, _Span(None)), (b, _Span(None))])
    assert booked == [("sweep_step", 0.75), ("sweep_step", 0.125)]
