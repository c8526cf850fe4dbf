"""Smoke run of pywindow_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing of
JAX.  Phases, each of which raises on failure (exit code != 0, no
result line):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, float32 matmuls in full precision;
2. build the eight CUDA kernels from ``pywindow_torch/csrc`` (one
   ninja build, the sources compiled in parallel) and the native host
   library from ``pywindow_torch/_native`` (``g++``);
3. each kernel against its plain PyTorch version on the card, on the
   inputs the main paths give it (single runs of CC3 = PUDXES, 168
   atoms, and REYMAL, 468 atoms, the sweep's first 1,440-frame chunk,
   whose neighbouring lanes hold different frames, and the periodic
   trajectory's first chunk, 48 frames of 8 cages; the plain versions
   take a chunk in slices of lanes), in float64 and, for the ray kernels
   and DBSCAN, float32.  Each timed call is read twice: the warm median
   of one wrapper call between CUDA events (on an idle card a small
   call's reading is the wrapper's host time) and its device time, the
   call captured 20 times in one CUDA graph and replayed
   (:func:`device_ms`); beside them the plain version's time and each
   kernel's bound (the least time the card could take).  Both
   ``lbfgsb_stable`` calls of a label are timed (d = 3 pore, d = 1 window
   z), and for each optimiser call the active-lane share, the slowest
   lane alone beside the whole call, the float64 instruction floor, the
   bound beside the one over every lane and atom and, for ``nm_xy``, the
   atoms its grid cull keeps (``nm_kernels.grid_keep``).  Both
   ``ray_exit`` calls of a label are timed (the full average-diameter
   call, the slim pre-analysis), with each float32 call's flips printed;
   ``path_sweep``, ``fine_path`` and ``dbscan`` are held bit for bit in
   both dtypes (``fine_path`` with the pipeline's active slots); for the
   three ray kernels the atoms their exact culls keep
   (``ray_kernels.ray_exit_keep``, ``path_sweep_keep``), the bound under
   the cull beside the one over every pair, and the FP32 instruction
   floor; for ``dbscan`` the valid points a frame and the bound over
   the work its exact tile rule leaves (``dbscan_work``) beside the ones
   over all unordered valid pairs and over all K^2.  ``clearance_min``,
   which no pipeline stage calls, is held to the bit (``torch.equal``,
   NaN where the plain version is NaN) in both dtypes on: the shapes of tests/test_pallas.py with the
   padding case, Q = 65,536 probes against N = 4,096 atoms, a 50^3
   clearance grid over the rebuilt periodic cell (1,344 atoms) and the
   adversarial sets of :func:`clearance_cases` (probes on atom centres
   and 1e3 Å outside, NaN probe, atom and radius, N = 1, Q = 1, every
   atom padded but one, Q = 1,000, N = 20,000, and far tiles a few ulps
   either side of the cull's skip bound); the main sets are timed, with
   ``torch.cdist`` + ``amin`` beside them, the pairs each probe's own
   exact test keeps and the bound over them beside the every-pair
   bound, the tile pairs and pairs its warps visit and the sort's bytes
   (the design's work), and the instruction floors.  ``max_dim`` (the
   atoms form and the value form) is held to the bit, atoms included, in
   both dtypes on every recorded call and on two sweep chunks built here,
   CC3 (4,320 x 168) and MIBQAR (1,200 x 424), timed on those too; then
   the device pipeline runs each of the two chunks through the kernel and
   through the plain all-pairs passes: packed rows equal bit for bit;
4. the 7-system golden gate through
   ``MolecularSystem.load_file(...).system_to_molecule().full_analysis()``
   (the card is the default device; float32 pipeline, float64 optimiser
   kernels), every system within 0.01 Å;
5. the batched gate: ``analyze_batch`` of 128 CC3 copies, every frame
   within 0.01 Å of the goldens;
6. the trajectory sweep at full width: a 4,320-frame DL_POLY HISTORY
   (the 20-frame CC3 fixture cycled, as ``bench.py`` builds it) through
   ``DLPOLY(path).analysis_batched(..., batch_size=1440)``, the streamed
   route it takes by default (slab k+1 decoded on a thread while the
   card runs chunk k, chunks copied from the pinned store of decoded
   frames on a side stream, results
   collected and converted by the native converter on a thread): all
   results present and finite, frames per second and peak device memory
   per chunk; then, outside the sweep's launch count, eight distinct
   frames against the single-frame path (pore_opt against
   ``full_analysis()``, windows against the frame alone at the sweep's
   sampling pin); (a) the streamed route again and the up-front route
   (every frame decoded, then ``sweep_uniform``) at the same pin, both
   timed, equal bit for bit on every frame, with the decode seconds the
   stream hid behind the card; (c) every packed block of that run
   through the native and the plain dict converters, equal dicts, both
   timed; (b) an escalation case, the first 1,440 frames and the same
   frames scaled by 1.35 through ``sweep_stream`` with a size gate,
   equal to ``sweep_uniform`` bit for bit, the delivery before the
   restart flagged not final and the last final;
7. the profile: host stage spans of one PUDXES and one REYMAL molecule,
   the device's busy share and kernel launches of a molecule and of
   a 1,440-frame chunk (``torch.profiler``), and seven more warm runs of
   each molecule with the garbage collector's oldest-generation passes;
8. the periodic system: ``MolecularSystem.load_file(system_periodic.pdb)``,
   ``rebuild_system()`` atom for atom against the reference's rebuild
   (``system_periodic_rebuild.pdb``), then ``make_modular(rebuild=True)``
   and ``analyze_molecules()`` on the card: every cage within 0.01 Å of
   its orientation's reference row;
9. a periodic PDB trajectory at full width: 96 frames of the 24.8 Å
   cell (frame 0 the file itself, the others translated by a random
   vector and wrapped into the cell) through ``PDB(path).analysis_batched(
   modular=True, rebuild=True, forcefield="DLF", batch_size=48)``, 384
   cage lanes per chunk: every frame 8 cages within 0.01 Å of their
   rows; frames and molecules per second, host stage spans, the chunks'
   device time, peak device memory and the native library's calls; then
   frames 0, 31, 63 and 95 against the serial ``analysis()``;
10. the clearance grid through ``clearance_min``, the entry point of the
   one kernel that no pipeline stage calls;
11. the public surface on the card: ``utilities.find_windows``,
   ``find_average_diameter``, ``opt_pore_diameter`` and
   ``window_analysis`` on PUDXES and REYMAL within 0.01 Å of the
   goldens, each call's own launches read on its thread (counts set to
   0 before it) and holding the kernels it must reach; the three scipy
   objectives on the card equal to ``pore_diameter``;
   ``calculate_shape_descriptors`` against the numpy ones, the command
   line's ``analyze`` and ``trajectory`` in subprocesses, each
   launching the seven pipeline kernels, and one molecule under
   ``profiling.trace`` (the seven pipeline kernels in the trace); then,
   off the main paths,
   ``dbscan_spiral`` on a sweep chunk's whole-spiral ray endpoints,
   timed beside the dbscan kernel on the same points;
12. the frame mesh and the multi-process sweep, run after phase 6's
   legs on its 4,320-frame history at ``batch_size=1440`` (profiling
   off): (a) ``analysis_batched(device="cuda")``, the default's card
   (``parallel.mesh.frame_device``), once as a main path and then
   timed against ``device="cuda:0"``; (c) two ``gloo`` ranks on the
   first card and (d) one NCCL rank, each a subprocess
   (``python3 chip_smoke.py --rank-worker ...``, :func:`rank_worker`)
   with its own timeout, through
   ``parallel.distributed.analysis_batched_distributed``: each rank
   decodes only its own shard, launches all seven pipeline kernels,
   loads no JAX and holds all 4,320 frames; (e) with more than one
   card, one NCCL rank a card.
   Every leg equals (a)'s ``cuda:0`` run bit for bit on every value of
   every frame; frames/s beside the card's name and power limit.
   ``python3 chip_smoke.py --mesh`` runs phases 1, 2 and 12 alone;
13. the port's benchmark, ``python -m pywindow_torch bench``, in a
   subprocess at full size after phase 12 (``bench_torch.py``: its own
   golden gate, CC3 kernel and end-to-end frames/s, MIBQAR and REYMAL,
   the seven pipeline kernels' device ms on its CC3 batch): exit code 0,
   the headline line last and under 1,000 bytes, the gate passed and
   all seven pipeline kernels launched; its rates and headline printed;
14. the walkthroughs and the validation suites, after phase 11: the
   eight ``docs/walkthroughs`` executed against ``pywindow_torch`` on the
   default device, the card (each file's python blocks in one namespace
   in a scratch directory under ``build/``, the package name replaced in
   memory; 02 through a stand-in of rdkit over
   ``io.inputs.rdkit_like_mol`` when rdkit is not installed, 05 without
   its forcefield-names aside, 08 on a two-frame periodic trajectory),
   each against its goldens within 0.01 Å, its seconds, worst error and
   own launches printed (all seven pipeline kernels, ``ray_exit`` for 03);
   the reference's validation suites, ``calculate_windows`` of five
   cages (0.01 Å, case_5 0.05 Å, centres matched order-insensitively)
   and ``calculate_average_diameter`` of five molecules (0.01 Å), each
   through its kernels; ``ops.analysis.pore_diameter_opt`` on PUDXES
   through ``lbfgsb_stable`` within 0.01 Å of 5.397, and
   ``ops.rays.ray_sphere_intersections`` reduced over atoms against the
   ``ray_exit`` kernel's ``any_front`` (no flip in float64, the flips
   counted in float32).

``PYWINDOW_TORCH_DEVICE``, where set, must name the card (``cuda`` or
``cuda:N``): the script refuses to start otherwise.

Phases 4-6, 8, 9, 10, 11, 14 and 12's first ``"cuda"`` run are the main paths: before each the kernel
launch counters are set to 0 and after it every kernel of the path must
have launched (all seven pipeline kernels; ``clearance_min`` and its three
helper passes on its grid);
every call of the device pipeline must launch each kernel as often as
every other (the count does not depend on the batch size), and no plain
optimiser loop may run on a CUDA tensor.  The kernel record's launch
counts are the DL_POLY sweep's own, and the grid's for
``clearance_min``, whose entry adds its helper passes' launches
(``helper_launches``).

The last three lines of standard output are the kernel record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import pathlib
import pickle
import re
import socket
import subprocess
import statistics
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
HISTORY = DATA / "HISTORY_singlemol_short"
SWEEP_FRAMES = 4320
SWEEP_CHUNK = 1440
SWEEP_LABEL = f"sweep{SWEEP_CHUNK}"
BATCH_GATE = 128
#: 8 sweep frames held against the single-frame path: distinct fixture
#: frames (frame % 20), from all three chunks
SWEEP_SAMPLE = [0, 3, 1447, 1450, 2885, 2898, 4306, 4319]
PERIODIC = DATA / "system_periodic.pdb"
PERIODIC_FRAMES = 96
PERIODIC_CHUNK = 48
PERIODIC_LABEL = f"periodic{PERIODIC_CHUNK}"
PERIODIC_SAMPLE = [0, 31, 63, 95]
#: the periodic cell's cages (JAX package, CPU float64): two
#: orientations, told apart by the average diameter (0.022 Å apart);
#: every cage's optimised pore diameter is 5.39702017731003 Å
PERIODIC_ROWS = {
    13.832017514255472: [3.6289651224, 3.6356210328, 3.6370723704, 3.6377874601],
    13.854084266982838: [3.6311549371, 3.6325120475, 3.6401548403, 3.6417727],
}
PERIODIC_PORE = 5.39702017731003
#: the clearance grid: 50^3 probes at 0.496 Å over the 24.8 Å cell
GRID_POINTS = 50
#: (probes, atoms) of the large random clearance input, the regime the
#: JAX kernel's docstring measured
CLEARANCE_LARGE = (65536, 4096)

#: the golden gate of scripts/validate_f32.py:37-97 (values from
#: BASELINE.md: reference tests and example scripts; REYMAL windows from
#: the JAX package's CPU float64 run), every system within 0.01 Å now
#: that the optimisers run as kernels (validate_f32.py:70-77).
GOLD = {
    "PUDXES": {
        "pore": 5.397020177310022,
        "avg": 13.832017514255472,
        "max": 22.179369990077188,
        "windows": [3.62896512, 3.63562103, 3.63707237, 3.63778746],
    },
    "YAQHOQ": {"pore": 3.6101512374999996, "pore_opt": 3.6289753088227567},
    "BATVUP": {
        "pore": 4.836533719851611,
        "windows": [3.3414604104301676, 3.729380286546027],
    },
    "MIBQAR": {
        "pore_opt": 12.277218239447373,
        "windows": [
            7.936596981480963, 7.938328681370597, 7.944268889914964,
            7.944822155795365, 7.95227623300941, 7.963120398998443,
        ],
    },
    "NUXHIZ": {
        "pore": 8.746544980478657,
        "windows": [6.503653849037591, 7.269555216539536, 7.903902924542914],
    },
    "REYMAL": {
        "windows": [
            9.05410173, 9.05947091, 9.16546626,
            9.17248558, 9.17507083, 9.19220592,
        ],
    },
    "SAYGOR": {
        "pore_opt": 9.40496927130876,
        "windows": [
            5.956810992876738, 6.808675682597675,
            7.891850464732435, 8.296593512434261,
        ],
    },
}
TOL = 0.01

KERNELS = {
    "ray_exit": ("pywindow_torch/csrc/ray_exit.cu", "pywindow_tpu/ops/pallas_kernels.py:445"),
    "path_sweep": ("pywindow_torch/csrc/path_sweep.cu", "pywindow_tpu/ops/pallas_kernels.py:170"),
    "dbscan": ("pywindow_torch/csrc/dbscan.cu", "pywindow_tpu/ops/cluster_pallas.py:62"),
    "lbfgsb_stable": ("pywindow_torch/csrc/lbfgsb_stable.cu", "pywindow_tpu/ops/lbfgsb_pallas.py:864"),
    "nm_xy": ("pywindow_torch/csrc/nm_xy.cu", "pywindow_tpu/ops/nm_pallas.py:283"),
    "fine_path": ("pywindow_torch/csrc/fine_path.cu", "pywindow_tpu/ops/pallas_kernels.py:799"),
    "clearance_min": ("pywindow_torch/csrc/clearance_min.cu", "pywindow_tpu/ops/pallas_kernels.py:43"),
    "max_dim": (
        "pywindow_torch/csrc/max_dim.cu",
        "none: pywindow_tpu/ops/geometry.py:169 max_dim and :194 max_dim_value, jnp left to XLA",
    ),
}
#: the kernels of the analysis pipeline (clearance_min has no caller)
PIPELINE_KERNELS = tuple(k for k in KERNELS if k != "clearance_min")

#: the device of the tensors this script makes itself (the entry points
#: default to the card)
DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes
#: per second, and operations per second outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
#: float64 instructions per second: 132 SMs x 64 FP64 lanes x 1.98 GHz
#: (an FMA is one instruction and two of the 34 TFLOP/s)
FP64_INSTR = 132 * 64 * 1.98e9
#: instructions of one float64 square root or divide on the card: a
#: reciprocal estimate refined by a Newton sequence (~10 instructions)
SQRT_DIV_INSTR = 10
#: float32 instructions per second: 132 SMs x 128 FP32 lanes x 1.98 GHz
#: (no FMAs: the kernels are built with -fmad=false)
FP32_INSTR = 132 * 128 * 1.98e9
#: instructions of one correctly rounded float32 square root on the card:
#: a reciprocal square-root estimate and its Newton fix-up (~8)
SQRT_F32_INSTR = 8
#: the ray kernels' operations: ray_exit per (ray, atom) pair, per (tile,
#: atom) cone test and per ray of cone set-up; path_sweep and fine_path
#: per (ray, atom) segment bound and per (probe, atom) clearance
RAY_PAIR_OPS = 21
CONE_ATOM_OPS = 35
CONE_RAY_OPS = 30
SEGMENT_ATOM_OPS = 30
PROBE_OPS = 11
#: dbscan's operations per pair test: three differences, three squares,
#: two sums and the square root (the compare not counted); per tile-pair
#: box test: two differences and two maxima an axis, three squares, two
#: sums and the square root
DBSCAN_PAIR_OPS = 9
DBSCAN_BOX_OPS = 18
#: clearance_min's operations per box test: per axis two differences, a
#: compare and a select, then three squares, two sums and the compare
#: with the skip threshold (the seed search's tests counted alike)
CLEARANCE_BOX_OPS = 18
#: max_dim's operations per unordered valid pair: three differences, three
#: squares, two sums, the square root, the two vdW sums and the compare;
#: the value form two sums and a compare more (both orders of the pair)
MAX_DIM_PAIR_OPS = 12
MAX_DIM_VALUE_PAIR_OPS = 15


def structure(name: str) -> pathlib.Path:
    path = DATA / f"{name}.xyz"
    return path if path.exists() else DATA / f"{name}.pdb"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def molecule(name: str):
    import pywindow_torch as pt

    return pt.MolecularSystem.load_file(structure(name)).system_to_molecule()


def nvidia_smi() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card() -> str:
    named = os.environ.get("PYWINDOW_TORCH_DEVICE")
    if named is not None and re.fullmatch(r"cuda(:\d+)?", named) is None:
        raise SystemExit(f"chip_smoke: PYWINDOW_TORCH_DEVICE={named!r} does not name the card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
    )
    check(
        not torch.backends.cuda.matmul.allow_tf32,
        "float32 matmuls must not run in TF32",
    )
    return smi


def phase_build() -> None:
    from pywindow_torch import native
    from pywindow_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load_extension()
    t1 = time.perf_counter()
    native.lib()
    t2 = time.perf_counter()
    print(
        f"build: {len(_cuda.SOURCES) - 1} CUDA kernels {t1 - t0:.2f} s (one ninja build "
        f"into {_cuda.BUILD_DIR}); native host library {t2 - t1:.2f} s (into {native.BUILD_DIR})"
    )


# -- phase 3: every kernel against its plain version --------------------------


def wrappers():
    """(module, wrapper attribute, kernel name, plain version) of every
    kernel the main path launches."""
    from pywindow_torch.ops import (
        clearance_kernels,
        cluster,
        cluster_kernels,
        lbfgsb_kernels,
        nm_kernels,
        pair_kernels,
        ray_kernels,
    )

    def dbscan_plain(points, valid, eps, min_samples, max_clusters):
        return cluster.dbscan(points, valid, eps, min_samples, max_clusters)[0]

    def ray_exit_plain(unit, rel, vdw, origin, want_exit, order):
        # the order only groups the kernel's rays
        return ray_kernels.ray_exit_plain(unit, rel, vdw, origin, want_exit)

    return [
        (ray_kernels, "ray_exit_cuda", "ray_exit", ray_exit_plain),
        (ray_kernels, "path_sweep_cuda", "path_sweep", ray_kernels.path_sweep_plain),
        (cluster_kernels, "dbscan_labels_cuda", "dbscan", dbscan_plain),
        (lbfgsb_kernels, "lbfgsb_stable_flat_cuda", "lbfgsb_stable",
         lbfgsb_kernels.lbfgsb_stable_flat_plain),
        (nm_kernels, "nm_xy_flat_cuda", "nm_xy", nm_kernels.nm_xy_flat_plain),
        (ray_kernels, "fine_path_cuda", "fine_path", ray_kernels.fine_path_plain),
        (clearance_kernels, "clearance_min_cuda", "clearance_min",
         clearance_kernels.clearance_min_plain),
        (pair_kernels, "max_dim_cuda", "max_dim", pair_kernels.max_dim_flat_plain),
    ]


def record_inputs() -> dict[str, list[tuple[str, tuple, dict]]]:
    """Run the main paths once (warm-up only) and keep a copy of every
    input each kernel wrapper received: single PUDXES and REYMAL runs,
    the sweep's first 1,440-frame chunk (the 20 distinct fixture frames
    cycled, so neighbouring lanes hold different frames) and the
    periodic trajectory's first chunk (48 frames, 384 cages); then the
    three input sets of ``clearance_min``."""
    import pywindow_torch as pt

    seen: dict[str, list] = {k: [] for k in KERNELS}
    current = [""]
    with recording(seen, current):
        for name in ("PUDXES", "REYMAL"):
            current[0] = name
            molecule(name).full_analysis()
        current[0] = SWEEP_LABEL
        pt.DLPOLY(synth_history(SWEEP_FRAMES)).analysis_batched(
            frames=list(range(SWEEP_CHUNK)), swap_atoms={"he": "H"}, forcefield="OPLS",
            batch_size=SWEEP_CHUNK,
        )
        current[0] = PERIODIC_LABEL
        pt.PDB(synth_periodic(PERIODIC_FRAMES)).analysis_batched(
            frames=list(range(PERIODIC_CHUNK)), batch_size=PERIODIC_CHUNK, modular=True,
            rebuild=True, forcefield="DLF",
        )
    seen["clearance_min"] = clearance_inputs() + clearance_adversarial()
    return seen


@contextlib.contextmanager
def recording(seen: dict[str, list], current: list[str]):
    """Inside the block every kernel wrapper keeps a copy of its inputs:
    ``(current[0], args, kwargs)`` appended to ``seen[kernel]`` for each
    call, before the call runs."""
    originals = []

    def recorder(fn, key):
        def run(*args, **kwargs):
            copy = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            seen[key].append((current[0], copy, dict(kwargs)))
            return fn(*args, **kwargs)

        return run

    try:
        for module, attr, key, _ in wrappers():
            originals.append((module, attr, getattr(module, attr)))
            setattr(module, attr, recorder(getattr(module, attr), key))
        yield
    finally:
        for module, attr, fn in originals:
            setattr(module, attr, fn)


def clearance_inputs() -> list[tuple[str, tuple, dict]]:
    """The input sets of ``clearance_min`` (float64; the comparison casts
    them): the shapes and seeds of tests/test_pallas.py:17-56 with the
    padding case, Q = 65,536 probes against N = 4,096 atoms (the regime
    of the JAX kernel's docstring), and the periodic clearance grid."""

    def f(*arrays):
        return tuple(torch.tensor(a, dtype=torch.float64, device=DEVICE) for a in arrays)

    calls = []
    for q, n in ((100, 50), (1024, 256), (513, 129)):
        rng = np.random.default_rng(q + n)
        probes = rng.normal(size=(q, 3)) * 10
        calls.append((f"pallas-test {q}x{n}", f(probes, rng.normal(size=(n, 3)) * 12, rng.uniform(1.0, 2.0, n)), {}))
    rng = np.random.default_rng(3)
    coords = np.concatenate([rng.normal(size=(40, 3)) * 5, np.full((24, 3), 1.0e6)])
    vdw = np.concatenate([rng.uniform(1, 2, 40), np.zeros(24)])
    calls.append(("pallas-test padding", f(rng.normal(size=(64, 3)) * 5, coords, vdw), {}))
    q, n = CLEARANCE_LARGE
    rng = np.random.default_rng(q)
    calls.append((
        f"Q{q}xN{n}",
        f(rng.uniform(-20, 20, (q, 3)), rng.normal(size=(n, 3)) * 12, rng.uniform(1.0, 2.0, n)),
        {},
    ))
    calls.append(("periodic grid", periodic_grid(torch.float64), {}))
    return calls


def clearance_adversarial() -> list[tuple[str, tuple, dict]]:
    """The adversarial sets of ``clearance_min`` (:func:`clearance_cases`)
    built in float64, then the skip bound's cases built in float32 (held
    in float64 exactly, so the float32 comparison sees the float32
    bound)."""
    calls = [(f"adversarial {label}", args, {}) for label, args in clearance_cases(torch.float64, DEVICE)]
    calls += [
        (f"adversarial {label} (float32 bound)", _as(args, torch.float64), {})
        for label, args in clearance_cases(torch.float32, DEVICE, large=False)
        if label.startswith("bound")
    ]
    return calls


def periodic_grid(dtype, points: int = GRID_POINTS, device=None) -> tuple:
    """(probes, coords, vdw) of the clearance grid: ``points``^3 probes at
    the voxel centres of the 24.8 Å cell against the rebuilt cell's
    atoms."""
    import pywindow_torch as pt
    from pywindow_torch import tables

    system = pt.MolecularSystem.load_file(PERIODIC)
    rebuilt = system.rebuild_system().system
    a = float(system.system["unit_cell"][0])
    axis = (np.arange(points) + 0.5) * (a / points)
    probes = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    vdw = tables.ELEMENT_VDW[tables.element_ids(rebuilt["elements"])]
    return tuple(
        torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device or DEVICE)
        for x in (probes, rebuilt["coordinates"], vdw)
    )


#: the adversarial sets of clearance_min at the skip bound: offsets of the
#: far tile's squared gap from the threshold T, in units in the last place
#: of T, and offsets of its atoms' clearance from the best, in units of
#: the best + vdW sum
BOUND_GAP_ULPS = (-3, -2, -1, 0, 1, 2, 3)
BOUND_CLEARANCE_ULPS = (-2, -1, 0, 1, 2)


def clearance_bound_case(dtype, device, ulps: int, at_threshold: bool = True) -> tuple:
    """(probes, coords, vdw) in ``dtype`` with one probe at the origin, a
    tile of 32 atoms at (0, 0, 1) with vdW 0.25 (clearance 0.75, exact,
    the group's seed) and a tile of 32 atoms at (L, 0, 0) with vdW 1.5:
    with ``at_threshold`` L^2 lands ``ulps`` places from the kernel's skip
    threshold T(0.75, 1.5) (the nearest square to that target), else L is
    ``ulps`` places from 2.25, so that the far atoms' clearance sits just
    below, on or above 0.75."""
    from pywindow_torch.ops.clearance_kernels import skip_threshold

    np_t = np.float32 if dtype == torch.float32 else np.float64
    best, r_far = np_t(0.75), np_t(1.5)
    if at_threshold:
        thr = skip_threshold(torch.tensor(best), torch.tensor(r_far)).numpy().astype(np_t)
        target = thr
        for _ in range(abs(ulps)):
            target = np.nextafter(target, np_t(np.inf if ulps > 0 else -np.inf))
        around = [np_t(np.sqrt(np.float64(target)))]
        for _ in range(4):
            around = [np.nextafter(around[0], np_t(-np.inf))] + around + [np.nextafter(around[-1], np_t(np.inf))]
        length = min(around, key=lambda x: abs(np.float64(x * x) - np.float64(target)))
    else:
        length = np_t(2.25)
        for _ in range(abs(ulps)):
            length = np.nextafter(length, np_t(np.inf if ulps > 0 else -np.inf))
    coords = np.zeros((64, 3), dtype=np_t)
    coords[:32, 2] = 1.0
    coords[32:, 0] = length
    vdw = np.concatenate([np.full(32, 0.25), np.full(32, 1.5)]).astype(np_t)
    return tuple(
        torch.tensor(a, dtype=dtype, device=device)
        for a in (np.zeros((1, 3), dtype=np_t), coords, vdw)
    )


def clearance_cases(dtype, device, large: bool = True) -> list[tuple[str, tuple]]:
    """The adversarial input sets of ``clearance_min`` in ``dtype``:
    probes on atom centres, probes 1e3 Å outside the molecule, a NaN
    probe, a NaN atom coordinate, a NaN radius, N = 1, Q = 1, every atom
    padded but one, Q = 1,000 (not a multiple of a warp) and the skip
    bound's cases (:func:`clearance_bound_case`); with ``large`` also N =
    20,000 atoms (CPU tests leave it out: the plain version holds Q x N x
    3 differences)."""
    rng = np.random.default_rng(7)

    def f(*arrays):
        return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrays)

    coords = rng.normal(size=(300, 3)) * 6
    vdw = rng.uniform(1.0, 2.0, 300)
    probes = rng.normal(size=(100, 3)) * 6
    nan_probe, nan_atom, nan_radius = probes.copy(), coords.copy(), vdw.copy()
    nan_probe[37, 1] = np.nan
    nan_atom[123, 2] = np.nan
    nan_radius[45] = np.nan
    padded = np.full((512, 3), 1.0e6)
    padded[200] = coords[0]
    padded_vdw = np.zeros(512)
    padded_vdw[200] = vdw[0]
    cases = [
        ("atom centres", f(coords[::3], coords, vdw)),
        ("1e3 A outside", f(rng.normal(size=(200, 3)) + [1.0e3, 0.0, 0.0], coords, vdw)),
        ("NaN probe", f(nan_probe, coords, vdw)),
        ("NaN atom", f(probes, nan_atom, vdw)),
        ("NaN radius", f(probes, coords, nan_radius)),
        ("N=1", f(probes, coords[:1], vdw[:1])),
        ("Q=1", f(probes[:1], coords, vdw)),
        ("padded but one", f(probes, padded, padded_vdw)),
        ("Q=1000", f(rng.uniform(-15.0, 15.0, (1000, 3)), coords, vdw)),
    ]
    cases += [
        (f"bound gap {k:+d}", clearance_bound_case(dtype, device, k)) for k in BOUND_GAP_ULPS
    ]
    cases += [
        (f"bound clearance {k:+d}", clearance_bound_case(dtype, device, k, at_threshold=False))
        for k in BOUND_CLEARANCE_ULPS
    ]
    if large:
        cases.append((
            "N=20000",
            f(rng.uniform(-30.0, 30.0, (2048, 3)), rng.normal(size=(20000, 3)) * 15,
              rng.uniform(1.0, 2.0, 20000)),
        ))
    return cases


def max_dim_cases(dtype, device) -> list[tuple[str, tuple]]:
    """The adversarial frames of ``max_dim`` in ``dtype``, each case
    (coords, vdw, mask) of one or more frames: equal maxima in two tiles
    of 128, the first row-major one in the later tile, and in one tile; a
    pair whose two orders round apart, the larger sum the lower
    triangle's; every atom masked; valid sums below -1e30 (the first
    -1e30 entry wins: (1, 0), or a masked atom of row 0); a NaN coordinate
    of a valid atom and of a masked one; N = 1; N = 301, padded atoms
    parked at 1e6."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(424)

    def f(coords, vdw, mask):
        return (
            torch.tensor(np.asarray(coords, dtype=np_t), device=device),
            torch.tensor(np.asarray(vdw, dtype=np_t), device=device),
            torch.tensor(np.asarray(mask, dtype=bool), device=device),
        )

    # ties: (100, 290) in tile (0, 2) and (101, 150) in tile (0, 1), then
    # (3, 7) and (5, 6) in one tile; each pair 20 Å apart with vdW 1.5,
    # every other atom within 4 Å of the origin
    ties = rng.uniform(-2.3, 2.3, (2, 300, 3))
    vdw = rng.uniform(1.2, 1.6, (2, 300))
    for frame, pairs in enumerate((((100, 290), (101, 150)), ((3, 7), (5, 6)))):
        for axis, (i, j) in enumerate(pairs):
            ties[frame, i], ties[frame, j] = 0.0, 0.0
            ties[frame, i, axis], ties[frame, j, axis] = -10.0, 10.0
            vdw[frame, [i, j]] = 1.5
    # two orders: atoms 5 and 200 of 256, x apart with vdW a and b, where
    # (x + b) + a > (x + a) + b; the others within 1 Å of their midpoint
    x = np_t(10.3)
    a, b = (np_t(v) for v in rng.uniform(1.0, 2.0, 2))
    while (x + a) + b == (x + b) + a:
        a, b = (np_t(v) for v in rng.uniform(1.0, 2.0, 2))
    if (x + a) + b > (x + b) + a:
        a, b = b, a
    orders = rng.uniform(-0.55, 0.55, (256, 3)) + [x / 2, 0.0, 0.0]
    orders_vdw = rng.uniform(1.0, 2.0, 256)
    orders[5], orders[200] = 0.0, [x, 0.0, 0.0]
    orders_vdw[5], orders_vdw[200] = a, b
    small = rng.normal(size=(2, 8, 3)) * 3
    low_mask = np.ones((2, 8), dtype=bool)
    low_mask[1, 6:] = False
    nan = rng.normal(size=(2, 40, 3)) * 6
    nan_mask = np.ones((2, 40), dtype=bool)
    nan[0, 3, 1] = np.nan
    nan[1, 39, 0], nan_mask[1, 39] = np.nan, False
    padded = np.full((2, 301, 3), 1.0e6)
    padded[:, :290] = rng.normal(size=(2, 290, 3)) * 6
    padded_vdw = np.zeros((2, 301))
    padded_vdw[:, :290] = rng.uniform(1.2, 2.0, (2, 290))
    return [
        ("ties", f(ties, vdw, np.ones((2, 300)))),
        ("two orders", f(orders[None], orders_vdw[None], np.ones((1, 256)))),
        ("all masked", f(rng.normal(size=(2, 24, 3)), np.ones((2, 24)), np.zeros((2, 24)))),
        ("below -1e30", f(small, np.full((2, 8), -6.0e29), low_mask)),
        ("NaN coordinate", f(nan, np.full((2, 40), 1.5), nan_mask)),
        ("N=1", f(rng.normal(size=(3, 1, 3)), [[1.5], [1.7], [0.0]], [[True], [True], [False]])),
        ("N=301 padded", f(padded, padded_vdw, np.broadcast_to(np.arange(301) < 290, (2, 301)))),
    ]


def time_ms(fn) -> float:
    """Warm median of one call, CUDA events; 3 to 25 repetitions."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = int(min(25, max(3, 0.5 / max(once, 1e-6))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


#: calls captured in one CUDA graph for a device time
GRAPH_CALLS = 20


def device_ms(fn) -> float:
    """ms a call of ``fn`` keeps the card busy: GRAPH_CALLS calls captured
    in one CUDA graph, the median of 5 warm replays over the calls (the
    kernels back to back, no host in between).  A wrapper that syncs with
    the host cannot be captured and raises here."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return sorted(times)[2]


#: per kernel: the argument whose leading axis is the lane (frame) axis,
#: and how many lanes one plain call takes (the plain versions hold
#: (lanes, rays, steps or atoms, ...) tensors, too large for a whole
#: sweep chunk at once; lanes are independent, so slices are exact)
PLAIN_LANES = {
    "ray_exit": (1, 128), "path_sweep": (2, 128), "fine_path": (2, 128),
    "dbscan": (0, 128), "lbfgsb_stable": (0, 1 << 20), "nm_xy": (0, 1024),
    "clearance_min": (0, 8192), "max_dim": (0, 1 << 20),
}


def plain_call(key, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, run on slices of the lane axis when a
    call holds more lanes than :data:`PLAIN_LANES` allows."""
    arg, lanes = PLAIN_LANES[key]
    b = args[arg].shape[0]
    if b <= lanes:
        return fn(*args, **kwargs)
    def cut(a, lo):
        return a[lo : lo + lanes] if torch.is_tensor(a) and a.ndim and a.shape[0] == b else a

    parts = []
    for lo in range(0, b, lanes):
        part = tuple(cut(a, lo) for a in args)
        parts.append(fn(*part, **{k: cut(v, lo) for k, v in kwargs.items()}))
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _as(args, dtype):
    return tuple(
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in args
    )


def compare_ray_exit(label, args, kwargs, dtype):
    from pywindow_torch.ops import ray_kernels

    unit, rel, vdw, origin, want_exit, order = _as(args, dtype)
    # the recorded directions are float32 unit vectors; in float64 they
    # are normalised again, since the kernel's expanded |p1|^2 takes
    # |u| = 1 (a float32 |u| is 1 only to ~1e-7)
    unit = unit / torch.sqrt((unit * unit).sum(-1, keepdim=True))
    hk, ek = ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, want_exit, order)
    hp, ep = plain_call("ray_exit", ray_kernels.ray_exit_plain, unit, rel, vdw, origin, want_exit)
    torch.cuda.synchronize()
    flips = hk != hp
    if dtype == torch.float64:
        check(not bool(flips.any()), "ray_exit f64: hit flags differ")
        err = float((ek - ep).abs().max())
        check(err <= 1e-9, f"ray_exit f64: exits differ by {err}")
        return err
    # float32: the kernel's front test is the algebraic form of the plain
    # version's, so rays within rounding of tangency may flip
    n_flip = int(flips.sum())
    print(
        f"  ray_exit {label} {tuple(unit.shape)} want_exit={want_exit} float32: "
        f"{n_flip} of {hk.numel()} rays flip against the plain version"
    )
    check(n_flip <= 0.005 * hk.numel(), f"ray_exit f32: {n_flip} of {hk.numel()} rays flip")
    if n_flip:
        u64, r64, v64, _, _, _ = _as(args, torch.float64)
        t_ca = (u64[..., :, None, :] * r64[..., None, :, :]).sum(-1)
        perp = r64[..., None, :, :] - t_ca[..., None] * u64[..., :, None, :]
        under = v64[..., None, :] ** 2 - (perp * perp).sum(-1)
        margin = under.abs().amin(-1)[flips]
        check(bool((margin <= 1e-4).all()), "ray_exit f32: a flipped ray is not tangent")
    both = hk & hp & torch.isfinite(ek)
    err = float((ek - ep)[both].abs().max()) if want_exit and bool(both.any()) else 0.0
    check(err <= 1e-4, f"ray_exit f32: exits differ by {err}")
    return err


def _compare_sweep(name, kernel, plain, args, dtype):
    """ok, pos and cmin equal to the bit: each kernel's cull keeps every
    atom that decides an output, and the kept atoms' clearances round
    like the plain version's (``fine_path``'s inactive slots hold the same
    placeholders on both sides)."""
    vectors, chunks, coords, vdw, max_steps, *active = _as(args, dtype)
    ok_k, pos_k, c_k = kernel(vectors, chunks, coords, vdw, max_steps, *active)
    ok_p, pos_p, c_p = plain_call(name, plain, vectors, chunks, coords, vdw, max_steps, *active)
    torch.cuda.synchronize()
    check(torch.equal(ok_k, ok_p), f"{name} {dtype}: ok differs")
    check(torch.equal(pos_k, pos_p), f"{name} {dtype}: argmin step differs")
    err = float((c_k - c_p).abs().max())
    check(torch.equal(c_k, c_p), f"{name} {dtype}: cmin differs by {err}")
    return err


def compare_path_sweep(label, args, kwargs, dtype):
    from pywindow_torch.ops import ray_kernels

    return _compare_sweep(
        "path_sweep", ray_kernels.path_sweep_cuda, ray_kernels.path_sweep_plain, args, dtype
    )


def compare_fine_path(label, args, kwargs, dtype):
    from pywindow_torch.ops import ray_kernels

    return _compare_sweep(
        "fine_path", ray_kernels.fine_path_cuda, ray_kernels.fine_path_plain, args, dtype
    )


def compare_dbscan(label, args, kwargs, dtype):
    from pywindow_torch.ops import cluster, cluster_kernels

    points, valid, eps, min_samples, max_clusters = _as(args, dtype)
    labels_k = cluster_kernels.dbscan_labels_cuda(points, valid, eps, min_samples, max_clusters)
    labels_p, _ = plain_call("dbscan", cluster.dbscan, points, valid, eps, min_samples, max_clusters)
    torch.cuda.synchronize()
    check(torch.equal(labels_k, labels_p), f"dbscan {dtype}: labels differ")
    return 0.0


def _compare_lanes(name, x_k, f_k, cap_k, x_p, f_p, cap_p):
    """x within 1e-6 Å and equal capped flags on every lane; a lane
    outside 1e-6 passes only on a tie of the objective to 1e-9.  Returns
    the largest difference of x or f over all lanes (inactive lanes
    included: both sides write the same placeholders)."""
    check(torch.equal(cap_k, cap_p), f"{name}: capped flags differ")
    dx = (x_k - x_p).abs().amax(-1)
    off = dx > 1e-6
    for i in torch.nonzero(off).flatten().tolist():
        df = float((f_k[i] - f_p[i]).abs())
        print(f"  {name} lane {i}: |dx| {float(dx[i]):.3e} A, |df| {df:.3e} (objective tie)")
        check(df <= 1e-9, f"{name} lane {i}: x differs by {float(dx[i])} and f by {df}")
    return max(float(dx.max()), float((f_k - f_p).abs().max())) if dx.numel() else 0.0


def compare_lbfgsb(label, args, kwargs, dtype):
    from pywindow_torch.ops import lbfgsb_kernels

    x_k, f_k, _, _, cap_k = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kwargs)
    x_p, f_p, _, _, cap_p = plain_call(
        "lbfgsb_stable", lbfgsb_kernels.lbfgsb_stable_flat_plain, *args, **kwargs
    )
    torch.cuda.synchronize()
    return _compare_lanes("lbfgsb_stable", x_k, f_k, cap_k, x_p, f_p, cap_p)


def compare_nm(label, args, kwargs, dtype):
    from pywindow_torch.ops import nm_kernels

    xy_k, f_k, cap_k = nm_kernels.nm_xy_flat_cuda(*args, **kwargs)
    xy_p, f_p, cap_p = plain_call("nm_xy", nm_kernels.nm_xy_flat_plain, *args, **kwargs)
    torch.cuda.synchronize()
    return _compare_lanes("nm_xy", xy_k, f_k, cap_k, xy_p, f_p, cap_p)


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal``, with a NaN equal to a NaN in the same place
    (``torch.equal`` counts NaN unequal to itself)."""
    return (
        a.shape == b.shape and a.dtype == b.dtype
        and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    )


def compare_clearance(label, args, kwargs, dtype):
    """Equal to the plain version, to the bit (NaN where it is NaN): the
    same difference-form distances rounded op by op, and an exact minimum
    over the pairs the exact cull keeps.  Returns the largest difference
    over the values that are not NaN (0)."""
    from pywindow_torch.ops import clearance_kernels

    probes, coords, vdw = _as(args, dtype)
    got = clearance_kernels.clearance_min_cuda(probes, coords, vdw)
    ref = plain_call("clearance_min", clearance_kernels.clearance_min_plain, probes, coords, vdw)
    torch.cuda.synchronize()
    both = ~(torch.isnan(got) | torch.isnan(ref))
    err = float((got - ref)[both].abs().max()) if bool(both.any()) else 0.0
    check(same_values(got, ref), f"clearance_min {label} {dtype}: differs by {err}")
    return err


def compare_max_dim(label, args, kwargs, dtype):
    """Equal to the plain version, to the bit (NaN where it is NaN), the
    atoms too: the same arithmetic op by op and torch's argmax order.
    Returns the largest difference over the values that are not NaN (0)."""
    from pywindow_torch.ops import pair_kernels

    coords, vdw, mask, atoms = _as(args, dtype)
    got = pair_kernels.max_dim_cuda(coords, vdw, mask, atoms)
    ref = plain_call("max_dim", pair_kernels.max_dim_flat_plain, coords, vdw, mask, atoms)
    torch.cuda.synchronize()
    both = ~(torch.isnan(got[0]) | torch.isnan(ref[0]))
    err = float((got[0] - ref[0])[both].abs().max()) if bool(both.any()) else 0.0
    form = "atoms" if atoms else "value"
    for name, g, r in zip(("value", "atom_1", "atom_2"), got, ref):
        check(same_values(g, r), f"max_dim {form} {label} {dtype}: {name} differs (value by {err})")
    return err


def cdist_amin(probes, coords, vdw):
    """The two-call library yardstick of clearance_min (the port never
    calls it)."""
    return (torch.cdist(probes, coords) - vdw).amin(1)


COMPARE = {
    "ray_exit": (compare_ray_exit, (torch.float64, torch.float32)),
    "path_sweep": (compare_path_sweep, (torch.float64, torch.float32)),
    "dbscan": (compare_dbscan, (torch.float64, torch.float32)),
    "lbfgsb_stable": (compare_lbfgsb, (torch.float64,)),
    "nm_xy": (compare_nm, (torch.float64,)),
    "fine_path": (compare_fine_path, (torch.float64, torch.float32)),
    "clearance_min": (compare_clearance, (torch.float64, torch.float32)),
    "max_dim": (compare_max_dim, (torch.float64, torch.float32)),
}


def bound(key, args, kwargs, out, every_lane=False, ops=None) -> tuple[float, str]:
    """The least time the card could take for one call: the larger of the
    bytes the function must move (inputs read once, outputs written once)
    over the HBM rate and the operations these inputs need over the peak
    rate of their type.  Operation counts per (ray, atom), (ray, step,
    atom), (point, point) or (evaluation, atom), a sqrt or a divide
    counted as one operation; for the optimisers the evaluations are a
    lower bound from each lane's iteration count (one line-search
    evaluation per iteration) or from the grid size.  An optimiser's
    inactive lanes read their flag and write their outputs, nothing
    else, and ``nm_xy``'s grid counts the atoms its exact cull keeps;
    the three ray walks count their cull pass and the atoms it keeps
    (:func:`ray_work`; ``fine_path`` reads only its active slots and the
    frames that hold one); ``dbscan`` reads the valid points'
    coordinates and counts a box test for each pair of 32-point tiles
    and the unordered pairs, self included, of the tile pairs its exact
    rule does not skip (:func:`dbscan_work`: the kernel tests each pair
    once); ``clearance_min`` counts a box test for every probe and tile
    and the pairs of the tiles each probe needs (:func:`clearance_work`).  ``every_lane`` counts every lane and
    atom (every pair of the ray kernels, every (slot, step, atom) of
    ``fine_path``, all K^2 ordered pairs of ``dbscan``) instead, the count
    that rows measured before the flags and the culls existed used.
    ``ops`` replaces the operation count (the same bytes)."""
    t = [a for a in args if torch.is_tensor(a)]
    dtype = t[0].dtype
    active = None if every_lane else kwargs.get("active")
    b = t[0].shape[0]
    share = 1.0 if active is None else int(active.sum()) / b
    in_bytes = sum(
        a.numel() * a.element_size() * (share if a.ndim and a.shape[0] == b else 1.0) for a in t
    )
    if active is not None:
        in_bytes += active.numel() * active.element_size()
    outs = [o for o in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(o)]
    out_bytes = sum(o.numel() * o.element_size() for o in outs)
    if key == "fine_path" and not every_lane:
        vectors, chunks, coords, vdw = args[:4]
        live = fine_live(args)
        frames = live.any(-1)
        in_bytes = (
            int(live.sum()) * (3 * vectors.element_size() + chunks.element_size())
            + int(frames.sum()) * (coords[0].numel() + vdw[0].numel()) * coords.element_size()
            + (args[5].numel() if len(args) > 5 and args[5] is not None else 0)
        )
    if key == "dbscan" and not every_lane:
        points, valid = args[:2]
        in_bytes += (int(valid.sum()) - valid.numel()) * 3 * points.element_size()
    if ops is None:
        ops = operations(key, args, kwargs, out, every_lane)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def operations(key, args, kwargs, out, every_lane) -> int:
    """The operations of one call that :func:`bound` counts."""
    if key in ("ray_exit", "path_sweep", "fine_path"):
        return ray_work(key, args, every_lane)[0]
    if key == "dbscan":
        b, k, _ = args[0].shape
        boxes, pairs = (0, b * k * k) if every_lane else dbscan_work(args)
        return DBSCAN_BOX_OPS * boxes + DBSCAN_PAIR_OPS * pairs
    if key in ("lbfgsb_stable", "nm_xy"):
        return optimiser_work(key, args, kwargs, out, every_lane)[0]
    if key == "max_dim":
        # the valid atoms' unordered pairs, self included, of each frame
        valid = args[2].sum(1).to(torch.int64)
        pairs = int((valid * (valid + 1) // 2).sum())
        return (MAX_DIM_PAIR_OPS if args[3] else MAX_DIM_VALUE_PAIR_OPS) * pairs
    if key == "clearance_min":
        if every_lane:
            return PROBE_OPS * args[0].shape[0] * args[1].shape[0]
        work = clearance_work(args)
        return CLEARANCE_BOX_OPS * work["boxes"] + PROBE_OPS * work["need_pairs"]
    raise KeyError(key)


def clearance_sort_bytes(args) -> int:
    """Bytes the sort passes of ``clearance_min`` move beyond the inputs
    and the output: the keys, the sorted probes (x, y, z) and atoms (x,
    y, z, vdW), the order and the tiles, each written once and read
    once, and the counters written, read and offset."""
    from pywindow_torch.ops import clearance_kernels as ck

    q, n = args[0].shape[0], args[1].shape[0]
    size = args[0].element_size()
    tiles = -(-n // ck.TILE)
    return 2 * (4 * (q + n) + size * (3 * q + 4 * n) + 4 * (q + n) + 8 * size * tiles) + 3 * 4 * ck.WORK_INTS


def clearance_work(args) -> dict[str, int]:
    """``clearance_min``'s work on one call: a kernel launch's own orders
    (``ClearanceWork.order``) through the mirror
    ``clearance_kernels.clearance_keep``: groups of 32 probes, tiles of 32
    atoms, box tests (every live probe against every tile but its seed,
    and each group's seed search); the (probe, atom) pairs of the tiles
    each probe needs (``need_pairs``: the tile of its minimum and those
    its exact test keeps with that minimum as its best, whatever the
    order: what the function needs, the bound's count); those of the
    tiles its own test keeps with its running minimum in the kernel's
    order (``lane_pairs``); and the (group, tile) pairs its warp visits
    and the (probe, atom) pairs they hold (``tile_pairs``, ``pairs``:
    the design's work, every lane computing every tile that any lane of
    its warp keeps)."""
    from pywindow_torch.ops import clearance_kernels as ck

    probes, coords, vdw = args
    q, n = probes.shape[0], coords.shape[0]
    _, work = ck.clearance_min_launch(probes, coords, vdw)
    orders = work.order.long()
    cull = ck.clearance_keep(probes, coords, vdw, probe_order=orders[:q], atom_order=orders[q:])
    g, nt = cull.kept.shape
    lanes = torch.full((g,), ck.GROUP, dtype=torch.int64, device=probes.device)
    lanes[-1] = q - ck.GROUP * (g - 1)
    atoms = torch.full((nt,), ck.TILE, dtype=torch.int64, device=probes.device)
    atoms[-1] = n - ck.TILE * (nt - 1)
    return {
        "groups": g, "tiles": nt, "boxes": q * (nt - 1) + g * nt,
        "tile_pairs": int(cull.kept.sum()),
        "pairs": int((cull.kept.to(torch.int64) * lanes[:, None] * atoms[None, :]).sum()),
        "lane_pairs": int((cull.lane_kept.to(torch.int64) * atoms).sum()),
        "need_tiles": int(cull.needed.sum()),
        "need_pairs": int((cull.needed.to(torch.int64) * atoms).sum()),
    }


def dbscan_pairs(args) -> torch.Tensor:
    """(B,) the unordered pairs of each frame's valid points, self
    included: n (n + 1) / 2 for n valid points."""
    n = args[1].to(torch.int64).sum(-1)
    return n * (n + 1) // 2


def dbscan_work(args) -> tuple[int, int]:
    """(box tests, pair tests) that ``dbscan``'s exact rule needs on a
    call: per frame, one box test for each pair of 32-point tiles of the
    compacted valid points (r <= c), and the unordered pairs, self
    included, of the tile pairs that ``cluster_kernels.dbscan_far_tiles``
    does not skip."""
    from pywindow_torch.ops import cluster_kernels

    points, valid, eps = (a.cpu() for a in args[:3])
    boxes = pairs = 0
    for f in range(points.shape[0]):
        pts = points[f][valid[f]]
        n = pts.shape[0]
        if n == 0:
            continue
        tiles = -(-n // 32)
        size = torch.full((tiles,), 32, dtype=torch.int64)
        size[-1] = n - 32 * (tiles - 1)
        near = ~cluster_kernels.dbscan_far_tiles(pts, eps[f])
        boxes += tiles * (tiles + 1) // 2
        pairs += int(((size[:, None] * size[None, :]) * near).triu(1).sum())
        pairs += int((size * (size + 1) // 2).sum())
    return boxes, pairs


def fine_live(args) -> torch.Tensor:
    """(B, W) bool: the slots ``fine_path`` walks (``active``, or all)."""
    active = args[5] if len(args) > 5 else None
    return torch.ones(args[1].shape, dtype=torch.bool, device=args[1].device) if active is None else active


def cull_kept(key, args) -> torch.Tensor:
    """The atoms the ray kernels' exact culls keep: (B, tiles) for
    ``ray_exit`` (``ray_kernels.ray_exit_keep``), (B, P) for
    ``path_sweep`` and (B, W) for ``fine_path`` (``path_sweep_keep``,
    the rule both walks share), in slices of 128 frames."""
    from pywindow_torch.ops import ray_kernels

    b = args[0].shape[0]
    kept = []
    for lo in range(0, b, 128):
        part = tuple(
            a[lo : lo + 128] if torch.is_tensor(a) and a.ndim and a.shape[0] == b else a
            for a in args
        )
        if key == "ray_exit":
            unit, rel, vdw, _, _, order = part
            kept.append(ray_kernels.ray_exit_keep(unit, rel, vdw, order).sum(-1))
        else:
            kept.append(ray_kernels.path_sweep_keep(*part[:5]).sum(-1))
    return torch.cat(kept)


def ray_work(key, args, every_lane=False) -> tuple[int, int]:
    """(operations, square roots) of a ray kernel's call: ``ray_exit``
    the cone test of every (tile, atom), the cone set-up of every ray and
    the kept (ray, atom) pairs (the ~5 exits a ray take a square root
    more, not counted); ``path_sweep`` the origin clearance of every
    frame that has a zero ray (``ray_kernels.path_sweep_origin_rays``:
    the kernel answers those rays from it, with no cull and no walk), and
    for every other ray the segment bound of each atom and the kept atoms
    at every valid probe; ``fine_path`` the same over its active slots,
    with no origin rays.  ``every_lane``: every (ray, atom) pair or
    (probe, atom) clearance, with no cull and every slot."""
    if key == "ray_exit":
        unit, rel = args[0], args[1]
        b, p, _ = unit.shape
        n = rel.shape[1]
        if every_lane:
            return RAY_PAIR_OPS * b * p * n, 0
        kept = cull_kept(key, args).to(torch.int64)  # (B, tiles)
        tiles = kept.shape[1]
        rays = torch.full((tiles,), 32, dtype=torch.int64, device=kept.device)
        rays[-1] = p - 32 * (tiles - 1)
        pairs = int((kept * rays).sum())
        ops = CONE_ATOM_OPS * b * tiles * n + CONE_RAY_OPS * b * p + RAY_PAIR_OPS * pairs
        return ops, b * tiles * n + 2 * b * p
    vectors, chunks, coords, _, max_steps = args[:5]
    n = coords.shape[1]
    steps = torch.clamp_max(chunks.to(torch.int64) + 1, int(max_steps))
    if every_lane:
        probes = int(steps.sum()) * n
        return PROBE_OPS * probes, probes
    from pywindow_torch.ops import ray_kernels

    if key == "fine_path":
        walked_rays = fine_live(args)
        origin_probes = 0
    else:
        at_origin = ray_kernels.path_sweep_origin_rays(vectors, chunks, int(max_steps))
        walked_rays = ~at_origin
        origin_probes = int(at_origin.any(-1).sum()) * n
    walked = int(walked_rays.sum())
    evals = int((steps * cull_kept(key, args).to(torch.int64) * walked_rays).sum())
    ops = PROBE_OPS * origin_probes + SEGMENT_ATOM_OPS * walked * n + PROBE_OPS * evals
    return ops, origin_probes + walked * n + evals


def fp32_floor(key, args, every_lane=False) -> float:
    """ms: a ray kernel's work as float32 instructions over
    :data:`FP32_INSTR`, each square root :data:`SQRT_F32_INSTR`
    instructions (the bound counts it as one operation)."""
    ops, sqrts = ray_work(key, args, every_lane)
    return 1e3 * (ops + (SQRT_F32_INSTR - 1) * sqrts) / FP32_INSTR


def ray_rows(key, label, args) -> None:
    """The ray kernels' extra readings of a timed call: the atoms the
    cull keeps (per tile of 32 rays for ``ray_exit``; for ``path_sweep``
    per ray it walks, beside the zero rays it answers from the origin
    clearance; for ``fine_path`` per active slot, beside the slots it
    skips), the bound under the cull beside the one over every pair, and
    the FP32 instruction floor."""
    kept = cull_kept(key, args).to(torch.float64)
    if key == "ray_exit":
        n, what = args[1].shape[1], "tile of 32 rays"
        print(
            f"    {key} {label}: the cull keeps {float(kept.mean()):.2f} atoms a {what} on average, "
            f"{int(kept.max())} at most, of {n}"
        )
    else:
        from pywindow_torch.ops import ray_kernels

        n = args[2].shape[1]
        if key == "fine_path":
            walked_rays = fine_live(args)
            skipped = f"{int((~walked_rays).sum())} of {walked_rays.numel()} slots are inactive"
        else:
            at_origin = ray_kernels.path_sweep_origin_rays(args[0], args[1], int(args[4]))
            walked_rays = ~at_origin
            skipped = (
                f"{int(at_origin.sum())} of {at_origin.numel()} rays are zero rays "
                "answered from the origin clearance"
            )
        walked = kept[walked_rays]
        culled = (
            f"the cull keeps {float(walked.mean()):.2f} atoms a ray on average, "
            f"{int(walked.max())} at most, of {n}, on the {walked.numel()} rays it walks"
            if walked.numel() else "no ray is walked"
        )
        print(f"    {key} {label}: {skipped}; {culled}")
    cull_ops, all_ops = ray_work(key, args)[0], ray_work(key, args, every_lane=True)[0]
    print(
        f"    {key} {label}: bound {bound(key, args, {}, ())[0]:.4e} ms over the work the cull "
        f"leaves ({cull_ops:.4e} operations), {bound(key, args, {}, (), every_lane=True)[0]:.4e} ms "
        f"over every pair ({all_ops:.4e}); fp32 instruction floor {fp32_floor(key, args):.4e} ms "
        f"({fp32_floor(key, args, every_lane=True):.4e} ms over every pair)"
    )


def clearance_rows(label, args, out) -> None:
    """``clearance_min``'s extra readings of a timed call: each launch's
    device time; the pairs each probe needs (the function's work, which
    the bound counts beside its box tests), with the bound and the
    every-pair bound in brackets; the pairs its own test keeps with its
    running minimum, and the pairs and tile pairs its warp visits (the
    design's work: every lane of a warp computes every tile that any
    lane keeps), per probe and in total, the design's work with the
    sort's bytes at the peak rates; and the FP32 or FP64 instruction
    floor of each count, each square root taken."""
    from pywindow_torch.ops import clearance_kernels as ck

    q, n = args[0].shape[0], args[1].shape[0]
    fp64 = args[0].dtype == torch.float64
    fp = "fp64" if fp64 else "fp32"
    every = q * n
    passes = kernel_device_us(lambda: ck.clearance_min_cuda(*args))
    print(
        f"    clearance_min {label} {args[0].dtype}: device us a call by kernel (torch.profiler, "
        f"20 calls): " + ", ".join(f"{k} {v:.2f}" for k, v in passes.items())
    )
    work = clearance_work(args)
    sqrt_extra = (SQRT_DIV_INSTR if fp64 else SQRT_F32_INSTR) - 1
    instr = FP64_INSTR if fp64 else FP32_INSTR

    def ops(pairs):
        return CLEARANCE_BOX_OPS * work["boxes"] + PROBE_OPS * pairs

    def floor(pairs):
        return 1e3 * (ops(pairs) + sqrt_extra * pairs) / instr

    def share(pairs):
        return f"{pairs} of {every} pairs ({pairs / q:.1f} a probe, {100 * pairs / every:.3f}%)"

    ms, by = bound("clearance_min", args, {}, out)
    print(
        f"    clearance_min {label} {args[0].dtype}: the probes need {work['need_tiles'] / q:.2f} of "
        f"{work['tiles']} tiles a probe, {share(work['need_pairs'])}; bound {ms:.5f} ms ({by}; "
        f"{work['boxes']} box tests and those pairs) "
        f"[every pair {bound('clearance_min', args, {}, out, every_lane=True)[0]:.5f} ms]; "
        f"{fp} instruction floor {floor(work['need_pairs']):.5f} ms"
    )
    design_bytes = sum(a.numel() * a.element_size() for a in args) + out.numel() * out.element_size()
    design_bytes += clearance_sort_bytes(args)
    design_ms = 1e3 * max(design_bytes / PEAK_BYTES, ops(work["pairs"]) / PEAK_OPS[args[0].dtype])
    print(
        f"    clearance_min {label} {args[0].dtype}: design work: each probe's own test with its "
        f"running minimum keeps {share(work['lane_pairs'])}, {fp} floor "
        f"{floor(work['lane_pairs']):.5f} ms; a warp visits {work['tile_pairs']} of "
        f"{work['groups'] * work['tiles']} tile pairs ({work['tile_pairs'] / work['groups']:.2f} of "
        f"{work['tiles']} tiles a group), {share(work['pairs'])}, {fp} floor "
        f"{floor(work['pairs']):.5f} ms; with {clearance_sort_bytes(args)} sort bytes "
        f"{design_ms:.5f} ms at the peak rates"
    )


def kernel_device_us(fn, calls: int = 20) -> dict[str, float]:
    """Device µs a call of ``fn`` spends in each CUDA kernel, by kernel
    function name, from torch.profiler over ``calls`` warm calls."""
    import collections
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per: dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.search(r"(\w+)(?:<[^>]*>)?\(", e.name)
            per[name.group(1) if name else e.name] += (e.time_range.end - e.time_range.start) / calls
    return dict(per)


def dbscan_rows(label, args, out) -> None:
    """``dbscan``'s extra readings of a timed call: the valid points a
    frame, and the bound over the work of its exact tile rule beside the
    ones over all unordered valid pairs (the same bytes) and over all K^2
    ordered pairs."""
    n = args[1].to(torch.int64).sum(-1).to(torch.float64)
    k = args[1].shape[1]
    boxes, pairs = dbscan_work(args)
    every = int(dbscan_pairs(args).sum())
    ms, _ = bound("dbscan", args, {}, out)
    all_pairs_ms, _ = bound("dbscan", args, {}, out, ops=DBSCAN_PAIR_OPS * every)
    print(
        f"    dbscan {label}: {float(n.mean()):.1f} valid points a frame on average "
        f"({int(n.min())}-{int(n.max())}) of K = {k}; bound {ms:.4e} ms over {boxes} tile-pair box "
        f"tests and the {pairs} pairs of the near tile pairs (the tile rule skips "
        f"{every - pairs} of {every} unordered pairs, self included; {all_pairs_ms:.4e} ms over "
        f"all of them), {bound('dbscan', args, {}, out, every_lane=True)[0]:.4e} ms over all K^2 pairs"
    )


def active_lanes(args, kwargs) -> int:
    """The lanes of an optimiser call that do work (an inactive lane, a
    slot that holds no window, returns at once)."""
    active = kwargs.get("active")
    return args[0].shape[0] if active is None else int(active.sum())


def grid_kept(args, kwargs) -> torch.Tensor:
    """The atoms ``nm_xy``'s grid cull keeps in each active lane
    (``nm_kernels.grid_keep``, in slices of 1,024 lanes)."""
    from pywindow_torch.ops import nm_kernels

    active = kwargs.get("active")
    lanes = [a if active is None else a[active] for a in args[:4]]
    ns = kwargs.get("brute_ns", 20)
    kept = [
        nm_kernels.grid_keep(*(a[lo : lo + 1024] for a in lanes), ns).sum(-1)
        for lo in range(0, lanes[0].shape[0], 1024)
    ]
    return torch.cat(kept) if kept else torch.zeros(0, dtype=torch.int64, device=args[0].device)


def optimiser_work(key, args, kwargs, out, every_lane=False) -> tuple[int, int]:
    """(operations, square roots and divides) of an optimiser call, per
    (evaluation, atom) as the kernels compute them, over the active
    lanes (``every_lane``: over all): nm_xy the anchor pass and 3
    simplex evaluations over every atom and the ns^2 grid over the atoms
    the cull keeps (``every_lane``: every atom); lbfgsb_stable the start
    and one line-search evaluation per iteration (a lower bound)."""
    lanes = args[0].shape[0] if every_lane else active_lanes(args, kwargs)
    n = args[0].shape[1]
    if key == "nm_xy":
        ns = kwargs.get("brute_ns", 20)
        grid = lanes * n if every_lane else int(grid_kept(args, kwargs).sum())
        ops = lanes * n * (12 + 22 * 3) + grid * 22 * ns * ns
        return ops, lanes * n * (1 + 2 * 3) + grid * 2 * ns * ns
    d = args[3].shape[1]
    iters = int(out[2].to(torch.int64).sum())
    ops = n * ((11 + 22 + 20 * d) * lanes + (11 + (11 + 20) + (11 + 11 + 20 * d)) * iters)
    return ops, n * ((3 + 2 * d) * lanes + (6 + 2 * d) * iters)


def fp64_floor(key, args, kwargs, out) -> float:
    """ms: the optimiser's work as float64 instructions over
    :data:`FP64_INSTR`, each square root and divide
    :data:`SQRT_DIV_INSTR` instructions (the bound counts them as one
    operation and the rate in flops)."""
    ops, sqrt_div = optimiser_work(key, args, kwargs, out)
    return 1e3 * (ops + (SQRT_DIV_INSTR - 1) * sqrt_div) / FP64_INSTR


def one_lane(args, kwargs, i):
    """The inputs of lane i alone."""
    b = args[0].shape[0]

    def pick(a):
        return a[i : i + 1].contiguous() if torch.is_tensor(a) and a.ndim and a.shape[0] == b else a

    return tuple(pick(a) for a in args), {k: pick(v) for k, v in kwargs.items()}


def optimiser_rows(key, kernel, label, args, kwargs, out, ms) -> None:
    """The optimisers' extra readings of a timed call: the active share,
    the slowest lane alone beside the whole call (close: the call is
    latency bound), the float64 instruction floor, the bound beside the
    one over every lane and atom and, for nm_xy, the atoms the grid
    cull keeps."""
    from pywindow_torch.ops import nm_kernels

    lanes = args[0].shape[0]
    if key == "lbfgsb_stable":
        its = out[2]
    else:
        its = torch.zeros(lanes, dtype=torch.int32, device=args[0].device)
        nm_kernels.nm_xy_flat_cuda(*args, **kwargs, iterations=its)
    i = int(torch.argmax(its))
    lane_args, lane_kwargs = one_lane(args, kwargs, i)
    alone = time_ms(lambda: kernel(*lane_args, **lane_kwargs))
    print(
        f"    {key} {label}: active lanes {active_lanes(args, kwargs)} of {lanes}; "
        f"slowest lane {i} ({int(its[i])} iterations) alone {alone:.4f} ms vs the call {ms:.4f} ms; "
        f"fp64 instruction floor {fp64_floor(key, args, kwargs, out):.5f} ms"
    )
    print(
        f"    {key} {label}: bound {bound(key, args, kwargs, out)[0]:.4e} ms over the work "
        f"this call needs, {bound(key, args, kwargs, out, every_lane=True)[0]:.4e} ms "
        "over every lane and atom"
    )
    if key == "nm_xy":
        kept = grid_kept(args, kwargs).to(torch.float64)
        print(
            f"    nm_xy {label}: grid cull keeps {float(kept.mean()):.1f} atoms a lane on average, "
            f"{int(kept.max())} at most, of {args[0].shape[1]}"
        )


#: the sweep chunks of the benchmark's two sweep cells, for max_dim's
#: timings and the packed-row check: (label, frames); CC3 at
#: batch_size=4,320, the 424-atom MIBQAR at 1,200
MAX_DIM_CHUNKS = (("CC3 chunk", 4320), ("MIBQAR chunk", 1200))


def max_dim_chunk(label: str, frames: int) -> tuple:
    """(mols, sizes) of a sweep chunk on the card, sized as
    ``dispatch_batch`` sizes a batch: CC3, the 20 frames of the DL_POLY
    fixture (OPLS, he as H) cycled; MIBQAR, ``tests/data/MIBQAR.pdb`` with
    a seeded Gaussian displacement of 0.1 Å per atom and axis a frame
    (the thermal stand-in of the benchmark's MIBQAR cell)."""
    import pywindow_torch as pt
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops.analysis import batch_sizes, max_dim_bound, max_dim_host
    from pywindow_torch.ops.encoding import encode_batch

    if label.startswith("CC3"):
        fixture = pt.DLPOLY(HISTORY).get_frames(swap_atoms={"he": "H"}, forcefield="OPLS")
        systems = [(m.system["elements"], m.system["coordinates"]) for m in fixture.values()]
        systems = [systems[i % len(systems)] for i in range(frames)]
    else:
        elements, coords = load_pdb_atoms(DATA / "MIBQAR.pdb")
        rng = np.random.default_rng(424)
        systems = [(elements, coords + rng.normal(scale=0.1, size=coords.shape)) for _ in range(frames)]
    maxd = max(max_dim_host(e, c) for e, c in systems[:20])
    largest = max(max_dim_bound(e, c) for e, c in systems[:20])
    return encode_batch(systems, device=DEVICE), batch_sizes(maxd, largest, DEFAULT_CONFIG)


def phase_max_dim_rows(chunks: dict) -> None:
    """The device pipeline on each sweep chunk of :data:`MAX_DIM_CHUNKS`
    through the max_dim kernel and through its plain version on the card
    (the eager all-pairs passes): packed rows equal bit for bit (NaN in
    the same places), each call's event ms printed."""
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops import analysis, pair_kernels

    kernel_fn = pair_kernels.max_dim_cuda
    for label, (mols, sizes) in chunks.items():
        def step():
            return analysis.run_pipeline(mols, sizes, DEFAULT_CONFIG)

        got = step()
        check(same_values(step(), got), f"max_dim {label}: the pipeline's rows vary from call to call")
        kernel_ms = time_ms(step)
        try:
            pair_kernels.max_dim_cuda = pair_kernels.max_dim_flat_plain
            ref = step()
            plain_ms = time_ms(step)
        finally:
            pair_kernels.max_dim_cuda = kernel_fn
        torch.cuda.synchronize()
        check(same_values(got, ref), f"max_dim {label}: packed rows differ from the plain passes'")
        print(
            f"  max_dim {label} {tuple(mols.coords.shape)}: packed rows equal the plain passes' "
            f"bit for bit; pipeline call {kernel_ms:.2f} ms (events) against {plain_ms:.2f} ms"
        )


def timed_calls(key, calls) -> list:
    """(label, args, kwargs) of the recorded calls that phase 3 times: the
    first of each main-path label, PUDXES first (the record's row); for
    lbfgsb_stable the first of each label and d, the pore (d = 3) and
    the window z (d = 1); for ray_exit the first of each label and form,
    the full average-diameter call, then the slim pre-analysis."""
    timed = []
    for label in ("PUDXES", "REYMAL", SWEEP_LABEL, PERIODIC_LABEL):
        mine = [c for c in calls if c[0] == label]
        if key == "lbfgsb_stable":
            for d in (3, 1):
                timed += [(f"{label} d={d}", a, k) for _, a, k in mine if a[3].shape[1] == d][:1]
        elif key == "ray_exit":
            for want, form in ((True, "full"), (False, "slim")):
                timed += [(f"{label} {form}", a, k) for _, a, k in mine if a[4] == want][:1]
        elif key == "max_dim":
            for atoms, form in ((True, "atoms"), (False, "value")):
                timed += [(f"{label} {form}", a, k) for _, a, k in mine if a[3] == atoms][:1]
        else:
            timed += mine[:1]
    if key == "max_dim":
        timed += [
            (f"{label} {'atoms' if a[3] else 'value'}", a, k)
            for label, a, k in calls if label in dict(MAX_DIM_CHUNKS)
        ]
    return timed


def phase_kernels() -> dict[str, dict]:
    seen = record_inputs()
    chunks = {label: max_dim_chunk(label, frames) for label, frames in MAX_DIM_CHUNKS}
    seen["max_dim"] += [
        (label, (mols.coords, mols.vdw, mols.mask, atoms), {})
        for label, (mols, _) in chunks.items() for atoms in (True, False)
    ]
    fns = {key: (getattr(m, attr), plain) for m, attr, key, plain in wrappers()}
    record = {}
    for key, calls in seen.items():
        check(len(calls) > 0, f"{key}: the main path never reached the kernel")
        compare, dtypes = COMPARE[key]
        worst = 0.0
        for label, args, kwargs in calls:
            for dtype in dtypes:
                err = compare(label, args, kwargs, dtype)
                if dtype == dtypes[-1]:
                    worst = max(worst, err)
        kernel_fn, plain_fn = fns[key]
        if key == "clearance_min":
            # every input set in float32, the card's pipeline dtype, and
            # the two large ones in float64 too; the record's row: the
            # periodic grid in float32 (the first row timed)
            large = ("periodic grid", "Q{}xN{}".format(*CLEARANCE_LARGE))
            timed = [
                (label, _as(args, dt), kwargs)
                for label, args, kwargs in sorted(calls, key=lambda c: c[0] != large[0])
                if not label.startswith("adversarial")
                for dt in ((torch.float32, torch.float64) if label in large else (torch.float32,))
            ]
        else:
            timed = timed_calls(key, calls)
        rows = []
        for label, args, kwargs in timed:
            ms = time_ms(lambda a=args, k=kwargs: kernel_fn(*a, **k))
            dev_ms = device_ms(lambda a=args, k=kwargs: kernel_fn(*a, **k))
            plain_ms = time_ms(lambda a=args, k=kwargs: plain_call(key, plain_fn, *a, **k))
            library_ms = time_ms(lambda a=args: cdist_amin(*a)) if key == "clearance_min" else None
            out = kernel_fn(*args, **kwargs)
            torch.cuda.synchronize()
            bound_ms, bound_by = bound(key, args, kwargs, out)
            shape = tuple(next(a for a in args if torch.is_tensor(a)).shape)
            rows.append((ms, dev_ms, plain_ms, bound_ms, bound_by, library_ms))
            library = "" if library_ms is None else f", cdist+amin {library_ms:.4f} ms"
            print(
                f"  {key} {label} {shape} {args[0].dtype}: kernel {ms:.4f} ms (events), "
                f"device {dev_ms:.4f} ms (CUDA graph), plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by}){library}"
            )
            if key == "lbfgsb_stable":
                nit = out[2].to(torch.int64)
                print(
                    f"    iterations per lane: max {int(nit.max())}, "
                    f"total {int(nit.sum())} over {nit.numel()} lanes"
                )
            if key in ("lbfgsb_stable", "nm_xy"):
                optimiser_rows(key, kernel_fn, label, args, kwargs, out, ms)
            if key in ("ray_exit", "path_sweep", "fine_path"):
                ray_rows(key, label, args)
            if key == "dbscan":
                dbscan_rows(label, args, out)
            if key == "clearance_min":
                clearance_rows(label, args, out)
        print(
            f"kernel {key}: {len(calls)} calls checked, "
            f"max abs err {worst:.3e} ({dtypes[-1]})"
        )
        if key == "max_dim":
            phase_max_dim_rows(chunks)
        ms, dev_ms, plain_ms, bound_ms, bound_by, library_ms = rows[0]
        record[key] = {
            "max_abs_err": worst, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        }
    return record


# -- phases 4-6: the main paths ----------------------------------------------


@contextlib.contextmanager
def main_path(label: str, pipeline_calls: list, kernels: tuple = PIPELINE_KERNELS):
    """Launch counters at 0 before the path, every kernel of ``kernels``
    launched after it; each device-pipeline call's launches and peak
    memory recorded; the plain optimiser loops refuse CUDA tensors
    meanwhile."""
    from pywindow_torch.ops import (
        _cuda,
        analysis,
        clearance_kernels,
        lbfgsb,
        lbfgsb_kernels,
        nm_kernels,
        optim,
        pair_kernels,
        windows,
    )

    def refuse_cuda(fn, name):
        def run(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda for a in args + tuple(kwargs.values())):
                raise AssertionError(f"{label}: the plain {name} ran on a CUDA tensor")
            return fn(*args, **kwargs)

        return run

    patched = [
        (analysis, "lbfgsb_minimize"), (windows, "lbfgsb_minimize"),
        (windows, "brute_then_polish"), (lbfgsb_kernels, "lbfgsb_minimize_stable"),
        (nm_kernels, "brute_then_polish"), (optim, "nelder_mead"),
        (lbfgsb, "lbfgsb_minimize_stable"),
    ]
    run_pipeline = analysis.run_pipeline

    def counted_pipeline(mols, sizes, cfg):
        # the calling thread's own launches: a sweep's collector thread
        # re-runs saturated frames while the main thread dispatches
        mine = _cuda.thread_launches()
        before = dict(mine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run_pipeline(mols, sizes, cfg)
        torch.cuda.synchronize()
        delta = {k: mine[k] - before.get(k, 0) for k in KERNELS}
        pipeline_calls.append(
            (label, mols.coords.shape[0], delta, torch.cuda.max_memory_allocated())
        )
        return out

    saved = [(m, a, getattr(m, a)) for m, a in patched]
    try:
        for m, a, fn in saved:
            setattr(m, a, refuse_cuda(fn, a))
        analysis.run_pipeline = counted_pipeline
        _cuda.LAUNCHES.clear()
        yield
        torch.cuda.synchronize()
        helpers = (*clearance_kernels.HELPER_KERNELS, *pair_kernels.HELPER_KERNELS)
        launches = {k: _cuda.LAUNCHES[k] for k in (*KERNELS, *helpers)}
        print(f"{label}: launches {json.dumps(launches)}")
        for key in kernels:
            check(launches[key] > 0, f"{label}: {key} was not launched")
        main_path.launches[label] = launches
    finally:
        analysis.run_pipeline = run_pipeline
        for m, a, fn in saved:
            setattr(m, a, fn)


main_path.launches = {}


def gate_errors(props, gold) -> dict[str, float]:
    """Absolute errors of one analysis against its goldens, by quantity;
    windows missing or of another count are an infinite error."""
    errs = {}
    if "pore" in gold:
        errs["pore"] = abs(props["pore_diameter"]["diameter"] - gold["pore"])
    if "pore_opt" in gold:
        errs["pore_opt"] = abs(props["pore_diameter_opt"]["diameter"] - gold["pore_opt"])
    if "avg" in gold:
        errs["avg"] = abs(props["average_diameter"] - gold["avg"])
    if "max" in gold:
        errs["max"] = abs(props["maximum_diameter"]["diameter"] - gold["max"])
    if "windows" in gold:
        wins = props["windows"]["diameters"]
        if wins is None or len(wins) != len(gold["windows"]):
            errs["windows"] = math.inf
        else:
            wins = np.sort(np.asarray(wins, dtype=np.float64))
            errs["windows"] = float(np.abs(wins - np.sort(gold["windows"])).max())
    return errs


def check_finite(name: str, props: dict) -> None:
    for key, value in props.items():
        if key == "windows":
            continue
        vals = value.values() if isinstance(value, dict) else [value]
        for v in vals:
            check(
                bool(np.all(np.isfinite(np.asarray(v, dtype=np.float64)))),
                f"{name}: {key} not finite",
            )


def gate_report(device="cuda") -> dict:
    """The 7-system golden gate: ``full_analysis()`` of each system of
    :data:`GOLD` on ``device``, its errors (:func:`gate_errors`), worst
    error and seconds, and whether every system is within :data:`TOL`.
    A value that is not finite raises."""
    systems = {}
    for name, gold in GOLD.items():
        t0 = time.perf_counter()
        props = molecule(name).full_analysis(device=device)
        seconds = time.perf_counter() - t0
        check_finite(name, props)
        errs = {k: float(v) for k, v in gate_errors(props, gold).items()}
        systems[name] = {"worst": max(errs.values()), "errors": errs, "seconds": seconds}
    return {"tol": TOL, "pass": all(s["worst"] < TOL for s in systems.values()), "systems": systems}


def phase_gate() -> None:
    for name, s in gate_report()["systems"].items():
        print(
            f"gate {name}: worst abs err {s['worst']:.3e} A (tol {TOL}) "
            f"{json.dumps(s['errors'])}, {s['seconds']:.3f} s"
        )
        check(s["worst"] < TOL, f"{name}: error {s['worst']} >= {TOL}")


def phase_batched_gate() -> None:
    from pywindow_torch.parallel import batch

    m = molecule("PUDXES")
    gold = {"pore": GOLD["PUDXES"]["pore"], "windows": GOLD["PUDXES"]["windows"]}
    t0 = time.perf_counter()
    res = batch.analyze_batch([(m.elements, m.coordinates)] * BATCH_GATE)
    seconds = time.perf_counter() - t0
    check(len(res) == BATCH_GATE, "batched gate: results missing")
    worst = 0.0
    for props in res:
        check_finite("batched PUDXES", props)
        worst = max(worst, max(gate_errors(props, gold).values()))
    print(
        f"batched gate: {BATCH_GATE} CC3 frames, worst abs err {worst:.3e} A "
        f"(tol {TOL}), {seconds:.3f} s"
    )
    check(worst < TOL, f"batched gate: error {worst} >= {TOL}")


def synth_file(stem: str, n_frames: int, source: pathlib.Path, write) -> pathlib.Path:
    """A synthesised trajectory under build/, named by ``stem``, its frame
    count and a hash of its ``source`` fixture, and written once:
    ``write(fh)`` fills a temporary file that is then renamed, so a file
    of that name is whole and was made from this very fixture."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / f"{stem}_{n_frames}_{digest}"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.part")
    with tmp.open("w") as fh:
        write(fh)
    tmp.replace(out)
    return out


def synth_history(n_frames: int) -> pathlib.Path:
    """An n-frame HISTORY cycling the 20-frame CC3 fixture with monotone
    timesteps rewritten (bench.py:201-227), under build/."""

    def write(fh) -> None:
        lines = HISTORY.read_text().split("\n")
        starts = [i for i, ln in enumerate(lines) if ln.startswith("timestep")]
        fh.write("\n".join(lines[: starts[0]]) + "\n")
        frames = []
        for i, s in enumerate(starts):
            e = starts[i + 1] if i + 1 < len(starts) else len(lines)
            frames.append("\n".join(lines[s:e]).rstrip("\n") + "\n")
        for k in range(n_frames):
            head, _, body = frames[k % len(frames)].partition("\n")
            parts = head.split()
            parts[1] = str(25 * k)
            fh.write(" ".join(parts) + "\n" + body)

    return synth_file("HISTORY_cc3", n_frames, HISTORY, write)


@contextlib.contextmanager
def stream_spy(runs: list):
    """Record each streamed sweep made inside the block: every frame's
    maximum diameter as its slab decoder returned it (their maximum is
    the sampling pin) and the size gate at each delivery."""
    from pywindow_torch.parallel import batch

    sweep_stream = batch.sweep_stream

    def spy(elements, n_frames, decode_slab, on_batch, *args, size_gate=None, **kwargs):
        run = {"maxd": np.full(n_frames, np.nan), "gate": []}
        runs.append(run)

        def decode(lo, hi, **slabs):
            run["maxd"][lo:hi] = decode_slab(lo, hi, **slabs)
            return run["maxd"][lo:hi]

        def deliver(positions, results):
            run["gate"].append(None if size_gate is None else bool(size_gate["final"]))
            on_batch(positions, results)

        return sweep_stream(elements, n_frames, decode, deliver, *args, size_gate=size_gate, **kwargs)

    batch.sweep_stream = spy
    try:
        yield
    finally:
        batch.sweep_stream = sweep_stream


def phase_sweep(pipeline_calls: list):
    """The 4,320-frame sweep through the route ``analysis_batched`` takes
    by default, the streamed one; returns the trajectory and its frames'
    maximum diameters (their maximum is the sweep's sampling pin)."""
    import pywindow_torch as pt

    from pywindow_torch import native, profiling
    from pywindow_torch.profiling import METRICS

    profiling.enable()
    path = synth_history(SWEEP_FRAMES)
    first = len(pipeline_calls)
    before, calls_before = dict(METRICS.stage_seconds), dict(native.CALLS)
    runs: list = []
    t0 = time.perf_counter()
    traj = pt.DLPOLY(path)
    with stream_spy(runs):
        traj.analysis_batched(swap_atoms={"he": "H"}, forcefield="OPLS", batch_size=SWEEP_CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(runs) == 1, f"sweep: {len(runs)} streamed sweeps, expected 1")
    maxd = runs[0]["maxd"]
    check(bool(np.isfinite(maxd).all()), "sweep: a slab was never decoded")
    check(runs[0]["gate"][-1] is True, "sweep: the last delivery was not final")
    sweep_stages("sweep", before)
    calls = native_calls("sweep", calls_before)
    for name in ("map_history", "decode_dlpoly_frames_batch", "props_dicts"):
        check(calls.get(name, 0) > 0, f"sweep: native {name} never ran")
    out = traj.analysis_output
    check(len(out) == SWEEP_FRAMES, f"sweep: {len(out)} of {SWEEP_FRAMES} frames")
    for frame, mols in out.items():
        check_finite(f"sweep frame {frame}", mols["0"])
        wins = mols["0"]["windows"]["diameters"]
        check(wins is None or bool(np.all(np.isfinite(wins))), f"sweep frame {frame}: windows")
    chunks = [c for c in pipeline_calls[first:] if c[1] == SWEEP_CHUNK]
    check(len(chunks) == SWEEP_FRAMES // SWEEP_CHUNK, f"sweep: {len(chunks)} full chunks")
    print(
        f"sweep: {SWEEP_FRAMES} frames in {seconds:.3f} s = {SWEEP_FRAMES / seconds:.1f} frames/s "
        f"(batch_size {SWEEP_CHUNK}, DLPOLY map + streamed decode + analysis, each pipeline "
        "call synchronised by the launch count)"
    )
    for _, b, _, peak in pipeline_calls[first:]:
        print(f"  sweep pipeline call: B={b}, peak device memory {peak / 2**30:.3f} GiB")
    return traj, maxd


SWEEP_FIELDS = (
    ("pore_diameter", "diameter"), ("pore_diameter_opt", "diameter"),
    ("average_diameter", None), ("maximum_diameter", "diameter"),
    ("windows", "diameters"), ("windows", "centre_of_mass"),
)


def same_results(label: str, got: dict, ref: dict) -> None:
    """Two sweeps' frames: every pore, average, maximum and window value
    equal bit for bit."""
    check(sorted(got) == sorted(ref), f"{label}: frames differ")
    for f in ref:
        for key, sub in SWEEP_FIELDS:
            a = got[f][key] if sub is None else got[f][key][sub]
            b = ref[f][key] if sub is None else ref[f][key][sub]
            check((a is None) == (b is None), f"{label} frame {f}: {key} {sub} present in one only")
            if b is not None:
                check(
                    np.array_equal(np.asarray(a), np.asarray(b)),
                    f"{label} frame {f}: {key} {sub} differs ({a} against {b})",
                )


def phase_sweep_routes(traj, maxd):
    """Outside the launch count: (a) the streamed route again and the
    up-front route (every frame decoded, then ``sweep_uniform``) at the
    same pin, timed, equal bit for bit; the decode seconds the stream
    hid behind the device; (c) every chunk's packed results through the
    native and the plain dict converters, equal dicts, both timed.
    Returns the decoded (elements, coordinates) for phase (b)."""
    import pywindow_torch as pt

    from pywindow_torch.ops import analysis
    from pywindow_torch.ops.analysis import static_sizes
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.parallel import batch
    from pywindow_torch.profiling import METRICS

    ff = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
    flats = []
    to_dicts = batch.to_properties_dicts_bulk

    def capture(flat, w):
        flats.append((flat.copy(), w))
        return to_dicts(flat, w)

    before = dict(METRICS.stage_seconds)
    batch.to_properties_dicts_bulk = capture
    batch.LEARNED_CAPS._caps.clear()
    try:
        t0 = time.perf_counter()
        stream = pt.DLPOLY(traj.filepath)
        stream.analysis_batched(batch_size=SWEEP_CHUNK, **ff)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
    finally:
        batch.to_properties_dicts_bulk = to_dicts
    spans = sweep_stages("streamed route", before)
    decode, wait = spans.get("sweep_decode", 0.0), spans.get("sweep_decode_wait", 0.0)
    print(
        f"streamed route: {SWEEP_FRAMES / t_stream:.1f} frames/s ({t_stream:.4f} s); decode "
        f"{decode:.4f} s on the decoder and main threads, of which {max(decode - wait, 0.0):.4f} s "
        f"hidden behind the device (the main thread waited {wait:.4f} s for slabs); sweep_step "
        f"{spans.get('sweep_step', 0.0):.4f} s of device time (CUDA events)"
    )

    batch.LEARNED_CAPS._caps.clear()
    t0 = time.perf_counter()
    up = pt.DLPOLY(traj.filepath)
    elements, coords = up._decode_uniform(list(range(up.no_of_frames)), ff["swap_atoms"], ff["forcefield"])
    maxd_dev = batch.frame_max_diameters(elements, coords, DEVICE)
    got: dict = {}
    batch.sweep_uniform(
        elements, coords, maxd, lambda pos, res: got.update(zip(pos.tolist(), res)),
        batch_size=SWEEP_CHUNK,
    )
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    check(
        static_sizes(float(maxd_dev.max()), DEFAULT_CONFIG)
        == static_sizes(float(maxd.max()), DEFAULT_CONFIG),
        "up-front route: the device maximum diameters give other sampling sizes",
    )
    print(
        f"up-front route (map, decode every frame, maximum diameters on the card, "
        f"sweep_uniform): {SWEEP_FRAMES / t_up:.1f} frames/s ({t_up:.4f} s)"
    )
    streamed = {f: stream.analysis_output[f]["0"] for f in stream.analysis_output}
    same_results("streamed vs up-front", streamed, got)
    same_results("streamed vs the main path", streamed, {f: traj.analysis_output[f]["0"] for f in traj.analysis_output})
    print(f"streamed vs up-front route: all {SWEEP_FRAMES} frames equal bit for bit")

    t_native = t_plain = 0.0
    rows = 0
    for flat, w in flats:
        t0 = time.perf_counter()
        native_dicts = analysis.to_properties_dicts_bulk(flat, w)
        t1 = time.perf_counter()
        plain_dicts = analysis.to_properties_dicts_bulk_plain(flat, w)
        t2 = time.perf_counter()
        t_native, t_plain, rows = t_native + t1 - t0, t_plain + t2 - t1, rows + len(flat)
        same_dicts(native_dicts, plain_dicts)
    print(
        f"dicts: {len(flats)} packed blocks, {rows} rows ({flats[0][0].dtype}): native converter "
        f"{t_native:.4f} s, plain {t_plain:.4f} s; dicts equal"
    )
    return elements, coords


def same_dicts(got: list, ref: list) -> None:
    check(len(got) == len(ref), "dicts: counts differ")
    for g, r in zip(got, ref):
        check(sorted(g) == sorted(r), "dicts: keys differ")
        for key in r:
            gv, rv = g[key], r[key]
            pairs = [(gv[k], rv[k]) for k in rv] if isinstance(rv, dict) else [(gv, rv)]
            for a, b in pairs:
                check((a is None) == (b is None), f"dicts: {key} present in one only")
                if b is None:
                    continue
                check(type(a) is type(b), f"dicts: {key} types differ")
                if isinstance(b, np.ndarray):
                    check(a.dtype == b.dtype and a.shape == b.shape, f"dicts: {key} arrays differ")
                check(np.array_equal(a, b), f"dicts: {key} values differ")


def phase_sweep_escalation(elements, coords) -> None:
    """(b) The sweep's first 1,440 frames, then the same frames scaled by
    1.35, through ``sweep_stream`` with a size gate: the second slab
    grows the sampling sizes, the stream restarts, and its results equal
    ``sweep_uniform``'s bit for bit; the delivery before the restart is
    flagged not final, the last final."""
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops.analysis import static_sizes
    from pywindow_torch.parallel import batch

    half = coords[:SWEEP_CHUNK]
    grown = np.concatenate([half, half * 1.35])
    maxd = batch.frame_max_diameters(elements, grown, DEVICE)
    check(
        static_sizes(float(maxd[:SWEEP_CHUNK].max()), DEFAULT_CONFIG)
        != static_sizes(float(maxd.max()), DEFAULT_CONFIG),
        "escalation: the scaled frames do not change the sampling sizes",
    )
    uniform: dict = {}
    batch.LEARNED_CAPS._caps.clear()
    batch.sweep_uniform(
        elements, grown, maxd, lambda pos, res: uniform.update(zip(pos.tolist(), res)),
        batch_size=SWEEP_CHUNK,
    )

    def decode_slab(lo, hi, out64=None, out32=None):
        for out in (out64, out32):
            if out is not None:
                out[...] = grown[lo:hi]
        return maxd[lo:hi]

    gate: dict = {"final": False}
    log: list = []
    stream: dict = {}

    def on_batch(pos, res):
        log.append(bool(gate["final"]))
        stream.update(zip(pos.tolist(), res))

    batch.LEARNED_CAPS._caps.clear()
    t0 = time.perf_counter()
    batch.sweep_stream(
        elements, len(grown), decode_slab, on_batch, batch_size=SWEEP_CHUNK, size_gate=gate
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(log[0] is False and log[-1] is True, f"escalation: size gate log {log}")
    same_results("escalation", stream, uniform)
    print(
        f"escalation: {len(grown)} frames (the second {SWEEP_CHUNK} scaled by 1.35) restarted "
        f"once, {len(log)} deliveries, gate {log}, in {seconds:.3f} s; equal to sweep_uniform bit for bit"
    )


def _windows_err(got, ref) -> float | None:
    """Largest difference of the sorted window diameters, None when the
    two runs found different numbers of windows."""
    gw, rw = got["windows"]["diameters"], ref["windows"]["diameters"]
    if gw is None or rw is None:
        return 0.0 if gw is None and rw is None else None
    if len(gw) != len(rw):
        return None
    return float(np.abs(np.sort(gw) - np.sort(rw)).max())


def phase_sweep_samples(traj, pin: float) -> None:
    """Eight distinct sweep frames against the single-frame path, outside
    the sweep's launch count: pore_opt against ``full_analysis()``, the
    windows against the same pipeline on the frame alone at the sweep's
    sampling pin (``full_analysis()`` samples with the frame's own
    maximum diameter, which may move a window by ~0.01 Å; that
    difference is printed, not held)."""
    from pywindow_torch.parallel import batch

    check(len({f % 20 for f in SWEEP_SAMPLE}) == len(SWEEP_SAMPLE), "sample frames repeat")
    fr = traj.get_frames(SWEEP_SAMPLE, swap_atoms={"he": "H"}, forcefield="OPLS")
    worst = {"pore_opt": 0.0, "windows_at_pin": 0.0, "windows_own_sampling": 0.0}
    for frame, molsys in fr.items():
        mol = molsys.system_to_molecule()
        single = mol.full_analysis()
        at_pin = batch.analyze_batch(
            [(mol.elements, mol.coordinates)], reference_max_diameter=pin
        )[0]
        got = traj.analysis_output[frame]["0"]
        d_pore = abs(got["pore_diameter_opt"]["diameter"] - single["pore_diameter_opt"]["diameter"])
        worst["pore_opt"] = max(worst["pore_opt"], d_pore)
        err = _windows_err(got, at_pin)
        check(err is not None, f"sweep frame {frame}: window count differs from the frame alone")
        worst["windows_at_pin"] = max(worst["windows_at_pin"], err)
        own = _windows_err(got, single)
        if own is None:
            print(f"  sweep frame {frame}: window count differs under its own sampling")
        else:
            worst["windows_own_sampling"] = max(worst["windows_own_sampling"], own)
    print(
        f"sweep vs the single-frame path, frames {SWEEP_SAMPLE} (pin {pin!r} A): "
        f"{json.dumps(worst)} A"
    )
    check(
        worst["pore_opt"] < TOL and worst["windows_at_pin"] < TOL,
        "sweep: frames differ from the single-frame path",
    )


@contextlib.contextmanager
def stage_timers(spans: dict):
    """Time the analysis stages on the host, synchronising the card on
    each side of a stage (the spans add up, nested ones excluded)."""
    from pywindow_torch.ops import analysis, rays, windows

    stages = [
        (analysis, "optimise_pore_centre_res", "pore centre (lbfgsb_stable)"),
        (windows, "_window_refine", "window refine (lbfgsb_stable z, nm_xy)"),
        (rays, "fine_path_analysis", "fine sweep (fine_path)"),
        (rays, "average_diameter", "average diameter (ray_exit)"),
        (rays, "preanalysis_open", "pre-analysis, coarse sweep, DBSCAN"),
        (rays, "path_analysis", "pre-analysis, coarse sweep, DBSCAN"),
        (windows, "dbscan", "pre-analysis, coarse sweep, DBSCAN"),
    ]
    saved = [(m, a, getattr(m, a)) for m, a, _ in stages]

    def timed(fn, name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return out

        return run

    try:
        for (m, a, fn), (_, _, name) in zip(saved, stages):
            setattr(m, a, timed(fn, name))
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def device_profile(fn) -> tuple[float, float, int]:
    """(wall seconds, device-busy seconds, kernel launches) of one warm
    call, from torch.profiler's kernel events: busy time is the union of
    their intervals, so an event listed twice counts once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        {
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
        }
    )
    busy_us, end = 0.0, -math.inf
    for start, stop, _ in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return wall, busy_us * 1e-6, len(spans)


def warm_repeats(name: str, mol, repeats: int = 7) -> None:
    """``repeats`` more warm ``full_analysis()`` runs of one molecule:
    every wall time, their median and the passes of the cyclic garbage
    collector's oldest generation during them (they walk every object
    the earlier phases keep alive)."""
    import gc

    passes = {"n": 0}

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start" and info["generation"] == 2:
            passes["n"] += 1

    times = []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mol.full_analysis()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        gc.callbacks.remove(on_gc)
    print(
        f"profile {name}: {repeats} warm runs, median {statistics.median(times) * 1e3:.3f} ms, "
        f"each {json.dumps([round(t * 1e3, 3) for t in times])} ms; "
        f"{passes['n']} oldest-generation gc passes, {len(gc.get_objects())} objects tracked"
    )


def phase_profile(pin: float) -> None:
    """Where a molecule's and a chunk's time goes: host stage spans of
    one warm PUDXES and REYMAL molecule, the device's busy share and
    kernel launches of one molecule and of one 1,440-frame chunk (at the
    sweep's sampling pin)."""
    from pywindow_torch.parallel import batch

    for name in ("PUDXES", "REYMAL"):
        mol = molecule(name)
        mol.full_analysis()
        spans: dict = {}
        with stage_timers(spans):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            molecule(name).full_analysis()
            torch.cuda.synchronize()
            whole = time.perf_counter() - t0
        rows = {"whole molecule": whole, **spans}
        rows["other (eager torch, host)"] = whole - sum(spans.values())
        for stage_name, sec in rows.items():
            print(f"profile {name}: {stage_name}: {sec:.4f} s ({100 * sec / whole:.1f}%)")
        wall, busy, launches = device_profile(lambda n=name: molecule(n).full_analysis())
        print(
            f"profile {name}: under torch.profiler {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%), {launches} kernel launches"
        )
        warm_repeats(name, mol)
    traj_frames = synth_history(SWEEP_FRAMES)
    import pywindow_torch as pt

    fr = pt.DLPOLY(traj_frames).get_frames(list(range(20)), swap_atoms={"he": "H"}, forcefield="OPLS")
    systems = [(m.system["elements"], m.system["coordinates"]) for m in fr.values()]
    chunk = [systems[k % 20] for k in range(SWEEP_CHUNK)]
    wall, busy, launches = device_profile(
        lambda: batch.analyze_batch(chunk, reference_max_diameter=pin)
    )
    print(
        f"profile chunk of {SWEEP_CHUNK} CC3 frames (analyze_batch): {wall:.4f} s, "
        f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%), {launches} kernel launches"
    )


def sweep_stages(label: str, before: dict) -> dict:
    """A sweep's host stage seconds (``profiling.stage`` spans, among
    them the trajectory map with its integrity check) since ``before``."""
    from pywindow_torch.profiling import METRICS

    spans = {
        k: v - before.get(k, 0.0)
        for k, v in METRICS.stage_seconds.items()
        if v - before.get(k, 0.0) > 0
    }
    print(f"{label} stages: {json.dumps({k: round(v, 4) for k, v in spans.items()})} s")
    return spans


def native_calls(label: str, before: dict) -> dict:
    """The native library's calls by function since ``before``."""
    from pywindow_torch import native

    calls = {k: v - before.get(k, 0) for k, v in native.CALLS.items() if v - before.get(k, 0)}
    print(f"{label} native calls: {json.dumps(calls)}")
    return calls


# -- phases 8-10: the periodic system, its trajectory, the clearance grid ------


def load_pdb_atoms(path: pathlib.Path) -> tuple[np.ndarray, np.ndarray]:
    """(elements, coordinates) of a PDB file's atom records."""
    atoms = [ln for ln in path.read_text().splitlines() if ln[:6] in ("ATOM  ", "HETATM")]
    elements = np.array([ln[76:78].strip() for ln in atoms])
    coords = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    return elements, coords


def periodic_errors(props: dict) -> dict[str, float]:
    """One cage against its orientation's row (the nearer average
    diameter): pore_opt, average diameter and the four sorted windows."""
    avg = props["average_diameter"]
    row = min(PERIODIC_ROWS, key=lambda r: abs(r - avg))
    check(props["no_of_atoms"] == 168, f"a cage of {props['no_of_atoms']} atoms")
    wins = props["windows"]["diameters"]
    check(wins is not None and len(wins) == 4, f"cage windows {wins}")
    return {
        "pore_opt": abs(props["pore_diameter_opt"]["diameter"] - PERIODIC_PORE),
        "avg": abs(avg - row),
        "windows": float(np.abs(np.sort(np.asarray(wins, np.float64)) - PERIODIC_ROWS[row]).max()),
    }


def phase_periodic_system() -> None:
    import pywindow_torch as pt

    system = pt.MolecularSystem.load_file(PERIODIC)
    t0 = time.perf_counter()
    rebuilt = system.rebuild_system().system
    t_rebuild = time.perf_counter() - t0
    gold_el, gold_co = load_pdb_atoms(DATA / "system_periodic_rebuild.pdb")
    check(
        np.array_equal(np.asarray(rebuilt["elements"], dtype="<U2"), gold_el),
        "rebuild: element order differs from the reference rebuild",
    )
    co_err = float(np.abs(rebuilt["coordinates"] - gold_co).max())
    check(co_err <= 5.1e-4, f"rebuild: coordinates differ by {co_err} A")
    system.make_modular(rebuild=True)
    check(len(system.molecules) == 8, f"{len(system.molecules)} molecules, expected 8")
    t0 = time.perf_counter()
    res = system.analyze_molecules()
    seconds = time.perf_counter() - t0
    worst = {"pore_opt": 0.0, "avg": 0.0, "windows": 0.0}
    for key, props in res.items():
        check_finite(f"cage {key}", props)
        for name, err in periodic_errors(props).items():
            worst[name] = max(worst[name], err)
    print(
        f"periodic system: rebuild {t_rebuild:.3f} s, {len(rebuilt['elements'])} atoms equal the "
        f"reference rebuild (coordinates within {co_err:.1e} A); 8 cages in {seconds:.3f} s, "
        f"worst abs err {json.dumps(worst)} A (tol {TOL})"
    )
    check(max(worst.values()) < TOL, "periodic system: a cage is off its reference row")


def synth_periodic(n_frames: int) -> pathlib.Path:
    """An n-frame periodic PDB trajectory under build/: frame 0 is
    ``system_periodic.pdb`` itself, frame f > 0 its cell translated by a
    vector uniform in the cell (seed 0) with every atom wrapped back, in
    the file's fixed columns, frames separated by END."""
    out = ROOT / "build" / f"periodic_{n_frames}.pdb"
    out.parent.mkdir(parents=True, exist_ok=True)
    text = PERIODIC.read_text()
    lines = text.splitlines()
    cryst = next(ln for ln in lines if ln.startswith("CRYST1"))
    atoms = [ln for ln in lines if ln[:6] in ("ATOM  ", "HETATM")]
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    a = float(cryst[6:15])
    rng = np.random.default_rng(0)
    with out.open("w") as fh:
        fh.write(text[: text.rindex("END")] + "END\n")
        for _ in range(1, n_frames):
            moved = np.mod(xyz + rng.uniform(0.0, a, 3), a)
            body = [ln[:30] + f"{x:8.3f}{y:8.3f}{z:8.3f}" + ln[54:] for ln, (x, y, z) in zip(atoms, moved)]
            fh.write("\n".join([cryst, *body, "END"]) + "\n")
    return out


def phase_periodic_trajectory(pipeline_calls: list):
    import pywindow_torch as pt

    from pywindow_torch import native
    from pywindow_torch.profiling import METRICS

    path = synth_periodic(PERIODIC_FRAMES)
    first = len(pipeline_calls)
    before, calls_before = dict(METRICS.stage_seconds), dict(native.CALLS)
    t0 = time.perf_counter()
    traj = pt.PDB(path)
    traj.analysis_batched(
        frames="all", batch_size=PERIODIC_CHUNK, modular=True, rebuild=True, forcefield="DLF"
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = traj.analysis_output
    check(len(out) == PERIODIC_FRAMES, f"periodic: {len(out)} of {PERIODIC_FRAMES} frames")
    worst = {"pore_opt": 0.0, "avg": 0.0, "windows": 0.0}
    n_mol = 0
    for frame, mols in out.items():
        check(sorted(mols) == list(range(8)), f"periodic frame {frame}: molecules {sorted(mols)}")
        for key, props in mols.items():
            check_finite(f"periodic frame {frame} cage {key}", props)
            for name, err in periodic_errors(props).items():
                worst[name] = max(worst[name], err)
            n_mol += 1
    print(
        f"periodic trajectory: {PERIODIC_FRAMES} frames, {n_mol} cages in {seconds:.3f} s = "
        f"{PERIODIC_FRAMES / seconds:.2f} frames/s, {n_mol / seconds:.1f} molecules/s "
        f"(batch_size {PERIODIC_CHUNK}: PDB map + decode + rebuild + analysis); "
        f"worst abs err {json.dumps(worst)} A (tol {TOL})"
    )
    check(max(worst.values()) < TOL, "periodic trajectory: a cage is off its reference row")
    sweep_stages("periodic trajectory", before)
    calls = native_calls("periodic trajectory", calls_before)
    for name in ("bfs_molecule", "decode_pdb_frame"):
        check(calls.get(name, 0) > 0, f"periodic trajectory: native {name} never ran")
    for _, b, _, peak in pipeline_calls[first:]:
        print(f"  periodic pipeline call: B={b}, peak device memory {peak / 2**30:.3f} GiB")
    return traj


def phase_periodic_serial(traj) -> None:
    """Frames of the periodic sweep against the serial path, outside the
    sweep's launch count: pore_opt within 1e-4 Å, the same window
    counts, windows within 0.01 Å (the serial path samples each cage
    with its own maximum diameter, the sweep with the chunk's pin)."""
    import pywindow_torch as pt

    serial = pt.PDB(traj.filepath)
    serial.analysis(frames=PERIODIC_SAMPLE, modular=True, rebuild=True, forcefield="DLF")
    worst = {"pore_opt": 0.0, "windows": 0.0}
    for frame in PERIODIC_SAMPLE:
        got, ref = traj.analysis_output[frame], serial.analysis_output[frame]
        check(sorted(got) == sorted(ref), f"periodic frame {frame}: molecule keys differ")
        for key in ref:
            d_pore = abs(got[key]["pore_diameter_opt"]["diameter"] - ref[key]["pore_diameter_opt"]["diameter"])
            worst["pore_opt"] = max(worst["pore_opt"], d_pore)
            err = _windows_err(got[key], ref[key])
            check(err is not None, f"periodic frame {frame} cage {key}: window counts differ")
            worst["windows"] = max(worst["windows"], err)
    print(f"periodic trajectory vs analysis(), frames {PERIODIC_SAMPLE}: {json.dumps(worst)} A")
    check(worst["pore_opt"] <= 1e-4, "periodic: pore_opt differs from the serial path")
    check(worst["windows"] < TOL, "periodic: windows differ from the serial path")


def phase_clearance_grid() -> None:
    """The clearance field of the periodic cell on its 50^3 grid, through
    the public ``clearance_min``."""
    from pywindow_torch.ops.clearance_kernels import clearance_min

    probes, coords, vdw = periodic_grid(torch.float32)
    t0 = time.perf_counter()
    field = clearance_min(probes, coords, vdw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(tuple(field.shape) == (GRID_POINTS**3,), f"grid: shape {tuple(field.shape)}")
    check(bool(torch.isfinite(field).all()), "grid: clearance not finite")
    free = int((field > 0).sum())
    print(
        f"clearance grid: {GRID_POINTS}^3 probes against {coords.shape[0]} atoms in "
        f"{seconds * 1e3:.3f} ms (first call); clearance {float(field.min()):.3f} to "
        f"{float(field.max()):.3f} A, {free} probes ({100 * free / field.numel():.1f}%) outside every vdW sphere"
    )


# -- phase 11: the public surface; dbscan_spiral -------------------------------

#: the surface phase's references: GOLD, and for REYMAL the pore_opt of
#: BASELINE.md:29 (the reference's example_1.py); REYMAL's average
#: diameter has no golden and is held to the card's full_analysis()
SURFACE_GOLD = {
    "PUDXES": {**GOLD["PUDXES"], "pore_opt": GOLD["PUDXES"]["pore"]},
    "REYMAL": {**GOLD["REYMAL"], "pore_opt": 13.75674},
}
#: kernel name substrings of the seven pipeline kernels in a trace
TRACE_NAMES = {
    "ray_exit": "ray_exit_kernel", "path_sweep": "path_sweep_kernel",
    "dbscan": "dbscan_kernel", "lbfgsb_stable": "lbfgsb_kernel",
    "nm_xy": "nm_xy_kernel", "fine_path": "fine_path_kernel",
    "max_dim": "max_dim_pairs",
}


def window_rays(u, elements, coords, centre, direction, seed: int = 0) -> np.ndarray:
    """A window cluster as ``utilities.window_analysis`` takes it: the
    rows of five open sampling rays (of the sampling sphere's radius)
    within ~2 degrees of ``direction``, about the pore ``centre``."""
    from pywindow_torch import tables

    vdw = tables.ELEMENT_VDW[tables.element_ids(elements)]
    length = u.max_dim(elements, coords - centre, device="cpu")[2] / 2.0
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(200):
        v = direction / np.linalg.norm(direction) + rng.normal(scale=0.03, size=3)
        res = u.vector_preanalysis(v / np.linalg.norm(v) * length, coords - centre, vdw)
        if res is not None:
            rows.append(res)
        if len(rows) == 5:
            break
    check(len(rows) > 0, "window_analysis: no open ray towards the window")
    return np.array(rows)


#: the kernels each ``utilities`` call of the surface phase must launch
SURFACE_KERNELS = {
    "find_windows": PIPELINE_KERNELS,
    "find_average_diameter": ("ray_exit",),
    "opt_pore_diameter": ("lbfgsb_stable",),
    "window_analysis": ("path_sweep", "lbfgsb_stable", "nm_xy"),
}
#: the command line in a subprocess: the function ``python -m
#: pywindow_torch`` runs, then the process's launch counts on stderr
CLI_RUNNER = (
    "import json, sys\n"
    "from pywindow_torch.__main__ import main\n"
    "from pywindow_torch.ops import _cuda\n"
    "main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps(dict(_cuda.LAUNCHES)), file=sys.stderr)\n"
)


def run_cli(*args: str) -> dict:
    """Run the command line's ``args`` in a subprocess; check that it
    launched the seven pipeline kernels and return its launch counts."""
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, *args], cwd=ROOT, capture_output=True,
        text=True, timeout=900, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    check(proc.returncode == 0, f"python -m pywindow_torch {args[0]}: {proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("LAUNCHES ")]
    check(len(lines) == 1, f"CLI {args[0]}: no launch counts")
    launches = json.loads(lines[0][len("LAUNCHES "):])
    missing = [k for k in PIPELINE_KERNELS if launches.get(k, 0) == 0]
    check(not missing, f"CLI {args[0]}: {missing} not launched")
    return launches


def own_launches(what: str, kernels: tuple, fn):
    """``fn()`` with the calling thread's launch counts set to 0 before
    it; every kernel of ``kernels`` launched after it -> (its result,
    its launches)."""
    from pywindow_torch.ops import _cuda

    mine = _cuda.thread_launches()
    mine.clear()
    out = fn()
    torch.cuda.synchronize()
    missing = [k for k in kernels if mine[k] == 0]
    check(not missing, f"{what} did not launch {missing}")
    return out, {k: mine[k] for k in KERNELS if mine[k]}


def surface_call(name: str, call: str, fn):
    """One ``utilities`` call through :func:`own_launches`, holding the
    kernels of :data:`SURFACE_KERNELS`."""
    return own_launches(f"surface {name}: {call}", SURFACE_KERNELS[call], fn)


def phase_surface() -> None:
    """The public surface on the card: ``utilities``' device functions on
    PUDXES and REYMAL against the goldens, each through its own kernels,
    and the scipy objectives against ``pore_diameter``; the shape
    descriptors against ``utilities``' numpy ones, the command line's
    two commands in subprocesses, and one molecule under
    ``profiling.trace``."""
    import tempfile

    from pywindow_torch import profiling
    from pywindow_torch import utilities as u

    for name, gold in SURFACE_GOLD.items():
        m = molecule(name)
        el, co = m.elements, m.coordinates
        errs, launched = {}, {}
        t0 = time.perf_counter()
        wins, launched["find_windows"] = surface_call(
            name, "find_windows", lambda: u.find_windows(el, co)
        )
        check(wins is not None and len(wins[0]) == len(gold["windows"]), f"{name}: find_windows {wins}")
        errs["find_windows"] = float(np.abs(np.sort(wins[0]) - np.sort(gold["windows"])).max())
        avg, launched["find_average_diameter"] = surface_call(
            name, "find_average_diameter", lambda: u.find_average_diameter(el, co)
        )
        avg_ref = gold["avg"] if "avg" in gold else m.full_analysis()["average_diameter"]
        errs["find_average_diameter"] = abs(avg - avg_ref)
        (d, _, centre), launched["opt_pore_diameter"] = surface_call(
            name, "opt_pore_diameter", lambda: u.opt_pore_diameter(el, co)
        )
        errs["opt_pore_diameter"] = abs(d - gold["pore_opt"])
        rows = window_rays(u, el, co, centre, wins[1][0] - centre)
        got, launched["window_analysis"] = surface_call(
            name, "window_analysis", lambda: u.window_analysis(rows, el, co - centre)
        )
        check(got is not None, f"{name}: window_analysis found no window")
        errs["window_analysis"] = float(np.abs(np.asarray(gold["windows"]) - got[0]).min())
        seconds = time.perf_counter() - t0
        print(
            f"surface {name}: utilities worst abs err {max(errs.values()):.3e} A (tol {TOL}) "
            f"{json.dumps(errs)}, {seconds:.3f} s; launches per call {json.dumps(launched)}"
        )
        check(max(errs.values()) < TOL, f"surface {name}: error {max(errs.values())} >= {TOL}")
        # the scipy objectives, on the card by default, against pore_diameter
        pore = u.pore_diameter(el, co, com=centre)[0]
        objectives = {
            "correct_pore_diameter": (u.correct_pore_diameter(centre, el, co), -pore),
            "optimise_xy": (u.optimise_xy(centre[:2], centre[2], el, co), -pore),
            "optimise_z": (u.optimise_z(centre[2:], centre[0], centre[1], el, co), pore),
        }
        for key, (value, want) in objectives.items():
            check(value == want, f"surface {name}: {key} {value} != pore_diameter's {want}")
        print(f"surface {name}: the three objectives on the card equal pore_diameter's {pore!r} (tol 0)")

    m = molecule("PUDXES")
    desc = m.calculate_shape_descriptors()
    ref = {
        "asphericity": u.calc_asphericity(m.elements, m.coordinates),
        "acylidricity": u.calc_acylidricity(m.elements, m.coordinates),
        "relative_shape_anisotropy": u.calc_relative_shape_anisotropy(m.elements, m.coordinates),
    }
    diff = {k: abs(desc[k] - ref[k]) for k in ref}
    check(all(math.isfinite(v) for v in desc.values()), f"shape descriptors {desc}")
    check(max(diff.values()) <= 1e-4, f"shape descriptors differ from numpy's: {diff}")
    print(f"surface shape descriptors (PUDXES, float64 on the card): {json.dumps(desc)}, vs numpy {json.dumps(diff)}")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        cli = run_cli("analyze", str(DATA / "PUDXES.xyz"), "-o", str(tmp / "pudxes.json"))
        props = json.loads((tmp / "pudxes.json").read_text())
        errs = gate_errors(props, GOLD["PUDXES"])
        print(
            f"surface CLI analyze PUDXES: worst abs err {max(errs.values()):.3e} A "
            f"{json.dumps(errs)}, {time.perf_counter() - t0:.2f} s (subprocess), "
            f"launches {json.dumps(cli)}"
        )
        check(max(errs.values()) < TOL, "CLI analyze: off the goldens")
        t0 = time.perf_counter()
        cli = run_cli(
            "trajectory", str(HISTORY), "--forcefield", "OPLS", "--swap", "he=H",
            "-o", str(tmp / "history.json"),
        )
        frames = json.loads((tmp / "history.json").read_text())
        check(sorted(frames, key=int) == [str(i) for i in range(20)], f"CLI trajectory: frames {sorted(frames)}")
        for key, mols in frames.items():
            check_finite(f"CLI trajectory frame {key}", mols["0"])
        print(
            f"surface CLI trajectory: 20 frames, finite, {time.perf_counter() - t0:.2f} s "
            f"(subprocess), launches {json.dumps(cli)}"
        )

        with profiling.trace(tmp / "trace"):
            molecule("PUDXES").full_analysis()
        files = list((tmp / "trace").glob("trace-*.json"))
        check(len(files) == 1, f"trace: {len(files)} files")
        kernels = {
            e["name"] for e in json.loads(files[0].read_text())["traceEvents"]
            if e.get("cat") == "kernel"
        }
        missing = [k for k, sub in TRACE_NAMES.items() if not any(sub in n for n in kernels)]
        check(not missing, f"trace: no kernel event of {missing}")
        print(
            f"surface trace: {files[0].name}, {len(kernels)} distinct kernels, "
            "the seven pipeline kernels among them"
        )


def phase_dbscan_spiral(pin: float) -> None:
    """``dbscan_spiral`` on the sweep chunk's ray endpoints over the whole
    spiral (its candidate lists need the spiral's own order: the pore
    centre, the pre-analysis and the coarse sweep of a 1,440-frame chunk
    without the open-ray compaction), labels equal to the dbscan kernel's
    on the same points, both timed; off any main path."""
    import pywindow_torch as pt

    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops import cluster, cluster_kernels, geometry, rays
    from pywindow_torch.ops.analysis import optimise_pore_centre_res, static_sizes
    from pywindow_torch.ops.encoding import encode_batch

    cfg = DEFAULT_CONFIG
    fr = pt.DLPOLY(HISTORY).get_frames(list(range(20)), swap_atoms={"he": "H"}, forcefield="OPLS")
    systems = [(m.system["elements"], m.system["coordinates"]) for m in fr.values()]
    mols = encode_batch([systems[k % 20] for k in range(SWEEP_CHUNK)], device=DEVICE)
    n_win, _, l1, _ = static_sizes(pin, cfg)
    centre, _ = optimise_pore_centre_res(mols, cfg)
    shifted = mols._replace(coords=mols.coords - centre[:, None, :])
    radius = geometry.max_dim_value(shifted) / 2.0
    points = rays.golden_spiral(n_win, radius)
    eps = rays.mean_knn_eps_scaled(n_win, radius)
    has_pore = geometry.pore_diameter(mols)[0] > 0.0
    path = rays.path_analysis(points, shifted, cfg.increment, l1)
    valid = (rays.preanalysis_open(points, shifted) & path.ok & has_pore[:, None]).contiguous()
    nbr = cluster.spiral_neighbor_candidates(n_win)
    args = (points, valid, eps, cfg.dbscan_min_samples, cfg.max_windows)
    spiral, _ = cluster.dbscan_spiral(points, valid, eps, nbr, *args[3:])
    kernel, _ = cluster_kernels.dbscan(*args)
    check(torch.equal(spiral, kernel), "dbscan_spiral: labels differ from the dbscan kernel's")
    t_spiral = time_ms(lambda: cluster.dbscan_spiral(points, valid, eps, nbr, *args[3:]))
    t_kernel = time_ms(lambda: cluster_kernels.dbscan(*args))
    dev_kernel = device_ms(lambda: cluster_kernels.dbscan_labels_cuda(*args))
    print(
        f"dbscan_spiral: {SWEEP_CHUNK} frames x {n_win} spiral points "
        f"({int(valid.sum())} valid, {nbr.shape[1]} candidates a point), {points.dtype}: "
        f"dbscan_spiral (torch operations) {t_spiral:.4f} ms (events); the dbscan kernel on the "
        f"same points {t_kernel:.4f} ms (events), {dev_kernel:.4f} ms (device, CUDA graph); "
        "labels equal"
    )


# -- phase 14: the walkthroughs and the validation suites --------------------

WALKTHROUGHS = ROOT / "docs" / "walkthroughs"
#: a fenced python block of a walkthrough (the regex of the walkthrough tests)
BLOCK_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def walkthrough_errors(key: str, ns: dict, cwd: pathlib.Path) -> dict[str, float]:
    """Walkthrough ``key``'s checks on its namespace, those of its CPU
    test with every golden held at :data:`TOL` -> {quantity: abs
    error}; a count, a file or a range not as the prose says raises."""
    props = ns.get("props")

    def pore_opt(p):
        return p["pore_diameter_opt"]["diameter"]

    def windows(gold):
        wins = props["windows"]["diameters"]
        check(wins is not None and len(wins) == len(gold), f"{key}: windows {wins}, want {len(gold)}")
        return float(np.abs(np.sort(np.asarray(wins, dtype=np.float64)) - np.sort(gold)).max())

    if key == "01":
        out = (cwd / "PUDXES_out.pdb").read_text().upper()
        check((cwd / "PUDXES_properties.json").exists(), "01: no PUDXES_properties.json")
        check(all(d in out for d in ("HE", "NE", "AR")), "01: the dummy atoms are not in the PDB")
        check(len(props["windows"]["diameters"]) == 4, "01: not 4 windows")
        return {"pore_opt": abs(pore_opt(props) - GOLD["PUDXES"]["pore"])}
    if key == "02":
        check(ns["mol"].no_of_atoms == 84, f"02: {ns['mol'].no_of_atoms} atoms")
        return {"pore": abs(props["pore_diameter"]["diameter"] - GOLD["PUDXES"]["pore"])}
    if key == "03":
        return {"avg": abs(ns["avg"] - GOLD["PUDXES"]["avg"])}
    if key in ("04", "05"):
        gold = GOLD["MIBQAR" if key == "04" else "SAYGOR"]
        return {"pore_opt": abs(pore_opt(props) - gold["pore_opt"]), "windows": windows(gold["windows"])}
    if key == "06":
        check(len(ns["molsys"].molecules) == 8 and len(ns["results"]) == 8, "06: not 8 cages")
        cages = [periodic_errors(p) for p in (props, *ns["results"].values())]
        return {q: max(c[q] for c in cages) for q in cages[0]}
    if key == "07":
        out = ns["traj"].analysis_output
        check(ns["traj"].no_of_frames == 20 and len(out) == 20, "07: not 20 frames analysed")
        check(len(ns["traj2"].analysis_output) == 20, "07: the saved analysis did not reload")
        check(pore_opt(props) > 3.0, "07: pore_opt <= 3")
        for frame, mols in out.items():
            check_finite(f"07 frame {frame}", mols["0"])
        return {}
    check(len(ns["mols"]) == 8 and 3.0 < pore_opt(ns["mols"][0]) < 7.0, "08: frame 0 is off")
    out = ns["traj"].analysis_output
    check(set(out) == {0, 1} and all(len(out[f]) == 8 for f in out), "08: not 8 cages in both frames")
    cages = [periodic_errors(p) for f in out for p in out[f].values()]
    return {q: max(c[q] for c in cages) for q in cages[0]}


#: per walkthrough: the blocks it skips (05's forcefield-names aside,
#: which SAYGOR does not need) and the kernels it must launch
WALKTHROUGH_RUNS = {
    "01_structural_properties.md": ((), PIPELINE_KERNELS),
    "02_rdkit_input.md": ((), PIPELINE_KERNELS),
    "03_average_diameter.md": ((), ("ray_exit",)),
    "04_mof.md": ((), PIPELINE_KERNELS),
    "05_metal_organic_cage.md": ((1,), PIPELINE_KERNELS),
    "06_periodic_system.md": ((), PIPELINE_KERNELS),
    "07_trajectory_single_molecule.md": ((), PIPELINE_KERNELS),
    "08_trajectory_periodic.md": ((), PIPELINE_KERNELS),
}


@contextlib.contextmanager
def rdkit_stand_in():
    """``rdkit.Chem.MolFromMol2File`` over the port's duck-typed Mol
    (``io.inputs.rdkit_like_mol``) unless a usable rdkit is installed:
    walkthrough 02's stand-in, as in its test."""
    try:
        import rdkit

        usable = hasattr(rdkit.Chem, "MolFromMol2File")
    except (ImportError, AttributeError):
        usable = False
    if usable:
        yield
        return
    import types

    from pywindow_torch.io.inputs import Input, rdkit_like_mol

    chem = types.ModuleType("rdkit.Chem")
    chem.MolFromMol2File = lambda path, removeHs=False: rdkit_like_mol(Input().load_file(path))
    rk = types.ModuleType("rdkit")
    rk.Chem = chem
    saved = {k: sys.modules.get(k) for k in ("rdkit", "rdkit.Chem")}
    sys.modules.update({"rdkit": rk, "rdkit.Chem": chem})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def run_walkthrough(name: str, cwd: pathlib.Path, skip: tuple) -> dict:
    """Execute the walkthrough's python blocks against ``pywindow_torch``
    (the package name replaced in memory) in one namespace, in ``cwd``,
    where ``tests/`` resolves to the checkout's; 08 first gets its
    two-frame ``periodic_traj.pdb``."""
    (cwd / "tests").symlink_to(ROOT / "tests")
    if name.startswith("08"):
        base = PERIODIC.read_text()
        (cwd / "periodic_traj.pdb").write_text((base[: base.rindex("END")] + "END\n") * 2)
    blocks = BLOCK_RE.findall((WALKTHROUGHS / name).read_text())
    check(len(blocks) > 0, f"{name}: no python blocks")
    ns: dict = {}
    here = os.getcwd()
    os.chdir(cwd)
    try:
        # the blocks' own prints (the prose's expected values) are dropped
        with rdkit_stand_in(), contextlib.redirect_stdout(io.StringIO()):
            for i, block in enumerate(blocks):
                if i not in skip:
                    code = block.replace("pywindow_tpu", "pywindow_torch")
                    exec(compile(code, f"{name}[block {i}]", "exec"), ns)
    finally:
        os.chdir(here)
    check(ns["pw"].__name__ == "pywindow_torch", f"{name}: not the port")
    return ns


def validation_case(case: str) -> tuple[dict, dict]:
    """One case of the reference's validation suites on the card, as its
    test reads it -> ({quantity: abs error}, launches): windows and their
    centres matched order-insensitively (case_5 at 0.05 Å), or the
    average diameter."""
    golden = json.loads((DATA / "validation_golden.json").read_text())[case]
    if case.startswith("avg_"):
        avg, launched = own_launches(
            f"validation {case}", ("ray_exit",),
            lambda: molecule(case).calculate_average_diameter(),
        )
        return {"avg": abs(avg - golden["average_diam"])}, launched
    mol = molecule(f"val_{case}")
    wins, launched = own_launches(f"validation {case}", PIPELINE_KERNELS, mol.calculate_windows)
    gold = golden["windows_diam"]
    if gold is None:
        check(wins is None, f"validation {case}: windows {wins}, want none")
        return {}, launched
    check(wins is not None and len(wins) == len(gold), f"validation {case}: windows {wins}")
    errs = {"windows": float(np.abs(np.sort(wins) - np.sort(gold)).max())}
    coms = mol.properties["windows"]["centre_of_mass"]
    taken: set = set()
    worst = 0.0
    for g in np.asarray(golden["windows_coms"]):
        order = np.argsort(np.linalg.norm(coms - g, axis=1))
        j = next(int(k) for k in order if int(k) not in taken)
        taken.add(j)
        worst = max(worst, float(np.abs(coms[j] - g).max()))
    errs["centres"] = worst
    return errs, launched


def phase_helpers() -> None:
    """The ``ops`` helpers on the card, on PUDXES: ``pore_diameter_opt``
    through the ``lbfgsb_stable`` kernel within :data:`TOL` of the
    golden, and ``ray_sphere_intersections`` reduced over atoms against
    the ``ray_exit`` kernel's ``any_front`` on the average-diameter
    spiral (no flip in float64; in float32 the kernel's algebraic front
    test may flip rays within rounding of tangency, counted as phase 3
    counts them)."""
    from pywindow_torch.ops import analysis, encoding, geometry, rays

    m = molecule("PUDXES")
    mol = encoding.encode_batch([(m.elements, m.coordinates)], device=DEVICE)
    (d, _, centre, _), launched = own_launches(
        "pore_diameter_opt", ("lbfgsb_stable",), lambda: analysis.pore_diameter_opt(mol)
    )
    err = abs(float(d[0]) - GOLD["PUDXES"]["pore"])
    print(
        f"helpers pore_diameter_opt (PUDXES, {mol.coords.dtype} pipeline): {float(d[0])!r} A at "
        f"{centre[0].tolist()}, abs err {err:.3e} A (tol {TOL}), launches {json.dumps(launched)}"
    )
    check(err < TOL, f"pore_diameter_opt: error {err} >= {TOL}")
    for dtype in (torch.float32, torch.float64):
        mm = mol.to(dtype)
        centred = geometry.shift_to(mm, torch.zeros(1, 3, dtype=dtype, device=DEVICE))
        maxd = geometry.max_dim_value(centred)
        points = rays.golden_spiral(rays.number_of_points(float(maxd[0])), maxd)
        inter = rays.ray_sphere_intersections(points, centred)
        (hit, _), _ = own_launches(
            "ray_exit", ("ray_exit",), lambda: rays.reversed_exit_distance(points, centred)
        )
        flips = int((inter.front.any(-1) != hit).sum())
        print(
            f"helpers ray_sphere_intersections (PUDXES, {dtype}, {tuple(inter.front.shape)} pairs): "
            f"{flips} of {hit.numel()} rays flip against the ray_exit kernel's any_front"
        )
        limit = 0 if dtype == torch.float64 else 0.005 * hit.numel()
        check(flips <= limit, f"ray_sphere_intersections {dtype}: {flips} rays flip")


def phase_walkthroughs() -> None:
    """The eight documented walkthroughs on the default device, the card
    (a float32 pipeline, float64 optimiser kernels), each against its
    goldens at :data:`TOL` and through its kernels; then the reference's
    two validation suites (five window cases, five average-diameter
    cases) and the ``ops`` helpers (:func:`phase_helpers`)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    for name, (skip, kernels) in WALKTHROUGH_RUNS.items():
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            cwd = pathlib.Path(tmp)
            t0 = time.perf_counter()
            ns, launched = own_launches(
                f"walkthrough {name}", kernels, lambda: run_walkthrough(name, cwd, skip)
            )
            seconds = time.perf_counter() - t0
            errs = walkthrough_errors(name[:2], ns, cwd)
        worst = max(errs.values(), default=0.0)
        print(
            f"walkthrough {name[:-3]}: {seconds:.3f} s, worst abs err {worst:.3e} A (tol {TOL}) "
            f"{json.dumps(errs)}, launches {json.dumps(launched)}"
        )
        check(worst < TOL, f"walkthrough {name}: error {worst} >= {TOL}")

    for suite, prefix in (("windows", "case_"), ("average diameter", "avg_case_")):
        worst, t0 = 0.0, time.perf_counter()
        for i in range(1, 6):
            case = f"{prefix}{i}"
            errs, launched = validation_case(case)
            tol = 0.05 if case == "case_5" else TOL
            print(f"  validation {case}: abs err {json.dumps(errs)} (tol {tol}), launches {json.dumps(launched)}")
            check(max(errs.values(), default=0.0) < tol, f"validation {case}: {errs} beyond {tol} A")
            worst = max(worst, *errs.values()) if errs else worst
        print(
            f"validation suite {suite}: 5 cases within tolerance, worst abs err {worst:.3e} A, "
            f"{time.perf_counter() - t0:.3f} s"
        )
    phase_helpers()


# -- phase 12: the frame mesh and the multi-process sweep --------------------

#: the sweep's force-field options (phase 6's)
SWEEP_FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
#: seconds a rank of phase 12 may run (start-up, kernel load, two sweeps)
RANK_TIMEOUT = 300


def frame_dicts(traj) -> dict:
    return {f: traj.analysis_output[f]["0"] for f in traj.analysis_output}


def same_frames(label: str, got: dict, ref: dict) -> None:
    """Every frame's dict equal to the reference's: the same keys, types
    and shapes, every value bit for bit."""
    check(sorted(got) == sorted(ref), f"{label}: {len(got)} frames against {len(ref)}")
    for f in ref:
        try:
            same_dicts([got[f]], [ref[f]])
        except AssertionError as exc:
            raise AssertionError(f"{label} frame {f}: {exc}") from exc


def mesh_sweep(path: pathlib.Path, device, chunk: int | None = SWEEP_CHUNK) -> tuple[dict, float]:
    """One 4,320-frame ``analysis_batched`` on ``device`` in chunks of
    ``chunk`` frames (learned caps cleared): its dicts and seconds, from
    the map to the last result."""
    import pywindow_torch as pt

    from pywindow_torch.parallel import batch

    batch.LEARNED_CAPS._caps.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = pt.DLPOLY(path)
    traj.analysis_batched(batch_size=chunk, device=device, **SWEEP_FF)
    torch.cuda.synchronize()
    return frame_dicts(traj), time.perf_counter() - t0


def timed_turns(label: str, path: pathlib.Path, specs: dict, ref: dict, chunk=SWEEP_CHUNK) -> dict:
    """Time the sweep on each ``{name: device}`` of ``specs`` in turns,
    forward then backward (the spread of one position shows), every run
    equal to ``ref``; prints and returns frames/s by name."""
    rates: dict = {name: [] for name in specs}
    for name in list(specs) + list(specs)[::-1]:
        got, seconds = mesh_sweep(path, specs[name], chunk)
        same_frames(f"{label} {name}", got, ref)
        rates[name].append(SWEEP_FRAMES / seconds)
    shown = "; ".join(f"{name} {json.dumps([round(r, 1) for r in v])}" for name, v in rates.items())
    print(f"{label}: {shown} frames/s; all {SWEEP_FRAMES} frames equal to (a) on cuda:0 bit for bit")
    return rates


def rank_worker(argv: list[str]) -> None:
    """One rank of phase 12, run as ``python3 chip_smoke.py --rank-worker
    RANK WORLD PORT BACKEND DEVICE HISTORY OUT``: joins the process group,
    sweeps HISTORY through ``analysis_batched_distributed`` twice (the
    first run loads the kernels; the second, with ``override``, is the
    warm one and must equal the first), and pickles its report to OUT:
    the frames it decoded, its kernel launches over the first run, both
    runs' seconds, whether JAX was loaded, and every frame's dict."""
    import pywindow_torch as pt

    from pywindow_torch.ops import _cuda
    from pywindow_torch.parallel import distributed, mesh

    rank, world, port, backend, device, path, out = argv
    dev = distributed.initialize(f"127.0.0.1:{port}", int(world), int(rank), backend=backend)
    traj = pt.DLPOLY(path)
    decoded: list = []
    decode = traj._decode_uniform

    def spy(frames, *args):
        decoded.append([frames[0], frames[-1], len(frames)])
        return decode(frames, *args)

    traj._decode_uniform = spy
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    plan = distributed.analysis_batched_distributed(
        traj, device=device, batch_size=SWEEP_CHUNK, **SWEEP_FF
    )
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: _cuda.LAUNCHES[k] for k in KERNELS}
    first = frame_dicts(traj)
    t0 = time.perf_counter()
    distributed.analysis_batched_distributed(
        traj, device=device, batch_size=SWEEP_CHUNK, override=True, **SWEEP_FF
    )
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    same_frames(f"rank {rank}: warm against cold", frame_dicts(traj), first)
    report = {
        "rank": int(rank), "device": str(dev), "backend": torch.distributed.get_backend(),
        "devices": [str(mesh.frame_device(device))],
        "ranks_on": mesh.ranks_on(dev), "decoded": decoded, "launches": launches,
        "cold_s": cold, "warm_s": warm, "plan": plan,
        "jax": [m for m in ("jax", "pywindow_tpu") if m in sys.modules],
        "output": frame_dicts(traj),
    }
    with open(out, "wb") as fh:
        pickle.dump(report, fh)
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(
    label: str, path: pathlib.Path, world: int, backend: str, device: str, one_card: bool = False
) -> list[dict]:
    """``world`` ranks of :func:`rank_worker` as subprocesses (``LOCAL_RANK``
    and ``LOCAL_WORLD_SIZE`` set as ``torchrun`` sets them; ``one_card``:
    only the first card visible to them); their reports.  A rank that
    fails, or runs past :data:`RANK_TIMEOUT`, fails the phase; every rank
    is stopped before this returns."""
    port = free_port()
    outdir = ROOT / "build" / "phase12"
    outdir.mkdir(parents=True, exist_ok=True)
    outs = [outdir / f"{label}-{r}.pkl" for r in range(world)]
    for out in outs:
        out.unlink(missing_ok=True)
    procs = []
    for r in range(world):
        env = {**os.environ, "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world)}
        if one_card:
            env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        cmd = [
            sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", str(r), str(world),
            str(port), backend, device, str(path), str(outs[r]),
        ]
        procs.append(
            subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        )
    t0 = time.perf_counter()
    logs = []
    try:
        for proc in procs:
            left = max(1.0, RANK_TIMEOUT - (time.perf_counter() - t0))
            logs.append(proc.communicate(timeout=left)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"{label}: rank {r} exited {proc.returncode}:\n{log[-3000:]}")
    reports = []
    for out in outs:
        with out.open("rb") as fh:
            reports.append(pickle.load(fh))
    print(f"{label}: {world} ranks ({backend}, device {device}) ran {wall:.3f} s as processes")
    return reports


def check_ranks(label: str, reports: list[dict], ref: dict, world: int) -> float:
    """Every rank: decoded only its own shard, launched the seven pipeline
    kernels, loaded no JAX, ran the same plan and holds all frames equal
    to ``ref`` bit for bit.  Returns the slowest rank's warm seconds."""
    from pywindow_torch.parallel.distributed import _shard_frames

    shards = _shard_frames(list(range(SWEEP_FRAMES)), world)
    for rep in reports:
        r = rep["rank"]
        own = shards[r]
        print(
            f"{label} rank {r}: device {rep['device']} (sweeps on {rep['devices']}), backend "
            f"{rep['backend']}, ranks on its card {rep['ranks_on']}, decoded {rep['decoded']}, "
            f"launches {json.dumps(rep['launches'])}, cold {rep['cold_s']:.4f} s, warm "
            f"{rep['warm_s']:.4f} s, pin and sizes {rep['plan']}, modules {rep['jax']}"
        )
        check(not rep["jax"], f"{label} rank {r}: loaded {rep['jax']}")
        check(
            all(d == [own[0], own[-1], len(own)] for d in rep["decoded"]),
            f"{label} rank {r}: decoded {rep['decoded']}, not its own shard",
        )
        for key in PIPELINE_KERNELS:
            check(rep["launches"][key] > 0, f"{label} rank {r}: {key} did not launch")
        check(rep["plan"] == reports[0]["plan"], f"{label} rank {r}: another plan")
        same_frames(f"{label} rank {r}", rep["output"], ref)
    return max(rep["warm_s"] for rep in reports)


def phase_mesh(pipeline_calls: list, smi: str) -> None:
    """Phase 12: the frame mesh and the multi-process sweep on the
    4,320-frame history of phase 6 at batch_size 1,440 (profiling off):
    (a) ``analysis_batched(device="cuda")`` against ``device="cuda:0"``,
    the first ``"cuda"`` run a main path (launches counted, every
    pipeline call's launches recorded), then timed in turns; (c) two
    gloo ranks on cuda:0; (d) one NCCL rank; (e) with more cards, one
    NCCL rank a card.  Every leg's 4,320 dicts equal (a)'s on cuda:0
    bit for bit."""
    from pywindow_torch import profiling
    from pywindow_torch.parallel import mesh

    was_on = profiling.enabled()
    profiling.enable(False)
    path = synth_history(SWEEP_FRAMES)
    n_cards = torch.cuda.device_count()
    try:
        # the reference, untimed
        ref, _ = mesh_sweep(path, "cuda:0")
        check(len(ref) == SWEEP_FRAMES, f"mesh: {len(ref)} frames on cuda:0")
        with main_path("frame mesh", pipeline_calls):
            got, _ = mesh_sweep(path, "cuda")
        same_frames('(a) device="cuda"', got, ref)
        timed_turns(
            f'(a) device="cuda" (on {mesh.frame_device("cuda")}) against "cuda:0"', path,
            {"cuda": "cuda", "cuda:0": "cuda:0"}, ref,
        )

        reports = run_ranks("(c)", path, 2, "gloo", "cuda:0", one_card=True)
        slowest = check_ranks("(c)", reports, ref, 2)
        check(all(rep["ranks_on"] == 2 for rep in reports), "(c): the ranks do not share the card's budget")
        print(
            f"(c) two gloo ranks on cuda:0: {SWEEP_FRAMES / slowest:.1f} frames/s (the slower rank's "
            f"warm sweep, {slowest:.4f} s); both ranks hold all {SWEEP_FRAMES} frames equal to (a)"
        )

        reports = run_ranks("(d)", path, 1, "nccl", "cuda")
        slowest = check_ranks("(d)", reports, ref, 1)
        print(
            f"(d) one nccl rank: {SWEEP_FRAMES / slowest:.1f} frames/s ({slowest:.4f} s warm); "
            f"all {SWEEP_FRAMES} frames equal to (a)"
        )

        if n_cards > 1:
            reports = run_ranks("(e)", path, n_cards, "nccl", "cuda")
            slowest = check_ranks("(e)", reports, ref, n_cards)
            print(
                f"(e) {n_cards} nccl ranks, one a card: {SWEEP_FRAMES / slowest:.1f} frames/s "
                f"({slowest:.4f} s warm); all {SWEEP_FRAMES} frames equal to (a)"
            )
        else:
            print(f"(e) not run: {n_cards} card (it needs more than one)")
        print(f"frame mesh and multi-process sweep: card {smi}")
    finally:
        profiling.enable(was_on)


#: seconds the bench subprocess of phase 13 may take
BENCH_TIMEOUT = 600


def phase_bench() -> None:
    """Phase 13: ``python -m pywindow_torch bench`` in a subprocess at full
    size, on the card: exit code 0, its last line the compact headline
    (under 1,000 bytes), the line before it the full record, whose gate
    passed and whose CC3 batch launched all seven pipeline kernels."""
    torch.cuda.empty_cache()  # the bench sizes its batches by free memory
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pywindow_torch", "bench"], cwd=ROOT, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench: exit code {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) >= 2, f"bench: {len(lines)} lines of output")
    check(len(lines[-1].encode()) < 1000, f"bench: a headline of {len(lines[-1].encode())} bytes")
    head, record = json.loads(lines[-1]), json.loads(lines[-2])
    check(head["value"] == record["value"] > 0, f"bench: headline {head}")
    check(record["gate"]["pass"], "bench: the gate failed")
    launched = {k["name"]: k["launches"] for k in record["kernels"]}
    missing = [k for k in PIPELINE_KERNELS if launched.get(k, 0) == 0]
    check(not missing, f"bench: {missing} not launched")
    rows = {
        row: [round(record[row][k], 1) for k in ("fps_median", "fps_min", "fps_max")]
        for row in ("kernel", "e2e", "mibqar_kernel", "reymal_kernel", "mibqar_e2e")
    }
    print(
        f"bench: {seconds:.1f} s (subprocess); frames/s median, min, max {json.dumps(rows)}; "
        f"launches per pipeline call {json.dumps(launched)}"
    )
    print(f"bench headline: {lines[-1]}")


def main() -> None:
    smi = phase_card()
    phase_build()
    record = phase_kernels()

    calls: list = []
    t0 = time.perf_counter()
    with main_path("gate", calls):
        phase_gate()
    print(f"gate: 7 systems in {time.perf_counter() - t0:.2f} s")
    with main_path("batched gate", calls):
        phase_batched_gate()
    with main_path("sweep", calls):
        traj, maxd = phase_sweep(calls)
    pin = float(maxd.max())
    phase_sweep_samples(traj, pin)
    elements, coords = phase_sweep_routes(traj, maxd)
    phase_sweep_escalation(elements, coords)
    phase_mesh(calls, smi)
    phase_bench()
    phase_profile(pin)
    with main_path("periodic system", calls):
        phase_periodic_system()
    with main_path("periodic trajectory", calls):
        periodic = phase_periodic_trajectory(calls)
    phase_periodic_serial(periodic)
    from pywindow_torch.ops import pair_kernels
    from pywindow_torch.ops.clearance_kernels import HELPER_KERNELS

    with main_path("clearance grid", calls, kernels=("clearance_min",) + HELPER_KERNELS):
        phase_clearance_grid()
    with main_path("surface", calls):
        phase_surface()
    with main_path("walkthroughs", calls):
        phase_walkthroughs()
    phase_dbscan_spiral(pin)

    per_call = {json.dumps(delta, sort_keys=True) for _, _, delta, _ in calls}
    sizes = sorted({b for _, b, _, _ in calls})
    print(f"launches per pipeline call over {len(calls)} calls (B in {sizes}): {sorted(per_call)}")
    check(len(per_call) == 1, "launches per pipeline call depend on the batch")

    def launches(key):
        path = "clearance grid" if key == "clearance_min" else "sweep"
        return main_path.launches[path][key]

    # the helper passes, launched once with each launch of their kernel
    helpers = {
        "clearance_min": {k: main_path.launches["clearance grid"][k] for k in HELPER_KERNELS},
        "max_dim": {k: main_path.launches["sweep"][k] for k in pair_kernels.HELPER_KERNELS},
    }

    kernels = [
        {
            "name": key,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches(key),
            "max_abs_err": record[key]["max_abs_err"],
            "ms": record[key]["ms"],
            "device_ms": record[key]["device_ms"],
            "plain_ms": record[key]["plain_ms"],
            "bound_ms": record[key]["bound_ms"],
            "bound_by": record[key]["bound_by"],
            "library_ms": record[key]["library_ms"],
            **({"helper_launches": helpers[key]} if key in helpers else {}),
        }
        for key, (src, replaces) in KERNELS.items()
    ]
    check(all(math.isfinite(k["ms"]) for k in kernels), "timings not finite")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


def main_mesh() -> None:
    """``--mesh``: phases 1, 2 and 12 alone (the frame mesh on every
    card of the machine), without the kernels' line or the ok line."""
    smi = phase_card()
    phase_build()
    calls: list = []
    phase_mesh(calls, smi)
    per_call = {json.dumps(delta, sort_keys=True) for _, _, delta, _ in calls}
    print(f"frame mesh: launches per pipeline call {sorted(per_call)}")
    check(len(per_call) == 1, "launches per pipeline call depend on the batch")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--mesh"]:
        main_mesh()
    else:
        main()
