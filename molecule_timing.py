"""Warm wall seconds of one molecule's ``full_analysis()`` on the card.

    python3 molecule_timing.py [--repeats N] [--ballast F]

Loads PUDXES and REYMAL (``tests/data``), runs each once to build and
warm the kernels, then times ``N`` further runs of each, interleaved
(host wall clock, the card synchronised on each side), and prints one
JSON line per molecule with every reading, their median and the cyclic
garbage collector's passes of its oldest generation during the timed
runs.  ``--ballast F`` first keeps ``F`` copies of PUDXES's property
dict alive, as many dicts as a sweep of ``F`` frames returns, so that
the collector's passes have that many objects to walk.

It calls only ``MolecularSystem.load_file(...).system_to_molecule()
.full_analysis()``, so it runs alike on any tree of the package: copy it
into an older checkout to compare two trees in one run on the card.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import pywindow_torch as pt  # noqa: E402

MOLECULES = ("PUDXES", "REYMAL")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=9)
    ap.add_argument("--ballast", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("molecule_timing: no CUDA device")

    mols = {
        name: pt.MolecularSystem.load_file(ROOT / "tests" / "data" / f"{name}.xyz")
        .system_to_molecule()
        for name in MOLECULES
    }
    first = {name: m.full_analysis() for name, m in mols.items()}
    ballast = [copy.deepcopy(first["PUDXES"]) for _ in range(args.ballast)]

    passes = {"n": 0}

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start" and info["generation"] == 2:
            passes["n"] += 1

    readings: dict = {name: [] for name in MOLECULES}
    gc_passes: dict = dict.fromkeys(MOLECULES, 0)
    gc.callbacks.append(on_gc)
    try:
        for _ in range(args.repeats):
            for name, m in mols.items():
                before = passes["n"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.full_analysis()
                torch.cuda.synchronize()
                readings[name].append(time.perf_counter() - t0)
                gc_passes[name] += passes["n"] - before
    finally:
        gc.callbacks.remove(on_gc)
    for name in MOLECULES:
        print(
            json.dumps(
                {
                    "molecule": name,
                    "ballast_dicts": len(ballast),
                    "median_ms": statistics.median(readings[name]) * 1e3,
                    "ms": [t * 1e3 for t in readings[name]],
                    "gen2_gc_passes": gc_passes[name],
                }
            )
        )


if __name__ == "__main__":
    main()
