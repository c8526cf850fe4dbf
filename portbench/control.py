"""The readings that the limits of ``correct`` are set from, for one cell
and many seeds in one process (not part of a benchmark run):

- ``program``: the numbers that a run compares, from a short window of
  the cell's own traffic at its own size (the lower readings);
- ``control``: the same numbers with the reference computed in the
  nearest precisions below the configuration's (the pipeline in
  bfloat16, the optimisers in float32) put in the program's place (the
  upper readings).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --units 2

prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, run  # noqa: E402

CONTROL = (torch.bfloat16, torch.float32)


def readings(name: str, seed: int, units: int, device, overrides: dict | None = None) -> dict:
    """The program's and the control's numbers for one seed."""
    _, cell, config, params = run.load_cell(name)
    for key, value in (overrides or {}).items():
        (config if key in config else params)[key] = value
    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']}")
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="portbench-control-"))
    ctx = run.Context(
        cell=name, seed=seed, seconds=0.0, trace=False, params=params, config=config,
        device=torch.device(device), chips=int(cell["chips"]), workdir=workdir,
    )
    state = driver.setup(ctx)
    try:
        done: dict = {}
        t0 = time.perf_counter()
        for _ in range(units):
            for k, v in driver.unit(state).items():
                done[k] = done.get(k, 0) + v
        window = time.perf_counter() - t0
        driver.after(state, {"units": done, "span_units": done})
        t0 = time.perf_counter()
        attempted, failed, checks = driver.check(state, {"units": done, "span_units": done})
        ref_s = time.perf_counter() - t0
        refs = driver.references(state)
        ctrl = driver.references(state, *CONTROL)
        tally = compare.Tally()
        answers = {k: [compare.as_answer(r) for r in v] for k, v in ctrl.items()}
        edge = getattr(getattr(state, "traj", None), "edge", None)
        compare.compare_all(tally, answers, refs, edge)
    finally:
        driver.close(state)
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "seed": seed, "units": done, "window_s": window, "check_s": ref_s,
        "attempted": attempted, "failed": failed,
        "program": {c["name"]: c["value"] for c in checks},
        "control": tally.values,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.units, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
