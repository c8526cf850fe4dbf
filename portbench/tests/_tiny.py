"""Shared set-up of the CPU tests: the tiny sizes each cell's driver runs
at here, the float32 dtype policy of the card, and a helper that runs a
snippet in a fresh interpreter."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: per cell: overrides that shrink it to a CPU test (the card's shapes
#: stay: the same molecules, fewer of them)
TINY = {
    "cc3_md.sweep": {"trajectory_frames": 40, "batch_size": 20, "sample": 4, "trace_units": 1,
                     "roofline_frames": 20},
    "cc3_md.single": {"pool": 20, "sample": 8, "trace_units": 2},
    "cc3_periodic.rebuild": {"frames": 2, "batch_size": 2, "sample": 8},
    "cc3_md_4rank.sweep": {"trajectory_frames": 40, "batch_size": 10, "sample": 4, "ranks": 2,
                           "trace_units": 1},
}
#: per cell: the window (s) of a tiny run; the single cell's comparison
#: takes medians over the sampled answers, so it serves a few more
SECONDS = {"cc3_md.single": 4.0}
#: the card's dtypes on the CPU (float32 pipeline, stable optimisers)
ENV = {"PYWINDOW_TORCH_FORCE_F32": "1"}


def card_dtypes(monkeypatch) -> None:
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def fresh(code: str, timeout: float = 600) -> dict:
    """Run ``code`` (which prints one JSON line last) in a new interpreter
    from the repository's root; its parsed last line."""
    env = {**os.environ, **ENV, "PYTHONPATH": str(ROOT)}
    got = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout, check=True,
    )
    return json.loads(got.stdout.strip().splitlines()[-1])
