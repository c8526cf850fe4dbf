"""Faults planted under the timed path, each of which ``correct`` has to
catch (not part of a benchmark run; :mod:`portbench.control` and the
tests drive them):

- ``answer_altered``: every optimised pore diameter comes out 0.1 A
  wider, where the pipeline produces it;
- ``half_left_out``: a sweep (one process's or the ranks') files only
  every other frame's answers;
- ``exchange_left_out``: the ranks exchange no rows, each filling the
  other ranks' frames with its own.
"""

from __future__ import annotations

import contextlib
import importlib

#: column of the optimised pore diameter in a packed result row
#: (``ops.analysis.pack_results``)
PORE_OPT_COLUMN = 5


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, inside the block."""
    if fault == "answer_altered":
        mod = importlib.import_module("pywindow_torch.ops.analysis")
        orig = mod.run_pipeline

        def run_pipeline(*args, **kwargs):
            flat = orig(*args, **kwargs)
            flat[:, PORE_OPT_COLUMN] += 0.1
            return flat

        target, attr, new = mod, "run_pipeline", run_pipeline
    elif fault == "half_left_out":
        mod = importlib.import_module("pywindow_torch.parallel.distributed")
        traj_mod = importlib.import_module("pywindow_torch.trajectory")
        orig = (traj_mod.Trajectory.analysis_batched, mod.analysis_batched_distributed)

        def drop_half(traj) -> None:
            for frame in list(traj.analysis_output)[1::2]:
                del traj.analysis_output[frame]

        def analysis_batched(self, *args, **kwargs):
            orig[0](self, *args, **kwargs)
            drop_half(self)

        def analysis_batched_distributed(traj, *args, **kwargs):
            out = orig[1](traj, *args, **kwargs)
            drop_half(traj)
            return out

        traj_mod.Trajectory.analysis_batched = analysis_batched
        try:
            with _swap(mod, "analysis_batched_distributed", analysis_batched_distributed):
                yield
        finally:
            traj_mod.Trajectory.analysis_batched = orig[0]
        return
    elif fault == "exchange_left_out":
        mod = importlib.import_module("pywindow_torch.parallel.distributed")

        def _gather_rows(block, redone, device):
            import torch.distributed as dist

            n = dist.get_world_size()
            return [block.copy() for _ in range(n)], [dict(redone) for _ in range(n)]

        target, attr, new = mod, "_gather_rows", _gather_rows
    else:
        raise KeyError(fault)
    with _swap(target, attr, new):
        yield


@contextlib.contextmanager
def _swap(target, attr: str, new):
    orig = getattr(target, attr)
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, orig)


def applicable(cell: str) -> list[str]:
    """The faults a cell can have: every cell an altered answer, the
    sweeps half a batch left out, the ranks the exchange."""
    from portbench import run

    traffic = run.load_cell(cell)[1]["traffic"]
    out = ["answer_altered"]
    if traffic != "single":
        out.append("half_left_out")
    if traffic == "ranks_sweep":
        out.append("exchange_left_out")
    return out


def run_with(fault: str, cell: str, seed: int, device, overrides: dict | None = None,
             seconds: float = 1.0) -> dict:
    """One run of ``cell`` with ``fault`` planted: what ``correct`` read."""
    import os

    from portbench import run
    from portbench.drivers import ranks_sweep

    os.environ[ranks_sweep.FAULT_ENV] = fault
    try:
        with planted(fault):
            out = run.run_cell(cell, seed, seconds, False, device=device, overrides=overrides)
    finally:
        del os.environ[ranks_sweep.FAULT_ENV]
    return {"fault": fault, "seed": seed, "correct": out["correct"], "failed": out["failed"],
            "checks": {k: v["value"] for k, v in out["checks"].items()}}
