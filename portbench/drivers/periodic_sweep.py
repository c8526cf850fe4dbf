"""Traffic kind ``periodic_sweep``: one client sweeps a seeded periodic
PDB trajectory again and again, each sweep a new
``PDB(path).analysis_batched(modular=True, rebuild=True, ...)``: every
frame's molecules made whole across the boundary, then analysed as one
batch of cages; the next sweep starts when the last ends.

Configuration keys: ``fixture``, ``forcefield``, ``molecules``,
``molecule_atoms``.
Traffic keys: ``frames``, ``batch_size``, ``sample`` (cages compared,
whole frames of them), ``trace_units``, ``limits``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import compare
from portbench.inputs import periodic, seeded
from portbench.reference import molecules, pipeline


@dataclasses.dataclass
class State:
    ctx: object
    traj: periodic.Periodic
    sample: np.ndarray
    kept: list = dataclasses.field(default_factory=list)
    missing: int = 0


def sweep(state: State) -> dict:
    import pywindow_torch as pt

    ctx = state.ctx
    traj = pt.PDB(state.traj.path)
    traj.analysis_batched(
        frames="all", modular=True, rebuild=True, forcefield=ctx.config["forcefield"],
        batch_size=int(ctx.params["batch_size"]), device=ctx.device,
    )
    return traj.analysis_output


def setup(ctx) -> State:
    """Write the seeded trajectory and sweep it once, untimed."""
    n = int(ctx.params["frames"])
    traj = periodic.write(ctx.workdir / "trajectory.pdb", n, ctx.seed, ctx.config["fixture"])
    per = int(ctx.config["molecules"])
    frames = max(1, int(ctx.params["sample"]) // per)
    pick = seeded.rng(ctx.seed, 12).choice(n, size=min(n, frames), replace=False)
    state = State(ctx=ctx, traj=traj, sample=np.sort(pick))
    sweep(state)
    return state


def unit(state: State) -> dict:
    out = sweep(state)
    conf = state.ctx.config
    cages = 0
    for f in range(state.traj.coords.shape[0]):
        mols = out.get(f, {})
        whole = [p for p in mols.values() if p.get("no_of_atoms") == conf["molecule_atoms"]]
        cages += len(whole)
        state.missing += int(conf["molecules"]) - len(whole)
    state.kept.append({int(f): [compare.snapshot(p) for p in out.get(int(f), {}).values()]
                       for f in state.sample})
    return {"cages": cages, "frames": state.traj.coords.shape[0]}


def after(state: State, readings: dict) -> dict:
    return {}


def answers(state: State) -> dict:
    """The program's cages of each sampled frame, every sweep's."""
    return {int(f): [p for kept in state.kept for p in kept[int(f)]] for f in state.sample}


def references(state: State, dtype=torch.float64, opt_dtype=torch.float64) -> dict:
    """The reference's cages of each sampled frame: its own rebuild of
    every frame (the chunk's sampling pin is the largest maximum
    diameter of its cages, the ray paths cover the largest bound)."""
    ctx, t = state.ctx, state.traj
    els = molecules.elements(t.names, None, ctx.config["forcefield"])
    cages = {f: molecules.rebuild(els, t.coords[f], t.edge) for f in range(t.coords.shape[0])}
    every = [m for f in cages for m in cages[f]]
    pin = max(pipeline.max_dim_host(e, c) for e, c in every)
    largest = max(pipeline.max_dim_bound(e, c) for e, c in every)
    sizes = pipeline.batch_sizes(pin, largest, pipeline.CFG)
    picked = [(int(f), m) for f in state.sample for m in cages[int(f)]]
    got = pipeline.analyse([m for _, m in picked], sizes, ctx.device, dtype, opt_dtype)
    out: dict = {}
    for (f, _), r in zip(picked, got):
        out.setdefault(f, []).append(r)
    return out


def check(state: State, readings: dict) -> tuple[int, int, list]:
    """Every cage of the sampled frames, in every sweep, against the
    reference cage whose centre of mass it matches modulo the lattice."""
    ctx = state.ctx
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare.Tally()
    compare.compare_all(tally, answers(state), references(state), state.traj.edge)
    tally.missing += state.missing
    attempted = readings["units"].get("cages", 0) + state.missing
    return attempted, state.missing, tally.checks(ctx.params["limits"])


def close(state: State) -> None:
    state.kept.clear()
