"""Traffic kind ``md_sweep``: one client sweeps a seeded DL_POLY HISTORY
again and again, each sweep a new ``DLPOLY(path).analysis_batched(...)``
from the file to the properties dicts; the next starts when the last
ends.  The harness keeps a seeded sample of each sweep's dicts and
releases the rest before the next sweep.

Configuration keys: ``fixture``, ``trajectory_frames``, ``swap_atoms``,
``forcefield``.  Traffic keys: ``batch_size``, ``shift_A`` (the frames'
translations), ``sample`` (frames compared), ``trace_units``,
``roofline_frames``, ``limits``.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from portbench import compare
from portbench.inputs import history, seeded
from portbench.reference import molecules, pipeline
from portbench.roofline import bound


@dataclasses.dataclass
class State:
    ctx: object
    hist: history.History
    sample: np.ndarray
    kept: list = dataclasses.field(default_factory=list)
    last: dict | None = None
    missing: int = 0


def sweep(state: State, frames="all") -> dict:
    """One sweep of the cell's file (``frames``: all, or a list)."""
    import pywindow_torch as pt

    ctx, conf = state.ctx, state.ctx.config
    traj = pt.DLPOLY(state.hist.path)
    traj.analysis_batched(
        frames=frames, swap_atoms=conf["swap_atoms"], forcefield=conf["forcefield"],
        batch_size=ctx.params["batch_size"], device=ctx.device,
    )
    return traj.analysis_output


def setup(ctx) -> State:
    """Write the seeded HISTORY and sweep it once, untimed (the kernels
    and native libraries load or build, the sweep sees its shapes)."""
    conf = ctx.config
    n = int(conf["trajectory_frames"])
    hist = history.write(
        ctx.workdir / "HISTORY", n, ctx.seed, conf["fixture"], float(ctx.params["shift_A"]),
        ctx.device,
    )
    pick = seeded.rng(ctx.seed, 10).choice(n, size=int(ctx.params["sample"]), replace=False)
    state = State(ctx=ctx, hist=hist, sample=np.sort(pick))
    sweep(state)
    return state


def unit(state: State) -> dict:
    state.last = None  # the previous sweep's output goes before the next
    out = sweep(state)
    n = state.hist.n_frames
    got = sum(1 for v in out.values() if "0" in v)
    state.missing += n - got
    state.kept.append(
        {int(k): compare.snapshot(out.get(int(k), {}).get("0")) for k in state.sample}
    )
    state.last = out
    return {"frames": got}


def after(state: State, readings: dict) -> dict:
    """Answers of the last sweep that are not finite count as missing."""
    if state.last is not None:
        state.missing += sum(
            1 for v in state.last.values() if not compare.answer_ok(v.get("0"))
        )
    state.last = None
    return {}


def rooflines(state: State) -> dict:
    """Each recorded kernel's (bound, device ms alone) over the calls of
    one chunk of the cell's own size."""
    k = min(int(state.ctx.params["roofline_frames"]), state.hist.n_frames)
    seen: dict = {}
    with bound.recording(seen):
        sweep(state, frames=list(range(k)))
    out = {}
    for key, calls in seen.items():
        modname, attr = bound.WRAPPERS[key]
        out[key] = bound.roofline(key, calls, getattr(importlib.import_module(modname), attr))
    return out


def answers(state: State) -> dict:
    """The program's kept answers by frame, one a sweep."""
    return {int(k): [kept[int(k)] for kept in state.kept] for k in state.sample}


def references(state: State, dtype=torch.float64, opt_dtype=torch.float64) -> dict:
    """The reference's result of each sampled frame (parsed from the
    file), at the sweep's sampling sizes: pinned by the largest maximum
    diameter of the whole file, the ray paths covering it."""
    conf, device = state.ctx.config, state.ctx.device
    frames = history.read_frames(state.hist, state.sample)
    els = molecules.elements(state.hist.keys, conf["swap_atoms"], conf["forcefield"])
    pin = float(molecules.max_diameters(els, state.hist.coords, device).max())
    sizes = pipeline.batch_sizes(pin, pin, pipeline.CFG)
    got = pipeline.analyse([(els, f) for f in frames], sizes, device, dtype, opt_dtype)
    return {int(k): [r] for k, r in zip(state.sample, got)}


def check(state: State, readings: dict) -> tuple[int, int, list]:
    """Every kept sample of every sweep against the reference."""
    ctx = state.ctx
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare.Tally()
    compare.compare_all(tally, answers(state), references(state))
    tally.missing += state.missing
    attempted = sum(readings["units"].values()) + state.missing
    return attempted, state.missing, tally.checks(ctx.params["limits"])


def close(state: State) -> None:
    state.last = None
    state.kept.clear()
