"""Traffic kind ``single``: one client asks for one structure at a time,
``MolecularSystem.load_file(xyz).system_to_molecule().full_analysis()``
to its properties dict, cycling a seeded pool of XYZ files written in
set-up; the next request starts when the last ends.

Configuration keys: ``fixture``, ``swap_atoms``, ``forcefield``.  Traffic
keys: ``pool`` (files, a multiple of the fixture's frames), ``shift_A``,
``sample`` (served files compared), ``trace_units``, ``limits``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from portbench import compare
from portbench.inputs import fixtures, seeded, structures
from portbench.reference import molecules, pipeline


@dataclasses.dataclass
class State:
    ctx: object
    pool: structures.Pool
    served: int = 0
    answers: list = dataclasses.field(default_factory=list)
    load_s: list = dataclasses.field(default_factory=list)


def request(state: State, k: int) -> dict:
    """One request for pool file ``k``; books its load time."""
    import pywindow_torch as pt

    t0 = time.perf_counter()
    mol = pt.MolecularSystem.load_file(state.pool.paths[k]).system_to_molecule()
    state.load_s.append(time.perf_counter() - t0)
    return mol.full_analysis(device=state.ctx.device)


def setup(ctx) -> State:
    """Write the pool and serve one file of each source frame, untimed."""
    conf = ctx.config
    keys = fixtures.atom_keys(fixtures.history(conf["fixture"])[1])
    els = molecules.elements(keys, conf.get("swap_atoms"), conf.get("forcefield"))
    n = int(ctx.params["pool"])
    pool = structures.write(ctx.workdir, n, ctx.seed, conf["fixture"], els, float(ctx.params["shift_A"]))
    state = State(ctx=ctx, pool=pool)
    for src in np.unique(pool.source):
        request(state, int(np.flatnonzero(pool.source == src)[0]))
    state.load_s.clear()
    return state


def unit(state: State) -> dict:
    k = state.served % len(state.pool.paths)
    props = request(state, k)
    state.served += 1
    state.answers.append((k, props))
    return {"structures": 1}


def after(state: State, readings: dict) -> dict:
    """The mean load time of the span window's requests."""
    done = readings["span_units"].get("structures", 0)
    return {"load_s": float(np.sum(state.load_s[-done:])) if done else 0.0}


def sample(state: State) -> list[int]:
    """The files compared: drawn from the seed, once the window has
    closed, among the files served."""
    served = sorted({k for k, _ in state.answers})
    n = min(len(served), int(state.ctx.params["sample"]))
    return sorted(served[i] for i in seeded.rng(state.ctx.seed, 11).choice(len(served), n, replace=False))


def answers(state: State) -> dict:
    """The program's answers for each sampled file, one a request."""
    out = {k: [] for k in sample(state)}
    for k, props in state.answers:
        if k in out:
            out[k].append(props)
    return out


def references(state: State, dtype=torch.float64, opt_dtype=torch.float64) -> dict:
    """The reference's result of each sampled file, at its own sampling
    sizes (from its own maximum diameter, as a single request sizes)."""
    els = state.pool.elements
    groups: dict = collections.defaultdict(list)
    for k in sample(state):
        xyz = state.pool.coords[k]
        groups[pipeline.static_sizes(pipeline.max_dim_host(els, xyz), pipeline.CFG)].append(k)
    out = {}
    for sizes, ks in groups.items():
        got = pipeline.analyse(
            [(els, state.pool.coords[k]) for k in ks], sizes, state.ctx.device, dtype, opt_dtype
        )
        out.update({k: [r] for k, r in zip(ks, got)})
    return out


def check(state: State, readings: dict) -> tuple[int, int, list]:
    """Every answer of a sampled file against the reference; every
    answer's values finite."""
    ctx = state.ctx
    missing = sum(1 for _, p in state.answers if not compare.answer_ok(p))
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare.Tally()
    compare.compare_all(tally, answers(state), references(state))
    state.answers.clear()
    tally.missing += missing
    return state.served, missing, tally.checks(ctx.params["limits"])


def close(state: State) -> None:
    state.answers.clear()
