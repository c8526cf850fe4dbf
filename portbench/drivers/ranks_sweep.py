"""Traffic kind ``ranks_sweep``: the ``md_sweep`` traffic swept by one
process a card, in lockstep: each sweep every rank opens a new
``DLPOLY(path)`` and calls ``analysis_batched_distributed``, and the
sweep ends when every rank holds every frame.  The run's own process is
rank 0 and reports; it starts the other ranks (``python3 -m
portbench.drivers.ranks_sweep --rank r ...``), tells them by a broadcast
what to do next, and waits for each to end.

Configuration keys: as ``md_sweep``, and ``ranks``.  Traffic keys:
``batch_size``, ``shift_A``, ``sample``, ``trace_units``, ``limits``
(``ranks_differ``: sampled answers in which a rank differs from rank 0).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import compare
from portbench.drivers import md_sweep
from portbench.inputs import history, seeded

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: what rank 0 tells the others before each step
OP_DONE, OP_SWEEP, OP_TRACE_ON, OP_TRACE_OFF = 0, 1, 2, 3
#: seconds a rank is given to end once told
JOIN_S = 120
#: names a fault of :mod:`portbench.faults` that every rank plants
FAULT_ENV = "PORTBENCH_FAULT"


@dataclasses.dataclass
class Rank:
    """One rank's side of the sweeps."""

    path: pathlib.Path
    n_frames: int
    sample: np.ndarray
    config: dict
    params: dict
    device: torch.device
    kept: list = dataclasses.field(default_factory=list)
    missing: int = 0
    own_s: float = 0.0
    spans_on: bool = False
    last: dict | None = None
    prof: object = None
    note: object = None
    trace_t0: float = 0.0
    trace_s: float = 0.0
    trace_out: dict | None = None

    def sweep(self) -> int:
        """One lockstep sweep; returns the frames this rank holds."""
        import pywindow_torch as pt
        from pywindow_torch import profiling
        from pywindow_torch.parallel import distributed

        self.last = None
        before = profiling.METRICS.snapshot()["stage_seconds"].get("sweep_gather", 0.0)
        t0 = time.perf_counter()
        traj = pt.DLPOLY(self.path)
        distributed.analysis_batched_distributed(
            traj, swap_atoms=self.config["swap_atoms"], forcefield=self.config["forcefield"],
            batch_size=int(self.params["batch_size"]),
            device="cpu" if self.device.type == "cpu" else "cuda",
        )
        took = time.perf_counter() - t0
        if self.spans_on:
            after = profiling.METRICS.snapshot()["stage_seconds"].get("sweep_gather", 0.0)
            self.own_s += took - (after - before)
        out = traj.analysis_output
        got = sum(1 for v in out.values() if "0" in v)
        self.missing += self.n_frames - got
        self.kept.append(
            {int(k): compare.snapshot(out.get(int(k), {}).get("0")) for k in self.sample}
        )
        self.last = out
        return got

    def trace_on(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from portbench import devtrace
        from pywindow_torch import profiling

        profiling.enable()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.note = torch.profiler.record_function(devtrace.WINDOW)
        self.note.__enter__()
        self.trace_t0 = time.perf_counter()

    def trace_off(self) -> None:
        """Stop the profiler; its trace is reduced once the window has
        closed, so no rank holds the others up inside the window."""
        from pywindow_torch import profiling

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.trace_s = time.perf_counter() - self.trace_t0
        self.note.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        profiling.METRICS.reset()
        self.spans_on = True

    def report(self) -> dict:
        """What rank 0 gathers once the window has closed."""
        from portbench import devtrace

        if self.prof is not None:
            r = devtrace.reduce(self.prof)
            self.prof = None
            self.trace_out = {"busy_s": r.busy_s, "window_s": self.trace_s}
        if self.last is not None:
            self.missing += sum(1 for v in self.last.values() if not compare.answer_ok(v.get("0")))
        self.last = None
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        return {"missing": self.missing, "kept": self.kept, "own_s": self.own_s,
                "trace": self.trace_out, "memory": int(peak)}


@dataclasses.dataclass
class State:
    ctx: object
    hist: history.History
    rank: Rank
    procs: list
    units: int = 0
    reports: list | None = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tell(op: int, device: torch.device) -> int:
    """Rank 0: broadcast ``op``; the others: receive it."""
    import torch.distributed as dist

    t = torch.tensor([op], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


def setup(ctx) -> State:
    """Write the file, start the other ranks, join the group as rank 0
    and sweep once, untimed."""
    from pywindow_torch.parallel import distributed

    conf, n = ctx.config, int(ctx.config["trajectory_frames"])
    world = int(conf["ranks"])
    hist = history.write(
        ctx.workdir / "HISTORY", n, ctx.seed, conf["fixture"], float(ctx.params["shift_A"]),
        ctx.device,
    )
    pick = np.sort(seeded.rng(ctx.seed, 10).choice(n, size=int(ctx.params["sample"]), replace=False))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    spec = {"path": str(hist.path), "n_frames": n, "sample": pick.tolist(), "config": conf,
            "params": ctx.params}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "portbench.drivers.ranks_sweep", "--rank", str(r),
             "--world", str(world), "--port", str(port), "--spec", json.dumps(spec)],
            cwd=ROOT, env=env,
        )
        for r in range(1, world)
    ]
    try:
        dev = distributed.initialize(f"localhost:{port}", world, 0)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    rank = Rank(path=hist.path, n_frames=n, sample=pick, config=conf, params=ctx.params,
                device=dev)
    state = State(ctx=ctx, hist=hist, rank=rank, procs=procs)
    _tell(OP_SWEEP, dev)
    rank.sweep()
    if ctx.trace:  # the other ranks' profilers start before the window
        _tell(OP_TRACE_ON, dev)
    return state


def unit(state: State) -> dict:
    ctx, rank = state.ctx, state.rank
    traced = int(ctx.params.get("trace_units", 1)) if ctx.trace else 0
    _tell(OP_SWEEP, rank.device)
    got = rank.sweep()
    state.units += 1
    if traced and state.units == traced:
        _tell(OP_TRACE_OFF, rank.device)
        rank.spans_on = True
    return {"frames": got}


def after(state: State, readings: dict) -> dict:
    """Tell the ranks the window has closed and gather their reports:
    the ranks' own seconds (the gather left out), their traced device
    time averaged over the cards, and their peaks."""
    import torch.distributed as dist

    rank = state.rank
    _tell(OP_DONE, rank.device)
    reports: list = [None] * dist.get_world_size()
    dist.all_gather_object(reports, rank.report())
    state.reports = reports
    out: dict = {"rank_seconds": [r["own_s"] for r in reports]}
    traces = [r["trace"] for r in reports[1:] if r["trace"]]
    if "trace" in readings and traces:
        mine = readings["trace"]
        out["trace"] = {
            **mine,
            "busy_s": (mine["busy_s"] + sum(t["busy_s"] for t in traces)) / (1 + len(traces)),
        }
    return out


def memory_peak(state: State) -> int:
    return max(r["memory"] for r in state.reports)


def answers(state: State) -> dict:
    """Rank 0's kept answers by frame, one a sweep."""
    return {int(k): [kept[int(k)] for kept in state.reports[0]["kept"]] for k in state.rank.sample}


def references(state: State, dtype=torch.float64, opt_dtype=torch.float64) -> dict:
    """As :func:`md_sweep.references`: the same file, sample and sizes."""
    return md_sweep.references(
        md_sweep.State(ctx=state.ctx, hist=state.hist, sample=state.rank.sample), dtype, opt_dtype
    )


def check(state: State, readings: dict) -> tuple[int, int, list]:
    """Rank 0's samples against the reference, and every other rank's
    sampled answers equal to rank 0's."""
    ctx = state.ctx
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    mine = state.reports[0]["kept"]
    differ = 0
    for other in state.reports[1:]:
        for a, b in zip(mine, other["kept"]):
            differ += sum(1 for k in a if not _same(a[k], b[k]))
        differ += abs(len(mine) - len(other["kept"])) * len(state.rank.sample)
    tally = compare.Tally()
    compare.compare_all(tally, answers(state), references(state))
    missing = sum(r["missing"] for r in state.reports)
    tally.missing += missing
    checks = tally.checks(ctx.params["limits"])
    checks.append({"name": "ranks_differ", "value": float(differ),
                   "limit": ctx.params["limits"]["ranks_differ"]})
    attempted = sum(readings["units"].values()) + state.reports[0]["missing"]
    return attempted, missing, checks


def _same(a, b) -> bool:
    """Whether two answers hold the same values, bit for bit."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    return a == b or (a != a and b != b)


def close(state: State) -> None:
    """Leave the group; wait for every other rank to end (ending those
    that do not)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    for p in state.procs:
        try:
            p.wait(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _rank_main(argv: list[str]) -> int:
    """A rank other than 0: join, follow rank 0's steps, report, leave."""
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)
    from pywindow_torch.parallel import distributed

    stack = contextlib.ExitStack()

    dev = distributed.initialize(f"localhost:{args.port}", args.world, args.rank)
    fault = os.environ.get(FAULT_ENV)
    if fault:  # planted by portbench.faults, in every rank
        from portbench import faults

        stack.enter_context(faults.planted(fault))
    rank = Rank(
        path=pathlib.Path(spec["path"]), n_frames=spec["n_frames"], sample=np.array(spec["sample"]),
        config=spec["config"], params=spec["params"], device=dev,
    )
    try:
        while True:
            op = _tell(OP_DONE, dev)
            if op == OP_DONE:
                break
            if op == OP_TRACE_ON:
                rank.trace_on()
            elif op == OP_TRACE_OFF:
                rank.trace_off()
            else:
                rank.sweep()
        dist.all_gather_object([None] * args.world, rank.report())
    finally:
        dist.destroy_process_group()
        stack.close()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
