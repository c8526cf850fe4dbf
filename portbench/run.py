"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration (``configs[].file``), its traffic parameters
(``portbench/workloads/<cell>.json``), the driver of its traffic kind
(``portbench/drivers/<traffic>.py``) and a reader a metric
(``portbench/metrics/<metric>.py``).  A run makes its inputs from the
seed, warms up (set-up), runs the driver's closed loop for ``--seconds``
(whole units: the last one may end past it), then checks the outputs
against the plain reference and prints one JSON line.  ``--trace 1``
profiles the window's first units, then times the program's stage spans
and the collector over the rest, and reports the per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = pathlib.Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pywindow_tpu")


@dataclasses.dataclass
class Context:
    """What a driver is given: the run's arguments, the cell's traffic
    parameters and configuration, the device and a scratch folder."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    params: dict
    config: dict
    device: object
    chips: int
    workdir: pathlib.Path


def load_cell(name: str):
    """(benchmark, cell entry, configuration dict, traffic parameters) of
    cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        msg = f"unknown workload {name!r}; known: {sorted(cells)}"
        raise SystemExit(msg)
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    params = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return bench, cell, config, params


def cell_metrics(bench: dict, cell: dict) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that cell ``cell`` reports."""

    def applies(m):
        return "workloads" not in m or cell["name"] in m["workloads"]

    return [m for m in bench["end_to_end"] if applies(m)], [
        m for m in bench["per_layer"] if applies(m)
    ]


def reader(name: str):
    """The ``read(readings)`` function of metric ``name``
    (``portbench/metrics/<name>.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@contextlib.contextmanager
def gc_watch(passes: dict):
    """Count the garbage collector's passes and their seconds inside the
    block, by generation (``passes``: {"gen0": n, ..., "seconds": s})."""
    started = {}

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            started["t"] = time.perf_counter()
            key = f"gen{info['generation']}"
            passes[key] = passes.get(key, 0) + 1
        else:
            passes["seconds"] = passes.get("seconds", 0.0) + time.perf_counter() - started["t"]

    gc.callbacks.append(on_gc)
    try:
        yield passes
    finally:
        gc.callbacks.remove(on_gc)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, state, ctx: Context, t_setup_end: float) -> dict:
    """The closed loop: whole units until ``ctx.seconds`` have passed.
    With tracing, the first ``trace_units`` units run under the profiler
    and the rest with the program's stage spans and the collector timed."""
    import torch

    from pywindow_torch import profiling

    readings: dict = {"units": {}, "latencies": [], "span_units": {}, "gc": {}}
    traced_units = int(ctx.params.get("trace_units", 1)) if ctx.trace else 0

    def one(into: dict | None = None) -> None:
        t0 = time.perf_counter()
        counts = driver.unit(state)
        readings["latencies"].append(time.perf_counter() - t0)
        for k, v in counts.items():
            readings["units"][k] = readings["units"].get(k, 0) + v
            if into is not None:
                into[k] = into.get(k, 0) + v

    t0 = time.perf_counter()
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        from portbench import devtrace

        profiling.enable()
        activities = [ProfilerActivity.CPU]
        if torch.device(ctx.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        traced: dict = {}
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(devtrace.WINDOW):
                ta = time.perf_counter()
                for _ in range(traced_units):
                    one(traced)
                _sync(ctx.device)
                tb = time.perf_counter()
        reduced = devtrace.reduce(prof)
        del prof
        readings["trace"] = {
            "busy_s": reduced.busy_s, "window_s": tb - ta, "kernels": reduced.kernels,
            "units": traced, "device_ops": reduced.device_ops, "idle_gaps": reduced.idle_gaps,
        }
        profiling.METRICS.reset()
    ts = time.perf_counter()
    with gc_watch(readings["gc"]):
        while True:
            one(readings["span_units"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    _sync(ctx.device)
    end = time.perf_counter()
    readings["window_s"] = end - t0
    readings["span_s"] = end - ts
    if ctx.trace:
        readings["spans"] = dict(profiling.METRICS.snapshot()["stage_seconds"])
        profiling.enable(False)
    readings["setup_s"] = t_setup_end - T_START
    return readings


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(
    name: str, seed: int, seconds: float, trace: bool, device=None, overrides: dict | None = None
) -> dict:
    """One run of cell ``name`` on ``device`` (default: the card, which
    must hold as many cards as the cell asks for); returns the result
    line as a dict.  ``overrides`` replace configuration or traffic
    values (the CPU tests run the drivers at tiny sizes)."""
    import torch

    bench, cell, config, params = load_cell(name)
    for key, value in (overrides or {}).items():
        (config if key in config else params)[key] = value
    if device is None:
        device = torch.device("cuda", 0)
    e2e, per_layer = cell_metrics(bench, cell)
    driver = importlib.import_module(f"portbench.drivers.{cell['traffic']}")
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    ctx = Context(
        cell=name, seed=seed, seconds=seconds, trace=trace, params=params, config=config,
        device=torch.device(device), chips=int(cell["chips"]), workdir=workdir,
    )
    state = None
    try:
        state = driver.setup(ctx)
        _sync(ctx.device)
        t_setup_end = time.perf_counter()
        readings = measure(driver, state, ctx, t_setup_end)
        readings["driver"] = driver.after(state, readings)
        memory = driver.memory_peak(state) if hasattr(driver, "memory_peak") else (
            torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        )
        wanted = per_layer if trace else e2e
        if trace and any(m["name"].startswith("kernel.") for m in wanted):
            readings["rooflines"] = driver.rooflines(state)
        attempted, failed, checks = driver.check(state, readings)
    finally:
        if state is not None:
            driver.close(state)
        shutil.rmtree(workdir, ignore_errors=True)
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    device_info = {
        "platform": "gpu" if ctx.device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        "count": ctx.chips if ctx.device.type == "cuda" else 1,
        "memory_peak_bytes": int(memory),
    }
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace:
        tr = readings["driver"].get("trace", readings["trace"])
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    import torch

    _, cell, *_ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
