"""Throughput benchmark of pywindow_torch: ``python -m pywindow_torch bench``.

The workloads of the JAX package's ``bench.py``, measured on the port
(``python3 bench_torch.py [--device cuda|cpu]`` from a checkout runs it
too).  The card is the default device, and the bench raises without
one; ``--device cpu`` runs the same rows on the CPU.  Either way the
pipeline is float32 with float64 optimiser kernels (the card's dtypes;
``PYWINDOW_TORCH_FORCE_F32`` on the CPU), as ``bench.py`` forced its
float32 pipeline.  Inputs come from ``tests/data`` only.  Rows:

0. the 7-system golden gate (``chip_smoke.gate_report``), every error
   < 0.01 Å, before anything is timed; a failed gate prints its report
   and exits with 1;
1. kernel frames/s, CC3: the 20 frames of the DL_POLY fixture (``he``
   swapped for ``H``, OPLS) replicated to 8,640 frames (fewer if
   ``parallel.batch.max_safe_batch`` says they do not fit), sized from
   the largest frame, one ``ops.analysis.run_pipeline`` call with its
   packed rows fetched to the host, warm;
2. end-to-end frames/s, CC3: ``DLPOLY(path).analysis_batched(swap_atoms=
   {"he": "H"}, forcefield="OPLS", batch_size=4320)`` on a 21,600-frame
   HISTORY (the fixture cycled), file to dicts, after one untimed sweep;
   the headline;
3. kernel frames/s of MIBQAR (424 atoms) and REYMAL (468 atoms) at 1,200
   copies each;
4. end-to-end frames/s of a 4,800-frame MIBQAR HISTORY,
   ``analysis_batched(forcefield="DLF", batch_size=1200)``, after two
   untimed sweeps (the first learns the escalated caps);
5. on the card, on row 1's batch: each of the seven pipeline kernels'
   launches in one pipeline call, device ms through a CUDA graph
   (``chip_smoke.device_ms``) and bound ms (``chip_smoke.bound``), and the
   pipeline call's device-busy time against its wall time
   (``chip_smoke.device_profile``); a kernel that did not launch fails
   the bench;
6. the reference's rate: ``null``, as ``bench.py`` records it when the
   reference checkout is not there (it is not).

Every timed row takes :data:`REPS` warm repetitions and records each
one's seconds, their median, min and max (frames/s from the median);
an end-to-end repetition also records the process's CPU seconds and the
garbage collector's passes and seconds during it.  Any failed row or
check raises: nothing is caught, nothing falls back.

Output: the full record as one JSON line, then, last, a compact
headline line under 1,000 bytes.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import pathlib
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
if str(ROOT) not in sys.path:  # run by path (runpy) from another directory
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the gate, device times and bounds)

KERNEL_BATCH = 8640
E2E_FRAMES = 21600  # five full chunks of E2E_BATCH
E2E_BATCH = 4320
BIG_BATCH = 1200
MIBQAR_FRAMES = 4800  # four full chunks of MIBQAR_BATCH
MIBQAR_BATCH = 1200
REPS = 7
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
#: expected pore diameters of the sanity checks (bench.py:112, :340)
CC3_PORE = 5.0
MIBQAR_PORE = 12.3
MIBQAR = chip_smoke.DATA / "MIBQAR.pdb"
METRIC = "cc3_full_analysis_throughput"


def spread(frames: int, seconds: list[float]) -> dict:
    """A timed row: every repetition's seconds, their median, min and
    max, and frames/s at the median, the slowest and the fastest."""
    med = statistics.median(seconds)
    return {
        "frames": frames, "reps": len(seconds), "rep_seconds": seconds,
        "median_s": med, "min_s": min(seconds), "max_s": max(seconds),
        "fps_median": frames / med, "fps_min": frames / max(seconds),
        "fps_max": frames / min(seconds),
    }


@contextlib.contextmanager
def gc_watch(passes: dict):
    """Count the garbage collector's passes and their seconds inside the
    block, by generation (``passes`` filled: {"gen0": n, ..., "seconds":
    s})."""
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


def card(device: torch.device) -> dict:
    """What ran the bench: the card's name and power limit as nvidia-smi
    prints them, the torch and CUDA versions; on the CPU, the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "smi": None, "torch": torch.__version__, "cuda": None}
    return {
        "platform": "gpu", "name": torch.cuda.get_device_name(device), "smi": chip_smoke.nvidia_smi(),
        "torch": torch.__version__, "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
    }


def fixture_frames() -> list[tuple[np.ndarray, np.ndarray]]:
    """The 20 frames of the CC3 DL_POLY fixture as (elements, coordinates),
    ``he`` swapped for ``H`` and deciphered with OPLS (bench.py:65-77)."""
    import pywindow_torch as pt

    frames = pt.DLPOLY(chip_smoke.HISTORY).get_frames(**FF)
    return [(m.system["elements"], m.system["coordinates"]) for m in frames.values()]


def kernel_batch(systems, frames: int, device: torch.device) -> tuple:
    """``systems`` cycled to ``frames`` frames (fewer, a multiple of
    len(systems), if ``max_safe_batch`` says they do not fit), encoded on
    ``device``, with the sizes ``dispatch_batch`` would give them: the
    largest maximum diameter as the pin, path lengths over the largest
    bound.  Returns (mols, sizes, frames, what was reduced or None)."""
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops.analysis import batch_sizes, max_dim_bound, max_dim_host
    from pywindow_torch.ops.encoding import encode_batch
    from pywindow_torch.parallel.batch import max_safe_batch

    maxd = max(max_dim_host(e, c) for e, c in systems)
    largest = max(max_dim_bound(e, c) for e, c in systems)
    safe = max_safe_batch(max(len(e) for e, _ in systems), maxd, DEFAULT_CONFIG, device)
    reduced = None
    if frames > safe:
        fit = safe // len(systems) * len(systems)
        chip_smoke.check(fit > 0, f"not even {len(systems)} frames fit the card's memory")
        reduced = f"{frames} frames do not fit (max_safe_batch {safe}): {fit}"
        frames = fit
    mols = encode_batch([systems[i % len(systems)] for i in range(frames)], device=device)
    return mols, batch_sizes(maxd, largest, DEFAULT_CONFIG), frames, reduced


def kernel_row(systems, frames: int, device: torch.device, reps: int = REPS, pore: float | None = None):
    """Rows 1 and 3: warm seconds of one pipeline call on ``frames``
    copies of ``systems``, its packed rows fetched to the host (the
    synchronisation point).  The first frame's pore must be finite and,
    with ``pore`` given, within 2 Å of it with a window found
    (bench.py:112-114).  Returns (row, (mols, sizes))."""
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops.analysis import run_pipeline, unpack_results

    mols, sizes, frames, reduced = kernel_batch(systems, frames, device)

    def step() -> np.ndarray:
        return run_pipeline(mols, sizes, DEFAULT_CONFIG).cpu().numpy()

    flat = step()  # first call: kernels loaded, allocator warm
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        flat = step()
        seconds.append(time.perf_counter() - t0)
    res = unpack_results(flat[0], DEFAULT_CONFIG.max_windows)
    got = float(res.pore_diameter)
    chip_smoke.check(bool(np.isfinite(got)), f"pore diameter {got}")
    if pore is not None:
        chip_smoke.check(abs(got - pore) < 2.0, f"pore diameter {got}")
        chip_smoke.check(int(np.sum(res.windows.valid)) >= 1, "no window found")
    row = {**spread(frames, seconds), "atoms": len(systems[0][0]), "sizes": list(sizes), "reduced": reduced}
    return row, (mols, sizes)


def synth_mibqar(n_frames: int) -> pathlib.Path:
    """An n-frame DL_POLY HISTORY of MIBQAR.pdb, the elements from its
    columns 77-78 (bench.py:276-310), under build/ (``chip_smoke.synth_file``)."""
    elements, coords = chip_smoke.load_pdb_atoms(MIBQAR)
    n = len(elements)
    body = "".join(
        f"{el:<8} {i + 1:9d}    1.000000    0.000000\n {x: .4E} {y: .4E} {z: .4E}\n"
        for i, (el, (x, y, z)) in enumerate(zip(elements, coords))
    )

    def write(fh) -> None:
        fh.write("MIBQAR synthetic trajectory\n")
        fh.write(f"{0:10d}{0:10d}{n:10d}\n")
        for k in range(n_frames):
            fh.write(f"timestep{k * 25:10d}{n:10d}{0:10d}{0:10d}    0.000700\n")
            fh.write(body)

    return chip_smoke.synth_file("HISTORY_mibqar", n_frames, MIBQAR, write)


def e2e_row(path, frames: int, batch: int, device, warm: list[int], ff: dict, pore: float, reps: int = REPS):
    """Rows 2 and 4: seconds of ``DLPOLY(path).analysis_batched(...)``,
    file to dicts, after untimed sweeps of the first ``n`` frames for
    each n of ``warm``.  The previous repetition's results are released
    before the clock starts.  Each repetition: its seconds, the
    process's CPU seconds and the garbage collector's passes.  Returns
    (row, the last repetition's ``analysis_output``)."""
    import pywindow_torch as pt

    warm_s = []
    for n in warm:
        t0 = time.perf_counter()
        pt.DLPOLY(path).analysis_batched(frames=list(range(n)), batch_size=batch, device=device, **ff)
        warm_s.append(time.perf_counter() - t0)
    seconds, cpu, passes = [], [], []
    traj = out = None
    for _ in range(reps):
        traj = out = None
        with gc_watch({}) as seen:
            t0, c0 = time.perf_counter(), time.process_time()
            traj = pt.DLPOLY(path)
            traj.analysis_batched(batch_size=batch, device=device, **ff)
            seconds.append(time.perf_counter() - t0)
            cpu.append(time.process_time() - c0)
        passes.append(seen)
        out = traj.analysis_output
        chip_smoke.check(len(out) == frames, f"{len(out)} of {frames} frames analysed")
        got = out[0]["0"]["pore_diameter"]["diameter"]
        chip_smoke.check(abs(got - pore) < 2.0, f"frame 0 pore diameter {got}")
    row = {**spread(frames, seconds), "batch_size": batch, "warmup_s": warm_s, "cpu_s": cpu, "gc": passes}
    return row, traj.analysis_output


def kernel_rows(mols, sizes) -> tuple[list[dict], dict]:
    """Row 5, on the card: each pipeline kernel's launches in one
    pipeline call on ``mols`` (``_cuda.LAUNCHES`` of the calling
    thread), the device ms of each of its calls through a CUDA graph and
    their bound ms, summed over the calls; and the call's wall and
    device-busy ms (torch.profiler)."""
    from pywindow_torch.config import DEFAULT_CONFIG
    from pywindow_torch.ops import _cuda
    from pywindow_torch.ops.analysis import run_pipeline

    seen: dict[str, list] = {k: [] for k in chip_smoke.KERNELS}
    mine = _cuda.thread_launches()
    before = dict(mine)
    with chip_smoke.recording(seen, ["bench"]):
        run_pipeline(mols, sizes, DEFAULT_CONFIG).cpu()
    launches = {k: mine[k] - before.get(k, 0) for k in chip_smoke.PIPELINE_KERNELS}
    missing = [k for k, n in launches.items() if n == 0]
    chip_smoke.check(not missing, f"{missing} not launched by the pipeline")
    fns = {key: getattr(m, attr) for m, attr, key, _ in chip_smoke.wrappers()}
    rows = []
    for key in chip_smoke.PIPELINE_KERNELS:
        fn, calls = fns[key], []
        for _, args, kwargs in seen[key]:
            dev_ms = chip_smoke.device_ms(lambda a=args, k=kwargs: fn(*a, **k))
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            bound_ms, bound_by = chip_smoke.bound(key, args, kwargs, out)
            calls.append({"device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        rows.append({
            "name": key, "launches": launches[key],
            "device_ms": sum(c["device_ms"] for c in calls),
            "bound_ms": sum(c["bound_ms"] for c in calls), "calls": calls,
        })
    wall, busy, traced = chip_smoke.device_profile(lambda: run_pipeline(mols, sizes, DEFAULT_CONFIG).cpu())
    pipeline = {
        "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy, "kernels_traced": traced,
        "pipeline_kernels_device_ms": sum(r["device_ms"] for r in rows),
    }
    return rows, pipeline


def run(
    device: torch.device, kernel_frames: int = KERNEL_BATCH, e2e_frames: int = E2E_FRAMES,
    e2e_batch: int = E2E_BATCH, big_frames: int = BIG_BATCH, mibqar_frames: int = MIBQAR_FRAMES,
    mibqar_batch: int = MIBQAR_BATCH, reps: int = REPS,
) -> dict:
    """Rows 0-6 on ``device``; the full record.  A failed gate prints its
    report and exits with 1."""
    record: dict = {"metric": METRIC, "unit": "frames/s", "device": card(device)}
    record["sizes"] = {
        "kernel_frames": kernel_frames, "e2e_frames": e2e_frames, "e2e_batch": e2e_batch,
        "big_frames": big_frames, "mibqar_frames": mibqar_frames, "mibqar_batch": mibqar_batch,
        "reps": reps,
    }
    gate = chip_smoke.gate_report(device)
    if not gate["pass"]:
        print(json.dumps({"error": "accuracy gate failed", **gate}))
        raise SystemExit(1)
    record["gate"] = gate

    record["kernel"], (mols, sizes) = kernel_row(fixture_frames(), kernel_frames, device, reps, pore=CC3_PORE)
    if device.type == "cuda":
        record["kernels"], record["pipeline"] = kernel_rows(mols, sizes)
    else:
        record["kernels"] = record["pipeline"] = None  # no kernel runs on the CPU
    del mols

    path = chip_smoke.synth_history(e2e_frames)
    record["e2e"], _ = e2e_row(path, e2e_frames, e2e_batch, device, [e2e_frames], FF, CC3_PORE, reps)

    for name in ("MIBQAR", "REYMAL"):
        mol = chip_smoke.molecule(name)
        systems = [(np.asarray(mol.elements), np.asarray(mol.coordinates))]
        record[f"{name.lower()}_kernel"], _ = kernel_row(systems, big_frames, device, reps)
    path = synth_mibqar(mibqar_frames)
    warm = [min(2 * mibqar_batch, mibqar_frames), min(mibqar_batch, mibqar_frames)]
    record["mibqar_e2e"], _ = e2e_row(
        path, mibqar_frames, mibqar_batch, device, warm, {"forcefield": "DLF"}, MIBQAR_PORE, reps,
    )

    # the reference pywindow's serial CPU rate (bench.py:382-426) needs
    # its checkout, which is not there: null, as bench.py records it
    record["reference_fps"] = None
    record["vs_baseline"] = None
    record["value"] = record["e2e"]["fps_median"]
    timed = (record["kernel"], record["mibqar_kernel"], record["reymal_kernel"])
    record["reduced"] = [r["reduced"] for r in timed if r["reduced"]]
    return record


def headline(record: dict) -> dict:
    """The compact last line: the median end-to-end rate, its spread and
    repetitions, the median kernel rate and the card."""
    e2e, dev = record["e2e"], record["device"]
    return {
        "metric": METRIC, "value": e2e["fps_median"], "unit": "frames/s",
        "spread": [e2e["fps_min"], e2e["fps_max"]], "reps": e2e["reps"],
        "kernel_fps": record["kernel"]["fps_median"], "device": dev["smi"] or dev["name"],
    }


def report(record: dict) -> None:
    """Print the full record on one line, then the headline, last."""
    line = json.dumps(headline(record))
    chip_smoke.check(len(line.encode()) < 1000, f"a headline of {len(line.encode())} bytes")
    print(json.dumps(record))
    print(line)


def main(argv: list[str] | None = None, **sizes) -> None:
    """``python3 bench_torch.py [--device DEV]``; ``sizes`` override the
    rows' frame counts and repetitions (the keyword arguments of
    :func:`run`)."""
    parser = argparse.ArgumentParser(prog="bench_torch.py", description=__doc__.split("\n")[0])
    parser.add_argument("--device")
    args = parser.parse_args(argv)
    from pywindow_torch.config import resolve_device

    device = resolve_device(args.device)
    # the card's dtypes wherever the bench runs (the card's default
    # already): on the CPU the float64 "classic" optimisers fail the gate
    # on NUXHIZ (ROADMAP Q3.4), as bench.py forced float32 for the TPU's
    with mock.patch.dict(os.environ, {"PYWINDOW_TORCH_FORCE_F32": "1"}):
        record = run(device, **sizes)
    report(record)


if __name__ == "__main__":
    main(sys.argv[1:])
