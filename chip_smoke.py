"""Smoke run of pywindow_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs
one CUDA card and the CUDA toolkit (``nvcc``), and imports nothing of
JAX.  Phases, each of which raises on failure (exit code != 0, no
result line):

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, float32 matmuls in full precision;
2. build the three CUDA kernels from ``pywindow_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, on the
   inputs the main path gives it for CC3 (PUDXES, 168 atoms) and REYMAL
   (468 atoms), in float32 and in float64, with warm timings;
4. the 7-system golden gate through
   ``MolecularSystem.load_file(...).system_to_molecule().full_analysis(device="cuda")``
   (float32 pipeline), with the kernel launch counters reset just
   before it;
5. every kernel was launched by phase 4.

The last two lines of standard output are the kernel record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

#: the golden gate of scripts/validate_f32.py:37-97 (values from
#: BASELINE.md: reference tests and example scripts; REYMAL windows from
#: the JAX package's CPU float64 run).  NUXHIZ carries 0.05 Å where the
#: optimisers do not run as kernels (validate_f32.py:70-83, 135-136).
GOLD = {
    "PUDXES": {
        "pore": 5.397020177310022,
        "avg": 13.832017514255472,
        "max": 22.179369990077188,
        "windows": [3.62896512, 3.63562103, 3.63707237, 3.63778746],
    },
    "YAQHOQ": {"pore": 3.6101512374999996, "pore_opt": 3.6289753088227567},
    "BATVUP": {
        "pore": 4.836533719851611,
        "windows": [3.3414604104301676, 3.729380286546027],
    },
    "MIBQAR": {
        "pore_opt": 12.277218239447373,
        "windows": [
            7.936596981480963, 7.938328681370597, 7.944268889914964,
            7.944822155795365, 7.95227623300941, 7.963120398998443,
        ],
    },
    "NUXHIZ": {
        "tol": 0.05,
        "pore": 8.746544980478657,
        "windows": [6.503653849037591, 7.269555216539536, 7.903902924542914],
    },
    "REYMAL": {
        "windows": [
            9.05410173, 9.05947091, 9.16546626,
            9.17248558, 9.17507083, 9.19220592,
        ],
    },
    "SAYGOR": {
        "pore_opt": 9.40496927130876,
        "windows": [
            5.956810992876738, 6.808675682597675,
            7.891850464732435, 8.296593512434261,
        ],
    },
}

KERNELS = {
    "ray_exit": ("pywindow_torch/csrc/ray_exit.cu", "pywindow_tpu/ops/pallas_kernels.py:445"),
    "path_sweep": ("pywindow_torch/csrc/path_sweep.cu", "pywindow_tpu/ops/pallas_kernels.py:170"),
    "dbscan": ("pywindow_torch/csrc/dbscan.cu", "pywindow_tpu/ops/cluster_pallas.py:62"),
}


def structure(name: str) -> pathlib.Path:
    path = DATA / f"{name}.xyz"
    return path if path.exists() else DATA / f"{name}.pdb"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
    )
    check(
        not torch.backends.cuda.matmul.allow_tf32,
        "float32 matmuls must not run in TF32",
    )
    return smi


def phase_build() -> None:
    from pywindow_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load_extension()
    print(f"build: {time.perf_counter() - t0:.2f} s (into {_cuda.BUILD_DIR})")


def record_inputs(names: list[str]) -> dict[str, list[tuple[str, tuple]]]:
    """Run the main path once per system and keep a copy of every input
    each kernel wrapper received (these runs are warm-up only)."""
    import pywindow_torch as pt
    from pywindow_torch.ops import cluster_kernels, ray_kernels

    seen: dict[str, list[tuple[str, tuple]]] = {k: [] for k in KERNELS}
    wrapped = [
        (ray_kernels, "ray_exit_cuda", "ray_exit"),
        (ray_kernels, "path_sweep_cuda", "path_sweep"),
        (cluster_kernels, "dbscan_labels_cuda", "dbscan"),
    ]
    originals = {(m, a): getattr(m, a) for m, a, _ in wrapped}
    current = [""]

    def recorder(fn, key):
        def run(*args):
            seen[key].append(
                (current[0], tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            )
            return fn(*args)

        return run

    try:
        for module, attr, key in wrapped:
            setattr(module, attr, recorder(originals[(module, attr)], key))
        for name in names:
            current[0] = name
            pt.MolecularSystem.load_file(structure(name)).system_to_molecule().full_analysis(
                device="cuda"
            )
    finally:
        for (module, attr), fn in originals.items():
            setattr(module, attr, fn)
    return seen


def time_ms(fn, reps: int = 25) -> float:
    """Warm median of one call, CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _as(args, dtype):
    return tuple(
        a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in args
    )


def compare_ray_exit(args, dtype):
    from pywindow_torch.ops import ray_kernels

    unit, rel, vdw, origin, want_exit = _as(args, dtype)
    # the recorded directions are float32 unit vectors; in float64 they
    # are normalised again, since the kernel's expanded |p1|^2 takes
    # |u| = 1 (a float32 |u| is 1 only to ~1e-7)
    unit = unit / torch.sqrt((unit * unit).sum(-1, keepdim=True))
    hk, ek = ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, want_exit)
    hp, ep = ray_kernels.ray_exit_plain(unit, rel, vdw, origin, want_exit)
    torch.cuda.synchronize()
    flips = hk != hp
    if dtype == torch.float64:
        check(not bool(flips.any()), "ray_exit f64: hit flags differ")
        err = float((ek - ep).abs().max())
        check(err <= 1e-9, f"ray_exit f64: exits differ by {err}")
        return err
    # float32: the kernel's front test is the algebraic form of the plain
    # version's, so rays within rounding of tangency may flip
    n_flip = int(flips.sum())
    check(n_flip <= 0.005 * len(hk), f"ray_exit f32: {n_flip} of {len(hk)} rays flip")
    if n_flip:
        u64, r64, v64, o64, _ = _as(args, torch.float64)
        t_ca = u64 @ r64.T
        perp = r64[None] - t_ca[..., None] * u64[:, None]
        under = v64[None] ** 2 - (perp * perp).sum(-1)
        margin = under.abs().amin(-1)[flips]
        check(bool((margin <= 1e-4).all()), "ray_exit f32: a flipped ray is not tangent")
    both = hk & hp & torch.isfinite(ek)
    err = float((ek - ep)[both].abs().max()) if want_exit and bool(both.any()) else 0.0
    check(err <= 1e-4, f"ray_exit f32: exits differ by {err}")
    return err


def compare_path_sweep(args, dtype):
    from pywindow_torch.ops import ray_kernels

    vectors, chunks, coords, vdw, max_steps = _as(args, dtype)
    ok_k, pos_k, c_k = ray_kernels.path_sweep_cuda(vectors, chunks, coords, vdw, max_steps)
    ok_p, pos_p, c_p = ray_kernels.path_sweep_plain(vectors, chunks, coords, vdw, max_steps)
    torch.cuda.synchronize()
    check(torch.equal(ok_k, ok_p), f"path_sweep {dtype}: ok differs")
    check(torch.equal(pos_k, pos_p), f"path_sweep {dtype}: argmin step differs")
    err = float((c_k - c_p).abs().max())
    check(err <= (1e-9 if dtype == torch.float64 else 1e-4), f"path_sweep {dtype}: cmin differs by {err}")
    return err


def compare_dbscan(args, dtype):
    from pywindow_torch.ops import cluster, cluster_kernels

    points, valid, eps, min_samples, max_clusters = _as(args, dtype)
    labels_k = cluster_kernels.dbscan_labels_cuda(points, valid, eps, min_samples, max_clusters)
    labels_p, _ = cluster.dbscan(points, valid, eps, min_samples, max_clusters)
    torch.cuda.synchronize()
    check(torch.equal(labels_k, labels_p), f"dbscan {dtype}: labels differ")
    return 0.0


def phase_kernels() -> dict[str, dict]:
    from pywindow_torch.ops import cluster, cluster_kernels, ray_kernels

    seen = record_inputs(["PUDXES", "REYMAL"])
    compare = {
        "ray_exit": compare_ray_exit,
        "path_sweep": compare_path_sweep,
        "dbscan": compare_dbscan,
    }
    kernel_fn = {
        "ray_exit": ray_kernels.ray_exit_cuda,
        "path_sweep": ray_kernels.path_sweep_cuda,
        "dbscan": cluster_kernels.dbscan_labels_cuda,
    }
    plain_fn = {
        "ray_exit": ray_kernels.ray_exit_plain,
        "path_sweep": ray_kernels.path_sweep_plain,
        "dbscan": cluster.dbscan,
    }
    record = {}
    for key, calls in seen.items():
        check(len(calls) > 0, f"{key}: the main path never reached the kernel")
        worst = 0.0
        shapes = set()
        for system, args in calls:
            for dtype in (torch.float32, torch.float64):
                err = compare[key](args, dtype)
                if dtype == torch.float32:
                    worst = max(worst, err)
            shapes.add((system,) + tuple(tuple(a.shape) for a in args if torch.is_tensor(a)))
        timings = []
        for system in ("PUDXES", "REYMAL"):
            for args in [a for s, a in calls if s == system][:2]:
                ms = time_ms(lambda a=args: kernel_fn[key](*a))
                plain_ms = time_ms(lambda a=args: plain_fn[key](*a))
                shape = [tuple(a.shape) for a in args if torch.is_tensor(a)][0]
                timings.append((system, shape, ms, plain_ms))
                print(
                    f"  {key} {system} {shape} f32: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms"
                )
        print(f"kernel {key}: {len(calls)} main-path calls checked, f32 max abs err {worst:.3e}")
        cc3 = timings[0]
        record[key] = {"max_abs_err": worst, "ms": cc3[2], "plain_ms": cc3[3]}
    return record


def phase_gate() -> None:
    import pywindow_torch as pt

    for name, gold in GOLD.items():
        gold = dict(gold)
        tol = gold.pop("tol", 0.01)
        t0 = time.perf_counter()
        props = (
            pt.MolecularSystem.load_file(structure(name))
            .system_to_molecule()
            .full_analysis(device="cuda")
        )
        seconds = time.perf_counter() - t0
        errs = {}
        if "pore" in gold:
            errs["pore"] = abs(props["pore_diameter"]["diameter"] - gold["pore"])
        if "pore_opt" in gold:
            errs["pore_opt"] = abs(props["pore_diameter_opt"]["diameter"] - gold["pore_opt"])
        if "avg" in gold:
            errs["avg"] = abs(props["average_diameter"] - gold["avg"])
        if "max" in gold:
            errs["max"] = abs(props["maximum_diameter"]["diameter"] - gold["max"])
        if "windows" in gold:
            wins = props["windows"]["diameters"]
            check(wins is not None, f"{name}: no windows")
            wins = np.sort(np.asarray(wins, dtype=np.float64))
            check(
                len(wins) == len(gold["windows"]),
                f"{name}: {len(wins)} windows, expected {len(gold['windows'])}",
            )
            errs["windows"] = float(np.abs(wins - np.sort(gold["windows"])).max())
        for key, value in props.items():
            if key == "windows":
                continue
            vals = value.values() if isinstance(value, dict) else [value]
            for v in vals:
                check(bool(np.all(np.isfinite(np.asarray(v, dtype=np.float64)))), f"{name}: {key} not finite")
        worst = max(errs.values())
        print(
            f"gate {name}: worst abs err {worst:.3e} A (tol {tol}) "
            f"{json.dumps({k: float(v) for k, v in errs.items()})}, {seconds:.3f} s"
        )
        check(worst < tol, f"{name}: error {worst} >= {tol}")


def main() -> None:
    smi = phase_card()
    phase_build()
    from pywindow_torch.ops import _cuda

    record = phase_kernels()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    phase_gate()
    torch.cuda.synchronize()
    print(f"gate: 7 systems in {time.perf_counter() - t0:.2f} s")
    launches = dict(_cuda.LAUNCHES)
    for key in KERNELS:
        check(launches.get(key, 0) > 0, f"{key}: no launch during the golden gate")
    kernels = [
        {
            "name": key,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": record[key]["max_abs_err"],
            "ms": record[key]["ms"],
            "plain_ms": record[key]["plain_ms"],
        }
        for key, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    check(all(math.isfinite(k["ms"]) for k in kernels), "timings not finite")
    print(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
