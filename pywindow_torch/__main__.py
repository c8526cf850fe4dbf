"""Command line: ``python -m pywindow_torch <command>`` (counterpart of
``pywindow_tpu.__main__``).

Commands:
  analyze FILE [--rebuild] [--forcefield FF] [--swap k=v] [-o OUT.json]
      [--device cuda|cpu]
      Full structural analysis of a structure file (XYZ/PDB/MOL).  With
      --rebuild, periodic systems are reconstructed and every molecule
      is analysed as one batch.
  trajectory FILE [--format dlpoly|xyz|pdb] [--frames A:B] [--batch N]
      [--exact-sizes] [--modular] [--rebuild] [--forcefield FF]
      [--swap k=v] [--autosave-every N] [-o OUT.json] [--device cuda|cpu]
      Batched analysis of an MD trajectory.
  bench [--device cuda|cpu]
      Run the throughput benchmark, ``bench_torch.py`` of the source
      checkout: the full record on one JSON line, then a compact
      headline line.

Everything runs on the card (``--device cuda``, the default) and raises
when there is none; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _swap_dict(pairs):
    out = {}
    for p in pairs or []:
        key, _, value = p.partition("=")
        if not value:
            msg = f"--swap expects key=value, got {p!r}"
            raise SystemExit(msg)
        out[key] = value
    return out or None


def _dump(obj, out) -> None:
    from pywindow_torch.io.outputs import to_list

    text = json.dumps(obj, default=to_list, indent=1)
    if out:
        pathlib.Path(out).write_text(text)
        print(f"wrote {out}")
    else:
        print(text)


def cmd_analyze(args) -> None:
    import pywindow_torch as pt

    molsys = pt.MolecularSystem.load_file(args.file)
    if args.swap:
        molsys.swap_atom_keys(_swap_dict(args.swap))
    if args.forcefield:
        molsys.decipher_atom_keys(args.forcefield)
    if args.rebuild:
        molsys.make_modular(rebuild=True)
        results = molsys.analyze_molecules(device=args.device)
        _dump({str(k): v for k, v in results.items()}, args.output)
    else:
        _dump(molsys.system_to_molecule().full_analysis(device=args.device), args.output)


def cmd_trajectory(args) -> None:
    import pywindow_torch as pt

    fmt = args.format
    if fmt is None:
        suffix = pathlib.Path(args.file).suffix.lower()
        fmt = {".xyz": "xyz", ".pdb": "pdb"}.get(suffix, "dlpoly")
    cls = {"dlpoly": pt.DLPOLY, "xyz": pt.XYZ, "pdb": pt.PDB}[fmt]
    traj = cls(args.file)
    frames = "all"
    if args.frames:
        a, _, b = args.frames.partition(":")
        frames = (int(a or 0), int(b or traj.no_of_frames))
    traj.analysis_batched(
        frames=frames,
        batch_size=args.batch,
        modular=args.modular or args.rebuild,
        rebuild=args.rebuild,
        swap_atoms=_swap_dict(args.swap),
        forcefield=args.forcefield,
        exact_sizes=args.exact_sizes,
        autosave=args.output,
        autosave_every=args.autosave_every,
        device=args.device,
    )
    if args.output:
        traj.save_analysis(args.output, override=True)
        print(f"analysed {len(traj.analysis_output)} frames -> {args.output}")
    else:
        _dump(traj.analysis_output, None)


#: the benchmark script, at the root of a source checkout
BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench_torch.py"


def cmd_bench(args) -> None:
    import runpy

    if not BENCH.is_file():
        msg = (
            "the benchmark (bench_torch.py + its trajectory fixture) ships "
            "with the source repository, not the installed package; "
            "run it from a checkout"
        )
        raise SystemExit(msg)
    argv = sys.argv
    sys.argv = [str(BENCH), "--device", str(args.device)]
    try:
        runpy.run_path(str(BENCH), run_name="__main__")
    finally:
        sys.argv = argv


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m pywindow_torch",
        description="structural analysis of porous molecules on a CUDA card",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("analyze", help="analyse one structure file")
    p.add_argument("file")
    p.add_argument("--rebuild", action="store_true")
    p.add_argument("--forcefield")
    p.add_argument("--swap", nargs="*", metavar="KEY=VALUE")
    p.add_argument("-o", "--output")
    p.add_argument("--device")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("trajectory", help="analyse an MD trajectory")
    p.add_argument("file")
    p.add_argument("--format", choices=["dlpoly", "xyz", "pdb"])
    p.add_argument("--frames", metavar="A:B")
    p.add_argument("--batch", type=int, default=480)
    p.add_argument("--exact-sizes", action="store_true")
    p.add_argument("--modular", action="store_true")
    p.add_argument("--rebuild", action="store_true")
    p.add_argument("--forcefield")
    p.add_argument("--swap", nargs="*", metavar="KEY=VALUE")
    p.add_argument("--autosave-every", type=int, default=10)
    p.add_argument("-o", "--output")
    p.add_argument("--device")
    p.set_defaults(fn=cmd_trajectory)

    p = sub.add_parser("bench", help="run the throughput benchmark")
    p.add_argument("--device")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    from pywindow_torch.config import resolve_device

    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
