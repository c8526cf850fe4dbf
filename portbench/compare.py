"""The comparison that decides ``correct``: each of the program's sampled
answers (a properties dict) against the reference's result for the same
molecule, reduced to a few numbers, each held to its own limit from the
cell's traffic file.

Per answer, the gap (Å) of each group of properties:

- geometry: centre of mass, maximum diameter, pore diameter at the
  centre of mass (closed forms, well conditioned);
- pore_opt: the optimised pore's diameter and centre;
- average: the average diameter;
- windows: each window's diameter and centre, the program's windows
  matched to the reference's nearest centre.

The numbers: ``geometry_A``, the largest geometry gap; ``pore_opt_A``
and ``average_A``, the median gap over the answers (the optimisers and
the ray sampling are chaotic on a few CC3 frames: a change of precision
can move a window by 1 Å or the optimised pore by 0.3 Å, so the widest
gap of these is no steady number); ``off_share``, the share of answers
with a gap of any group, windows included, over :data:`ACCURACY`, or
another number of windows; ``missing``, answers due that never came or
hold a value that is not finite.

On a periodic cell the centres are compared modulo the lattice: the
rebuild may place a whole cage in any image.
"""

from __future__ import annotations

import numpy as np

#: Å: the accuracy pywindow's users are promised against its published
#: numbers (0.01 Å); an answer with a larger gap is off
ACCURACY = 0.01
NUMBERS = ("geometry_A", "pore_opt_A", "average_A", "off_share", "missing")


class Tally:
    """The gaps of the answers compared."""

    def __init__(self) -> None:
        self.gaps: dict[str, list] = {g: [] for g in ("geometry", "pore_opt", "average", "windows")}
        self.answers = 0
        self.off = 0
        self.missing = 0

    @property
    def values(self) -> dict:
        """Each number of :data:`NUMBERS` over the answers so far."""

        def median(g):
            return float(np.median(self.gaps[g])) if self.gaps[g] else 0.0

        return {
            "geometry_A": float(max(self.gaps["geometry"], default=0.0)),
            "pore_opt_A": median("pore_opt"),
            "average_A": median("average"),
            "off_share": self.off / self.answers if self.answers else 0.0,
            "missing": float(self.missing),
        }

    def checks(self, limits: dict) -> list[dict]:
        """``{"name", "value", "limit"}`` of every number."""
        values = self.values
        return [{"name": n, "value": values[n], "limit": limits[n]} for n in NUMBERS]


def snapshot(props):
    """A copy of an answer that holds no view into the program's buffers."""
    if props is None:
        return None
    out = {}
    for k, v in props.items():
        if isinstance(v, dict):
            out[k] = snapshot(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.copy()
        else:
            out[k] = v
    return out


def _windows(props: dict) -> tuple[np.ndarray, np.ndarray]:
    w = props["windows"]
    if w["diameters"] is None:
        return np.zeros(0), np.zeros((0, 3))
    return np.asarray(w["diameters"], np.float64), np.asarray(w["centre_of_mass"], np.float64)


def answer_ok(props) -> bool:
    """Whether an answer came and its core values are finite."""
    if props is None:
        return False
    core = [
        props["maximum_diameter"]["diameter"], props["average_diameter"],
        props["pore_diameter"]["diameter"], props["pore_diameter_opt"]["diameter"],
        *np.asarray(props["centre_of_mass"]).ravel(),
        *np.asarray(props["pore_diameter_opt"]["centre_of_mass"]).ravel(),
    ]
    d, c = _windows(props)
    return bool(np.all(np.isfinite(core)) and np.all(np.isfinite(d)) and np.all(np.isfinite(c)))


def compare(tally: Tally, props, ref: dict, edge: float | None = None) -> None:
    """Fold one answer ``props`` against the reference result ``ref`` into
    ``tally``; ``edge``: the cubic cell's edge on a periodic cell."""
    tally.answers += 1
    if not answer_ok(props):
        tally.missing += 1
        tally.off += 1
        return
    com = np.asarray(props["centre_of_mass"], np.float64)
    shift = np.zeros(3) if edge is None else edge * np.round((com - ref["centre_of_mass"]) / edge)

    def centre_gap(a, b) -> float:
        return float(np.max(np.abs(np.asarray(a, np.float64) - shift - b)))

    opt = props["pore_diameter_opt"]
    gaps = {
        "geometry": max(
            centre_gap(com, ref["centre_of_mass"]),
            abs(props["maximum_diameter"]["diameter"] - ref["maximum_diameter"]),
            abs(props["pore_diameter"]["diameter"] - ref["pore_diameter"]),
        ),
        "pore_opt": max(
            abs(opt["diameter"] - ref["pore_diameter_opt"]),
            centre_gap(opt["centre_of_mass"], ref["pore_opt_centre"]),
        ),
        "average": abs(props["average_diameter"] - ref["average_diameter"]),
    }
    d, c = _windows(props)
    rd, rc = ref["window_diameters"], ref["window_centres"]
    same_count = len(d) == len(rd)
    if same_count and len(d):
        gaps["windows"] = max(
            max(abs(di - rd[j]), float(np.max(np.abs(ci - rc[j]))))
            for di, ci in zip(d, c - shift)
            for j in [int(np.argmin(np.linalg.norm(rc - ci, axis=1)))]
        )
    elif same_count:
        gaps["windows"] = 0.0
    for g, v in gaps.items():
        tally.gaps[g].append(float(v))
    if not same_count or max(gaps.values()) > ACCURACY:
        tally.off += 1


def compare_all(tally: Tally, answers: dict, refs: dict, edge: float | None = None) -> None:
    """Fold every answer into ``tally``: ``answers[key]`` lists the
    program's answers for key (a frame, a file), ``refs[key]`` the
    reference's results for it (one, or a periodic frame's cages, each
    answer matched to the cage whose centre of mass is nearest, modulo
    the lattice)."""
    for key, got in answers.items():
        ref = refs[key]
        coms = np.array([r["centre_of_mass"] for r in ref])
        for props in got:
            if not answer_ok(props) or len(ref) == 1:
                compare(tally, props, ref[0], edge)
                continue
            d = np.asarray(props["centre_of_mass"]) - coms
            if edge is not None:
                d -= edge * np.round(d / edge)
            compare(tally, props, ref[int(np.argmin(np.abs(d).max(1)))], edge)


def as_answer(ref: dict) -> dict:
    """A reference result in the program's answer schema (the control
    puts the reference in the program's place)."""
    any_open = len(ref["window_diameters"]) > 0
    return {
        "centre_of_mass": ref["centre_of_mass"],
        "maximum_diameter": {"diameter": ref["maximum_diameter"]},
        "average_diameter": ref["average_diameter"],
        "pore_diameter": {"diameter": ref["pore_diameter"]},
        "pore_diameter_opt": {"diameter": ref["pore_diameter_opt"],
                              "centre_of_mass": ref["pore_opt_centre"]},
        "windows": {
            "diameters": ref["window_diameters"] if any_open else None,
            "centre_of_mass": ref["window_centres"] if any_open else None,
        },
    }
