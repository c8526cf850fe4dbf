"""Force-field atom-key deciphering (DL_F and OPLS notations).

Host-side string work, performed once at the I/O boundary
(reference: utilities.py:267-341).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.frozen.tables import opls_atom_keys


class AtomKeyError(KeyError):
    """An atom key could not be deciphered."""


class AtomKeyConflictError(AtomKeyError):
    """An OPLS atom key that is ambiguous without user intervention."""


class ForceFieldError(ValueError):
    """An unsupported force field was requested."""


#: OPLS keys that collide with element symbols and must be swapped by the
#: user first (reference: utilities.py:291).
OPLS_CONFLICTS = ("ne", "he", "na")

# reverse map: opls key -> element (first element wins, like the reference's
# insertion-ordered scan over opls_atom_keys).
_OPLS_REVERSE: dict[str, str] = {}
for _el, _keys in opls_atom_keys.items():
    for _k in _keys:
        _OPLS_REVERSE.setdefault(_k, _el)


def dlf_notation(atom_key: str) -> str:
    """DL_F notation: leading alphabetic run, '?' and digits stripped.

    reference: utilities.py:267-285 (including the Materials-Studio
    leading-integer tolerance).
    """
    out = []
    for ch in str(atom_key):
        if ch.isdigit():
            if out:
                break
            continue  # tolerate leading integers (Materials Studio output)
        if ch == "?":
            continue
        out.append(ch)
    if not out:
        msg = f"cannot decipher DL_F atom key {atom_key!r}"
        raise AtomKeyError(msg)
    return "".join(out)


def opls_notation(atom_key: str) -> str:
    """OPLS atom key -> element symbol (reference: utilities.py:288-305)."""
    if atom_key in OPLS_CONFLICTS:
        msg = (
            f"ambiguous OPLS atom key {atom_key!r} (Ne/He/Na conflict); "
            "swap it explicitly with MolecularSystem.swap_atom_keys()"
        )
        raise AtomKeyConflictError(msg)
    try:
        return _OPLS_REVERSE[atom_key]
    except KeyError:
        msg = f"OPLS atom key {atom_key!r} not found in the OPLS dictionary"
        raise AtomKeyError(msg) from None


_NOTATIONS = {
    "DLF": dlf_notation,
    "DL_F": dlf_notation,
    "OPLS": opls_notation,
    "OPLSAA": opls_notation,
    "OPLS2005": opls_notation,
    "OPLS3": opls_notation,
}


def decipher_atom_key(atom_key: str, forcefield: str) -> str:
    """Dispatch an atom key to the right notation decoder."""
    fn = _NOTATIONS.get(str(forcefield).upper())
    if fn is None:
        msg = (
            f"force field {forcefield!r} is not supported; choose one of "
            f"{sorted(_NOTATIONS)}"
        )
        raise ForceFieldError(msg)
    return fn(atom_key)


def decipher_all(atom_keys, forcefield: str) -> np.ndarray:
    """Vector version: decipher each *distinct* key once and gather.

    O(distinct keys) decipher work per call with no retained global
    state — trajectory frames repeat a handful of distinct keys.
    """
    arr = np.asarray(atom_keys)
    uniq, inverse = np.unique(arr, return_inverse=True)
    mapped = np.array(
        [decipher_atom_key(str(k), forcefield) for k in uniq],
        dtype="<U8",
    )
    return mapped[inverse]
