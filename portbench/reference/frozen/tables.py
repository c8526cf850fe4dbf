"""Chemical reference data for pywindow_torch (a copy of pywindow_tpu.tables).

Atomic masses, van der Waals radii and covalent radii follow the CCDC
compilations used by the reference implementation
(reference: src/pywindow/_internal/tables.py:1-762) -- these are physical
constants, stored here as a single parsed text table rather than literal
dictionaries.  The dummy atom ``X`` (mass/radii = 1) is included for
coarse-grained models.

Exports (same semantics as the reference):

* ``atomic_mass`` / ``atomic_vdw_radius`` / ``atomic_covalent_radius`` --
  dicts keyed by UPPERCASE element symbol.
* ``periodic_table`` -- dict mapping element symbol (canonical case) to
  atomic number, all 118 elements.
* ``opls_atom_keys`` -- element symbol -> tuple of OPLS force-field atom
  keys that decipher to it.
* Integer-encoded lookup arrays (``ELEMENT_MASS``, ``ELEMENT_VDW``,
  ``ELEMENT_COV``) indexed by the internal element id used on device, and
  ``element_ids()`` to encode element-symbol arrays.
"""

from __future__ import annotations

import numpy as np

# One row per element known to the analysis kernels:
#   symbol  Z  mass  vdw_radius  covalent_radius     (radii in Angstrom)
_ELEMENT_ROWS = """\
H    1      1.008  1.09  0.23
He   2      4.003   1.4   1.5
Li   3      6.941  1.82  1.28
Be   4      9.012     2  0.96
B    5     10.811     2  0.83
C    6     12.011   1.7  0.68
N    7     14.007  1.55  0.68
O    8     15.999  1.52  0.68
F    9     18.998  1.47  0.64
Ne  10      20.18  1.54   1.5
Na  11     22.991  2.27  1.66
Mg  12     24.305  1.73  1.41
Al  13     26.982     2  1.21
Si  14     28.086   2.1   1.2
P   15     30.974   1.8  1.05
S   16     32.066   1.8  1.02
Cl  17     35.453  1.75  0.99
Ar  18     39.948  1.88  1.51
K   19     39.098  2.75  2.03
Ca  20     40.078     2  1.76
Sc  21     44.956     2   1.7
Ti  22     47.867     2   1.6
V   23     50.942     2  1.53
Cr  24     51.996     2  1.39
Mn  25     54.938     2  1.61
Fe  26     55.845     2  1.52
Co  27     58.933     2  1.26
Ni  28     58.693  1.63  1.24
Cu  29     63.546   1.4  1.32
Zn  30      65.39  1.29  1.22
Ga  31     69.723  1.87  1.22
Ge  32      72.61     2  1.17
As  33     74.922  1.85  1.21
Se  34      78.96   1.9  1.22
Br  35     79.904  1.85  1.21
Kr  36       83.8  2.02   1.5
Rb  37     85.468     2   2.2
Sr  38      87.62     2  1.95
Y   39     88.906     2   1.9
Zr  40     91.224     2  1.75
Nb  41     92.906     2  1.64
Mo  42      95.94     2  1.54
Ru  44     101.07     2  1.46
Rh  45    102.906     2  1.42
Pd  46     106.42  1.63  1.39
Ag  47    107.868  1.72  1.45
Cd  48    112.411  1.58  1.54
In  49    114.818  1.93  1.42
Sn  50     118.71  2.17  1.39
Sb  51     121.76     2  1.39
Te  52      127.6  2.06  1.47
I   53    126.904  1.98   1.4
Xe  54     131.29  2.16   1.5
Cs  55    132.905     2  2.44
Ba  56    137.327     2  2.15
La  57    138.906     2  2.07
Ce  58    140.116     2  2.04
Pr  59    140.908     2  2.03
Nd  60     144.24     2  2.01
Sm  62     150.36     2  1.98
Eu  63    151.964     2  1.98
Gd  64     157.25     2  1.96
Tb  65    158.925     2  1.94
Dy  66      162.5     2  1.92
Ho  67     164.93     2  1.92
Er  68     167.26     2  1.89
Tm  69    168.934     2   1.9
Yb  70     173.04     2  1.87
Lu  71    174.967     2  1.87
Hf  72     178.49     2  1.75
Ta  73    180.948     2   1.7
W   74     183.84     2  1.62
Re  75    186.207     2  1.51
Os  76     190.23     2  1.44
Ir  77    192.217     2  1.41
Pt  78    195.078  1.72  1.36
Au  79    196.967  1.66  1.36
Hg  80     200.59  1.55  1.32
Tl  81    204.383  1.96  1.45
Pb  82      207.2  2.02  1.46
Bi  83     208.98     2  1.48
Th  90    232.038     2  2.06
Pa  91    231.036     2     2
U   92    238.029  1.86  1.96
X    0          1     1     1
"""

# Elements with a known atomic number but no mass/radii entry in the CCDC
# tables (analysis on these raises, matching the reference KeyError).
_Z_ONLY_ROWS = """\
Ac 89
Am 95
At 85
Bh 107
Bk 97
Cf 98
Cm 96
Cn 112
Db 105
Ds 110
Es 99
Fl 114
Fm 100
Fr 87
Hs 108
Lr 103
Lv 116
Md 101
Mt 109
No 102
Np 93
Pm 61
Po 84
Pu 94
Ra 88
Rf 104
Rg 111
Rn 86
Sg 106
Tc 43
Uuo 118
Uup 115
Uus 117
Uut 113
"""

# OPLS force-field atom keys, grouped per deciphered element.
_OPLS_ROWS = """\
Ar: AR Ar ar
B: B b
Br: BR BR- Br br br-
C: CTD CZN C CBO CZB CDS CALK CG CML C5B CTP CTF C5BC CZA CTS CO C5X CQ CP1 CDXR CANI CRA C4T CHZ CAO CTA CDX CA5 CTJ CZ CO4 CTI C5BB CG1 C5M CTM CT C5A CN C3M CB CT1 C5N CO3 CTQ CTH CTU CTE CTC CTG C3T CD CME CT_F CA C56B CT1G C56A CM CTNC CR3 ctd czn c cbo czb cds calk cg cml c5b ctp ctf c5bc cza cts co c5x cq cp1 cdxr cani cra c4t chz cao cta cdx ca5 ctj cz co4 cti c5bb cg1 c5m ctm ct c5a cn c3m cb ct1 c5n co3 ctq cth ctu cte ctc ctg c3t cd cme ct_f ca c56b ct1g c56a cm ctnc cr3
Cl: CL CL- Cl cl cl-
F: F FX1 FX2 FX3 FX4 FG F- f fx1 fx2 fx3 fx4 fg f-
H: HA HAE HS HT3 HC HWS H HNP HAM H_OH HP HT4 HG HMET HO HANI HY HCG HE ha hae hs ht3 hc hws h hnp ham h_oh hp ht4 hg hmet ho hani hy hcg
He: He
I: I I- i i-
Kr: Kr kr
N: NAP NN NB N5BB NS NOM NTC NP N NTH2 NTH NZC NO N5B NO3 NZT NZ NI NTH0 NA5B NT NO2 NBQ NG NE NZA NA NZB NHZ NO2B NEA NA5 NE nap nn nb n5bb ns nom ntc np n nth2 nth nzc no n5b no3 nzt nz ni nth0 na5b nt no2 nbq ng nza nzb nhz no2b nea na5
Na: Na Na+
Ne: Ne
O: OM OAB ONI O2ZP O2Z OHE OES OBS OT4 OWS O3T OT3 O4T OAL O2 OAS OS ON OVE OZ O OHX OY ONA OA OHP OSP OH om oab oni o2zp o2z ohe oes obs ot4 ows o3t ot3 o4t oal o2 oas os on ove oz o ohx oy ona oa ohp osp oh
P: P P1 P2 P3 P4 PR p p1 p2 p3 p4 pr
Rn: Rn rn
S: S SX6 SY SH SA SZ SD s sx6 sy sh sa sz sd
Xe: Xe xe
"""


def _parse_elements() -> tuple:
    symbols, zs, masses, vdws, covs = [], [], [], [], []
    for line in _ELEMENT_ROWS.strip().splitlines():
        sym, z, mass, vdw, cov = line.split()
        symbols.append(sym)
        zs.append(int(z))
        masses.append(float(mass))
        vdws.append(float(vdw))
        covs.append(float(cov))
    return (
        tuple(symbols),
        np.asarray(zs, dtype=np.int32),
        np.asarray(masses, dtype=np.float64),
        np.asarray(vdws, dtype=np.float64),
        np.asarray(covs, dtype=np.float64),
    )


ELEMENT_SYMBOLS, ELEMENT_Z, ELEMENT_MASS, ELEMENT_VDW, ELEMENT_COV = (
    _parse_elements()
)

#: internal element id, keyed by UPPERCASE symbol.
ELEMENT_INDEX: dict[str, int] = {
    sym.upper(): i for i, sym in enumerate(ELEMENT_SYMBOLS)
}

atomic_mass: dict[str, float] = {
    sym.upper(): float(m) for sym, m in zip(ELEMENT_SYMBOLS, ELEMENT_MASS)
}
atomic_vdw_radius: dict[str, float] = {
    sym.upper(): float(r) for sym, r in zip(ELEMENT_SYMBOLS, ELEMENT_VDW)
}
atomic_covalent_radius: dict[str, float] = {
    sym.upper(): float(r) for sym, r in zip(ELEMENT_SYMBOLS, ELEMENT_COV)
}

periodic_table: dict[str, int] = {
    sym: int(z) for sym, z in zip(ELEMENT_SYMBOLS, ELEMENT_Z) if sym != "X"
}
for _line in _Z_ONLY_ROWS.strip().splitlines():
    _sym, _z = _line.split()
    periodic_table[_sym] = int(_z)

opls_atom_keys: dict[str, tuple[str, ...]] = {}
for _line in _OPLS_ROWS.strip().splitlines():
    _el, _keys = _line.split(":")
    opls_atom_keys[_el.strip()] = tuple(_keys.split())


class UnknownElementError(KeyError):
    """Raised when an element symbol has no mass/radius data."""


_ENCODE_CACHE: dict = {}


def element_ids(elements) -> np.ndarray:
    """Encode an array of element symbols into internal integer ids.

    Symbols are matched case-insensitively.  Raises
    :class:`UnknownElementError` for symbols without tabulated data.
    Encodings are memoised per distinct element sequence (trajectory
    frames repeat the same sequence thousands of times).
    """
    arr = np.asarray(elements)
    key = None
    if arr.dtype.kind in ("U", "S"):
        key = (arr.dtype.str, arr.tobytes())
        cached = _ENCODE_CACHE.get(key)
        if cached is not None:
            return cached
    ids = np.empty(len(arr), dtype=np.int32)
    for i, sym in enumerate(arr):
        try:
            ids[i] = ELEMENT_INDEX[str(sym).upper()]
        except KeyError:
            msg = (
                f"element {sym!r} has no tabulated mass/radius data; "
                "decipher force-field atom keys first (see manual)"
            )
            raise UnknownElementError(msg) from None
    if key is not None:
        if len(_ENCODE_CACHE) > 256:
            _ENCODE_CACHE.clear()
        _ENCODE_CACHE[key] = ids
    return ids
