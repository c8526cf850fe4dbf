"""Static configuration of the analysis (frozen copy of
``pywindow_torch/config.py``: ``AnalysisConfig``, the budgets, the
optimisers' dtype and the padding).  The reference runs the card's
stable optimisers whatever the pipeline's dtype.
"""

from __future__ import annotations

import dataclasses

import torch


#: dtype of the optimiser stages (pore centre, window z, window xy),
#: whatever the pipeline dtype.  On a float32 pipeline the stages run
#: the stable drivers on float64 copies of their inputs: in float32 the
#: stable pore driver stops on the NUXHIZ ridge at 8.78 Å (pore_opt)
#: for 20 of 27 one-ulp perturbations of its start point, because the
#: iterate cannot resolve the steps that lead off it, while in float64
#: all 27 stop at the same point.  The JAX package ran these stages in
#: float32 because the TPU emulates float64; the H100 has it natively,
#: and these stages are latency-bound loops over a few lanes.
OPT_DTYPE = torch.float64


def pad_multiple() -> int:
    """Atom-axis padding granularity of :func:`~pywindow_torch.ops.encoding.encode_batch`.

    The CUDA kernels take any atom count, so padding only has to keep
    the port's encoding identical to the JAX package's (8), which the
    parity tests rely on.
    """
    return 8


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Static parameters of the pore/window analysis.

    Defaults reproduce the reference (utilities.py:1364-1377, :391-426,
    :1191-1199, :820-824); the field meanings are documented on
    :class:`pywindow_tpu.config.AnalysisConfig`.
    """

    adjust: float = 1.0
    increment: float = 1.0
    increment2: float = 0.1
    pore_opt: bool = True
    bond_tol: float = 0.4
    lb_z: bool = True
    z_second_mini: bool = False
    dbscan_min_samples: int = 5
    brute_ns: int = 20
    #: window slots per molecule; the host entry point doubles it and
    #: re-runs when a molecule saturates it, up to MAX_WINDOWS_CEILING.
    max_windows: int = 8
    #: open-ray compaction cap as a fraction of the sampling points;
    #: overflow re-runs with the fraction doubled (>= 1.0 disables).
    open_cap_frac: float = 0.4
    opt_maxiter: int = 120
    nm_maxiter: int = 400
    #: run with the reduced budgets below first; a molecule whose
    #: optimiser hits them is re-run at the full budgets.
    fast_budgets: bool = True
    fast_opt_maxiter: int = 40
    fast_nm_maxiter: int = 120

    def __post_init__(self) -> None:
        if self.adjust <= 0 or self.increment <= 0 or self.increment2 <= 0:
            msg = "adjust/increment/increment2 must be positive"
            raise ValueError(msg)
        if self.open_cap_frac <= 0:
            msg = "open_cap_frac must be positive (>= 1.0 disables)"
            raise ValueError(msg)


def effective_budgets(cfg: AnalysisConfig) -> tuple[int, int]:
    """(quasi-Newton, Nelder–Mead) iteration budgets of one run."""
    if cfg.fast_budgets:
        return (
            min(cfg.opt_maxiter, cfg.fast_opt_maxiter),
            min(cfg.nm_maxiter, cfg.fast_nm_maxiter),
        )
    return cfg.opt_maxiter, cfg.nm_maxiter


DEFAULT_CONFIG = AnalysisConfig()

#: bound of the automatic max_windows doubling.
MAX_WINDOWS_CEILING = 64
