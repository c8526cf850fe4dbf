"""Static configuration and the dtype policy of the analysis.

``AnalysisConfig`` mirrors :class:`pywindow_tpu.config.AnalysisConfig`
field for field, so one package's config converts into the other's
(see :func:`pywindow_torch.convert.config_from_dict`).

Device policy: every entry point runs on the card unless the caller
asks for the CPU, and raises when asked for a card that is not there
(:func:`resolve_device`).  An entry point's ``device=None`` is the
default device, :func:`default_device`: the card, or what the caller
names once in ``PYWINDOW_TORCH_DEVICE`` (the counterpart of the JAX
package's ``jax_platforms``; the CPU tests set it to ``cpu``).

Dtype policy (counterpart of ``pywindow_tpu.config.default_dtype``):
float64 on the CPU, where the optimisers run in the scipy-parity
"classic" mode; float32 on CUDA, where they run in the "stable"
symbolic-difference mode, as the optimiser kernels.
``PYWINDOW_TORCH_FORCE_F32=1`` forces float32 on the CPU too, so the
stable path can be tested without a card.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch


def warm_cpu_math() -> None:
    """One discarded multithreaded ``torch.sqrt`` in each float dtype.

    With torch 2.13.0+cpu (MKL vector math, 8 OpenMP threads, an AVX-512
    host) the first multithreaded ``torch.sqrt`` of a process returned,
    in some processes and not others, one thread's share of the elements
    at reduced precision; later calls were unaffected.  The plain
    versions on the CPU take square roots of (Q, N) or larger tensors,
    so the first of them could return a wrong answer.  Called once at
    import, with enough elements to engage every thread.
    """
    n = torch.get_num_threads() * 32768
    for dtype in (torch.float32, torch.float64):
        torch.sqrt(torch.ones(n, dtype=dtype))


warm_cpu_math()


#: names the default device (:func:`default_device`)
DEVICE_ENV = "PYWINDOW_TORCH_DEVICE"


def default_device() -> torch.device:
    """The device of an entry point called without one: ``cuda`` unless
    :data:`DEVICE_ENV` names ``cpu``, ``cuda`` or ``cuda:N`` (read at
    each call); any other value raises ``ValueError``."""
    name = os.environ.get(DEVICE_ENV, "cuda")
    if re.fullmatch(r"cpu|cuda(:\d+)?", name) is None:
        msg = f"{DEVICE_ENV}={name!r}: expected cpu, cuda or cuda:N"
        raise ValueError(msg)
    return torch.device(name)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on (``None``: :func:`default_device`);
    raises when the card is asked for and none is available (there is
    no fallback to the CPU)."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (
            "pywindow_torch: no CUDA device is available; "
            f"pass device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU"
        )
        raise RuntimeError(msg)
    return dev


def default_dtype(device: torch.device | str) -> torch.dtype:
    """Compute dtype for tensors that live on ``device``."""
    if os.environ.get("PYWINDOW_TORCH_FORCE_F32"):
        return torch.float32
    if torch.device(device).type == "cpu":
        return torch.float64
    return torch.float32


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


def pore_opt_mode(dtype: torch.dtype) -> str:
    """How the pore-centre optimiser consumes its objective, by the
    pipeline dtype.

    ``"stable"`` (float32 pipeline): the symbolic-difference L-BFGS-B
    driver (:func:`pywindow_torch.ops.lbfgsb.lbfgsb_minimize_stable`),
    whose decisions only see cancellation-free clearance differences,
    so its gradients carry no finite-difference cancellation noise.
    ``"classic"`` (float64 pipeline): the plain driver with scipy's FD
    gradients, the scipy-parity golden path the JAX package runs on the
    CPU.  Both run in :data:`OPT_DTYPE`.
    """
    return "stable" if dtype == torch.float32 else "classic"


def window_opt_mode(dtype: torch.dtype) -> str:
    """How the window z and xy optimisers consume their objectives
    (same rule as :func:`pore_opt_mode`)."""
    return "stable" if dtype == torch.float32 else "classic"


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

#: the escalation markers of a device run's properties dict, by reason,
#: in the order a molecule's re-runs take them
ESCALATION_MARKERS = {
    "open_overflow": "_open_cap_overflow",
    "budget": "_opt_budget_exceeded",
    "window_sat": "_window_cap_saturated",
}


def escalate(cfg: AnalysisConfig, reason: str) -> AnalysisConfig | None:
    """The config a molecule re-runs at when its run at ``cfg`` raised
    the marker of ``reason`` (:data:`ESCALATION_MARKERS`), or None when
    that marker escalates no further:

    - ``open_overflow``: ``open_cap_frac`` doubled;
    - ``budget``: the full optimiser budgets, once (a full-budget run
      that still caps matches scipy's own maxiter stop);
    - ``window_sat``: ``max_windows`` doubled, up to
      :data:`MAX_WINDOWS_CEILING`.
    """
    if reason == "open_overflow":
        return dataclasses.replace(cfg, open_cap_frac=2.0 * cfg.open_cap_frac)
    if reason == "budget":
        return dataclasses.replace(cfg, fast_budgets=False) if cfg.fast_budgets else None
    if reason == "window_sat":
        if cfg.max_windows >= MAX_WINDOWS_CEILING:
            return None
        return dataclasses.replace(cfg, max_windows=min(2 * cfg.max_windows, MAX_WINDOWS_CEILING))
    msg = f"escalate: unknown reason {reason!r}"
    raise ValueError(msg)
