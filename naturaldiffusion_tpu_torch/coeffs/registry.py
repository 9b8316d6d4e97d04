"""Name -> deriver registry (copy of ``naturaldiffusion_tpu/coeffs/
registry.py``, numpy only).

``step_counts`` mirrors the grids the reference ships in ``results/``
(e.g. ``src/AnalyzeDDPMDDIM.py:408-429``, ``src/AnalyzeDPMSolver.py:669-690``);
the repository's copy is ``results/corpus/<result_dir>/<prefix>_NNN.npz``.
Note the 2s/3s DPM-Solver and Heun entries take the number of *outer*
steps; the emitted matrix has 2x/3x rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import ddpm_ddim, deis, dpm_solver, euler_heun, flow
from .matrix import CoeffMatrix


@dataclasses.dataclass(frozen=True)
class DeriverSpec:
    fn: Callable[[int], CoeffMatrix]
    step_counts: tuple[int, ...]          # reference-shipped grids
    result_dir: str                       # subdir under results/
    prefix: str                           # file prefix inside that dir
    rows_per_step: int = 1                # matrix rows per 'step' argument


DERIVERS: dict[str, DeriverSpec] = {
    "ddpm": DeriverSpec(ddpm_ddim.derive_ddpm, (18, 24, 100, 200), "ddpm", "ddpm_sympy"),
    "ddpm_analytic": DeriverSpec(ddpm_ddim.derive_ddpm_analytic, (18, 24, 100, 500), "ddpm", "ddpm"),
    "ddim": DeriverSpec(ddpm_ddim.derive_ddim, (18, 24, 100, 200), "ddim", "ddim_sympy"),
    "ddim_analytic": DeriverSpec(ddpm_ddim.derive_ddim_analytic, (18, 24, 100, 500), "ddim", "ddim"),
    "sde_euler": DeriverSpec(euler_heun.derive_sde_euler, (18, 24, 100, 200), "euler_heun", "sde_euler"),
    "ode_euler": DeriverSpec(euler_heun.derive_ode_euler, (18, 24, 100, 200), "euler_heun", "ode_euler"),
    "ode_heun": DeriverSpec(euler_heun.derive_ode_heun, (9, 12, 50, 100), "euler_heun", "ode_heun", rows_per_step=2),
    "dpmsolver2s": DeriverSpec(dpm_solver.derive_dpmsolver_2s, (9, 12, 50, 100), "dpmsolver", "dpmsolver2s", rows_per_step=2),
    "dpmsolver3s": DeriverSpec(dpm_solver.derive_dpmsolver_3s, (6, 8, 33, 67), "dpmsolver", "dpmsolver3s", rows_per_step=3),
    "dpmsolverpp2s": DeriverSpec(dpm_solver.derive_dpmsolver_pp_2s, (9, 12, 50, 100), "dpmsolverpp", "dpmsolverpp2s", rows_per_step=2),
    "dpmsolverpp3s": DeriverSpec(dpm_solver.derive_dpmsolver_pp_3s, (6, 8, 33, 67), "dpmsolverpp", "dpmsolverpp3s", rows_per_step=3),
    "deis_tab": DeriverSpec(deis.derive_deis_tab, (18, 24, 100, 200), "deis", "deis_tab"),
    "flow_euler": DeriverSpec(flow.derive_flow_euler, (18, 24, 100, 200), "flow_euler", "flow_euler_simpy"),
    "flow_euler_analytic": DeriverSpec(flow.derive_flow_euler_analytic, (18,), "flow_euler", "flow_euler"),
}


def derive(name: str, num_step: int) -> CoeffMatrix:
    """Derive + NaN-guard: a poisoned schedule raises FloatingPointError
    here instead of silently emitting NaN matrices."""
    if name not in DERIVERS:
        raise KeyError(f"unknown derivation {name!r}; known: "
                       f"{sorted(DERIVERS)}")
    return DERIVERS[name].fn(num_step).check_finite(
        context=f"{name}({num_step})")
