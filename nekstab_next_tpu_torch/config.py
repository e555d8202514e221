"""Solver and Newton configuration — the same frozen dataclasses as
``nekstab_next_tpu/config.py`` ``SolverConfig`` and ``NewtonConfig``, field
for field, so one config built for either package builds the other.

The port implements a subset of the options.  Where the JAX package quietly
falls back to another path, the port raises where it reads an option it does
not implement (``stepper/navier_stokes.py`` ``NavierStokes``):

* ``lanes_layout``, ``pressure_direct``, ``cg_fixed_iters`` and
  ``fused_pressure=False`` are TPU workarounds and are not ported;
* ``fused_solves`` needs float32 fields, or ``mixed_precision``, where the
  kernels are the f32 inner solves of ``mixed_ir_cycles`` refinement
  cycles (the fused-IR path), and runs on the 2-D ``'pnpn2'`` step only.

``finite_difference`` (with ``fd_order``) is read by the stability
analyses, which then take the finite-difference propagator (direct only).

``bdf_order`` and ``NewtonConfig.finite_difference`` are read nowhere, as in
the JAX package: the stepper always ramps BDF1 -> BDF3 and Newton always
takes the exact tangent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Time-integration / inner-solver knobs (field meanings as in the JAX
    package's ``SolverConfig``)."""

    dt: Optional[float] = None  # None -> from target_cfl
    target_cfl: float = 0.5
    bdf_order: int = 3  # read nowhere: the stepper always ramps BDF1 -> 3
    pressure_tol: float = 1e-8
    velocity_tol: float = 1e-9
    scalar_tol: float = 1e-9
    pressure_maxiter: int = 2000
    velocity_maxiter: int = 500
    scalar_maxiter: int = 500
    dealias: bool = True  # 3/2 over-integration of convection
    fdm_precond: bool = True  # FDM element preconditioner; False -> Jacobi
    pressure_operator: str = "pnpn2"  # 'pnpn2' | 'consistent' | 'laplacian'
    finite_difference: bool = False  # the analyses' finite-difference propagator
    fd_order: int = 2
    warm_start: bool = True  # residual-correction warm start of both solves
    pressure_precond: str = "fdm"  # 'fdm' | 'block' | 'schwarz' (ops/schwarz.py)
    pressure_patch_overlap: str = "face"  # 'schwarz' patches: 'face' | 'node'
    velocity_precond: str = "fdm"  # 'fdm' | 'block' (exact element blocks)
    pressure_direct: bool = False  # lanes path only (not ported)
    fused_solves: bool = False  # both inner solves as one CUDA kernel each (K1, K2)
    fused_pressure: bool = True  # False is a TPU-compiler workaround
    mixed_ir_cycles: int = 2  # refinement cycles of each fused-IR solve
    cg_fixed_iters: bool = False  # TPU While-trip workaround (not ported)
    lanes_layout: bool = False  # TPU lanes layout (not ported)


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton-Krylov knobs (field meanings as in the JAX package's
    ``NewtonConfig``; ``finite_difference`` is read nowhere, as in the JAX
    package)."""

    max_iter: int = 100
    tol: float = 1e-10
    gmres_restarts: int = 100
    dynamic_tol: bool = True  # Eisenstat-Walker forcing of the GMRES tolerance
    finite_difference: bool = False  # read nowhere (Newton takes the exact tangent)
    fd_order: int = 2
    fd_epsilon: float = 1e-6
