"""Cylinder-in-crossflow case setup (port of
``nekstab_next_tpu/cases/cylinder.py``): mesh, freestream Dirichlet BC
field, radial sponge toward the freestream, and stepper construction.
Literature anchors: Hopf bifurcation at Re_c ~ 46.7 with St_c ~ 0.117,
growth rate sigma ~ 0.05 and St ~ 0.13-0.14 at Re = 60 (Barkley 2006)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..mesh.cylinder import cylinder_mesh
from ..ops.core import SEM
from ..stepper.navier_stokes import NavierStokes


def smooth_step(x: np.ndarray) -> np.ndarray:
    """C1 cubic step: 0 for x<=0, 1 for x>=1 (reference ``mth_stepf``)."""
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


@dataclasses.dataclass
class CylinderCase:
    reynolds: float = 60.0
    nr: int = 12
    ntheta: int = 32
    order: int = 6
    outer_radius: float = 40.0
    grading: float = 60.0
    outflow_half_angle: float = 70.0
    sponge_start_frac: float = 0.5  # sponge begins at this fraction of R_out
    sponge_strength: float = 1.0
    dt: Optional[float] = None
    target_cfl: float = 0.5
    solver: SolverConfig = SolverConfig()
    dtype: Optional[torch.dtype] = None  # None -> float64
    device: Optional[object] = None  # None -> the current CUDA device (raises without one)
    # f64 state, f32 inner solves under iterative refinement: fused-IR on K1/K2
    # with fused_solves on a shift-decomposable mesh, else the legacy
    # 'laplacian' path (NavierStokes chooses, as the JAX stepper does)
    mixed_precision: bool = False

    def __post_init__(self):
        self.mesh = cylinder_mesh(
            nr=self.nr,
            ntheta=self.ntheta,
            order=self.order,
            outer_radius=self.outer_radius,
            grading=self.grading,
            outflow_half_angle=self.outflow_half_angle,
        )
        m = self.mesh
        self.sem = SEM(m, dtype=self.dtype, device=self.device)
        s = self.sem
        r = np.sqrt(m.x**2 + m.y**2)

        # freestream Dirichlet values on the outer arc (wall stays 0)
        ubc = np.zeros(m.x.shape + (2,))
        outer = m.dirichlet_nodes & (r > 1.0)
        ubc[outer, 0] = 1.0
        self.u_bc = torch.as_tensor(ubc, dtype=s.dtype, device=s.device)

        # radial sponge toward the freestream + masked inner product
        if self.sponge_strength > 0:
            r0 = self.sponge_start_frac * self.outer_radius
            lam = self.sponge_strength * smooth_step(
                (r - r0) / (self.outer_radius - r0)
            )
            s.set_sponge(lam)
            self.sponge_ref = torch.as_tensor(
                np.stack([np.ones_like(m.x), np.zeros_like(m.x)], axis=-1),
                dtype=s.dtype, device=s.device,
            )
        else:
            self.sponge_ref = None

        if self.dt is None:
            # CFL-targeted dt; |u| ~ 1.5
            self.dt = float(self.target_cfl * m.min_spacing() / 1.5)

    def make_ns(self) -> NavierStokes:
        return NavierStokes(
            self.sem,
            viscosity=1.0 / self.reynolds,
            dt=self.dt,
            u_bc=self.u_bc,
            sponge_ref=self.sponge_ref,
            solver=self.solver,
            mixed_precision=self.mixed_precision,
        )

    def uniform_flow(self) -> torch.Tensor:
        """Freestream initial condition honoring the wall BC."""
        m, s = self.mesh, self.sem
        u = np.stack([np.ones_like(m.x), np.zeros_like(m.x)], axis=-1)
        return torch.as_tensor(u, dtype=s.dtype, device=s.device) * s.vmask + self.u_bc
