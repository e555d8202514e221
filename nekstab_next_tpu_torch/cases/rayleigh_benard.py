"""Rayleigh-Benard convection case — thermal (Boussinesq) instability (port
of ``nekstab_next_tpu/cases/rayleigh_benard.py``).

Nondimensionalization on the layer depth d and thermal diffusion time
d^2/kappa:

    du/dt + u.grad u = -grad p + Pr lap u + Ra Pr theta e_y
    dtheta/dt + u.grad theta = lap theta

Base state: u = 0, T = 1 - y (conduction).  With free-slip walls and
periodic x the linear problem is exactly solvable (Rayleigh 1916): normal
modes w ~ sin(pi y) exp(i k x + sigma t) obey

    (sigma + Pr q^2)(sigma + q^2) = Ra Pr k^2 / q^2,   q^2 = k^2 + pi^2,

with neutral curve Ra_c(k) = q^6/k^2, minimized at k_c = pi/sqrt(2):
Ra_c = 27 pi^4 / 4 ~ 657.51: a machine-checkable growth rate for the
coupled linearized operator.

The walls are free-slip: they mask u_y and leave u_x free, so the velocity
mask differs by component; the layer has no pressure Dirichlet node, so
the pressure solve removes the mean.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..mesh.box import box_mesh_2d
from ..mesh.mesh import BoundaryCondition as BC
from ..ops.core import SEM
from ..stepper.navier_stokes import NavierStokes


def growth_rate_freeslip(Ra: float, Pr: float, k: float) -> float:
    """Exact leading growth rate of the free-slip RB normal mode (n=1)."""
    q2 = k * k + np.pi**2
    # sigma^2 + (1+Pr) q^2 sigma + Pr (q^4 - Ra k^2 / q^2) = 0
    b = (1.0 + Pr) * q2
    c = Pr * (q2 * q2 - Ra * k * k / q2)
    disc = b * b - 4.0 * c
    return float((-b + np.sqrt(disc)) / 2.0)


RA_CRITICAL = 27.0 * np.pi**4 / 4.0  # ~657.511
K_CRITICAL = np.pi / np.sqrt(2.0)


@dataclasses.dataclass
class RayleighBenardCase:
    """Free-slip (stress-free) RB layer, one critical wavelength wide by
    default (``nx`` elements over the width 2 pi / ``wavenumber``).

    ``dtype`` (float64 when None) and ``device`` (the current CUDA device
    when None; raises without one, as ``CylinderCase``) place the fields."""

    rayleigh: float = 2000.0
    prandtl: float = 1.0
    nx: int = 4
    ny: int = 2
    order: int = 6
    wavenumber: float = K_CRITICAL  # domain width = 2 pi / k
    dt: float = 2.5e-3
    solver: SolverConfig = SolverConfig()
    dtype: Optional[torch.dtype] = None
    device: Optional[object] = None

    def __post_init__(self):
        width = 2.0 * np.pi / self.wavenumber
        self.mesh = box_mesh_2d(
            self.nx, self.ny, order=self.order,
            x0=0.0, x1=width, y0=0.0, y1=1.0,
            periodic_x=True,
            bc={"bottom": BC.SYMMETRY, "top": BC.SYMMETRY},
        )
        m = self.mesh
        self.sem = SEM(m, dtype=self.dtype, device=self.device)
        s = self.sem
        # temperature Dirichlet at the free-slip walls (box_mesh_2d only
        # zeroes tmask at WALL/DIRICHLET edges): the buffer is overwritten
        wall = (np.abs(m.y) < 1e-12) | (np.abs(m.y - 1.0) < 1e-12)
        tmask = s.tmask.cpu().numpy() * (~wall)
        s.tmask = torch.as_tensor(tmask, dtype=s.dtype, device=s.device)

        # conduction base state and its Dirichlet data (hot bottom T=1)
        self.base_T = torch.as_tensor((1.0 - m.y)[..., None], dtype=s.dtype, device=s.device)
        self.t_bc = self.base_T.clone()
        self.base_u = torch.zeros(m.x.shape + (2,), dtype=s.dtype, device=s.device)

    def make_ns(self, **kwargs) -> NavierStokes:
        """The coupled stepper: viscosity Pr, one scalar of diffusivity 1,
        buoyancy Ra Pr T e_y; ``kwargs`` go to :class:`NavierStokes`
        (e.g. ``mixed_precision``)."""
        RaPr = self.rayleigh * self.prandtl

        def buoyancy(T):
            z = torch.zeros_like(T[..., 0])
            return torch.stack([z, RaPr * T[..., 0]], dim=-1)

        return NavierStokes(
            self.sem,
            viscosity=self.prandtl,
            dt=self.dt,
            solver=self.solver,
            scalar_diff=(1.0,),
            t_bc=self.t_bc,
            buoyancy=buoyancy,
            **kwargs,
        )

    def exact_growth_rate(self) -> float:
        return growth_rate_freeslip(self.rayleigh, self.prandtl, self.wavenumber)
