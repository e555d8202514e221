"""3-D wall-mounted-cube roughness case (port of
``nekstab_next_tpu/cases/cube.py``).

Geometry: channel-like box [0,Lx] x [0,Ly] x [0,Lz] with a cube of side h
mounted on the bottom wall, carved out of the element lattice (faces exposed
by carving are tagged WALL).  Inflow: smooth shear profile u(y); spanwise (z)
periodic; outflow at x = Lx; freestream Dirichlet at the top."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..mesh.mesh import BoundaryCondition as BC
from ..mesh.mesh3 import box_mesh_3d
from ..ops.core3 import SEM3
from ..stepper.navier_stokes import NavierStokes


@dataclasses.dataclass
class CubeRoughnessCase:
    """Cube of side ``h`` at x ~ cube_x on the bottom wall."""

    reynolds: float = 500.0  # U_inf h / nu
    h: float = 1.0
    lx: float = 12.0
    ly: float = 4.0
    lz: float = 4.0
    cube_x: float = 4.0
    cube_z: Optional[float] = None  # default: lz / 2
    nx: int = 12
    ny: int = 4
    nz: int = 4
    order: int = 5
    delta: float = 1.5  # inflow shear-layer thickness
    dt: Optional[float] = None
    target_cfl: float = 0.5
    solver: SolverConfig = SolverConfig()
    dtype: Optional[torch.dtype] = None  # None -> float64
    device: Optional[object] = None  # None -> the current CUDA device (raises without one)

    def __post_init__(self):
        h = self.h
        zc0 = self.lz / 2 if self.cube_z is None else self.cube_z
        x0c, x1c = self.cube_x - h / 2, self.cube_x + h / 2
        z0c, z1c = zc0 - h / 2, zc0 + h / 2

        def carve(xc, yc, zc):
            return (x0c < xc < x1c) and (yc < h) and (z0c < zc < z1c)

        self.mesh = box_mesh_3d(
            self.nx, self.ny, self.nz, order=self.order,
            x1=self.lx, y1=self.ly, z1=self.lz,
            bc={
                "left": BC.DIRICHLET,
                "right": BC.OUTFLOW,
                "bottom": BC.WALL,
                "top": BC.DIRICHLET,
            },
            periodic_z=True,
            mask=carve,
            mask_bc=BC.WALL,
        )
        m = self.mesh
        self.sem = SEM3(m, dtype=self.dtype, device=self.device)
        s = self.sem

        prof = np.tanh(m.y / self.delta)
        ubc = np.zeros(m.x.shape + (3,))
        dirichlet = m.dirichlet_nodes & (
            np.isclose(m.x, 0.0) | np.isclose(m.y, self.ly)
        )
        ubc[..., 0] = np.where(dirichlet, prof, 0.0)
        self.u_bc = torch.as_tensor(ubc, dtype=s.dtype, device=s.device)

        if self.dt is None:
            self.dt = float(self.target_cfl * m.min_spacing() / 1.2)

    def make_ns(self) -> NavierStokes:
        return NavierStokes(
            self.sem,
            viscosity=self.h / self.reynolds,
            dt=self.dt,
            u_bc=self.u_bc,
            solver=self.solver,
        )

    def initial_flow(self) -> torch.Tensor:
        m, s = self.mesh, self.sem
        prof = np.tanh(m.y / self.delta)
        u = np.stack([prof, np.zeros_like(prof), np.zeros_like(prof)], axis=-1)
        return torch.as_tensor(u, dtype=s.dtype, device=s.device) * s.vmask + self.u_bc
