"""The decaying Taylor-Green vortex on the PyTorch port (the counterpart of
``examples/taylor_green.py``): five PnPn-2 steps on a periodic 6 x 6 box at
order 6 from the exact solution, printing the same line a step as the JAX
script: the velocity norm beside the exact one, the error, the strong
divergence and the pressure error.

Runs on the current CUDA device; ``NEKSTAB_CPU=1`` selects the CPU.

Usage:  python examples_torch/taylor_green.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

DEVICE = "cpu" if os.environ.get("NEKSTAB_CPU") else None
NU, DT, NSTEPS = 0.1, 0.01, 5


def main() -> None:
    mesh = box_mesh_2d(6, 6, order=6, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    sem = SEM(mesh, device=DEVICE)
    f = lambda a: torch.as_tensor(a, dtype=sem.dtype, device=sem.device)

    def tg(t):
        d = np.exp(-2.0 * NU * t)
        u = -np.cos(mesh.x) * np.sin(mesh.y) * d
        v = np.sin(mesh.x) * np.cos(mesh.y) * d
        p = -0.25 * (np.cos(2 * mesh.x) + np.cos(2 * mesh.y)) * d * d
        return u, v, p

    u0, v0, p0 = tg(0.0)
    ns = NavierStokes(sem, viscosity=NU, dt=DT)
    gll = ns.p_shape == tuple(sem.bm.shape)
    st = ns.make_state(torch.stack([f(u0), f(v0)], dim=-1),
                       p=f(p0) if gll else sem.p_from_gll(f(p0)))
    for k in range(NSTEPS):
        st = ns.step(st)
        ue, _, pe = tg(st.time)
        err = float(sem.norm(st.u[..., 0] - f(ue)))
        p_gll = st.p if gll else sem.p_to_gll(st.p)
        print(f"step {k + 1} t={st.time:.3f} |u|={float(sem.norm(st.u[..., 0])):.6f} "
              f"|ue|={float(sem.norm(f(ue))):.6f} err={err:.3e} "
              f"div={float(sem.norm(sem.div(st.u[..., 0], st.u[..., 1]))):.2e} "
              f"|p-pe|={float(sem.norm(p_gll - f(pe))):.2e}", flush=True)


if __name__ == "__main__":
    main()
