"""Print the restart transient of the cube example's base flow under the
JAX package's 3-D PnPn-2 step and the port's, on the CPU.

    python3 tools_torch/cube_restart_check.py [--steps 50]

``cube_out/BF_cube_00001.npz`` holds the velocity of the JAX march that
stopped at |du/dt| ~ 3.25e-8, without its pressure and step history.  A
fresh state from it (zero pressure, the BDF1 -> BDF3 ramp) moves the wake
by a transient: this script marches both packages ``--steps`` steps from
it with ``examples/cube_transient_growth.py``'s case and solver (184
elements at order 4, f64, 'pnpn2', 'fdm', 1e-7/1e-8) and prints the
example's measure |du/dt| ~ ||u_N - u_0|| / (N dt) after 5, 10, 20 and N
steps in each package, and the two packages' distance.  The port's SEM3
takes the JAX SEM3's factors.  ``chip_smoke.py`` phase 7 holds the card's
march to the JAX value printed here.  Takes about two minutes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube  # noqa: E402
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from nekstab_next_tpu_torch.config import SolverConfig  # noqa: E402
from nekstab_next_tpu_torch.interop import sem3_arrays, sem3_from_arrays  # noqa: E402
from nekstab_next_tpu_torch.stepper import NavierStokes  # noqa: E402

CASE = dict(reynolds=60.0, h=2.0, lx=12.0, ly=4.0, lz=4.0, cube_x=4.0, cube_z=2.0,
            nx=12, ny=4, nz=4, order=4, delta=1.0, target_cfl=0.2)
SOLVER = dict(pressure_tol=1e-7, velocity_tol=1e-8, pressure_maxiter=300,
              velocity_maxiter=120)
MARKS = (5, 10, 20)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    torch.backends.opt_einsum.enabled = False
    jcase = JaxCube(**CASE, solver=JaxSolverConfig(**SOLVER))
    jsem = jcase.sem
    base = np.load(ROOT / "cube_out" / "BF_cube_00001.npz")["u"]
    marks = sorted(set(MARKS + (args.steps,)))

    def measure(norm, u, n):
        return norm(u - base) / (n * jcase.dt)

    jns = jcase.make_ns()
    jstep = jax.jit(jns.step)
    jnorm = lambda d: float(jnp.sqrt(sum(jsem.inner(d[..., i], d[..., i], masked=False)
                                         for i in range(3))))
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=jcase.h / jcase.reynolds, dt=jcase.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)), solver=SolverConfig(**SOLVER))
    pnorm = lambda d: float(torch.sqrt(sum(sem.inner(d[..., i], d[..., i], masked=False)
                                           for i in range(3))))
    jst = jns.make_state(jnp.asarray(base))
    st = ns.make_state(torch.as_tensor(base))
    for n in range(1, args.steps + 1):
        jst = jstep(jst)
        st = ns.step(st)
        if n in marks:
            ju = np.asarray(jst.u)
            pu = st.u.numpy()
            print(f"{n} steps: |du/dt| JAX {measure(lambda d: jnorm(jnp.asarray(d)), ju, n):.10e}, "
                  f"port {measure(lambda d: pnorm(torch.as_tensor(d)), pu, n):.10e}; "
                  f"max |u_port - u_JAX| / max |u_JAX| "
                  f"{np.abs(pu - ju).max() / np.abs(ju).max():.3e}", flush=True)


if __name__ == "__main__":
    main()
