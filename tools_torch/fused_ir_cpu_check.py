"""Print how far the fused-IR mixed-precision path is from the f64 path, in
the JAX package and in the port, on the CPU.

    python3 tools_torch/fused_ir_cpu_check.py

The numbers that ``tests/test_torch_mixed_ir.py`` bounds, printed: on the
32-element cylinder (``nr=4, ntheta=8, order=6``) with the mixed settings of
``examples/cylinder_stability.py``, about the uniform flow, 3 steps, the
3-step tangent matvec and rmatvec of a seeded C0 field: JAX's fused-IR
(Pallas kernels in interpret mode) and the port's fused-IR (the kernels'
plain versions) against JAX's f64 path with solves at 1e-12, the two
fused-IR paths against each other, the adjoint identity of each fused-IR
path, and the CG iterations of each of the port's inner solves.  Runs on
the CPU only (JAX and the port both); takes about two minutes.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase  # noqa: E402
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig  # noqa: E402
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes  # noqa: E402
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxOp  # noqa: E402
from nekstab_next_tpu_torch.config import SolverConfig  # noqa: E402
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays  # noqa: E402
from nekstab_next_tpu_torch.stepper import NavierStokes  # noqa: E402
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator  # noqa: E402

MESH = dict(nr=4, ntheta=8, order=6)
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=500,
             velocity_maxiter=300, pressure_precond="block")
NSTEPS = 3


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def main() -> None:
    torch.set_num_threads(1)
    jcase = JaxCylinderCase(**MESH, solver=JaxSolverConfig(**MIXED), mixed_precision=True)
    jns = jcase.make_ns()
    jns64 = JaxNavierStokes(jcase.sem, viscosity=jns.nu, dt=jns.dt, u_bc=jcase.u_bc,
                            sponge_ref=jcase.sponge_ref, solver=JaxSolverConfig(**TIGHT))
    sem = sem_from_arrays(sem_arrays(jcase.sem), device="cpu")
    ns = NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                      solver=SolverConfig(**dataclasses.asdict(jns.solver)),
                      mixed_precision=True)
    u0 = np.array(jcase.uniform_flow())
    vm = np.asarray(jcase.sem.vmask)
    outside = np.asarray(jcase.sem.bms > 0)[..., None]

    def continuous(seed):
        q = np.random.default_rng(seed).standard_normal(vm.shape)
        return vm * np.stack([np.asarray(jcase.sem.dsavg(jnp.asarray(q[..., d])))
                              for d in range(2)], -1)

    q = continuous(1)
    out = {}
    for tag, j in (("jax ir", jns), ("jax f64", jns64)):
        st = jax.jit(lambda s, j=j: j.advance(s, NSTEPS))(j.make_state(jnp.asarray(u0)))
        op = JaxOp(j, jnp.asarray(u0), nsteps=NSTEPS)
        out[tag] = (np.asarray(st.u), np.asarray(op.matvec(jnp.asarray(q))),
                    np.asarray(op.rmatvec(jnp.asarray(q))))
    iters = {"K1": [], "K2": []}
    for key, k in (("K1", ns.fused_v), ("K2", ns.fused_p)):
        def counted(*a, k=k, key=key):
            x, it = k.plain(*a, return_iters=True)
            iters[key].append(it)
            return x
        k.solve = counted
    op = LinearizedOperator(ns, torch.as_tensor(u0), nsteps=NSTEPS)
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), NSTEPS)
    out["port ir"] = (st.u.numpy(), op.matvec(torch.as_tensor(q)).numpy(),
                      op.rmatvec(torch.as_tensor(q)).numpy())
    for i, name in enumerate((f"{NSTEPS} steps", f"{NSTEPS}-step tangent", f"{NSTEPS}-step rmatvec")):
        print(f"{name}: JAX fused-IR vs JAX f64 {rel(out['jax ir'][i], out['jax f64'][i]):.3e}, "
              f"port fused-IR vs JAX f64 {rel(out['port ir'][i], out['jax f64'][i]):.3e}, "
              f"port vs JAX fused-IR {rel(out['port ir'][i], out['jax ir'][i]):.3e}")
    print(f"port inner CG iterations at 3e-6, solve by solve: {iters}")
    w, p = outside * continuous(5), outside * continuous(4)
    bms = np.asarray(jcase.sem.bms)[..., None]
    jop = JaxOp(jns, jnp.asarray(u0), nsteps=NSTEPS)
    for tag, mv, rmv in (
            ("JAX fused-IR", lambda x: np.asarray(jop.matvec(jnp.asarray(x))),
             lambda x: np.asarray(jop.rmatvec(jnp.asarray(x)))),
            ("port fused-IR", lambda x: op.matvec(torch.as_tensor(x)).numpy(),
             lambda x: op.rmatvec(torch.as_tensor(x)).numpy())):
        a, b = float(np.sum(mv(p) * w * bms)), float(np.sum(p * rmv(w) * bms))
        print(f"adjoint identity, {tag} ({NSTEPS} steps): rel {abs(a - b) / abs(a):.3e}")


if __name__ == "__main__":
    main()
