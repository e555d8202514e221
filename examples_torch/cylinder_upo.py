"""Autonomous UPO on the PyTorch port: the cylinder Re = 100 vortex-shedding
orbit (the counterpart of ``examples/cylinder_upo.py``).

Campaign, as the JAX script's: a DNS settles into the Re = 100 limit cycle,
the period is estimated from the lift's zero crossings
(``utils/diagnostics.py`` ``periods_from_signal``), then
``newton_krylov(upo=True)`` refines (orbit point, period) against the
trajectory-linearized monodromy (the orbit stored once per Newton
iteration and replayed by every GMRES matvec).

Literature anchor: Strouhal St = f D / U ~ 0.164-0.167 at Re = 100
(Williamson 1989; Barkley & Henderson 1996).

On the card: f32 with both inner solves as the fused CUDA kernels K1/K2
(caps 24/12, tolerances 1e-5/1e-6, ``'block'``).  ``NEKSTAB_CPU=1`` runs
f64 with ``'schwarz'`` on the CPU.  Outputs in ``--outdir``:
``UPO_seed.npz``, ``lift_series.dat``, ``UPO_cyl_00001.npz``, ``upo.json``
and the campaign's ``report.json``.

Usage: python examples_torch/cylinder_upo.py [--outdir upo_out]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nekstab_next_tpu_torch.algorithms import newton_krylov
from nekstab_next_tpu_torch.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.io import load_field, save_field
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.utils import (
    boundary_quadrature,
    periods_from_signal,
    surface_force_and_torque,
)

# the JAX script's mesh (192 elements at order 6), its DNS length in time
# units and its chunk of steps between lift samples
MESH = dict(nr=8, ntheta=24, order=6, outer_radius=20.0, grading=10.0)
DNS_TIME = 160.0
CHUNK = 50
F32_SOLVER = dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=24,
                  velocity_maxiter=12, pressure_precond="block", fused_solves=True)


def make_case(reynolds: float, on_card: bool, device=None) -> CylinderCase:
    """The example's case: f32 on the fused kernels on the card, f64
    ``'schwarz'`` elsewhere."""
    if on_card:
        return CylinderCase(reynolds=reynolds, **MESH, dtype=torch.float32,
                            solver=SolverConfig(**F32_SOLVER), device=device)
    return CylinderCase(reynolds=reynolds, **MESH,
                        solver=SolverConfig(pressure_precond="schwarz"), device=device)


def newton_upo(ns, seed_path: str, tol: float, max_iter: int = 20, t0=None,
               tag: str = "upo"):
    """The Newton stage: ``newton_krylov(upo=True)`` from the saved seed
    (its ``period_estimate`` is the initial period), GMRES ``k_dim`` 50, one
    line an iteration.  Returns the result and the initial period."""
    sem = ns.sem
    t0 = time.time() if t0 is None else t0
    f = load_field(seed_path)
    T_est = float(f.meta["period_estimate"])
    u0 = torch.as_tensor(f.u, dtype=sem.dtype, device=sem.device)
    nsteps = int(round(T_est / ns.dt))
    print(f"[{tag}] newton from {seed_path}: T={T_est:.6f} in {nsteps} steps of "
          f"{ns.dt:.7g}, tol {tol:g}", flush=True)

    def cb(it, res, T):
        print(f"[{tag}] newton iter {it}  res={res:.4e}  T={T:.6f}  "
              f"({time.time()-t0:.0f}s)", flush=True)

    r = newton_krylov(ns, u0, horizon=T_est, nsteps=nsteps, upo=True,
                      cfg=NewtonConfig(tol=tol, max_iter=max_iter), k_dim=50,
                      callback=cb)
    return r, T_est


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="upo_out")
    ap.add_argument("--reynolds", type=float, default=100.0)
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    device = "cpu" if os.environ.get("NEKSTAB_CPU") else None
    on_card = device is None
    case = make_case(args.reynolds, on_card, device=device)
    ns = case.make_ns()
    sem = case.sem
    bq = boundary_quadrature(case.mesh, tags=(BC.WALL,))
    t0 = time.time()
    print(f"[upo] Re={args.reynolds} nelem={case.mesh.nelem} dt={case.dt:.4f} "
          f"device={sem.device} dtype={sem.dtype}", flush=True)

    snap_path = "UPO_seed.npz"

    def run_dns(wd):
        # settle into the limit cycle recording the lift coefficient; the
        # asymmetry kick breaks the symmetric transient
        rng = np.random.default_rng(5)
        kick = 0.01 * torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape) + (2,)),
                                      dtype=sem.dtype, device=sem.device)
        st = ns.make_state(case.uniform_flow() + sem.vmask * kick)
        times, lifts = [], []
        nchunks = int(round(DNS_TIME / (CHUNK * case.dt)))
        for i in range(nchunks):
            st = ns.advance(st, CHUNK)
            _, fy, _ = surface_force_and_torque(sem, bq, st.u, st.p, viscosity=ns.nu)
            times.append(float(st.time))
            lifts.append(2.0 * float(fy))
            if i % 40 == 0:
                print(f"[upo] t={float(st.time):.1f}  Cl={lifts[-1]:+.4f}  "
                      f"({time.time()-t0:.0f}s)", flush=True)
        times = np.asarray(times)
        lifts = np.asarray(lifts)
        # period from the last ~40% of the signal (saturated cycle)
        i0 = int(0.6 * len(times))
        Ts = periods_from_signal(times[i0:], lifts[i0:])
        assert Ts.size >= 2, "no shedding cycles detected"
        T_est = float(np.mean(Ts[-3:]))
        amp = float(np.std(lifts[i0:]))
        print(f"[upo] estimated period T={T_est:.4f} (St={1.0/T_est:.4f}), "
              f"Cl_rms={amp:.3f}", flush=True)
        assert amp > 1e-3, "flow did not saturate into the limit cycle"
        save_field(os.path.join(wd, snap_path), st.u, p=st.p,
                   period_estimate=T_est, cl_rms=amp)
        np.savetxt(os.path.join(wd, "lift_series.dat"),
                   np.column_stack([times, lifts]), header="t Cl")
        return dict(period_estimate=T_est, strouhal=1.0 / T_est)

    def run_newton(wd):
        # the f32 floor: the orbit matvec carries ~1e-3 noise at the capped
        # solves (the TPU's Newton dithered at ~1.2e-3)
        r, T_est = newton_upo(ns, os.path.join(wd, snap_path),
                              tol=1.5e-3 if on_card else 1e-8, t0=t0)
        St = 1.0 / r.period
        print(f"[upo] UPO period T={r.period:.5f}  St={St:.5f}  "
              f"res={r.residual:.2e}  converged={r.converged}  "
              f"({r.n_matvecs} matvecs, {time.time()-t0:.0f}s)", flush=True)
        save_field(os.path.join(wd, "UPO_cyl_00001.npz"), r.u, p=r.p,
                   period=r.period, residual=r.residual)
        out = dict(reynolds=args.reynolds, nelem=int(case.mesh.nelem),
                   backend=sem.device.type, dtype=str(sem.dtype),
                   period_estimate=T_est, period=float(r.period),
                   strouhal=float(St), residual=float(r.residual),
                   converged=bool(r.converged), n_matvecs=int(r.n_matvecs),
                   history=[list(h) for h in r.history])
        with open(os.path.join(wd, "upo.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        # literature gate (relaxed for the coarse mesh): St in [0.15, 0.18]
        assert 0.15 < St < 0.18, St
        return out

    camp = Campaign(args.outdir, [
        Stage("dns", run_dns, done=artifact_exists(snap_path)),
        Stage("newton_upo", run_newton, done=artifact_exists("upo.json")),
    ])
    camp.run()
    print(f"[upo] done in {time.time()-t0:.0f}s -> {args.outdir}/upo.json", flush=True)


if __name__ == "__main__":
    main()
