"""Cylinder-in-crossflow global stability analysis on the PyTorch port
(the counterpart of ``examples/cylinder_stability.py``).

Pipeline, as the JAX script's:

1. Newton-Krylov base flow at Re, seeded by a short DNS transient;
2. direct leading eigenmodes (Krylov-Schur on the tangent propagator);
3. adjoint leading eigenmodes (Krylov-Schur on its adjoint);
4. wavemaker and base-flow sensitivity;
5. outputs: BF/mode snapshots (npz, readable by either package), spectrum
   files, the drag of the base flow, and a JSON summary with the JAX
   script's keys.

``--precision f64`` (the default) preconditions the pressure solve with
``'schwarz'`` (overlapping element patches + P0 and Q1 coarse levels,
``ops/schwarz.py``), as the JAX script does.

``--precision mixed`` is the JAX script's production route, as there: a
warm phase on the f32 fused kernels (K1/K2 at caps 16/10: the DNS settle
and Newton to 3e-4), then the fused-IR mixed-precision stepper (f64 state,
K1/K2 as the f32 inner solves of iterative refinement, 1e-8/1e-9
tolerances) for the Newton polish to 1e-9 and the eigen stages.

Runs on the current CUDA device; ``NEKSTAB_CPU=1`` selects the CPU, as the
JAX script's variable does.

Usage:  python examples_torch/cylinder_stability.py [--preset quick|medium|full]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nekstab_next_tpu_torch.algorithms import linear_stability_analysis, newton_krylov
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.io import save_field
from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu_torch.postproc import bf_sensitivity, wave_maker
from nekstab_next_tpu_torch.utils import boundary_quadrature, surface_force_and_torque

PRESETS = {
    "quick": dict(nr=6, ntheta=16, order=6, outer_radius=20.0, k_dim=48,
                  horizon=1.0, settle=300, newton_kdim=40),
    "medium": dict(nr=10, ntheta=28, order=6, outer_radius=30.0, k_dim=64,
                   horizon=1.0, settle=400, newton_kdim=48),
    "full": dict(nr=16, ntheta=48, order=6, outer_radius=40.0, k_dim=128,
                 horizon=1.0, settle=600, newton_kdim=64),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--reynolds", type=float, default=60.0)
    ap.add_argument("--outdir", default="cylinder_out")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--modes", default="direct,adjoint",
                    help="comma list: direct[,adjoint]; adjoint enables the "
                         "wavemaker/sensitivity stage")
    ap.add_argument("--precision", choices=["f64", "mixed"], default="f64",
                    help="'f64' (the default) or 'mixed': f32-fused settle + "
                         "Newton warm phase, then the fused-IR mixed-precision "
                         "stepper (f64 state, f32 K1/K2 inner solves, 1e-8/1e-9 "
                         "tolerances) for the Newton polish and the eigen stages")
    args = ap.parse_args()
    P = PRESETS[args.preset]
    os.makedirs(args.outdir, exist_ok=True)
    device = "cpu" if os.environ.get("NEKSTAB_CPU") else None

    mixed = args.precision == "mixed"
    solver = (
        SolverConfig(pressure_tol=1e-8, velocity_tol=1e-9,
                     pressure_maxiter=500, velocity_maxiter=200,
                     pressure_precond="block", fused_solves=True)
        if mixed else SolverConfig(pressure_precond="schwarz")
    )
    case = CylinderCase(
        reynolds=args.reynolds, nr=P["nr"], ntheta=P["ntheta"],
        order=P["order"], outer_radius=P["outer_radius"],
        solver=solver, mixed_precision=mixed, device=device,
    )
    ns = case.make_ns()
    if mixed:
        assert ns._mixed_ir, "fused-IR mixed path did not engage"
    nsteps = max(int(round(P["horizon"] / case.dt)), 1)
    dt = P["horizon"] / nsteps
    ns.dt = dt
    print(f"[cyl] Re={args.reynolds} nelem={case.mesh.nelem} order={P['order']} "
          f"dt={dt:.5f} nsteps/matvec={nsteps} precision={args.precision} "
          f"device={case.sem.device}", flush=True)

    # ---- 1. base flow --------------------------------------------------
    t0 = time.time()

    def newton_cb(it, res, T):
        print(f"[cyl] newton iter {it}  res={res:.3e}  ({time.time()-t0:.0f}s)",
              flush=True)

    if mixed:
        # warm phase on the fused f32 path (same mesh, same dt): DNS settle
        # + inexact Newton down to the f32-reachable 3e-4, then the iterate
        # goes to the fused-IR stepper for the 1e-9 polish
        case32 = CylinderCase(
            reynolds=args.reynolds, nr=P["nr"], ntheta=P["ntheta"],
            order=P["order"], outer_radius=P["outer_radius"], dt=dt,
            solver=SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                                pressure_maxiter=16, velocity_maxiter=10,
                                pressure_precond="block", fused_solves=True),
            dtype=torch.float32, device=device,
        )
        ns32 = case32.make_ns()
        st32 = ns32.advance(ns32.make_state(case32.uniform_flow()), P["settle"])
        print(f"[cyl] f32 DNS settle {P['settle']} steps done "
              f"({time.time()-t0:.0f}s)", flush=True)
        warm = newton_krylov(
            ns32, st32.u, horizon=P["horizon"], nsteps=nsteps,
            cfg=NewtonConfig(tol=3e-4, max_iter=20), k_dim=P["newton_kdim"],
            callback=newton_cb,
        )
        print(f"[cyl] f32 Newton warm res={warm.residual:.2e} "
              f"({time.time()-t0:.0f}s)", flush=True)
        u_seed = warm.u.to(torch.float64)
    else:
        st = ns.advance(ns.make_state(case.uniform_flow()), P["settle"])
        print(f"[cyl] DNS settle {P['settle']} steps done ({time.time()-t0:.0f}s)",
              flush=True)
        u_seed = st.u

    result = newton_krylov(
        ns, u_seed, horizon=P["horizon"], nsteps=nsteps,
        cfg=NewtonConfig(tol=1e-9, max_iter=30), k_dim=P["newton_kdim"],
        callback=newton_cb,
    )
    assert result.converged, f"Newton failed: {result.history[-3:]}"
    base = result.u
    save_field(os.path.join(args.outdir, "BF_cyl_00001.npz"), base,
               p=result.p, time=0.0, reynolds=args.reynolds)
    bq = boundary_quadrature(case.mesh, tags=(BC.WALL,))
    fx, fy, _ = surface_force_and_torque(case.sem, bq, base, result.p,
                                         viscosity=ns.nu)
    cd = 2.0 * float(fx)  # Cd = Fx / (1/2 rho U^2 D), U = D = 1
    print(f"[cyl] base flow converged res={result.residual:.2e} "
          f"Cd={cd:.4f} ({time.time()-t0:.0f}s)", flush=True)

    # ---- 2./3. direct + adjoint eigenmodes ------------------------------
    out = {"reynolds": args.reynolds, "preset": args.preset,
           "precision": args.precision, "nelem": case.mesh.nelem, "cd": cd,
           "newton_residual": result.residual}
    modes = tuple(m.strip() for m in args.modes.split(",") if m.strip())
    for mode in modes:
        res = linear_stability_analysis(
            ns, base, horizon=P["horizon"], nsteps=nsteps, mode=mode,
            k_dim=P["k_dim"], nev=2, tol=args.tol, nmodes_out=2,
        )
        lam = res.lam[0]
        print(f"[cyl] {mode}: lambda = {lam.real:+.6f} {lam.imag:+.6f}i  "
              f"St = {abs(lam.imag)/(2*np.pi):.5f}  res={res.residuals[0]:.2e} "
              f"({res.n_matvecs} matvecs, {time.time()-t0:.0f}s)", flush=True)
        out[mode] = dict(
            sigma=float(lam.real), omega=float(lam.imag),
            strouhal=float(abs(lam.imag) / (2 * np.pi)),
            ritz_residual=float(res.residuals[0]),
            n_matvecs=int(res.n_matvecs),
        )
        prefix = "d" if mode == "direct" else "a"
        re_, im_ = res.modes[0]
        save_field(os.path.join(args.outdir, f"{prefix}Re_cyl_00001.npz"),
                   re_, time=P["horizon"], eigenvalue=[lam.real, lam.imag])
        save_field(os.path.join(args.outdir, f"{prefix}Im_cyl_00001.npz"),
                   im_, time=P["horizon"], eigenvalue=[lam.real, lam.imag])
        np.savetxt(
            os.path.join(args.outdir, f"Spectre_NS{prefix}.dat"),
            np.column_stack([res.lam.real, res.lam.imag, res.residuals]),
            header="sigma omega ritz_residual",
        )
        out[f"{mode}_modes"] = res.modes

    # ---- 4. wavemaker + base-flow sensitivity ---------------------------
    if "adjoint" not in modes:
        out.pop("direct_modes", None)
        with open(os.path.join(args.outdir, "summary.json"), "w") as f:
            json.dump(out, f, indent=2)
        print(f"[cyl] done (direct-only) in {time.time()-t0:.0f}s -> "
              f"{args.outdir}/summary.json", flush=True)
        return
    d_re, d_im = out["direct_modes"][0]
    a_re, a_im = out["adjoint_modes"][0]
    wm = wave_maker(case.sem, d_re, d_im, a_re, a_im)
    save_field(os.path.join(args.outdir, "wm_cyl_00001.npz"),
               torch.stack([wm, wm], dim=-1), time=0.0)
    sens = bf_sensitivity(case.sem, d_re, d_im, a_re, a_im)
    for k, v in sens.items():
        save_field(os.path.join(args.outdir, f"{k}_cyl_00001.npz"), v, time=0.0)
    ix = int(torch.argmax(wm))
    x, y = case.mesh.x.reshape(-1)[ix], case.mesh.y.reshape(-1)[ix]
    print(f"[cyl] wavemaker peak {float(wm.max()):.3f} at x={x:.2f} y={y:.2f}",
          flush=True)
    out["wavemaker_peak"] = dict(value=float(wm.max()), x=float(x), y=float(y))

    del out["direct_modes"], out["adjoint_modes"]
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"[cyl] done in {time.time()-t0:.0f}s -> {args.outdir}/summary.json",
          flush=True)


if __name__ == "__main__":
    main()
