"""Cylinder resolvent frequency sweep on the PyTorch port (the counterpart
of ``examples/cylinder_resolvent_sweep.py``).

Sweeps the resolvent gain sigma_1(omega) of the Re = 50 cylinder steady
state through the shedding frequency (St ~ 0.12-0.13, omega ~ 0.75-0.82),
the reference's ``uparam 3.4`` path.  Outputs, campaign-gated, in
``--outdir``:

* ``BF_cyl_00001.npz``           the Newton base flow;
* ``Spectre_Sd.dat``             the omega / gain table;
* ``gains.json`` (``--out``)     the summary, written after every point;
* ``{fRe,fIm,uRe,uIm}_cyl_00001.npz``  the leading forcing and response
  modes at the peak-gain frequency.

The steps a period follow from the CFL time step at each omega (rounded up
to a multiple of 4).  On the card the sweep runs in f32 with both inner
solves as the fused CUDA kernels K1/K2, and the base flow comes from an
f32 warm Newton followed by the fused-IR mixed-precision Newton (f64
state); ``NEKSTAB_CPU=1`` runs everything in f64 with ``'schwarz'``.  One
omega per process (``--omegas W --out gains_W.json``) and
``tools_torch/merge_resolvent_sweep.py`` give the same table.

Usage: python examples_torch/cylinder_resolvent_sweep.py [--omegas ...]
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
from nekstab_next_tpu_torch.algorithms.resolvent import ResolventOperator, _complex_space
from nekstab_next_tpu_torch.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.io import load_field, save_field
from nekstab_next_tpu_torch.krylov.svd import svds
from nekstab_next_tpu_torch.utils.noise import velocity_noise

OMEGAS = (0.45, 0.60, 0.70, 0.78, 0.85, 0.95, 1.10)
# the sweep mesh (192 elements at order 6, gentle grading) and --coarse's
MESH = dict(nr=8, ntheta=24, order=6, outer_radius=20.0, grading=8.0)
COARSE = dict(nr=6, ntheta=16, order=4, outer_radius=15.0, grading=4.0)
F32_SOLVER = dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=24,
                  velocity_maxiter=12, pressure_precond="block", fused_solves=True)
BF_SOLVER = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=400,
                 velocity_maxiter=150, pressure_precond="block", fused_solves=True)


def make_cases(mesh: dict, on_card: bool, device=None):
    """(sweep case, base-flow case): f32 on K1/K2 and the fused-IR
    mixed-precision stepper on the card, f64 ``'schwarz'`` for both
    elsewhere."""
    if on_card:
        return (CylinderCase(**mesh, dtype=torch.float32, solver=SolverConfig(**F32_SOLVER),
                             device=device),
                CylinderCase(**mesh, solver=SolverConfig(**BF_SOLVER), mixed_precision=True,
                             device=device))
    case = CylinderCase(**mesh, solver=SolverConfig(pressure_precond="schwarz"), device=device)
    return case, case


def steps_per_period(omega: float, dt: float) -> int:
    """Steps a period from the CFL time step, rounded up to a multiple of 4."""
    return int(np.ceil(2 * np.pi / omega / dt / 4.0)) * 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reynolds", type=float, default=50.0)
    ap.add_argument("--outdir", default="resolvent_out")
    ap.add_argument("--omegas", type=float, nargs="*", default=None)
    ap.add_argument("--k-dim", type=int, default=8)
    ap.add_argument("--coarse", action="store_true",
                    help="coarser sweep mesh (order 4, gentler grading)")
    ap.add_argument("--out", default="gains.json",
                    help="sweep-stage output file (one omega per process: "
                         "--omegas W --out gains_W.json, merged by "
                         "tools_torch/merge_resolvent_sweep.py)")
    args = ap.parse_args()
    omegas = tuple(args.omegas) if args.omegas else OMEGAS
    os.makedirs(args.outdir, exist_ok=True)
    device = "cpu" if os.environ.get("NEKSTAB_CPU") else None
    on_card = device is None
    mesh = dict(reynolds=args.reynolds, **(COARSE if args.coarse else MESH))
    case, case_bf = make_cases(mesh, on_card, device=device)
    ns = case.make_ns()
    ns_bf = case_bf.make_ns()
    sem = case.sem
    t0 = time.time()
    print(f"[res] Re={args.reynolds} nelem={case.mesh.nelem} dt={case.dt:.4f} "
          f"device={sem.device} dtype={sem.dtype}", flush=True)

    bf_path = "BF_cyl_00001.npz"

    def run_baseflow(wd):
        st = ns.advance(ns.make_state(case.uniform_flow()), 600)
        print(f"[res] settle done ({time.time()-t0:.0f}s)", flush=True)

        def cb(it, res, T):
            print(f"[res] newton iter {it} res={res:.3e} ({time.time()-t0:.0f}s)",
                  flush=True)

        horizon = 1.0
        nst = max(int(round(horizon / case.dt)), 1)
        seed = st.u
        if on_card:
            warm = newton_krylov(ns, st.u, horizon=horizon, nsteps=nst,
                                 cfg=NewtonConfig(tol=3e-4, max_iter=20), k_dim=40,
                                 callback=cb)
            seed = warm.u.to(torch.float64)
        result = newton_krylov(ns_bf, seed, horizon=horizon, nsteps=nst,
                               cfg=NewtonConfig(tol=1e-9, max_iter=25), k_dim=40,
                               callback=cb)
        assert result.converged, result.history[-3:]
        save_field(os.path.join(wd, bf_path), result.u, p=result.p,
                   residual=result.residual, reynolds=args.reynolds)
        print(f"[res] base flow res={result.residual:.2e} ({time.time()-t0:.0f}s)",
              flush=True)
        return dict(residual=result.residual)

    def run_sweep(wd):
        bf = load_field(os.path.join(wd, bf_path))
        base = torch.as_tensor(bf.u, dtype=sem.dtype, device=sem.device)
        space = _complex_space(sem)
        rows = []
        best = None
        for om in omegas:
            spp = steps_per_period(om, case.dt)
            op = ResolventOperator(ns, base, om, steps_per_period=spp,
                                   gmres_kdim=20, gmres_restarts=2,
                                   gmres_tol=2e-5 if on_card else 1e-8)
            x0 = (velocity_noise(sem, seed=7), velocity_noise(sem, seed=8))
            t1 = time.time()

            def timed(apply, name):
                def run(x):
                    t, n = time.time(), op.n_matvecs + op.n_rmatvecs
                    y = apply(x)
                    print(f"[res]   {name}: {time.time() - t:.1f} s, "
                          f"{op.n_matvecs + op.n_rmatvecs - n} GMRES matvecs", flush=True)
                    return y
                return run

            res = svds(timed(op.matvec_pure, "R"), timed(op.rmatvec, "R*"), space, x0,
                       nsv=1, k_dim=args.k_dim, tol=1e-4)
            sig = float(res.sigma[0])
            rows.append(dict(omega=om, strouhal=om / (2 * np.pi), sigma=sig,
                             steps_per_period=spp, n_matvecs=int(res.n_matvecs),
                             svds_residual=float(res.residuals[0]),
                             gmres_iterations=int(op.n_matvecs + op.n_rmatvecs),
                             seconds=time.time() - t1))
            print(f"[res] omega={om:.3f} St={om/(2*np.pi):.4f} sigma1={sig:.4e}  "
                  f"[{res.n_matvecs} applies, {op.n_matvecs} + {op.n_rmatvecs} GMRES "
                  f"matvecs, {time.time()-t0:.0f}s]", flush=True)
            if best is None or sig > best[0]:
                best = (sig, om, res)
            # incremental write: a long sweep survives a cut
            with open(os.path.join(wd, args.out), "w") as fh:
                json.dump(dict(reynolds=args.reynolds, nelem=int(case.mesh.nelem),
                               backend=sem.device.type, dtype=str(sem.dtype),
                               partial=True, points=rows), fh, indent=1)
        # Spectre_S* convention: omega, gain(s)
        np.savetxt(os.path.join(wd, "Spectre_Sd.dat"),
                   np.array([[r["omega"], r["sigma"]] for r in rows]),
                   header="omega sigma1")
        sig, om, res = best
        (fr, fi), (ur, ui) = res.right[0], res.left[0]
        for name, fld in [("fRe", fr), ("fIm", fi), ("uRe", ur), ("uIm", ui)]:
            save_field(os.path.join(wd, f"{name}_cyl_00001.npz"), fld, omega=om, sigma=sig)
        out = dict(reynolds=args.reynolds, nelem=int(case.mesh.nelem),
                   backend=sem.device.type, dtype=str(sem.dtype), points=rows,
                   peak=dict(omega=om, sigma=sig, strouhal=om / (2 * np.pi)))
        with open(os.path.join(wd, args.out), "w") as fh:
            json.dump(out, fh, indent=1)
        sigs = [r["sigma"] for r in rows]
        assert all(np.isfinite(sigs)), sigs
        if len(sigs) > 2:
            # gate: a genuine interior peak across the sweep
            imax = int(np.argmax(sigs))
            assert 0 < imax < len(sigs) - 1, (
                f"gain peak at the sweep boundary (omega={rows[imax]['omega']})")
        return out

    camp = Campaign(args.outdir, [
        Stage("baseflow", run_baseflow, done=artifact_exists(bf_path)),
        Stage("sweep", run_sweep, done=artifact_exists(args.out)),
    ])
    camp.run()
    print(f"[res] done in {time.time()-t0:.0f}s -> {args.outdir}/{args.out}", flush=True)


if __name__ == "__main__":
    main()
