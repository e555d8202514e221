"""Backward-facing-step optimal transient growth vs Barkley et al. (2008),
on the PyTorch port (the counterpart of ``examples/bfs_transient_growth.py``).

The optimal energy-growth envelope G(t) of the Re = 500 backward-facing
step, against the digitized fig. 5 of Barkley, Blackburn & Sherwin (2008)
when that file is in the repository (``BARKLEY_REF``; without it there is
no Barkley gate).  A :class:`~nekstab_next_tpu_torch.campaign.Campaign` of
artifact-gated stages: base flow (DNS march, BoostConv-accelerated when no
earlier march is found, finished by an f64 march) -> G(t) sweep.  The same
presets, stages, gates, artifacts and printed lines as the JAX script;
the solver is f64 with the ``'schwarz'`` pressure preconditioner.

Runs on the current CUDA device; ``NEKSTAB_CPU=1`` selects the CPU, as the
JAX script's variable does.

Usage:  python examples_torch/bfs_transient_growth.py \\
            [--preset quick|barkley|full] [--horizons 1.723 5.901 ...]

quick: coarsened mesh + the two shortest Barkley horizons.  barkley and
full: graded meshes with the reference's sponges.  ``tools_torch/
bfs_march.py`` and ``tools_torch/bfs_tg.py`` run the f32 route (K1/K2 with
``--fused``) on the same cases.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nekstab_next_tpu_torch.algorithms import boostconv_dns, transient_growth_analysis
from nekstab_next_tpu_torch.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.io import load_field, save_field

# the digitized fig. 5 of Barkley et al. (2008), 41 (t, G) pairs, read from
# the repository when it is there
BARKLEY_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "examples", "back_fstep", "barkley2008_fig5.ref")

PRESETS = {
    # uniform x: too coarse at the step corner (G low by ~58 %); smoke runs
    "quick": dict(order=5, eu=6, ed=24, ey=6, outflow=35.0, k_dim=24,
                  horizons=(1.723, 5.901)),
    # geometric grading into the step corner and the reference's sponges;
    # the three t >= 9 horizons carry the Barkley gate
    "barkley": dict(order=5, eu=8, ed=28, ey=10, outflow=50.0, k_dim=24,
                    horizons=(1.723, 5.901, 9.795, 11.793, 13.729),
                    step_dx=0.22, sponge=True),
    "full": dict(order=6, eu=10, ed=40, ey=14, outflow=50.0, k_dim=48,
                 horizons=(1.723, 3.853, 5.901, 9.795, 15.9),
                 step_dx=0.1, sponge=True),
}

# the base-flow stage without an earlier march: MARCH_TIME time units of
# DNS, then BoostConv; then the f64 march in chunks of CHUNK steps, at most
# MARCH_CHUNKS of them, to a one-step residual below 2e-6
MARCH_TIME = 20.0
CHUNK = 2000
MARCH_CHUNKS = 60


def device_of_env():
    """The CPU when ``NEKSTAB_CPU`` is set, else the current CUDA device."""
    return "cpu" if os.environ.get("NEKSTAB_CPU") else None


def build_case(P, dtype=None, solver=None, sponge=None, device=None):
    """Shared case construction for the campaign and the tools (honours the
    preset's ``step_dx`` and ``sponge``)."""
    kw = dict(
        reynolds=500.0, order=P["order"], elems_upstream=P["eu"],
        elems_downstream=P["ed"], elems_y=P["ey"],
        outflow_length=P["outflow"],
        step_dx=P.get("step_dx"),
        sponge=P.get("sponge", False) if sponge is None else sponge,
        device=device,
    )
    if solver is not None:
        kw["solver"] = solver
    if dtype is not None:
        kw["dtype"] = dtype
    return BackwardFacingStepCase(**kw)


def f32_solver(fused: bool) -> SolverConfig:
    """The f32 route of ``tools_torch/bfs_march.py`` and ``bfs_tg.py``.
    ``fused``: K1/K2 with the element-block + Q1 pressure preconditioner
    (~300 iterations to 1e-5 on the graded mesh, so cap 350) and velocity
    cap 40; else the plain solves with ``'schwarz'`` at caps 40/24."""
    if fused:
        return SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                            pressure_maxiter=350, velocity_maxiter=40,
                            pressure_precond="block", fused_solves=True)
    return SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                        pressure_maxiter=40, velocity_maxiter=24,
                        pressure_precond="schwarz")


def mesh_fingerprint(case, P) -> dict:
    m = case.mesh
    return dict(nelem=int(m.nelem), order=int(P["order"]),
                xhash=float(np.sum(np.asarray(m.x) ** 2)))


def same_mesh(meta: dict, fp: dict) -> bool:
    return (meta.get("nelem") == fp["nelem"]
            and abs(meta.get("xhash", -1.0) - fp["xhash"]) < 1e-6 * (1 + fp["xhash"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--outdir", default="bfs_out")
    ap.add_argument("--horizons", type=float, nargs="*", default=None)
    ap.add_argument("--gate", type=float, default=0.15,
                    help="relative G(t) tolerance vs Barkley for the "
                         "campaign to pass (>= 3 horizons required)")
    args = ap.parse_args()
    P = PRESETS[args.preset]
    horizons = tuple(args.horizons) if args.horizons else P["horizons"]
    device = device_of_env()

    # the base-flow march runs unsponged (the steady state of pure NS); the
    # TG stage turns the sponge on with sponge_ref = the base flow
    solver = SolverConfig(pressure_precond="schwarz")
    case = build_case(P, sponge=False, solver=solver, device=device)
    ns = case.make_ns()
    t0 = time.time()
    print(f"[bfs] nelem={case.mesh.nelem} order={P['order']} dt={case.dt:.4f}",
          flush=True)

    bf_path = "BF_bfs_00001.npz"
    fp = mesh_fingerprint(case, P)

    def baseflow_ok(wd):
        """Done only if the artifact exists, meets the residual gate and was
        computed on this preset's mesh."""
        p = os.path.join(wd, bf_path)
        if not os.path.exists(p):
            return False
        f = load_field(p)
        ok = f.meta.get("residual", np.inf) < 2e-6 and same_mesh(f.meta, fp)
        if not ok:
            print(f"[bfs] stale/unconverged {bf_path} "
                  f"(meta={f.meta}) — recomputing", flush=True)
        return ok

    def run_baseflow(wd):
        # The Re=500 2-D BFS is linearly stable, so plain DNS marches to the
        # steady state.  Continue from an earlier march on this mesh
        # (tools_torch/bfs_march.py writes bfs_march.npz), else march and
        # accelerate with BoostConv; finish with the f64 march.
        march = os.path.join(wd, "bfs_march.npz")
        u0 = None
        if os.path.exists(march):
            mf = load_field(march)
            if mf.u.shape[0] == case.mesh.nelem and same_mesh(mf.meta, fp):
                u0 = torch.as_tensor(mf.u, dtype=case.sem.dtype, device=case.sem.device)
                print(f"[bfs] continuing from march {march}", flush=True)
            else:
                print(f"[bfs] ignoring {march}: wrong mesh "
                      f"(meta={mf.meta}, want {fp})", flush=True)
        if u0 is None:
            last = [0.0]

            def cb(steps, res):
                if time.time() - last[0] > 30:
                    last[0] = time.time()
                    print(f"[bfs] boostconv step {steps}  res={res:.3e}  "
                          f"({time.time()-t0:.0f}s)", flush=True)

            st = ns.advance(ns.make_state(case.initial_flow()),
                            int(round(MARCH_TIME / case.dt)))
            r = boostconv_dns(ns, st.u, skip=50, subspace=12, tol=1e-4,
                              max_steps=200_000, callback=cb)
            u0 = r.u
            print(f"[bfs] boostconv reached res={r.residual:.2e} "
                  f"({r.iterations} steps, {time.time()-t0:.0f}s)", flush=True)

        # the f64 march: the flow is linearly stable, so it converges; a
        # one-step residual ||u(t)-u(t-dt)|| <= 2e-6 puts the steady defect
        # far below the G(t) accuracy this comparison targets
        st = ns.make_state(u0)
        res = np.inf
        for it in range(MARCH_CHUNKS):
            st1 = ns.advance(st, CHUNK - 1)
            st = ns.step(st1)
            du = st.u - st1.u
            res = float(torch.sqrt(sum(case.sem.inner(du[..., d], du[..., d], masked=False)
                                       for d in range(2))))
            print(f"[bfs] f64 march step {(it+1)*CHUNK}  res={res:.3e}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
            if res < 2e-6:
                break
        if not res < 2e-6:
            raise RuntimeError(f"f64 march stalled at {res:.3e}")
        save_field(os.path.join(wd, bf_path), st.u, p=st.p, time=0.0,
                   residual=res, **fp)
        print(f"[bfs] base flow converged res={res:.2e} "
              f"({time.time()-t0:.0f}s)", flush=True)
        return {"residual": res}

    def run_growth(wd):
        base = torch.as_tensor(load_field(os.path.join(wd, bf_path)).u,
                               dtype=case.sem.dtype, device=case.sem.device)
        # TG with the preset's sponge on (same mesh): perturbations damped in
        # the sponges and the energy norm (bm1s) zeroed there; the sponge
        # damps toward the base flow, which stays an equilibrium
        if P.get("sponge"):
            case_tg = build_case(P, solver=solver, device=device)
            ns_tg = case_tg.make_ns(sponge_ref=base)
        else:
            ns_tg = ns
        ref = np.loadtxt(BARKLEY_REF) if os.path.exists(BARKLEY_REF) else None
        rows = []
        for T in horizons:
            nsteps = max(int(round(T / case.dt)), 1)
            res = transient_growth_analysis(
                ns_tg, base, horizon=T, nsteps=nsteps, nsv=1,
                k_dim=P["k_dim"], tol=1e-6,
            )
            G = float(res.gains[0])
            Gref = float(np.interp(T, ref[:, 0], ref[:, 1])) if ref is not None else None
            rows.append(dict(t=T, G=G, G_barkley=Gref,
                             rel=None if Gref is None else G / Gref - 1.0))
            print(f"[bfs] G({T}) = {G:.2f}"
                  + (f"  (Barkley {Gref:.2f}, {100*(G/Gref-1):+.1f}%)"
                     if Gref else ""), flush=True)
        with open(os.path.join(wd, "growth.json"), "w") as fh:
            json.dump(rows, fh, indent=1)
        # the Barkley gate: the campaign fails unless >= 3 horizons agree
        # with Barkley to the gate tolerance
        within = [r for r in rows
                  if r["rel"] is not None and abs(r["rel"]) <= args.gate]
        if len([r for r in rows if r["rel"] is not None]) >= 3 and len(within) < 3:
            raise RuntimeError(
                f"Barkley G(t) gate: only {len(within)} of {len(rows)} "
                f"horizons within {args.gate:.0%}: {rows}"
            )
        return {"points": rows, "n_within_gate": len(within)}

    campaign = Campaign(args.outdir, [
        Stage("baseflow", run_baseflow, done=baseflow_ok),
        Stage("transient_growth", run_growth,
              done=artifact_exists("growth.json")),
    ])
    campaign.run()
    print(f"[bfs] done in {time.time()-t0:.0f}s -> {args.outdir}/report.json",
          flush=True)


if __name__ == "__main__":
    main()
