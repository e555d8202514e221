"""The base flow of a configuration (never run by the benchmark itself).

The configuration's ``base_flow.make`` names a converged field of the
repository on another mesh of the same case (``start``, with that mesh's
keys) and the Newton-Krylov settings (``newton``).  This tool
interpolates the start field spectrally onto the configuration's mesh,
sets the Dirichlet values, and runs the program's ``newton_krylov`` on the
configuration's mesh at its Reynolds number until the residual
||Phi_T(q) - q|| is under ``tol`` or ``--minutes`` have passed, saving
the iterate after every Newton step.  The output holds ``u`` (the layout
of ``bench_port/reference/mesh2d.py``) and the residual of that ``u``:

    python3 bench_port/tools/base_flow.py --config bench_port/configs/bfs_re500.json \\
        --out chiprun_out/bf/bfs_re500.npz --minutes 10
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _lagrange(z: np.ndarray, s: np.ndarray) -> np.ndarray:
    """L[p, k] = the k-th Lagrange polynomial on the nodes z at s[p]."""
    L = np.ones((s.size, z.size))
    for k in range(z.size):
        for m in range(z.size):
            if m != k:
                L[:, k] *= (s - z[m]) / (z[k] - z[m])
    return L


def _tensor_layout(cfg: dict):
    """(breaks along a, breaks along b, element of each (ia, ib) or -1,
    the map (x, y) -> (a, b)) of a configuration's mesh, as
    ``reference/mesh2d.py`` lays it: (r, theta) rings and sectors of the
    cylinder, (x, y) columns and rows of the step."""
    from bench_port.reference import mesh2d

    if cfg["case"] == "cylinder":
        nr, nt = cfg["nr"], cfg["ntheta"]
        g = cfg["grading"] ** (1.0 / max(nr - 1, 1))
        cum = np.concatenate([[0.0], np.cumsum(g ** np.arange(nr))])
        ba = cfg["radius"] + (cfg["outer_radius"] - cfg["radius"]) * cum / cum[-1]
        bb = np.linspace(0.0, 2.0 * np.pi, nt + 1)
        table = np.arange(nr * nt).reshape(nr, nt)
        ab = lambda x, y: (np.hypot(x, y), np.mod(np.arctan2(y, x), 2.0 * np.pi))
        return ba, bb, table, ab
    Li, Lo = cfg["inflow_length"], cfg["outflow_length"]
    eu, ed, ey = cfg["elems_upstream"], cfg["elems_downstream"], cfg["elems_y"]
    up = mesh2d._graded(0.0, Li, eu, cfg["step_dx"])
    ba = np.concatenate([(-up[::-1])[:-1], mesh2d._graded(0.0, Lo, ed, cfg["step_dx"])])
    bb = np.linspace(-1.0, 1.0, ey + 1)
    table = -np.ones((eu + ed, ey), dtype=np.int64)
    e = 0
    for i in range(eu + ed):
        for j in range(ey):
            if not (0.5 * (ba[i] + ba[i + 1]) < 0 and 0.5 * (bb[j] + bb[j + 1]) < 0):
                table[i, j] = e
                e += 1
    return ba, bb, table, lambda x, y: (x, y)


def interpolate(u_from: np.ndarray, cfg_from: dict, cfg_to: dict) -> np.ndarray:
    """A (nelem, n, n, c) field on cfg_from's mesh, evaluated at every node
    of cfg_to's mesh by its element's tensor Lagrange interpolant."""
    from bench_port.reference import mesh2d

    to = mesh2d.build(cfg_to)
    ba, bb, table, ab = _tensor_layout(cfg_from)
    a, b = ab(to.x.ravel(), to.y.ravel())
    ia = np.clip(np.searchsorted(ba, a, side="right") - 1, 0, ba.size - 2)
    ib = np.clip(np.searchsorted(bb, b, side="right") - 1, 0, bb.size - 2)
    # a node on the edge of a carved block belongs to the kept neighbour
    for _ in range(2):
        bad = table[ia, ib] < 0
        ia = np.where(bad & (ia + 1 < ba.size - 1), ia + 1, ia)
        bad = table[ia, ib] < 0
        ib = np.where(bad & (ib + 1 < bb.size - 1), ib + 1, ib)
    e = table[ia, ib]
    if np.any(e < 0):
        raise ValueError("a node outside the start mesh")
    xi = np.clip(2.0 * (a - ba[ia]) / (ba[ia + 1] - ba[ia]) - 1.0, -1.0, 1.0)
    eta = np.clip(2.0 * (b - bb[ib]) / (bb[ib + 1] - bb[ib]) - 1.0, -1.0, 1.0)
    z, _ = mesh2d.gll(u_from.shape[1])
    La, Lb = _lagrange(z, xi), _lagrange(z, eta)
    out = np.einsum("pk,pl,pklc->pc", La, Lb, u_from[e])
    return out.reshape(to.x.shape + (u_from.shape[-1],))


def stepper(cfg: dict, device):
    """The program's float64 Navier-Stokes of the configuration, without
    a sponge toward the base flow (the steady state of the equations),
    and its boundary data."""
    import torch

    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    mk = cfg["base_flow"]["make"]
    solver = SolverConfig(**mk["solver"])
    if cfg["case"] == "cylinder":
        from nekstab_next_tpu_torch.cases.cylinder import CylinderCase

        case = CylinderCase(
            reynolds=cfg["reynolds"], nr=cfg["nr"], ntheta=cfg["ntheta"], order=cfg["order"],
            outer_radius=cfg["outer_radius"], grading=cfg["grading"],
            outflow_half_angle=cfg["outflow_half_angle"],
            sponge_start_frac=cfg["sponge_start_frac"], sponge_strength=cfg["sponge_strength"],
            dt=cfg["dt"], solver=solver, dtype=torch.float64, device=device,
            mixed_precision=mk["mixed_precision"])
        return case.make_ns(), case
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase

    case = BackwardFacingStepCase(
        reynolds=cfg["reynolds"], order=cfg["order"], elems_upstream=cfg["elems_upstream"],
        elems_downstream=cfg["elems_downstream"], elems_y=cfg["elems_y"],
        inflow_length=cfg["inflow_length"], outflow_length=cfg["outflow_length"],
        step_dx=cfg["step_dx"], sponge=False, dt=cfg["dt"], solver=solver,
        dtype=torch.float64, device=device)
    ns = NavierStokes(case.sem, viscosity=1.0 / cfg["reynolds"], dt=cfg["dt"], u_bc=case.u_bc,
                      solver=solver, mixed_precision=mk["mixed_precision"])
    return ns, case


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from nekstab_next_tpu_torch.algorithms.newton import _dotv, newton_krylov
    from nekstab_next_tpu_torch.config import NewtonConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--check", action="store_true",
                    help="print the residual of the configuration's base flow and stop")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    with open(os.path.join(ROOT, args.config)) as f:
        cfg = json.load(f)
    mk = cfg["base_flow"]["make"]
    T, nsteps = mk["horizon"], int(mk["nsteps"])
    dev = torch.device(args.device)
    ns, case = stepper(cfg, dev)
    s = ns.sem
    if args.check:
        u = torch.as_tensor(np.load(os.path.join(ROOT, cfg["base_flow"]["file"]))["u"],
                            dtype=torch.float64, device=s.device)
        F = ns.propagator(u, nsteps, dt=T / nsteps) - u
        print(json.dumps({"file": cfg["base_flow"]["file"],
                          "residual": float(torch.sqrt(_dotv(s, F, F))),
                          "seconds": time.perf_counter() - t0}), flush=True)
        return 0
    start = mk["start"]
    u0 = np.load(os.path.join(ROOT, start["file"]))["u"]
    q = interpolate(u0, dict(start["mesh"], case=cfg["case"]), cfg)
    vm = s.vmask if s.vmask.dim() == q.ndim else s.vmask[..., None]
    q = torch.as_tensor(q, dtype=torch.float64, device=s.device)
    q = s.dsavg(q * vm + case.u_bc * (1.0 - vm))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ncfg = NewtonConfig(tol=mk["tol"], max_iter=1, gmres_restarts=mk["gmres_restarts"])
    log = []

    def save(u, res, converged):
        np.savez(args.out, u=u.detach().cpu().numpy(), residual=res, converged=converged,
                 newton=json.dumps(log))

    res = None
    while True:
        r = newton_krylov(ns, q, horizon=T, nsteps=nsteps, cfg=ncfg, k_dim=mk["k_dim"])
        res = r.history[-1][1]
        log.append({"iterate": len(log), "residual": res, "n_matvecs": r.n_matvecs,
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(log[-1]), flush=True)
        if r.converged:
            save(q, res, True)
            break
        q = r.u
        save(q, float("nan"), False)
        if time.perf_counter() - t0 > 60.0 * args.minutes:
            F = ns.propagator(q, nsteps, dt=T / nsteps) - q
            res = float(torch.sqrt(_dotv(s, F, F)))
            log.append({"iterate": len(log), "residual": res, "stopped": "minutes"})
            print(json.dumps(log[-1]), flush=True)
            save(q, res, False)
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
