"""3-D wall-mounted-block roughness transient growth on the PyTorch port
(the counterpart of ``examples/cube_transient_growth.py``).

The steady wake behind a 2h x h x 2h block on the bottom wall of a
channel-like box at Re = 60 (184 elements at order 4, f64, the default
``'pnpn2'`` step), then the optimal energy growth G(t) of its tangent
propagator at ``HORIZONS`` by Golub-Kahan ``svds``.  A
:class:`~nekstab_next_tpu_torch.campaign.Campaign` of artifact-gated
stages with the JAX script's CLI and outputs:

1. ``baseflow`` -- DNS march in chunks of 200 steps from the inflow profile
   until |du/dt| ~ ||u_{n+200} - u_n|| / (200 dt) < 1e-7, saved as
   ``BF_cube_00001.npz``;
2. ``growth`` -- for each horizon: the adjoint identity of the tangent pair
   in the energy product (gate 1e-6), then ``svds(op.matvec, op.rmatvec,
   velocity_space(sem), x0, nsv=1, k_dim, tol=1e-6)`` from the seed-11
   start; ``growth.json`` with G, steps, matvecs and the svds residual.

The JAX script runs its growth stage element-sharded over a device mesh
and checks it against a single-device svds at the shortest horizon.  The
port runs on one device: it makes that single-device call at every horizon
and writes ``devices: 1``; the sharded leg and its gate wait for the port's
``torch.distributed`` layer.

Runs on the current CUDA device and raises without one; ``NEKSTAB_CPU=1``
selects the CPU.

Usage:  python examples_torch/cube_transient_growth.py [--outdir cube_out_torch]
            [--k-dim 12]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from nekstab_next_tpu_torch.algorithms.stability import velocity_space
from nekstab_next_tpu_torch.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.io import load_field, save_field
from nekstab_next_tpu_torch.krylov.svd import svds
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

HORIZONS = (2.0, 6.0)
BF_PATH = "BF_cube_00001.npz"
CHUNK = 200
MAX_STEPS = 60_000
MARCH_TOL = 1e-7
SVDS_TOL = 1e-6


def device_of_env():
    """The CPU when ``NEKSTAB_CPU`` is set, else the current CUDA device."""
    return "cpu" if os.environ.get("NEKSTAB_CPU") else None


def make_case(device=None) -> CubeRoughnessCase:
    """The JAX script's case: a 12 x 4 x 4 lattice minus a 2 x 2 x 2-element
    block (2h wide and deep, h tall), 184 elements.  Re = 60 per unit length
    with the tanh inflow (block-height Reynolds ~ 115) sits in the
    steady-wake regime; target_cfl 0.2 leaves a margin for the impulsive
    start past the block."""
    return CubeRoughnessCase(
        reynolds=60.0, h=2.0, lx=12.0, ly=4.0, lz=4.0,
        cube_x=4.0, cube_z=2.0, nx=12, ny=4, nz=4, order=4, delta=1.0,
        target_cfl=0.2,
        solver=SolverConfig(pressure_tol=1e-7, velocity_tol=1e-8,
                            pressure_maxiter=300, velocity_maxiter=120),
        device=device,
    )


def velocity_change(sem, du: torch.Tensor) -> float:
    """||du|| in the unmasked mass product, summed over the components."""
    return float(torch.sqrt(sum(sem.inner(du[..., d], du[..., d], masked=False)
                                for d in range(du.shape[-1]))))


def run_baseflow(case: CubeRoughnessCase, wd: str, t0: float) -> dict:
    """March from the inflow profile in chunks of ``CHUNK`` steps until the
    |du/dt| estimate drops below ``MARCH_TOL``; save the velocity.  The
    viscosity is h/Re through ``make_ns`` (the case Reynolds number is per
    block height)."""
    ns = case.make_ns()
    st = ns.make_state(case.initial_flow())
    res, steps = float("inf"), 0
    while steps < MAX_STEPS:
        u_prev = st.u
        st = ns.advance(st, CHUNK)
        steps += CHUNK
        res = velocity_change(case.sem, st.u - u_prev) / (CHUNK * case.dt)
        if not np.isfinite(res):
            raise FloatingPointError(f"base-flow march diverged at step {steps}")
        if steps % 2000 == 0:
            print(f"[cube] march {steps} steps  |du/dt|~{res:.3e}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if res < MARCH_TOL:
            break
    print(f"[cube] base flow |du/dt| ~ {res:.3e} after {steps} steps "
          f"({time.time() - t0:.0f}s)", flush=True)
    save_field(os.path.join(wd, BF_PATH), st.u.cpu().numpy(), time=steps * case.dt,
               residual=res, nelem=int(case.mesh.nelem))
    return dict(residual=res, steps=steps)


def growth_point(case: CubeRoughnessCase, base: torch.Tensor, T: float, k_dim: int,
                 t0: float) -> dict:
    """G(T) of the tangent propagator about ``base``: the adjoint identity
    gate, then the single-device svds from the seed-11 start."""
    sem = case.sem
    space = velocity_space(sem)
    nsteps = max(int(round(T / case.dt)), 1)
    op = LinearizedOperator(case.make_ns(), base, nsteps=nsteps)
    rng = np.random.default_rng(11)
    field = lambda: torch.as_tensor(rng.standard_normal(tuple(base.shape)), dtype=sem.dtype,
                                    device=sem.device) * sem.vmask
    x0 = field()
    # a non-adjoint pair makes Golub-Kahan produce spurious Ritz values
    # above the true spectrum
    yv = field()
    a1 = float(space.dot(op.matvec(x0), yv))
    a2 = float(space.dot(x0, op.rmatvec(yv)))
    adj_rel = abs(a1 - a2) / max(abs(a1), 1e-300)
    print(f"[cube] adjoint identity rel = {adj_rel:.2e}", flush=True)
    if not adj_rel < 1e-6:
        raise AssertionError(f"adjoint identity {adj_rel:.3e} >= 1e-6 ({a1}, {a2})")
    res = svds(op.matvec, op.rmatvec, space, x0, nsv=1, k_dim=k_dim, tol=SVDS_TOL)
    G = float(res.sigma[0] ** 2)
    print(f"[cube] G({T}) = {G:.3f} ({G!r})  [{res.n_matvecs} matvecs, "
          f"res {float(res.residuals[0]):.1e}, {time.time() - t0:.0f}s]", flush=True)
    return dict(t=T, G=G, nsteps=nsteps, n_matvecs=int(res.n_matvecs),
                svds_residual=float(res.residuals[0]), adjoint_rel=adj_rel)


def run_growth(case: CubeRoughnessCase, wd: str, k_dim: int, t0: float) -> dict:
    bf = load_field(os.path.join(wd, BF_PATH))
    base = torch.as_tensor(bf.u, dtype=case.sem.dtype, device=case.sem.device)
    rows = [growth_point(case, base, T, k_dim, t0) for T in HORIZONS]
    out = dict(reynolds=case.reynolds, nelem=int(case.mesh.nelem), order=case.order,
               devices=1, points=rows)
    with open(os.path.join(wd, "growth.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    gs = [r["G"] for r in rows]
    if not (all(np.isfinite(gs)) and all(g > 0 for g in gs)):
        raise AssertionError(f"gains not finite and positive: {gs}")
    return out


def main(argv=None, case=None) -> None:
    """The campaign; ``case`` replaces :func:`make_case`'s (tests pass a
    small one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="cube_out_torch")
    ap.add_argument("--k-dim", type=int, default=12)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    if case is None:
        case = make_case(device_of_env())
    t0 = time.time()
    print(f"[cube] nelem={case.mesh.nelem} order={case.order} dt={case.dt:.4f} "
          f"devices=1 ({case.sem.device})", flush=True)
    camp = Campaign(args.outdir, [
        Stage("baseflow", lambda wd: run_baseflow(case, wd, t0),
              done=artifact_exists(BF_PATH)),
        Stage("growth", lambda wd: run_growth(case, wd, args.k_dim, t0),
              done=artifact_exists("growth.json")),
    ])
    camp.run()
    print(f"[cube] done in {time.time() - t0:.0f}s -> {args.outdir}/growth.json",
          flush=True)


if __name__ == "__main__":
    main()
