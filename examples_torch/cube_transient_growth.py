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

Both stages run element-sharded, as the JAX script's do, through
:class:`~nekstab_next_tpu_torch.parallel.ShardedContext` over a
``torch.distributed`` process group: the march on the shard view's
stepper, the growth stage's ``svds`` on the sharded tangent and its
transpose with the Krylov bases stored sharded.  Over two or more ranks,
at the shortest horizon a single-device ``svds`` from the same start must
give the same G to 1e-6.  Under ``python`` the group has one rank (NCCL
on the card, gloo with ``NEKSTAB_CPU=1``), whose shard view makes no
collective: it is the single-device computation, at its speed, and the
cross-check is not run.  Under ``torchrun --nproc_per_node=N`` the group
has N ranks, one a card (the mesh's 184 elements divide by 1, 2, 4 and 8).  ``growth.json``
writes the group's size as ``devices``; rank 0 writes the files.

Runs on this rank's CUDA device (``cuda:LOCAL_RANK``) and raises without
one; ``NEKSTAB_CPU=1`` selects the CPU.

Usage:  python examples_torch/cube_transient_growth.py [--outdir cube_out_torch]
            [--k-dim 12]
        torchrun --nproc_per_node=N examples_torch/cube_transient_growth.py ...
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from nekstab_next_tpu_torch.algorithms.stability import velocity_space
from nekstab_next_tpu_torch.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.io import load_field, save_field
from nekstab_next_tpu_torch.krylov.svd import svds
from nekstab_next_tpu_torch.parallel import ShardedContext, make_device_mesh
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

HORIZONS = (2.0, 6.0)
BF_PATH = "BF_cube_00001.npz"
CHUNK = 200
MAX_STEPS = 60_000
MARCH_TOL = 1e-7
SVDS_TOL = 1e-6
SHARD_GATE = 1e-6  # sharded against single-device G at HORIZONS[0]


def device_of_env():
    """The CPU when ``NEKSTAB_CPU`` is set, else None: the card of this rank
    (``cuda:LOCAL_RANK``)."""
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


def make_context(case: CubeRoughnessCase, dmesh) -> ShardedContext:
    """The sharded stepper of the case.  The viscosity is h/Re, as
    ``case.make_ns`` has it: the case Reynolds number is per block height
    (1/Re ran the JAX script's sharded leg at twice the Reynolds number of
    its single-device cross-check)."""
    return ShardedContext(case.mesh, dmesh, viscosity=case.h / case.reynolds, dt=case.dt,
                          u_bc=case.u_bc, solver=case.solver)


def velocity_change(sem, du: torch.Tensor) -> float:
    """||du|| in the unmasked mass product, summed over the components."""
    return float(torch.sqrt(sum(sem.inner(du[..., d], du[..., d], masked=False)
                                for d in range(du.shape[-1]))))


def run_baseflow(ctx: ShardedContext, case: CubeRoughnessCase, wd: str, t0: float) -> dict:
    """March from the inflow profile in chunks of ``CHUNK`` steps, sharded,
    until the |du/dt| estimate drops below ``MARCH_TOL``; rank 0 saves the
    gathered velocity."""
    adv = ctx.compile(lambda ns, st: ns.advance(st, CHUNK))
    st = ctx.shard_state(ctx.make_host_state(case.initial_flow()))
    res, steps = float("inf"), 0
    while steps < MAX_STEPS:
        u_prev = st.u
        st = adv(st)
        steps += CHUNK
        res = velocity_change(ctx.sem, st.u - u_prev) / (CHUNK * case.dt)
        if not np.isfinite(res):
            raise FloatingPointError(f"base-flow march diverged at step {steps}")
        if steps % 2000 == 0:
            print(f"[cube] march {steps} steps  |du/dt|~{res:.3e}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if res < MARCH_TOL:
            break
    print(f"[cube] base flow |du/dt| ~ {res:.3e} after {steps} steps "
          f"({time.time() - t0:.0f}s)", flush=True)
    u = ctx.gather_field(st.u)
    if ctx.dmesh.rank == 0:
        save_field(os.path.join(wd, BF_PATH), u.cpu().numpy(), time=steps * case.dt,
                   residual=res, nelem=int(case.mesh.nelem))
    dist.barrier(ctx.dmesh.group)
    return dict(residual=res, steps=steps)


def growth_point(ctx: ShardedContext, case: CubeRoughnessCase, base: torch.Tensor,
                 T: float, k_dim: int, t0: float) -> dict:
    """G(T) of the sharded tangent propagator about ``base``: the adjoint
    identity gate, then ``svds`` from the seed-11 start; at ``HORIZONS[0]``
    over two or more ranks the single-device ``svds`` from the same start
    too, with its gate."""
    sem = case.sem
    space = velocity_space(ctx.sem)
    nsteps = max(int(round(T / case.dt)), 1)
    op = LinearizedOperator(ctx.ns, ctx.shard_field(base), nsteps=nsteps)
    rng = np.random.default_rng(11)
    field = lambda: torch.as_tensor(rng.standard_normal(tuple(base.shape)), dtype=sem.dtype,
                                    device=sem.device) * sem.vmask
    x0 = field()
    # a non-adjoint pair makes Golub-Kahan produce spurious Ritz values
    # above the true spectrum
    yv = field()
    x0s, yvs = ctx.shard_field(x0), ctx.shard_field(yv)
    a1 = float(space.dot(op.matvec(x0s), yvs))
    a2 = float(space.dot(x0s, op.rmatvec(yvs)))
    adj_rel = abs(a1 - a2) / max(abs(a1), 1e-300)
    print(f"[cube] adjoint identity rel = {adj_rel:.2e}", flush=True)
    if not adj_rel < 1e-6:
        raise AssertionError(f"adjoint identity {adj_rel:.3e} >= 1e-6 ({a1}, {a2})")
    res = svds(op.matvec, op.rmatvec, space, x0s, nsv=1, k_dim=k_dim, tol=SVDS_TOL)
    G = float(res.sigma[0] ** 2)
    print(f"[cube] G({T}) = {G:.3f} ({G!r})  [{res.n_matvecs} matvecs, "
          f"res {float(res.residuals[0]):.1e}, {time.time() - t0:.0f}s]", flush=True)
    row = dict(t=T, G=G, nsteps=nsteps, n_matvecs=int(res.n_matvecs),
               svds_residual=float(res.residuals[0]), adjoint_rel=adj_rel)
    if T == HORIZONS[0] and ctx.dmesh.size > 1:
        op1 = LinearizedOperator(case.make_ns(), base, nsteps=nsteps)
        res1 = svds(op1.matvec, op1.rmatvec, velocity_space(sem), x0, nsv=1, k_dim=k_dim,
                    tol=SVDS_TOL)
        G1 = float(res1.sigma[0] ** 2)
        rel = abs(G - G1) / G1
        print(f"[cube] single-device cross-check G={G1:.3f} (rel {rel:.2e})", flush=True)
        row.update(G_single_device=G1, sharded_vs_single_rel=rel)
        if not rel < SHARD_GATE:
            raise AssertionError(f"sharded G {G!r} against single-device {G1!r}: "
                                 f"rel {rel:.3e} >= {SHARD_GATE}")
    return row


def run_growth(ctx: ShardedContext, case: CubeRoughnessCase, wd: str, k_dim: int,
               t0: float) -> dict:
    bf = load_field(os.path.join(wd, BF_PATH))
    base = torch.as_tensor(bf.u, dtype=case.sem.dtype, device=case.sem.device)
    rows = [growth_point(ctx, case, base, T, k_dim, t0) for T in HORIZONS]
    out = dict(reynolds=case.reynolds, nelem=int(case.mesh.nelem), order=case.order,
               devices=ctx.dmesh.size, points=rows)
    if ctx.dmesh.rank == 0:
        with open(os.path.join(wd, "growth.json"), "w") as fh:
            json.dump(out, fh, indent=1)
    gs = [r["G"] for r in rows]
    if not (all(np.isfinite(gs)) and all(g > 0 for g in gs)):
        raise AssertionError(f"gains not finite and positive: {gs}")
    return out


def main(argv=None, case=None) -> None:
    """The campaign on every rank of the process group (joined, or created
    from ``torchrun``'s environment); ``case`` replaces :func:`make_case`'s
    (tests pass a small one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="cube_out_torch")
    ap.add_argument("--k-dim", type=int, default=12)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    dmesh = make_device_mesh(device=device_of_env() if case is None else case.sem.device)
    try:
        if case is None:
            case = make_case(dmesh.device)
        ctx = make_context(case, dmesh)
        t0 = time.time()
        print(f"[cube] nelem={case.mesh.nelem} order={case.order} dt={case.dt:.4f} "
              f"devices={dmesh.size} ({dmesh.backend}, {dmesh.device})", flush=True)
        stages = [
            Stage("baseflow", lambda wd: run_baseflow(ctx, case, wd, t0),
                  done=artifact_exists(BF_PATH)),
            Stage("growth", lambda wd: run_growth(ctx, case, wd, args.k_dim, t0),
                  done=artifact_exists("growth.json")),
        ]
        if dmesh.rank == 0:
            Campaign(args.outdir, stages).run()
        else:  # the same stages; rank 0 keeps the report
            for st in stages:
                if not st.done(args.outdir):
                    st.run(args.outdir)
        print(f"[cube] done in {time.time() - t0:.0f}s -> {args.outdir}/growth.json",
              flush=True)
    finally:
        dmesh.close()


if __name__ == "__main__":
    main()
