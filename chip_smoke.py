"""Drive the PyTorch port's paths once on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nekstab_next_tpu_torch/csrc`` (one nvcc per
source, sm_90a, all at once) and drives:

1. the flagship 2-D path: checks K1 and K2 (the whole-solve CG kernels)
   against their plain PyTorch versions at the flagship shapes and on a
   4,608-element cylinder whose element groups outnumber the blocks that
   fit on the card (the kernels' grid-stride path), printing each launch's
   grid and a digest of each result; runs the flagship 50-step f32 tangent
   matvec (the quantity ``bench.py`` times: 768-element Re=60 cylinder,
   order 6, caps 16/10) through them, checks it against the plain versions
   and an f64 reference, runs 20 nonlinear steps and times everything with
   CUDA events, K1 and K2 also at tol 0 for maxiter 1, 4 and 16 (the
   per-iteration time is the slope);
2. the 3-D mixed-precision path: checks K4 (the fused local Helmholtz
   apply) against its plain version at the cylinder's shape and at both of
   the cube's (the three-component velocity apply and the one-component
   pressure apply), and over d = 2, 3, n = 4..8 and C = 1, 2, 3 at one
   element, at a count that leaves the last element group partial and at a
   count larger than the persistent grid holds at once; runs the 10-step
   mixed tangent matvec on the 1,472-element order-6 cube through K4
   (counting its launches at the velocity and the pressure shape), checks it
   against K4's plain version and the f64 'laplacian' matvec, runs 5
   nonlinear mixed steps and times it;
3. the Krylov layer and the cylinder stability pipeline on the flagship
   mesh, against the full-preset artifacts of ``cylinder_out_full/`` (read
   with the port's ``load_field``): Cd and the wavemaker of the saved
   fields; the f64 adjoint identity over 10 steps; the 50-step f32 rmatvec
   through K1 and K2 (the launches of its backward counted), against the
   plain versions and the f64 rmatvec; the saved modes' eigen-residuals
   under the f32 operator at the full horizon (540 steps); one Newton
   iteration and the adjoint ``linear_stability_analysis`` (50 steps a
   matvec, k_dim 24, one restart) with the wavemaker and base-flow
   sensitivity of its mode and the saved direct mode; then the
   rmatvec/matvec time ratio, the
   f64 step at the example's tolerances, ``ortho_insert`` at k = 24 and
   128, and the projected time of each preset's eigen stages;
4. the fused-IR mixed-precision path (``--precision mixed`` of the
   example: f64 state on the PnPn-2 step, K1 and K2 as the f32 inner
   solves of iterative refinement) on the flagship mesh about the loaded
   base flow: one step and the 50-step matvec and rmatvec through the
   kernels against the same with their plain versions and against the f64
   path at 1e-12 (bound 1e-7 each), their launches and each inner solve's
   CG iterations, the adjoint identity, the saved modes' eigen-residuals
   under the fused-IR operators at 540 steps (bound 1e-4), the step,
   matvec and inner-solve times beside the f32 and f64 steps, and the
   projected time of each preset's eigen stages on this path;
5. the backward-facing step (``examples_torch/bfs_transient_growth.py``'s
   barkley preset: 320 elements at order 5 graded into the re-entrant
   corner, the reference's sponges): the f64 ``'schwarz'`` set-up (colours,
   extraction and inversion times) and its pressure CG iterations to 1e-5
   with face and node patches; one f64 BDF1 step with ``'schwarz'``
   against one with ``'fdm'`` on the quick preset; on the ``--fused`` f32
   route of ``tools_torch/bfs_tg.py`` about ``bfs_out/bfs_march.npz``,
   K1 and K2 against their plain versions on three steps' solves (each
   solve's iterations, flagged at its cap) and a 5-step matvec, the step
   time, and G(1.723) through K1/K2 (220 steps a matvec, k_dim 16, tol
   1e-4) against the TPU's 6.304672 (within 5e-3); and two BoostConv
   cycles in f64 from the march;
6. periodic bases and forced response: on ``examples/cylinder_upo.py``'s
   192-element Re = 100 mesh with its f32 K1/K2 solver, the period map of
   ``upo_out/UPO_cyl_00001.npz`` over 1,604 steps (the orbit the
   full-period Floquet operator stores), the 50-step orbit tangent against
   the plain versions and f64 central differences, one full-period Floquet
   matvec on the stored orbit and two 50-step ones on one operator (3 x 50
   launches of each kernel: the orbit is stored once), the orbit's neutral
   phase mode, the f64 Floquet adjoint identity and the f32 Floquet
   rmatvec against the plain versions (its backward's launches), and the
   example's projected time; on ``examples/cylinder_resolvent_sweep.py``'s
   Re = 50 mesh about ``resolvent_out/BF_cyl_00001.npz``, the forced
   tangent integration at omega = 0.78 against the plain
   versions (64 steps) and over a whole period (2,176 launches of each),
   its transpose identity in f64, and the projected time of an R(omega)
   apply and of an svds;
7. the f64 3-D PnPn-2 step (no kernel: the JAX package's 3-D ``'pnpn2'``
   step runs none) on ``examples_torch/cube_transient_growth.py``'s case
   (184 elements at order 4, ``'fdm'``, 1e-7/1e-8) about the JAX run's
   ``cube_out/BF_cube_00001.npz``: 50 steps restarted from it against the
   JAX step's |du/dt| (``tools_torch/cube_restart_check.py``) with each
   solve's CG iterations, the G(2.0) matvec and rmatvec (69 steps) with
   the adjoint identity (the example's gate, 1e-6) and their times, the
   projected minutes of the march and of G(2.0) and G(6.0) from
   ``cube_out/``'s matvec counts, the ``'block'`` and ``'schwarz'`` set-up
   and pressure iterations on one step beside ``'fdm'``, and the 3-D rung:
   a 10-step ``'pnpn2'`` matvec on phase 2's 1,472-element cube beside its
   ``'laplacian'`` one;
8. the thermal (Boussinesq) path: on the Rayleigh-Benard case (Ra 2000,
   Pr 1, 4 x 2 elements at order 6, f64 plain) the coupled (u, T) adjoint
   identity (5 steps, 1e-11) and ``linear_stability_analysis(base_T=...)``
   at 40 steps a matvec (k_dim 8, one restart; sigma within 1.5 % of the
   exact 11.0155, a stationary mode); on the rung (512 elements, eight
   critical wavelengths, f32 ``fused_solves``: K1 with masks that differ
   by component, K2 with the mean projection) K1/K2 against their plain
   versions on one coupled step's solves, the launches and times of a
   40-step coupled matvec and rmatvec, sigma within 1.5 % of 12.0372
   (k_dim 16, one Krylov-Schur restart on the coupled basis); one
   fused-IR coupled step against f64 (1e-7); an FST ``u_bc_fn`` step and
   a ``'consistent'`` step on the card against the same on the CPU
   (1e-12).

Each path is driven with every kernel's launch count set to 0 just before
it and read just after.  Every phase is fatal on failure and prints its
wall seconds (``phase N name: ... s wall``).  Imports nothing of JAX.

Output: one line per result, then a ``{"kernels": [...]}`` JSON line (each
kernel's launches on its path, max abs error against its plain version,
time, plain time, and the least time the card could take, ``bound_ms``;
for K1 and K2 also ``per_iter_ms``, ``phases``, the grid barriers the
timed solve crossed, ``rmatvec_launches``, the launches in one
rmatvec's backward, and ``fused_ir``: launches a fused-IR step, matvec,
rmatvec backward and eigen-residual run, iterations per inner solve, and
one BDF3 inner solve's kernel and plain times; and ``bfs``: launches in
the G(1.723) run, max abs error against the plain version on the step
mesh, iterations of each recorded solve, ``bdf3_solve``: one BDF3
solve's kernel and plain times, iterations and bound, and the step time;
and ``periodic``: launches on phase 6's run, max abs error against the
plain versions there, the two 50-step orbit matvecs', the Floquet
rmatvec backward's and the particular solution's launches, and the step,
full-period matvec and primal times; and ``thermal``: launches per coupled
matvec, rmatvec and fused-IR step on the RB rung, max abs error against
the plain versions there, the matvec and rmatvec times and dof-steps/s;
K4 once per cube shape, with its
``shape``), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
Exits nonzero, printing no result, without a CUDA device or without the
port's package beside this script.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

NSTEPS = 50
REPS = 3  # timed matvecs of a kernel path; a plain path's check is timed once
# flagship: bench.py's f32 rung (bench.py:58-62,131-140)
FLAGSHIP = dict(reynolds=60.0, nr=16, ntheta=48, order=6, outer_radius=40.0)
CAPS_F32 = dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=16,
                velocity_maxiter=10, pressure_precond="block")
CAPS_TIGHT = dict(pressure_tol=1e-10, velocity_tol=1e-10, pressure_maxiter=2000,
                  velocity_maxiter=500, pressure_precond="block")
# the flagship cylinder refined 2 x 3: 4,608 elements, 1,152 element groups
# of 4, more than the 1,056 blocks of 256 threads an H100 can hold at once,
# so K1 and K2 run their grid-stride path (a block owns several groups)
LARGE = dict(reynolds=60.0, nr=32, ntheta=144, order=6, outer_radius=40.0)
SWEEP = (1, 4, 16)  # maxiter of the tol = 0 timing sweep
TPU_KERNEL = {  # the pallas_call each kernel replaces
    "fused_helmholtz_cg": "nekstab_next_tpu/ops/fused_cg.py:394",
    "fused_pressure_cg": "nekstab_next_tpu/ops/fused_cg.py:665",
    "fused_helmholtz": "nekstab_next_tpu/ops/pallas_kernels.py:210",
}
SOURCE = {
    "fused_helmholtz_cg": "nekstab_next_tpu_torch/csrc/fused_helmholtz_cg.cu",
    "fused_pressure_cg": "nekstab_next_tpu_torch/csrc/fused_pressure_cg.cu",
    "fused_helmholtz": "nekstab_next_tpu_torch/csrc/fused_helmholtz.cu",
}
# the 3-D path: examples/cube_transient_growth.py's cube with the element
# lattice doubled (24 x 8 x 8, 1,472 elements after carving) at the
# flagship's order 6, its tolerances, and a horizon cut to 10 steps
CUBE = dict(reynolds=60.0, h=2.0, lx=12.0, ly=4.0, lz=4.0, cube_x=4.0, cube_z=2.0,
            nx=24, ny=8, nz=8, order=6, delta=1.0, target_cfl=0.2)
CUBE_TOL = dict(pressure_tol=1e-7, velocity_tol=1e-8, pressure_maxiter=300,
                velocity_maxiter=120)
CUBE_TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=2000,
                  velocity_maxiter=500)
CUBE_NSTEPS = 10
CUBE_REPS = 2
# the Krylov layer and the cylinder pipeline: the full preset of
# examples/cylinder_stability.py on the flagship mesh (its artifacts in
# cylinder_out_full/, its horizon 1.0), depth cut: 10-step f64 identity,
# 50-step f32 matvecs for the stability API, one Newton iteration, the
# adjoint analysis with one Krylov-Schur restart (the direct one, the same
# eigs on the matvec, is not run: the smoke's time limit)
ARTIFACTS = ("cylinder_out_full", "cylinder_out2")  # full and quick presets
QUICK = dict(reynolds=60.0, nr=6, ntheta=16, order=6, outer_radius=20.0)
HORIZON = 1.0
CAPS_12 = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=2000,
               velocity_maxiter=500, pressure_precond="block")
EXAMPLE_F64 = dict(pressure_precond="block")  # 1e-8 / 1e-9, the example's f64 solver
IDENTITY_STEPS = 10
STEP_REPS = 5  # timed f64 steps a preset (~0.3 s each, host-bound)
EIGS = dict(k_dim=24, nev=2, max_restarts=1)
# the fused-IR mixed path: examples/cylinder_stability.py's --precision mixed
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)
ORTHO_K = (24, 128)
# the backward-facing step: examples_torch/bfs_transient_growth.py's barkley
# preset (320 elements at order 5, graded into the re-entrant corner, the
# reference's sponges), its f32 base flow marched on the TPU and the TPU's
# transient growth through the fused kernels (tools/bfs_tpu_tg.py --fused)
BFS_EXAMPLE = "examples_torch/bfs_transient_growth.py"
BFS_MARCH = "bfs_out/bfs_march.npz"
BFS_G = ("bfs_out/growth_fused_check.json", "bfs_out/growth.json")  # fused, 'schwarz'
BFS_T = 1.723
BFS_TG = dict(nsv=1, k_dim=16, tol=1e-4)  # bfs_tg.py --fused's svds
BFS_ITERS = {"face": 55, "node": 50}  # 'schwarz' CG iterations to 1e-5, at most
BFS_TIGHT = dict(pressure_tol=1e-10, velocity_tol=1e-10, pressure_maxiter=3000,
                 velocity_maxiter=1000)
BFS_MATVEC_STEPS = 5
BFS_BOOST = dict(skip=50, subspace=12, cycles=2)
# periodic bases and forced response: examples/cylinder_upo.py's Re = 100
# orbit (192 elements, f32 K1/K2 at caps 24/12) at the TPU run's period in
# 1,604 steps, and its DNS length; examples/cylinder_resolvent_sweep.py's
# Re = 50 mesh (grading 8) with the TPU's base flow, its f64 Newton
# tolerances, and omega = 0.78 (2,176 steps a period), its forced
# integration cut to 64 steps against the plain versions and 16 in f64
UPO_DIR = "upo_out"
UPO_MESH = dict(reynolds=100.0, nr=8, ntheta=24, order=6, outer_radius=20.0, grading=10.0)
UPO_F32 = dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=24, velocity_maxiter=12,
               pressure_precond="block", fused_solves=True)
UPO_STEPS = 1604
UPO_DNS_TIME = 160.0
SWEEP_DIR = "resolvent_out"
SWEEP_MESH = dict(reynolds=50.0, nr=8, ntheta=24, order=6, outer_radius=20.0, grading=8.0)
SWEEP_OMEGA = 0.78
SWEEP_CUT = 64
SWEEP_T_STEPS = 16
# the 3-D PnPn-2 step: examples_torch/cube_transient_growth.py's case (184
# elements at order 4, f64, 'pnpn2' with 'fdm', its tolerances) about the
# JAX package's recorded run in cube_out/ (its march's base flow, and
# G(2.0), G(6.0) with their matvec counts)
CUBE_EXAMPLE = "examples_torch/cube_transient_growth.py"
CUBE_OUT = "cube_out"
CUBE_MARCH = 50
CUBE_G_T = 2.0
# |du/dt| ~ ||u_50 - u_0|| / (50 dt) of the JAX step from that base flow
# (a fresh state: zero pressure, the BDF ramp), on the CPU by
# tools_torch/cube_restart_check.py; the port's CPU step reads 2.6738579525e-4
CUBE_RESTART = 2.6738579526e-4
# published H100 SXM peaks: device memory and float32 outside the tensor
# cores
# phase 8: the thermal (Boussinesq) path
RB_SMALL = dict(rayleigh=2000.0, prandtl=1.0, nx=4, ny=2, order=6, dt=2.5e-3)
RB_SIGMA = 11.0155  # growth_rate_freeslip(2000, 1, K_CRITICAL)
RB_RUNG_SIGMA = 12.0372  # the rung's most unstable admissible k = 10 K_CRITICAL / 8
RB_STEPS = 40  # steps a matvec (horizon 0.1 thermal times), as JAX's test
RB_IDENTITY_STEPS = 5
# k_dim 8 where JAX's test takes 24: a pass fills k_dim matvecs before its
# convergence check, and 8 reach the test's tolerance after one restart in
# 11 matvecs with the same sigma (10.99748421 on the CPU either way)
RB_EIGS = dict(k_dim=8, nev=1, tol=1e-8, max_restarts=10)
# the rung's sigma: k_dim 16 and one restart (the Schur condensation and
# the Q Z rotation of the coupled (u, T) basis on the card)
RB_RUNG_EIGS = dict(k_dim=16, nev=1, tol=1e-6, max_restarts=1)
# the small case's f64 pressure solves: 11 'schwarz' CG iterations a solve
# with node-overlap patches, where face patches take 17 and 'fdm' 50, on a
# host-bound step (the JAX test's default 'fdm' took 228 s for the 960
# steps of its Krylov-Schur run on the card)
RB_PRECOND = dict(pressure_precond="schwarz", pressure_patch_overlap="node")
RB_F32 = dict(fused_solves=True, pressure_tol=1e-5, velocity_tol=1e-6, scalar_tol=1e-6)
RB_TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, scalar_tol=1e-12)

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def roofline(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_flops(E: int, n: int, C: int, iters: int) -> float:
    """Operations of a K1 solve, per iteration and node and component as
    counted from csrc/fused_helmholtz_cg.cu: the local Helmholtz apply
    (8n + 10), the FDM preconditioner (8n + 12), two assemblies (8), three
    dots (6) and three axpys (6)."""
    return float(iters) * E * n * n * C * (16 * n + 38)


def k2_flops(E: int, n: int, nc: int, iters: int) -> float:
    """Operations of a K2 solve, per iteration and element as counted from
    csrc/fused_pressure_cg.cu (m = n - 2): E = D M^-1 D^T with its Gauss <->
    GLL transfers (16 n^3 + 4 n m (m + n) + 25 n^2), the element-block
    inverse (2 m^4), the Q1 restriction and prolongation, dots and axpys
    (28 m^2); plus the dense coarse solve (2 nc^2) once per iteration."""
    m = n - 2
    per_elem = 16 * n ** 3 + 4 * n * m * (m + n) + 25 * n * n + 2 * m ** 4 + 28 * m * m
    return float(iters) * (E * per_elem + 2.0 * nc * nc)


def k4_flops(E: int, n: int, dim: int, C: int) -> float:
    """Operations of one K4 apply, per node and component: dim reference
    derivatives and dim transposed ones of 2n each, the metric combination
    (2-D 6, 3-D 15) and h1 K u + h2 bm u (4)."""
    per_node = 8 * n + 10 if dim == 2 else 12 * n + 19
    return float(E) * n ** dim * C * per_node


def k4_bound(k4, u, h2: float, C) -> dict:
    """Bound of one K4 apply: u read and out written once, the metrics and
    D read once, bm only where h2 != 0 (the kernel skips it at h2 = 0)."""
    fields = (u, u, *k4.metrics, k4.D) + ((k4.bm,) if h2 != 0 else ())
    return roofline(nbytes(*fields), k4_flops(k4.nelem, k4.n, k4.ndim, C or 1))


def k4_shapes(sem, cube, h1: float, h2: float):
    """(label, SEM, components or None for no component axis, (h1, h2)) of
    the shapes the two paths give K4: the cylinder's velocity (C = 2), the
    cube's velocity (C = 3) and its pressure (one component, h1 = 1,
    h2 = 0)."""
    return (("cylinder", sem, 2, (h1, h2)),
            ("cube velocity", cube.sem, 3, (cube.h / cube.reynolds, (11.0 / 6.0) / cube.dt)),
            ("cube pressure", cube.sem, None, (1.0, 0.0)))


def k4_fields(sem, nelem: int):
    """The fields K4 reads from a SEM, tiled (or cut) to ``nelem`` elements:
    a stand-in SEM for element counts that no small mesh has."""
    import types

    import torch

    keys = (("g11", "g12", "g22") if sem.ndim == 2
            else ("g11", "g22", "g33", "g12", "g13", "g23"))
    reps = -(-nelem // sem.nelem)
    tile = lambda t: torch.cat([t] * reps)[:nelem].contiguous()
    return types.SimpleNamespace(n=sem.n, ndim=sem.ndim, nelem=nelem, D=sem.D,
                                 bm=tile(sem.bm), **{k: tile(getattr(sem, k)) for k in keys})


def check_k4_sweep(dev) -> float:
    """Hold K4 against its plain version (rel < 1e-5) for d = 2, 3, n = 4..8
    and C = 1, 2, 3 at three element counts each: one element, two groups
    and one element (the last group partial), and one group more than the
    grid holds, plus one element (blocks walk several groups).  Returns the
    largest max abs error."""
    import torch
    from nekstab_next_tpu_torch.mesh import box_mesh_2d, box_mesh_3d
    from nekstab_next_tpu_torch.ops.core import SEM
    from nekstab_next_tpu_torch.ops.core3 import SEM3
    from nekstab_next_tpu_torch.ops.fused_helmholtz import FusedHelmholtz, block_groups

    rng = np.random.default_rng(11)
    worst = 0.0
    for dim in (2, 3):
        for n in range(4, 9):
            base = (SEM(box_mesh_2d(3, 3, order=n - 1, grading_x=1.3), dtype=torch.float32,
                        device=dev) if dim == 2 else
                    SEM3(box_mesh_3d(3, 2, 3, order=n - 1, periodic_z=True),
                         dtype=torch.float32, device=dev))
            for C in (1, 2, 3):
                geo = FusedHelmholtz(k4_fields(base, 1)).geometry(C)
                per, fit = geo["per_block"], geo["per_sm"] * geo["sms"]
                rels, grids = [], []
                for E in (1, 2 * per + 1, per * (fit + 1) + 1):
                    k4 = FusedHelmholtz(k4_fields(base, E))
                    shape = k4.node_shape + ((C,) if C > 1 else ())
                    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                        device=dev)
                    got, ref = k4.apply(u, 0.0167, 100.0), k4.plain(u, 0.0167, 100.0)
                    torch.cuda.synchronize()
                    r = rel(got, ref)
                    worst = max(worst, float((got - ref).abs().max()))
                    rels.append(r)
                    grids.append(k4.grid)
                    if not (r < 1e-5 and k4.launches == 1):
                        fail(f"K4 sweep d={dim} n={n} C={C} E={E}: rel {r:.3e}, "
                             f"launches {k4.launches}")
                if len(block_groups(0, grids[-1], per * (fit + 1) + 1, per)) < 2:
                    fail(f"K4 sweep d={dim} n={n} C={C}: no block walked several groups")
                log(f"K4 sweep d={dim} n={n} C={C}: {per} elements x {geo['threads']} threads "
                    f"a block, {geo['smem']} B shared, {geo['per_sm']} blocks an SM; "
                    f"E = 1, {2 * per + 1}, {per * (fit + 1) + 1} on grids {grids}: rel "
                    + ", ".join(f"{r:.2e}" for r in rels) + " (bound 1e-5)")
    return worst


def phase_wall(name: str, t0: float) -> float:
    """Log a phase's wall seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    log(f"phase {name}: {now - t0:.1f} s wall")
    return now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def kernel_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device milliseconds of one launch of fn(), which must launch
    kernels without synchronising the host.  A GPU spin queued first keeps
    the card busy while the host enqueues every launch, so no host time
    falls between the CUDA events; with ``cold`` the 50 MB L2 cache is
    flushed (a 128 MB write) before each launch, outside the events."""
    import torch

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps if cold else 1)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning, longer than the enqueue
    if cold:
        for start, end in ev:
            flush.zero_()
            start.record()
            fn()
            end.record()
    else:
        ev[0][0].record()
        for _ in range(reps):
            fn()
        ev[0][1].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds of fn() over reps calls, by CUDA events, after one
    warm-up call (``warm_up=False``: the caller's last call of the same
    path, a check's, was the warm-up)."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_call(fn):
    """(fn(), its milliseconds by CUDA events): one call, timed as it runs."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def plain_solves(ns):
    """Route the stepper's two solves through the kernels' plain versions."""
    fv, fp = ns.fused_v, ns.fused_p
    fv.solve, fp.solve = fv.plain, fp.plain
    try:
        yield
    finally:
        del fv.solve, fp.solve


@contextlib.contextmanager
def plain_k4(ns):
    """Route the mixed stepper's local Helmholtz apply through K4's plain
    version."""
    k4 = ns.mixed.fused
    k4.apply = k4.plain
    try:
        yield
    finally:
        del k4.apply


def make_case(dtype, caps, fused: bool):
    import torch
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig

    return CylinderCase(**FLAGSHIP, dtype=dtype, device=torch.device("cuda", 0),
                        solver=SolverConfig(**caps, fused_solves=fused))


def digest(t) -> str:
    """First 16 hex digits of the sha256 of a tensor's bytes: equal digests
    mean bit-identical results."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def cg_inputs(sem, rng):
    """Seeded right-hand sides of K1 (projected, C = 2) and K2."""
    import torch
    from nekstab_next_tpu_torch.ops.elliptic import make_projector

    dev = sem.device
    rhs_v = make_projector(sem, sem.vmask)(
        torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape) + (2,)),
                        dtype=torch.float32, device=dev))
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32, device=dev)
    return rhs_v, rhs_p


def check_cg_kernels(label: str, sem, h1: float, h2: float, rng, grid_stride: bool = False):
    """Hold K1 (C = 2, maxiter 10, tol 1e-6; rel < 1e-5) and K2 (tol 1e-6;
    rel < 1e-4 at maxiter 300, < 1e-3 at 16) against their plain versions
    on seeded inputs, printing each launch's grid; with ``grid_stride``
    fail unless the grid is smaller than the element groups.  Returns
    (rhs_v, rhs_p, the K1 instance, max abs errors by kernel)."""
    import torch
    from nekstab_next_tpu_torch.ops.fused_cg import FusedHelmholtzCG, FusedPressureCG

    rhs_v, rhs_p = cg_inputs(sem, rng)
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    x_k, x_p = k1.solve(rhs_v, h1, h2), k1.plain(rhs_v, h1, h2)
    torch.cuda.synchronize()
    r1 = rel(x_k, x_p)
    err = {"fused_helmholtz_cg": float((x_k - x_p).abs().max())}
    groups = -(-sem.nelem // 4)

    def check_grid(k, name):
        log(f"  {name} launch at the {label}: {k.grid} blocks of 256 threads for {groups} "
            f"element groups (at most {k.resident} fit on the card)")
        if grid_stride and not k.grid < groups:
            fail(f"{name} at the {label}: {k.grid} blocks cover all {groups} groups, "
                 "the grid-stride path did not run")

    log(f"K1 fused_helmholtz_cg vs plain at the {label} (C=2, maxiter 10, tol 1e-6): "
        f"rel {r1:.3e} (bound 1e-5), digest {digest(x_k)}")
    check_grid(k1, "K1")
    if not (r1 < 1e-5):
        fail(f"K1 disagrees with its plain version at the {label}: rel {r1:.3e}")
    errs_p = []
    for maxiter, bound in ((300, 1e-4), (16, 1e-3)):
        k2 = FusedPressureCG(sem, maxiter=maxiter, tol=1e-6,
                             project_mean=not sem.has_pressure_dirichlet)
        y_k, y_p = k2.solve(rhs_p), k2.plain(rhs_p)
        torch.cuda.synchronize()
        r2 = rel(y_k, y_p)
        errs_p.append(float((y_k - y_p).abs().max()))
        log(f"K2 fused_pressure_cg vs plain at the {label} (maxiter {maxiter}, tol 1e-6): "
            f"rel {r2:.3e} (bound {bound:g}), digest {digest(y_k)}")
        check_grid(k2, "K2")
        if not (r2 < bound):
            fail(f"K2 disagrees with its plain version at the {label}, maxiter {maxiter}: "
                 f"rel {r2:.3e}")
    err["fused_pressure_cg"] = max(errs_p)
    return rhs_v, rhs_p, k1, err


def cg_sweep(sem, rhs_v, rhs_p, h1: float, h2: float, tag: str) -> dict:
    """Device time of one K1 and one K2 solve at tol = 0 for each maxiter of
    SWEEP (every solve runs exactly maxiter iterations) and the
    least-squares line through them: per_iter_ms (slope) and setup_ms
    (intercept)."""
    from nekstab_next_tpu_torch.ops.fused_cg import FusedHelmholtzCG, FusedPressureCG

    solvers = {
        "fused_helmholtz_cg": (lambda m: FusedHelmholtzCG(sem, sem.vmask, maxiter=m, tol=0.0),
                               lambda k: k.solve(rhs_v, h1, h2)),
        "fused_pressure_cg": (lambda m: FusedPressureCG(
            sem, maxiter=m, tol=0.0, project_mean=not sem.has_pressure_dirichlet),
            lambda k: k.solve(rhs_p)),
    }
    out = {}
    for name, (make, call) in solvers.items():
        ms = []
        for m in SWEEP:
            k = make(m)
            ms.append(kernel_ms(lambda: call(k), 20))
        slope, icpt = np.polyfit(SWEEP, ms, 1)
        out[name] = {"sweep_ms": ms, "per_iter_ms": float(slope), "setup_ms": float(icpt)}
        log(f"timing {tag} {name} at tol 0, maxiter {SWEEP}: "
            + ", ".join(f"{t:.4f}" for t in ms)
            + f" ms; per iteration {slope * 1e3:.3f} us, set-up {icpt * 1e3:.3f} us")
    return out


def energy(sem, x) -> float:
    """Sponge-masked energy norm of a velocity field or an (re, im) pair."""
    parts = x if isinstance(x, tuple) else (x,)
    return float(sum(sem.inner(p[..., d], p[..., d]) for p in parts for d in range(2))) ** 0.5


def eigen_residual(sem, apply, re, im, lam, T: float) -> float:
    """||A v - mu v|| / ||v|| for v = re + i im, mu = exp(lam T), A real."""
    mu = np.exp(complex(*lam) * T)
    Ar, Ai = apply(re), apply(im)
    r = (Ar - mu.real * re + mu.imag * im, Ai - mu.real * im - mu.imag * re)
    return energy(sem, r) / energy(sem, (re, im))


def pipeline_phase(tag: str, dev) -> dict:
    """The Krylov layer and the cylinder pipeline on the flagship mesh
    (768 elements), against the full-preset artifacts; fails on any check.
    Returns the numbers the kernels line and the projections need."""
    import torch
    from nekstab_next_tpu_torch.algorithms import (
        linear_stability_analysis, newton_krylov, velocity_space)
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.krylov import Basis
    from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
    from nekstab_next_tpu_torch.postproc import bf_sensitivity, wave_maker
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu_torch.utils import (
        boundary_quadrature, surface_force_and_torque, velocity_noise)

    root = os.path.dirname(os.path.abspath(__file__))
    art = os.path.join(root, ARTIFACTS[0])
    with open(os.path.join(art, "summary.json")) as f:
        summary = json.load(f)
    load = lambda name: load_field(os.path.join(art, f"{name}_cyl_00001.npz"))
    # the example's time step: the horizon in a whole number of steps
    case64 = make_case(torch.float64, CAPS_12, fused=False)
    nsteps_full = max(int(round(HORIZON / case64.dt)), 1)
    dt = case64.dt = HORIZON / nsteps_full
    s64 = case64.sem

    def case_at(dtype, caps, fused):
        return CylinderCase(**FLAGSHIP, dtype=dtype, dt=dt, device=dev,
                            solver=SolverConfig(**caps, fused_solves=fused))

    # ---- P1. the artifacts: Cd and the wavemaker ------------------------
    bf = load("BF")
    if bf.u.shape != tuple(s64.bm.shape) + (2,) or bf.p.shape != tuple(s64.p_shape):
        fail(f"artifact shapes {bf.u.shape}, {bf.p.shape} against the port mesh's "
             f"{tuple(s64.bm.shape) + (2,)}, {tuple(s64.p_shape)}")
    base64 = torch.as_tensor(bf.u, device=dev)
    fx = surface_force_and_torque(s64, boundary_quadrature(case64.mesh, tags=(BC.WALL,)),
                                  base64, torch.as_tensor(bf.p, device=dev),
                                  viscosity=1.0 / summary["reynolds"])[0]
    cd = 2.0 * float(fx)
    r_cd = abs(cd - summary["cd"]) / summary["cd"]
    log(f"pipeline: {nsteps_full} steps a full-horizon matvec (dt {dt:.6g}); base flow "
        f"Cd {cd:.15g} vs summary.json {summary['cd']:.15g}: rel {r_cd:.3e} (bound 1e-9)")
    if not (r_cd <= 1e-9):
        fail(f"Cd of the loaded base flow {cd} against summary.json: rel {r_cd:.3e}")
    modes = {k: torch.as_tensor(load(k).u, device=dev) for k in ("dRe", "dIm", "aRe", "aIm")}
    wm = wave_maker(s64, modes["dRe"], modes["dIm"], modes["aRe"], modes["aIm"])
    saved = torch.as_tensor(load("wm").u[..., 0], device=dev)
    r_wm = rel(wm, saved)
    ix = int(torch.argmax(wm))
    peak = (float(wm.max()), float(case64.mesh.x.reshape(-1)[ix]),
            float(case64.mesh.y.reshape(-1)[ix]))
    ref_peak = summary["wavemaker_peak"]
    log(f"pipeline: wavemaker of the loaded modes vs wm_cyl_00001.npz: rel {r_wm:.3e} "
        f"(bound 1e-10); peak {peak[0]:.15g} at ({peak[1]:.6f}, {peak[2]:.6f}), "
        f"summary.json {ref_peak['value']:.15g} at ({ref_peak['x']:.6f}, {ref_peak['y']:.6f})")
    if not (r_wm <= 1e-10 and ix == int(torch.argmax(saved))
            and abs(peak[0] - ref_peak["value"]) <= 1e-10 * ref_peak["value"]
            and (peak[1], peak[2]) == (ref_peak["x"], ref_peak["y"])):
        fail(f"wavemaker against the artifact: rel {r_wm:.3e}, peak {peak}")

    # ---- P2. f64 adjoint identity, 10 steps, solves at 1e-12 -------------
    op64 = LinearizedOperator(case64.make_ns(), base64, nsteps=IDENTITY_STEPS)
    outside = (s64.bms > 0)[..., None].to(s64.dtype)  # M* projects out the sponge
    q, w = (outside * velocity_noise(s64, seed=sd) for sd in (1, 2))
    a = float(sum(s64.inner(op64.matvec(q)[..., d], w[..., d]) for d in range(2)))
    b = float(sum(s64.inner(q[..., d], op64.rmatvec(w)[..., d]) for d in range(2)))
    r_id = abs(a - b) / abs(a)
    log(f"pipeline: f64 adjoint identity about the loaded base ({IDENTITY_STEPS} steps, "
        f"solves at 1e-12): <Mq,w> {a:.15e}, <q,M*w> {b:.15e}, rel {r_id:.3e} (bound 1e-11)")
    if not (r_id <= 1e-11):
        fail(f"f64 adjoint identity: rel {r_id:.3e}")

    # ---- P3. the f32 rmatvec through K1/K2 --------------------------------
    case32 = case_at(torch.float32, CAPS_F32, True)
    s32 = case32.sem
    ns32 = case32.make_ns()
    fv, fp = ns32.fused_v, ns32.fused_p
    base32 = base64.float()
    op32 = LinearizedOperator(ns32, base32, nsteps=NSTEPS)
    # a smooth input, as the matvec's (bench.py's): capped solves on noise
    # stop far from the converged operator
    w32 = modes["aRe"].float()
    fv.launches = fp.launches = 0
    op32.rmatvec(w32)
    torch.cuda.synchronize()
    first = (fv.launches, fp.launches)
    fv.launches = fp.launches = 0
    out_k = op32.rmatvec(w32)
    torch.cuda.synchronize()
    backward = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    log(f"pipeline: f32 rmatvec ({NSTEPS} steps, caps 16/10) launches: first call "
        f"K1 {first[0]}, K2 {first[1]} (the vjp's forward at the zero history, "
        f"{first[0] - backward['fused_helmholtz_cg']} each, plus the backward); "
        f"later calls, backward only: {backward}")
    if backward != {"fused_helmholtz_cg": NSTEPS, "fused_pressure_cg": NSTEPS}:
        fail(f"expected {NSTEPS} K1 and K2 launches in the rmatvec's backward, got {backward}")
    if not bool(torch.isfinite(out_k).all()) or out_k.dtype != torch.float32:
        fail("f32 rmatvec output is not finite f32")
    with plain_solves(ns32):
        out_p = op32.rmatvec(w32)
    r_p = rel(out_k, out_p)
    op64t = LinearizedOperator(case_at(torch.float64, CAPS_TIGHT, False).make_ns(),
                               base64, nsteps=NSTEPS)
    out_64 = op64t.rmatvec(w32.double())
    drift = rel(out_k, out_64)
    log(f"pipeline: f32 rmatvec kernels vs plain versions: rel {r_p:.3e} (bound 1e-3); vs f64 "
        f"rmatvec at 1e-10: drift {drift:.3e} (bound 1e-3); digests kernels {digest(out_k)}, "
        f"plain {digest(out_p)}, f64 {digest(out_64)}")
    if not (r_p < 1e-3 and drift < 1e-3):
        fail(f"f32 rmatvec: vs plain {r_p:.3e}, drift {drift:.3e}")

    # ---- P4. eigen-residuals of the loaded modes at the full horizon -----
    op_full = LinearizedOperator(ns32, base32, nsteps=nsteps_full)
    f32 = {k: v.float() for k, v in modes.items()}
    res_d = eigen_residual(s32, op_full.matvec, f32["dRe"], f32["dIm"],
                           load("dRe").meta["eigenvalue"], op_full.T)
    res_a = eigen_residual(s32, op_full.rmatvec, f32["aRe"], f32["aIm"],
                           load("aRe").meta["eigenvalue"], op_full.T)
    log(f"pipeline: eigen-residual ||Mv - mu v||/||v|| of the loaded modes under the f32 "
        f"kernels' operator ({nsteps_full} steps): direct {res_d:.3e} (bound 1e-2), adjoint "
        f"under rmatvec {res_a:.3e} (reported, not gated: the artifacts' adjoint sigma is "
        f"{summary['adjoint']['sigma']:.6f} against direct {summary['direct']['sigma']:.6f})")
    if not (res_d <= 1e-2):
        fail(f"direct-mode eigen-residual {res_d:.3e} under the port's f32 operator")

    # ---- P5. the stability API at full width, depth cut -------------------
    # (the path's run: every launch count set to 0 just before, read after)
    fv.launches = fp.launches = 0
    nres = newton_krylov(ns32, base32, horizon=NSTEPS * dt, nsteps=NSTEPS,
                         cfg=NewtonConfig(max_iter=1, gmres_restarts=1), k_dim=8)
    F = ns32.propagator(nres.u, NSTEPS, dt=dt) - nres.u
    res_after = float(sum(s32.inner(F[..., d], F[..., d], masked=False) for d in range(2))) ** 0.5
    log(f"pipeline: one newton_krylov iteration (f32 kernels, {NSTEPS} steps, k_dim 8): "
        f"residual {nres.history[0][1]:.4e} before, {res_after:.4e} after, "
        f"{nres.n_matvecs} matvecs")
    space = velocity_space(s32)
    t0 = time.perf_counter()
    r = linear_stability_analysis(ns32, base32, horizon=NSTEPS * dt, nsteps=NSTEPS,
                                  mode="adjoint", **EIGS)
    torch.cuda.synchronize()
    audit = r.eigresult.orthonormality_audit(space)
    log(f"pipeline: linear_stability_analysis adjoint (f32, {NSTEPS} steps, k_dim "
        f"{EIGS['k_dim']}, {EIGS['max_restarts']} restart): lambda0 {r.lam[0]:.6f}, "
        f"lambda1 {r.lam[1]:.6f}, residuals {r.residuals[0]:.2e} {r.residuals[1]:.2e}, "
        f"{r.n_matvecs} matvecs in {time.perf_counter() - t0:.1f} s, orthonormality "
        f"audit {audit:.2e} (bound 1e-5)")
    if not (np.all(np.isfinite(r.lam[:2])) and audit <= 1e-5):
        fail(f"stability analysis adjoint: lambda {r.lam[:2]}, audit {audit:.2e}")
    wm32 = wave_maker(s32, f32["dRe"], f32["dIm"], *r.modes[0])
    sens = bf_sensitivity(s32, f32["dRe"], f32["dIm"], *r.modes[0])
    torch.cuda.synchronize()
    path = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    finite = bool(torch.isfinite(wm32).all()) and all(bool(torch.isfinite(v).all())
                                                      for v in sens.values())
    log(f"pipeline: wave_maker and bf_sensitivity of the saved direct and the result's "
        f"adjoint mode: finite {finite}; "
        f"kernel launches on the pipeline's run: {path}")
    if not finite:
        fail("wavemaker or base-flow sensitivity of the stability result is not finite")
    if min(path.values()) == 0:
        fail(f"the pipeline's run launched no K1 or K2: {path}")

    # ---- P6. times -----------------------------------------------------
    ms = {}

    def chained(fn, x0):
        state = {"x": x0}

        def run():
            state["x"] = fn(state["x"])
        return run

    ms["f32 matvec"] = cuda_ms(chained(op32.matvec, w32), REPS)
    ms["f32 rmatvec"] = cuda_ms(chained(op32.rmatvec, w32), REPS)
    ratio = ms["f32 rmatvec"] / ms["f32 matvec"]
    log(f"timing {tag} pipeline: f32 ({NSTEPS} steps, caps 16/10) matvec "
        f"{ms['f32 matvec']:.2f} ms, rmatvec through the kernels {ms['f32 rmatvec']:.2f} ms, "
        f"ratio {ratio:.3f}")
    steps = {}
    for label, geometry in (("full", FLAGSHIP), ("quick", QUICK)):
        c = CylinderCase(**geometry, device=dev, solver=SolverConfig(**EXAMPLE_F64))
        n = max(int(round(HORIZON / c.dt)), 1)
        c.dt = HORIZON / n
        ns = c.make_ns()
        st = {"s": ns.make_state(base64 if label == "full" else c.uniform_flow())}

        def step():
            st["s"] = ns.step(st["s"])
        steps[label] = (n, cuda_ms(step, STEP_REPS))
        log(f"timing {tag} pipeline: f64 step at the example's tolerances (1e-8/1e-9, 'block') "
            f"on the {label} preset's mesh ({c.mesh.nelem} elements, {n} steps a matvec): "
            f"{steps[label][1]:.2f} ms")
    for k in ORTHO_K:
        basis = Basis(space, base64, capacity=k + 1)
        basis.Q[:k] = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (k,) + tuple(base64.shape)), device=dev)
        wk = velocity_noise(s64, seed=k)
        ms[f"ortho {k}"] = cuda_ms(lambda: basis.ortho_insert(wk, k - 1), 10)
        log(f"timing {tag} pipeline: one ortho_insert at k = {k} (f64, "
            f"{base64.numel()} dof, two CGS passes): {ms[f'ortho {k}']:.3f} ms")
    # projected time of the eigen stages (direct + adjoint matvecs of each
    # summary.json; Newton's matvecs are not recorded there): steps a
    # matvec x matvecs x ms a step, the adjoint's times the rmatvec ratio
    for label, d in (("full", ARTIFACTS[0]), ("quick", ARTIFACTS[1])):
        with open(os.path.join(root, d, "summary.json")) as f:
            sm = json.load(f)
        n, t64 = steps[label]
        nd, na = sm["direct"]["n_matvecs"], sm["adjoint"]["n_matvecs"]
        per_f32 = ms["f32 matvec"] / NSTEPS
        p64 = n * (nd + na * ratio) * t64 / 3.6e6
        p32 = n * (nd + na * ratio) * per_f32 / 3.6e6
        log(f"projection {tag} pipeline: {label} preset eigen stages ({nd} + {na} matvecs "
            f"from {d}/summary.json, {n} steps each): f64 at the example's tolerances "
            f"{p64:.2f} h, f32 kernels (caps 16/10, flagship per-step time) {p32:.2f} h")
    return {"rmatvec_launches": backward, "path_launches": path, "ms": ms, "ratio": ratio,
            "base64": base64, "modes": modes, "dt": dt, "nsteps_full": nsteps_full,
            "lam": {k: load(k).meta["eigenvalue"] for k in ("dRe", "aRe")},
            "summary": summary, "f64_step_ms": steps, "f32_step_ms": ms["f32 matvec"] / NSTEPS}

def cg_iterations(k, barriers: int) -> int:
    """CG iterations of a K1/K2 launch from its grid barriers: 2 + 4 k, and
    2 more with K2's mean projection (csrc/fused_*_cg.cu)."""
    return (barriers - 2 - 2 * int(getattr(k, "project_mean", False))) // 4


@contextlib.contextmanager
def recording_solves(ns, log_calls: list):
    """Record every K1/K2 launch of the stepper: (kernel, f32 rhs, its other
    arguments, CG iterations from the launch's barriers).  Synchronises."""
    fv, fp = ns.fused_v, ns.fused_p

    def wrap(k, name):
        solve = k.solve

        def run(rhs, *a):
            out = solve(rhs, *a)
            log_calls.append((name, rhs.float().clone(), a, cg_iterations(k, k.last_barriers())))
            return out
        return run

    fv.solve, fp.solve = wrap(fv, "fused_helmholtz_cg"), wrap(fp, "fused_pressure_cg")
    try:
        yield
    finally:
        del fv.solve, fp.solve


def fused_ir_phase(tag: str, dev, pipe: dict) -> dict:
    """The fused-IR mixed-precision path (f64 state on the PnPn-2 step, K1/K2
    as the f32 inner solves of iterative refinement) on the flagship mesh
    with the example's --precision mixed settings, about the loaded base
    flow; fails on any check.  Returns the numbers the kernels line needs."""
    import torch
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu_torch.utils import (
        boundary_quadrature, surface_force_and_torque, velocity_noise)

    dt, base64, modes = pipe["dt"], pipe["base64"], pipe["modes"]
    case = CylinderCase(**FLAGSHIP, dt=dt, device=dev, mixed_precision=True,
                        solver=SolverConfig(**MIXED))
    s64 = case.sem
    t0 = time.perf_counter()
    ns = case.make_ns()
    if not (ns._mixed_ir and ns.mixed is None and ns._scheme == "pnpn2"):
        fail("the fused-IR path did not engage on the flagship mesh")
    fv, fp = ns.fused_v, ns.fused_p
    cycles = ns.solver.mixed_ir_cycles
    log(f"fused-IR: flagship mesh, example's mixed settings, {cycles} refinement cycles, "
        f"inner solves at tol {fv.tol:g} with caps K1 {fv.maxiter}, K2 {fp.maxiter}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    ns64 = CylinderCase(**FLAGSHIP, dt=dt, device=dev,
                        solver=SolverConfig(**CAPS_12)).make_ns()

    def counts():
        return {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}

    # ---- R1. one step: launches, iterations, kernels vs plain vs f64 ----
    st0 = ns.make_state(base64)
    calls = []
    fv.launches = fp.launches = 0
    with recording_solves(ns, calls):
        st1 = ns.step(st0)
    torch.cuda.synchronize()
    per_step = counts()
    if per_step != {k: cycles for k in per_step}:
        fail(f"a fused-IR step launched {per_step}, expected {cycles} of each")
    with plain_solves(ns):
        st1_p = ns.step(st0)
    st1_64 = ns64.step(ns64.make_state(base64))
    r_p, r_64 = rel(st1.u, st1_p.u), rel(st1.u, st1_64.u)
    log(f"fused-IR step: launches {per_step}; kernels vs plain versions rel {r_p:.3e} "
        f"(bound 1e-7), vs f64 at 1e-12 drift {r_64:.3e} (bound 1e-7)")
    if st1.u.dtype != torch.float64 or not (r_p < 1e-7 and r_64 < 1e-7):
        fail(f"fused-IR step: {st1.u.dtype}, vs plain {r_p:.3e}, drift {r_64:.3e}")

    # the inner solves of a BDF3 step and of a tangent step: iterations at
    # 3e-6, none at its cap (a capped inner solve stalls the refinement)
    calls.clear()
    with recording_solves(ns, calls):
        st3 = ns.advance(st0, 3)
        LinearizedOperator(ns, base64, nsteps=3).matvec(velocity_noise(s64, seed=3))
    torch.cuda.synchronize()
    iters = {name: [c[3] for c in calls if c[0] == name] for name in per_step}
    caps = {"fused_helmholtz_cg": fv.maxiter, "fused_pressure_cg": fp.maxiter}
    log(f"fused-IR inner iterations per solve (3 steps, then a 3-step tangent; "
        f"cycle by cycle): {iters}")
    if any(max(v) >= caps[k] for k, v in iters.items()):
        fail(f"a fused-IR inner solve hit its cap: {iters}, caps {caps}")
    # the first cycle's solves of the third (BDF3) step, for the timings
    bdf3 = {name: next(c for c in calls[4 * cycles:6 * cycles] if c[0] == name)
            for name in per_step}

    # ---- R2. 50-step tangent matvec and rmatvec -------------------------
    outside = (s64.bms > 0)[..., None].to(s64.dtype)
    q, w = (outside * velocity_noise(s64, seed=sd) for sd in (4, 5))
    op = LinearizedOperator(ns, base64, nsteps=NSTEPS)
    op64 = LinearizedOperator(ns64, base64, nsteps=NSTEPS)
    fv.launches = fp.launches = 0
    mv = op.matvec(q)
    torch.cuda.synchronize()
    mv_launches = counts()
    op._stage_vjps()
    fv.launches = fp.launches = 0
    rmv = op.rmatvec(w)
    torch.cuda.synchronize()
    rmv_launches = counts()
    with plain_solves(ns):
        mv_p, rmv_p = op.matvec(q), op.rmatvec(w)
    mv_64, rmv_64 = op64.matvec(q), op64.rmatvec(w)
    checks = {"matvec": (rel(mv, mv_p), rel(mv, mv_64)),
              "rmatvec": (rel(rmv, rmv_p), rel(rmv, rmv_64))}
    want = {k: NSTEPS * cycles for k in per_step}
    for name, (r_p, r_64) in checks.items():
        log(f"fused-IR {NSTEPS}-step {name}: launches "
            f"{mv_launches if name == 'matvec' else rmv_launches}"
            f"{' (backward only)' if name == 'rmatvec' else ''}; kernels vs plain versions "
            f"rel {r_p:.3e} (bound 1e-7), vs f64 at 1e-12 drift {r_64:.3e} (bound 1e-7)")
        if not (r_p < 1e-7 and r_64 < 1e-7):
            fail(f"fused-IR {name}: vs plain {r_p:.3e}, drift {r_64:.3e}")
    if mv_launches != want or rmv_launches != want:
        fail(f"fused-IR launches: matvec {mv_launches}, rmatvec {rmv_launches}, want {want}")
    bms = s64.bms[..., None]
    a, b = float(torch.sum(mv * w * bms)), float(torch.sum(q * rmv * bms))
    r_id = abs(a - b) / abs(a)
    log(f"fused-IR adjoint identity ({NSTEPS} steps): rel {r_id:.3e} (bound 1e-8)")
    if not (r_id <= 1e-8):
        fail(f"fused-IR adjoint identity: rel {r_id:.3e}")

    # ---- R3. eigen-residuals of the saved modes at the full horizon -----
    # (the path's run: launch counts set to 0 just before, read after)
    fv.launches = fp.launches = 0
    op_full = LinearizedOperator(ns, base64, nsteps=pipe["nsteps_full"])
    t0 = time.perf_counter()
    res_d = eigen_residual(s64, op_full.matvec, modes["dRe"], modes["dIm"],
                           pipe["lam"]["dRe"], op_full.T)
    res_a = eigen_residual(s64, op_full.rmatvec, modes["aRe"], modes["aIm"],
                           pipe["lam"]["aRe"], op_full.T)
    torch.cuda.synchronize()
    path = counts()
    sm = pipe["summary"]
    log(f"fused-IR eigen-residuals of the loaded modes ({pipe['nsteps_full']} steps, "
        f"{time.perf_counter() - t0:.1f} s): direct {res_d:.3e} (sigma "
        f"{sm['direct']['sigma']:.6f}), adjoint under rmatvec {res_a:.3e} (sigma "
        f"{sm['adjoint']['sigma']:.6f}), each with its own lambda (bound 1e-4); "
        f"kernel launches {path}")
    if not (res_d <= 1e-4 and res_a <= 1e-4):
        fail(f"fused-IR eigen-residuals: direct {res_d:.3e}, adjoint {res_a:.3e}")
    if min(path.values()) == 0:
        fail(f"the fused-IR run launched no K1 or K2: {path}")

    # the quick preset's artifacts (JAX, f64) under the fused-IR operators
    # of the quick mesh: Cd of the saved base flow and both modes'
    # eigen-residuals at its horizon, reported (not gated)
    root = os.path.dirname(os.path.abspath(__file__))
    qart = os.path.join(root, ARTIFACTS[1])
    loadq = lambda name: load_field(os.path.join(qart, f"{name}_cyl_00001.npz"))
    with open(os.path.join(qart, "summary.json")) as f:
        smq = json.load(f)
    quick = CylinderCase(**QUICK, device=dev, mixed_precision=True, solver=SolverConfig(**MIXED))
    nq = max(int(round(HORIZON / quick.dt)), 1)
    quick.dt = HORIZON / nq
    nsq = quick.make_ns()
    if not nsq._mixed_ir:
        fail("the fused-IR path did not engage on the quick preset's mesh")
    bfq = loadq("BF")
    base_q = torch.as_tensor(bfq.u, device=dev)
    cd_q = 2.0 * float(surface_force_and_torque(
        quick.sem, boundary_quadrature(quick.mesh, tags=(BC.WALL,)), base_q,
        torch.as_tensor(bfq.p, device=dev), viscosity=1.0 / smq["reynolds"])[0])
    opq = LinearizedOperator(nsq, base_q, nsteps=nq)
    mq = {k: torch.as_tensor(loadq(k).u, device=dev) for k in ("dRe", "dIm", "aRe", "aIm")}
    res_qd = eigen_residual(quick.sem, opq.matvec, mq["dRe"], mq["dIm"],
                            loadq("dRe").meta["eigenvalue"], opq.T)
    res_qa = eigen_residual(quick.sem, opq.rmatvec, mq["aRe"], mq["aIm"],
                            loadq("aRe").meta["eigenvalue"], opq.T)
    log(f"fused-IR, quick preset artifacts ({ARTIFACTS[1]}, JAX f64; {quick.mesh.nelem} "
        f"elements, {nq} steps): Cd of the saved base flow {cd_q:.15g} vs summary.json "
        f"{smq['cd']:.15g}; eigen-residuals direct {res_qd:.3e} (sigma "
        f"{smq['direct']['sigma']:.9f}), adjoint under rmatvec {res_qa:.3e} (sigma "
        f"{smq['adjoint']['sigma']:.9f}), each with its own lambda (reported)")

    # ---- R4. times -------------------------------------------------------
    ms = {}

    def chained(fn, x0):
        state = {"x": x0}

        def run():
            state["x"] = fn(state["x"])
        return run

    st = {"s": st3}

    def step():
        st["s"] = ns.step(st["s"])
    ms["step"] = cuda_ms(step, 20)
    ms["matvec"] = cuda_ms(chained(op.matvec, q), REPS)
    ms["rmatvec"] = cuda_ms(chained(op.rmatvec, w), REPS)
    ratio = ms["rmatvec"] / ms["matvec"]
    solve = {}
    for name, (_, rhs, args, it) in bdf3.items():
        k = fv if name == "fused_helmholtz_cg" else fp
        flops = (k1_flops(s64.nelem, s64.n, 2, it) if k is fv
                 else k2_flops(s64.nelem, s64.n, s64.pc_nc, it))
        solve[name] = {"ms": kernel_ms(lambda: k.solve(rhs, *args), 20),
                       "plain_ms": cuda_ms(lambda: k.plain(rhs, *args), 5), "iterations": it,
                       **roofline(nbytes(rhs, rhs, *k._dev.values()), flops)}
    log(f"timing {tag} fused-IR (flagship, example's mixed settings): step "
        f"{ms['step']:.2f} ms (f64 at the example's tolerances "
        f"{pipe['f64_step_ms']['full'][1]:.2f} ms, f32 kernels at caps 16/10 "
        f"{pipe['f32_step_ms']:.2f} ms a tangent step); {NSTEPS}-step matvec "
        f"{ms['matvec']:.2f} ms, rmatvec {ms['rmatvec']:.2f} ms, ratio {ratio:.3f}")
    for name, v in solve.items():
        log(f"timing {tag} one fused-IR inner {name} solve (BDF3 step, tol {fv.tol:g}): "
            f"kernel {v['ms']:.4f} ms at {v['iterations']} iterations, plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})")
    stq = {"s": nsq.make_state(base_q)}

    def step_q():
        stq["s"] = nsq.step(stq["s"])
    ir_steps = {"full": (pipe["nsteps_full"], ms["step"]), "quick": (nq, cuda_ms(step_q, 20))}
    log(f"timing {tag} fused-IR step on the quick preset's mesh ({quick.mesh.nelem} "
        f"elements): {ir_steps['quick'][1]:.2f} ms")
    for label, d in (("full", ARTIFACTS[0]), ("quick", ARTIFACTS[1])):
        with open(os.path.join(root, d, "summary.json")) as f:
            smd = json.load(f)
        nd, na = smd["direct"]["n_matvecs"], smd["adjoint"]["n_matvecs"]
        n, t_ir = ir_steps[label]
        t64 = pipe["f64_step_ms"][label][1]
        p64 = n * (nd + na * pipe["ratio"]) * t64 / 3.6e6
        pir = n * (nd + na * ratio) * t_ir / 3.6e6
        log(f"projection {tag} fused-IR: {label} preset eigen stages ({nd} + {na} matvecs, "
            f"{n} steps each): fused-IR {pir:.2f} h at {t_ir:.2f} ms a step, f64 at the "
            f"example's tolerances {p64:.2f} h")
    return {"per_step": per_step, "matvec": mv_launches, "rmatvec": rmv_launches,
            "path": path, "iterations": iters, "solve": solve, "ms": ms}


def load_example(path: str, name: str):
    """An example script of the repository as a module (its presets, case
    builders and stage functions)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bfs_phase(tag: str, dev) -> dict:
    """The backward-facing step at the barkley preset: the f64 'schwarz'
    set-up and its pressure iterations, the 'schwarz' step against the
    'fdm' one on the quick preset, K1/K2 against their plain versions on
    the graded mesh (one step's solves and a 5-step matvec of the --fused
    f32 route), G(1.723) through K1/K2 against the TPU's value, and a few
    BoostConv cycles in f64; fails on any check.  Returns the numbers the
    kernels line needs."""
    import torch
    from nekstab_next_tpu_torch.algorithms import boostconv_dns, transient_growth_analysis
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.ops.cg import pcg
    from nekstab_next_tpu_torch.ops.schwarz import (
        build_p0_coarse, build_pressure_patches, element_coupling_colors, extract_sparse_E,
        make_pressure_operator, p0_coarse_apply, patch_apply)
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    root = os.path.dirname(os.path.abspath(__file__))
    ex = load_example(BFS_EXAMPLE, "bfs_transient_growth_torch")
    P = ex.PRESETS["barkley"]

    # ---- B1. the f64 'schwarz' set-up and its pressure iterations --------
    case64 = ex.build_case(P, sponge=False, device=dev,
                           solver=SolverConfig(pressure_precond="schwarz"))
    s64 = case64.sem
    gid = s64.gid_np.reshape(s64.nelem, -1)
    ncol = {d: int(element_coupling_colors(gid, distance=d).max()) + 1 for d in (1, 2)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    B = extract_sparse_E(s64)
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    patches = {adj: build_pressure_patches(s64, weighted=False, B=B, adjacency=adj)
               for adj in ("face", "node")}
    t_patches = time.perf_counter() - t0
    t0 = time.perf_counter()
    Acinv = torch.as_tensor(build_p0_coarse(s64, B=B), device=dev)
    t_p0 = time.perf_counter() - t0
    at_corner = (np.abs(case64.mesh.x) < 1e-12) & (np.abs(case64.mesh.y) < 1e-12)
    corner = int(np.bincount(gid.reshape(-1))[gid.reshape(-1)[at_corner.reshape(-1)][0]])
    log(f"bfs: barkley preset, {s64.nelem} elements, n={s64.n}, {s64.pc_nc} coarse vertices "
        f"(elements at the step corner: {corner}), dt={case64.dt:.6g}; f64 'schwarz' set-up: "
        f"{ncol[2]} distance-2 colours ({ncol[1]} at distance 1), {len(B)} blocks of E "
        f"extracted in {t_extract:.2f} s, face and node patches inverted in {t_patches:.2f} s "
        f"(sizes {patches['face'][1].shape[1]}, {patches['node'][1].shape[1]}), P0 coarse "
        f"inverse in {t_p0:.2f} s")
    E_op = make_pressure_operator(s64)
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(s64.p_shape), device=dev)
    for adj, cap in BFS_ITERS.items():
        def M(r, pt=patches[adj]):
            z = patch_apply(*pt, r) + p0_coarse_apply(Acinv, r)
            return z + s64.restrict_p(s64.coarse_apply_pressure(s64.lift_p(r)))

        x, k = pcg(E_op, b, precond=M, tol=1e-5, maxiter=500, return_iters=True)
        r_res = float((b - E_op(x)).norm() / b.norm())
        log(f"bfs: f64 pressure CG to 1e-5 on seeded noise, 'schwarz' {adj} patches: {k} "
            f"iterations (bound {cap}), residual {r_res:.3e}")
        if not (k <= cap and r_res < 2e-5):
            fail(f"'schwarz' {adj} patches: {k} iterations, residual {r_res:.3e}")
    s64.setup_pressure_blocks()
    k_block = pcg(E_op, b, precond=s64.pressure_precond_block, tol=1e-5, maxiter=2000,
                  return_iters=True)[1]
    log(f"bfs: the same solve with 'block' (K2's preconditioner): {k_block} iterations")

    # ---- B2. 'schwarz' against 'fdm': one BDF1 step on the quick preset --
    steps = {}
    for pc in ("schwarz", "fdm"):
        qc = ex.build_case(ex.PRESETS["quick"], device=dev,
                           solver=SolverConfig(**BFS_TIGHT, pressure_precond=pc))
        nsq = qc.make_ns()
        t0 = time.perf_counter()
        steps[pc] = nsq.step(nsq.make_state(qc.initial_flow())).u
        torch.cuda.synchronize()
        steps[pc + "_s"] = time.perf_counter() - t0
    d_step = float((steps["schwarz"] - steps["fdm"]).abs().max())
    log(f"bfs: quick preset ({qc.mesh.nelem} elements), one f64 BDF1 step at 1e-10 "
        f"tolerances, 'schwarz' vs 'fdm': max abs {d_step:.3e} (bound 1e-7); "
        f"{steps['schwarz_s']:.2f} s and {steps['fdm_s']:.2f} s")
    if not (d_step < 1e-7):
        fail(f"'schwarz' step against the 'fdm' step: {d_step:.3e}")

    # ---- B3. the --fused f32 route: K1/K2 against their plain versions --
    bf = load_field(os.path.join(root, BFS_MARCH))
    case = ex.build_case(P, dtype=torch.float32, solver=ex.f32_solver(True), device=dev)
    sem = case.sem
    if bf.u.shape != tuple(sem.bm.shape) + (2,) or not ex.same_mesh(
            bf.meta, ex.mesh_fingerprint(case, P)):
        fail(f"{BFS_MARCH} (meta {bf.meta}) is not on the barkley mesh")
    base = torch.as_tensor(bf.u, dtype=torch.float32, device=dev)
    ns = case.make_ns(sponge_ref=base)
    fv, fp = ns.fused_v, ns.fused_p
    log(f"bfs: {BFS_MARCH} (TPU f32 march, residual {bf.meta['residual']:.3e}) on the "
        f"--fused f32 route: K1 cap {fv.maxiter} tol {fv.tol:g}, K2 cap {fp.maxiter} tol "
        f"{fp.tol:g}, sponge toward the base")
    calls = []
    with recording_solves(ns, calls):
        st = ns.advance(ns.make_state(base), 3)
    torch.cuda.synchronize()
    err = {"fused_helmholtz_cg": 0.0, "fused_pressure_cg": 0.0}
    bound = {"fused_helmholtz_cg": 1e-5, "fused_pressure_cg": 1e-4}
    caps = {"fused_helmholtz_cg": fv.maxiter, "fused_pressure_cg": fp.maxiter}
    for i, (name, rhs, args, it) in enumerate(calls):
        k = fv if name == "fused_helmholtz_cg" else fp
        got, (ref, it_p) = k.solve(rhs, *args), k.plain(rhs, *args, return_iters=True)
        torch.cuda.synchronize()
        r = rel(got, ref)
        err[name] = max(err[name], float((got - ref).abs().max()))
        log(f"bfs: step {i // 2 + 1} {name}: kernel vs plain rel {r:.3e} (bound "
            f"{bound[name]:g}), {it} iterations (plain {it_p}, cap {caps[name]})"
            + (" AT ITS CAP" if it >= caps[name] else "") + f", digest {digest(got)}")
        if not (r < bound[name]):
            fail(f"{name} on the step mesh: rel {r:.3e} against its plain version")
    iterations = {n: [c[3] for c in calls if c[0] == n] for n in err}
    op = LinearizedOperator(ns, base, nsteps=BFS_MATVEC_STEPS)
    q = sem.vmask * base  # a smooth input, as the flagship matvec's
    out_k = op.matvec(q)
    with plain_solves(ns):
        out_p = op.matvec(q)
    r_mv = rel(out_k, out_p)
    log(f"bfs: {BFS_MATVEC_STEPS}-step f32 matvec through K1/K2 vs the plain versions: rel "
        f"{r_mv:.3e} (bound 1e-3)")
    if not (bool(torch.isfinite(out_k).all()) and r_mv < 1e-3):
        fail(f"step-mesh matvec through the kernels: rel {r_mv:.3e}")
    state = {"s": st}

    def step():
        state["s"] = ns.step(state["s"])
    step_ms = cuda_ms(step, 10)
    solve = {}  # the last (BDF3) step's solves
    for name, rhs, args, it in calls[-2:]:
        k = fv if name == "fused_helmholtz_cg" else fp
        flops = (k1_flops(sem.nelem, sem.n, 2, it) if k is fv
                 else k2_flops(sem.nelem, sem.n, sem.pc_nc, it))
        solve[name] = {"ms": kernel_ms(lambda: k.solve(rhs, *args), 10),
                       "plain_ms": cuda_ms(lambda: k.plain(rhs, *args), 3), "iterations": it,
                       **roofline(nbytes(rhs, rhs, *k._dev.values()), flops)}
        log(f"timing {tag} bfs one BDF3 {name} solve: kernel {solve[name]['ms']:.4f} ms "
            f"at {it} iterations, plain {solve[name]['plain_ms']:.4f} ms, bound "
            f"{solve[name]['bound_ms']:.4f} ms ({solve[name]['bound_by']})")
    log(f"timing {tag} bfs --fused f32 step: {step_ms:.2f} ms")

    # ---- B4. G(1.723) through K1/K2 ---------------------------------------
    with open(os.path.join(root, BFS_G[0])) as f:
        g_fused = json.load(f)["points"][0]
    with open(os.path.join(root, BFS_G[1])) as f:
        g_schwarz = next(pt for pt in json.load(f)["points"] if pt["t"] == BFS_T)
    nsteps = max(int(round(BFS_T / case.dt)), 1)
    fv.launches = fp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = transient_growth_analysis(ns, base, horizon=BFS_T, nsteps=nsteps, **BFS_TG)
    torch.cuda.synchronize()
    t_tg = time.perf_counter() - t0
    launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    G = float(res.gains[0])
    gap = G / g_fused["G"] - 1.0
    log(f"bfs: G({BFS_T}) through K1/K2 ({nsteps} steps a matvec, dt {case.dt:.7g}, "
        f"k_dim {BFS_TG['k_dim']}, tol {BFS_TG['tol']:g}) = {G:.9f}; TPU fused "
        f"{g_fused['G']:.9f} ({BFS_G[0]}): rel {gap:+.3e} (bound 5e-3); TPU 'schwarz' "
        f"{g_schwarz['G']:.9f}: rel {G / g_schwarz['G'] - 1.0:+.3e}; svds residual "
        f"{float(res.residuals[0]):.3e}, {res.n_matvecs} matvecs + rmatvecs, launches "
        f"{launches}, {t_tg:.1f} s")
    if not (abs(gap) < 5e-3 and min(launches.values()) > 0):
        fail(f"G({BFS_T}) = {G} against the TPU's {g_fused['G']}: rel {gap:.3e}, "
             f"launches {launches}")

    # ---- B5. BoostConv cycles in f64 'schwarz' from the march ---------------
    ns_b = case64.make_ns()  # the example's f64 solver: 'schwarz', 1e-8 / 1e-9
    hist = []
    t0 = time.perf_counter()
    boostconv_dns(ns_b, torch.as_tensor(bf.u, device=dev), skip=BFS_BOOST["skip"],
                  subspace=BFS_BOOST["subspace"], tol=0.0,
                  max_steps=BFS_BOOST["skip"] * BFS_BOOST["cycles"],
                  callback=lambda n, r: hist.append(r))
    t_boost = time.perf_counter() - t0
    log(f"bfs: BoostConv (skip {BFS_BOOST['skip']}, subspace {BFS_BOOST['subspace']}) in "
        f"f64 'schwarz' from {BFS_MARCH}: residuals "
        + ", ".join(f"{r:.3e}" for r in hist) + f" ({t_boost:.1f} s)")
    if not (len(hist) == BFS_BOOST["cycles"] and np.all(np.isfinite(hist))):
        fail(f"BoostConv residual history {hist}")
    return {"launches": launches, "max_abs_err": err, "iterations": iterations,
            "solve": solve, "step_ms": step_ms}


def periodic_phase(tag: str, dev) -> dict:
    """Periodic bases and forced response: the Re = 100 shedding orbit of
    ``examples/cylinder_upo.py`` (192 elements, its f32 K1/K2 solver) and
    the Re = 50 resolvent-sweep mesh of ``examples/cylinder_resolvent_sweep.py``
    at omega = 0.78; fails on any check.  Returns the numbers the kernels
    line needs."""
    import torch
    from nekstab_next_tpu_torch.algorithms.newton import _dotv
    from nekstab_next_tpu_torch.algorithms.resolvent import ResolventOperator
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.stepper.linearized import (
        FloquetOperator, LinearizedOperator, make_orbit_tangent_propagator)
    from nekstab_next_tpu_torch.utils import velocity_noise

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, UPO_DIR, "upo.json")) as f:
        upo = json.load(f)
    T = upo["period"]
    N = UPO_STEPS
    dt = T / N
    norm = lambda x: float(_dotv(sem, x, x)) ** 0.5

    def upo_case(dtype, solver):
        return CylinderCase(**UPO_MESH, dt=dt, dtype=dtype, device=dev,
                            solver=SolverConfig(**solver))

    case = upo_case(torch.float32, UPO_F32)
    sem = case.sem
    ns = case.make_ns()
    fv, fp = ns.fused_v, ns.fused_p
    path = {"fused_helmholtz_cg": 0, "fused_pressure_cg": 0}
    err = {"fused_helmholtz_cg": 0.0, "fused_pressure_cg": 0.0}

    def take(stepper=ns):
        """Add the stepper's launches since the last reset to the path's
        count, and reset them."""
        torch.cuda.synchronize()
        path["fused_helmholtz_cg"] += stepper.fused_v.launches
        path["fused_pressure_cg"] += stepper.fused_p.launches
        stepper.fused_v.launches = stepper.fused_p.launches = 0

    def against_plain(got, ref):
        e = float((got - ref).abs().max())
        for k in err:
            err[k] = max(err[k], e)
        return rel(got, ref)

    fv.launches = fp.launches = 0
    u = torch.as_tensor(load_field(os.path.join(root, UPO_DIR, "UPO_cyl_00001.npz")).u,
                        dtype=torch.float32, device=dev)
    log(f"periodic: {UPO_DIR}/UPO_cyl_00001.npz on the UPO mesh ({sem.nelem} elements, "
        f"Re {case.reynolds}), T {T:.6f} in {N} steps of {dt:.7g}, f32 K1/K2 caps "
        f"{fp.maxiter}/{fv.maxiter}")

    # ---- U1. the period map: the orbit stored by the full-period operator --
    op = FloquetOperator(ns, u, nsteps=N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = op._orbit()
    take()
    t_period = time.perf_counter() - t0
    r_map = norm(steps.final - u)
    primal = dict(path)
    log(f"periodic: ||Phi_T(u) - u|| = {r_map:.4e} (bound 5e-3; the TPU's f32 Newton "
        f"stopped at {upo['residual']:.4e}), {t_period:.2f} s ({1e3 * t_period / N:.3f} ms "
        f"a step), the orbit stored by the full-period FloquetOperator: launches {primal}")
    if not (r_map <= 5e-3) or primal != {k: N for k in primal}:
        fail(f"the loaded orbit's period map residual {r_map:.4e}, launches {primal}")

    # ---- U2. the orbit tangent at 50 steps --------------------------------
    q = sem.vmask * u  # a smooth input
    got = make_orbit_tangent_propagator(ns, NSTEPS)(u, None, q, dt)
    take()
    with plain_solves(ns):
        ref = make_orbit_tangent_propagator(ns, NSTEPS)(u, None, q, dt)
    r_plain = against_plain(got, ref)
    ns64 = upo_case(torch.float64, CAPS_TIGHT).make_ns()
    u64, q64 = u.double(), q.double()
    eps = 1e-5
    fd = (ns64.propagator(u64 + eps * q64, NSTEPS) - ns64.propagator(u64 - eps * q64, NSTEPS)) / (2 * eps)
    r_fd = rel(got, fd)
    frozen = LinearizedOperator(ns, u, nsteps=NSTEPS).matvec(q)
    take()
    log(f"periodic: {NSTEPS}-step orbit tangent through K1/K2 vs plain versions rel "
        f"{r_plain:.3e} (bound 1e-3), vs central differences of the f64 propagator at 1e-10 "
        f"{r_fd:.3e} (bound 1e-3); the frozen-base tangent is {rel(frozen, fd):.3e} from them")
    if not (r_plain <= 1e-3 and r_fd <= 1e-3):
        fail(f"orbit tangent: vs plain {r_plain:.3e}, vs f64 differences {r_fd:.3e}")

    # ---- U3. the full-period orbit matvec; the orbit stored once ----------
    qdot = (ns.propagator(u, 1) - u) / dt
    take()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Mq = op.matvec(qdot)
    torch.cuda.synchronize()
    ms_matvec, ms_primal = 1e3 * (time.perf_counter() - t0), 1e3 * t_period
    full = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    take()
    neutral = norm(Mq - qdot) / norm(qdot)
    log(f"periodic: a full-period matvec on the stored orbit launched {full} (expected {N} "
        f"each), {ms_matvec:.1f} ms, the stored primal {ms_primal:.1f} ms; monodromy drift "
        f"{op.monodromy_drift:.4e}")
    if full != {k: N for k in full}:
        fail(f"a full-period orbit matvec launched {full}, expected {N} each")
    short = FloquetOperator(ns, u, nsteps=NSTEPS)
    Ms = short.matvec(qdot)
    Ms2 = short.matvec(qdot)
    launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    take()
    log(f"periodic: two {NSTEPS}-step matvecs on one FloquetOperator launched {launches} "
        f"(3 x {NSTEPS} each: the orbit is stored once); equal bits {torch.equal(Ms, Ms2)}")
    if launches != {k: 3 * NSTEPS for k in launches} or not torch.equal(Ms, Ms2):
        fail(f"two orbit matvecs launched {launches}, expected 3 x {NSTEPS} each")
    log(f"periodic: neutral phase mode ||M qdot - qdot|| / ||qdot|| = {neutral:.4e} "
        f"(bound 5e-2)")
    if not (neutral <= 5e-2):
        fail(f"the orbit's multiplier at 1: {neutral:.4e}")

    # ---- U4. the Floquet adjoint ---------------------------------------------
    ns12 = upo_case(torch.float64, CAPS_12).make_ns()
    op64 = FloquetOperator(ns12, u64, nsteps=IDENTITY_STEPS * 2)
    outside = (sem.bms > 0)[..., None].double()
    qa, wa = (outside * velocity_noise(ns12.sem, seed=sd) for sd in (1, 2))
    a = float(sum(ns12.sem.inner(op64.matvec(qa)[..., d], wa[..., d]) for d in range(2)))
    b = float(sum(ns12.sem.inner(qa[..., d], op64.rmatvec(wa)[..., d]) for d in range(2)))
    r_id = abs(a - b) / abs(a)
    log(f"periodic: f64 Floquet adjoint identity ({2 * IDENTITY_STEPS} steps along the orbit, "
        f"solves at 1e-12, bms product): {a:.15e} vs {b:.15e}, rel {r_id:.3e} (bound 1e-10)")
    if not (r_id <= 1e-10):
        fail(f"Floquet adjoint identity: rel {r_id:.3e}")
    w = sem.vmask * u
    opa = FloquetOperator(ns, u, nsteps=NSTEPS)
    opa.rmatvec(w)
    take()
    got = opa.rmatvec(w)
    rmatvec_launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    take()
    with plain_solves(ns):
        ref = FloquetOperator(ns, u, nsteps=NSTEPS).rmatvec(w)
    r_rp = against_plain(got, ref)
    log(f"periodic: f32 Floquet rmatvec ({NSTEPS} steps) kernels vs plain rel {r_rp:.3e} "
        f"(bound 1e-3); its backward launched {rmatvec_launches}")
    if not (r_rp <= 1e-3 and rmatvec_launches == {k: NSTEPS for k in rmatvec_launches}):
        fail(f"Floquet rmatvec: rel {r_rp:.3e}, backward launches {rmatvec_launches}")

    # ---- U5. the example's projected time ------------------------------------
    step_ms = 1e3 * t_period / N
    dns_steps = int(round(UPO_DNS_TIME / CylinderCase(**UPO_MESH, device=dev).dt))
    log(f"projection {tag} periodic: examples/cylinder_upo.py DNS {UPO_DNS_TIME:g} time units "
        f"= {dns_steps} steps x {step_ms:.3f} ms = {dns_steps * step_ms / 6e4:.1f} min; Newton "
        f"{upo['n_matvecs']} matvecs ({UPO_DIR}/upo.json) x ({ms_matvec:.0f} + "
        f"{ms_primal:.0f}) ms = {upo['n_matvecs'] * (ms_matvec + ms_primal) / 6e4:.1f} min "
        f"(at most: one primal an iteration)")

    # (the f64 residual of the saved sweep base flow over one time unit, 86 s
    # on the card, is no longer run here; the sweep example's Newton reports
    # its own base flow's residual)
    bf = load_field(os.path.join(root, SWEEP_DIR, "BF_cyl_00001.npz"))
    base64 = torch.as_tensor(bf.u, device=dev)

    # ---- S2. the forced integration at omega = 0.78 in f32 ------------------
    c32 = CylinderCase(**SWEEP_MESH, dtype=torch.float32, device=dev,
                       solver=SolverConfig(**UPO_F32))
    n32 = c32.make_ns()
    gv, gp = n32.fused_v, n32.fused_p
    spp = int(np.ceil(2 * np.pi / SWEEP_OMEGA / c32.dt / 4.0)) * 4
    base32 = base64.float()
    ro = ResolventOperator(n32, base32, SWEEP_OMEGA, steps_per_period=spp)
    fr = c32.sem.vmask * base32
    fi = c32.sem.vmask * (base32 - c32.uniform_flow())
    gv.launches = gp.launches = 0
    got = ro._integrate(torch.zeros_like(fr), fr, fi, SWEEP_CUT)
    take(n32)
    with plain_solves(n32):
        ref = ro._integrate(torch.zeros_like(fr), fr, fi, SWEEP_CUT)
    r_f = against_plain(got, ref)
    log(f"periodic: sweep mesh f32 forced integration at omega {SWEEP_OMEGA} ({spp} steps a "
        f"period) cut to {SWEEP_CUT} steps: kernels vs plain rel {r_f:.3e} (bound 1e-3)")
    if not (r_f <= 1e-3):
        fail(f"forced integration: kernels vs plain {r_f:.3e}")
    t0 = time.perf_counter()
    b_full = ro._apply((fr, fi))
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0
    part = {"fused_helmholtz_cg": gv.launches, "fused_pressure_cg": gp.launches}
    take(n32)
    log(f"periodic: full-period particular solution: launches {part} (expected {spp} each), "
        f"{t_part:.2f} s ({1e3 * t_part / spp:.3f} ms a step), finite "
        f"{bool(torch.isfinite(b_full).all())}")
    if part != {k: spp for k in part} or not bool(torch.isfinite(b_full).all()):
        fail(f"the particular solution launched {part}")

    # ---- S3. the transpose identity in f64, 16 steps, bm product ------------
    r64 = ResolventOperator(CylinderCase(**SWEEP_MESH, device=dev,
                                         solver=SolverConfig(**CAPS_12)).make_ns(),
                            base64, SWEEP_OMEGA, steps_per_period=spp)
    f64r, f64i = fr.double(), fi.double()
    wv = velocity_noise(r64.sem, seed=3)
    bm = r64.sem.bm[..., None]
    Pf = r64._integrate(torch.zeros_like(f64r), f64r, f64i, SWEEP_T_STEPS)
    ct = [torch.zeros_like(f64r), torch.zeros_like(f64r)]
    r64._integrate_t(wv * bm, SWEEP_T_STEPS, ct)
    lhs = float(torch.sum(bm * Pf * wv))
    rhs = float(torch.sum(f64r * ct[0] + f64i * ct[1]))
    r_t = abs(lhs - rhs) / abs(lhs)
    log(f"periodic: f64 forced-integration transpose identity ({SWEEP_T_STEPS} steps, bm "
        f"product): {lhs:.15e} vs {rhs:.15e}, rel {r_t:.3e} (bound 1e-10)")
    if not (r_t <= 1e-10):
        fail(f"forced-integration transpose: rel {r_t:.3e}")
    apply_s = (2 * 20 + 2) * t_part
    log(f"projection {tag} periodic: one R(omega = {SWEEP_OMEGA}) apply at the sweep's GMRES "
        f"(k_dim 20, 2 restarts) costs at most 42 period integrations = {apply_s:.0f} s; one "
        f"svds at k_dim 8 (8 applies of R and 8 of R*) {16 * apply_s / 60:.0f} min")
    return {"launches": path, "max_abs_err": err, "orbit_matvec": launches,
            "rmatvec_launches": rmatvec_launches, "particular": part,
            "ms": {"step": step_ms, "matvec": ms_matvec, "primal": ms_primal,
                   "particular_step": 1e3 * t_part / spp}}


@contextlib.contextmanager
def recording_pcg(iters: list):
    """Record (solve, CG iterations) of every plain ``pcg`` the stepper
    runs: 'velocity' for a solve with a component axis, else 'pressure'.
    Synchronises once a solve."""
    from nekstab_next_tpu_torch.ops import cg as cg_mod

    pcg = cg_mod.pcg

    def run(A, b, *args, **kw):
        x, k = pcg(A, b, *args, **dict(kw, return_iters=True))
        iters.append(("velocity" if b.dim() == 5 else "pressure", k))
        return x

    cg_mod.pcg = run
    try:
        yield
    finally:
        cg_mod.pcg = pcg


def iteration_summary(iters: list, name: str) -> str:
    ks = [k for n, k in iters if n == name]
    return f"{name} {min(ks)}-{max(ks)} (mean {np.mean(ks):.1f}, first {ks[:3]})"


def cube3d_phase(tag: str, dev, cube: dict) -> dict:
    """The f64 3-D PnPn-2 step on the cube example's case about
    ``cube_out/BF_cube_00001.npz``: a march from the loaded base flow, the
    G(2.0) matvec and rmatvec with their adjoint identity, the projected
    svds minutes, the 'block' and 'schwarz' set-ups and iterations beside
    'fdm', and the 3-D rung (a 10-step 'pnpn2' matvec on phase 2's
    1,472-element cube beside its 'laplacian' one); fails on any check.
    ``cube``: phase 2's cube SEM, its stepper arguments, base and input
    and its f64 'laplacian' matvec time."""
    import dataclasses

    import torch
    from nekstab_next_tpu_torch.algorithms.stability import velocity_space
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    root = os.path.dirname(os.path.abspath(__file__))
    ex = load_example(CUBE_EXAMPLE, "cube_transient_growth_torch")
    with open(os.path.join(root, CUBE_OUT, "growth.json")) as f:
        growth = json.load(f)
    t0 = time.perf_counter()
    case = ex.make_case(dev)
    sem = case.sem
    ns = case.make_ns()
    bf = load_field(os.path.join(root, CUBE_OUT, "BF_cube_00001.npz"))
    base = torch.as_tensor(bf.u, device=dev)
    log(f"cube3d: {CUBE_OUT}/BF_cube_00001.npz on {CUBE_EXAMPLE}'s case ({sem.nelem} "
        f"elements, n={sem.n}, {case.mesh.npoints * 3} velocity dof, dt={case.dt:.6g}), f64 "
        f"'{ns._scheme}' with '{case.solver.pressure_precond}' at "
        f"{case.solver.pressure_tol:g}/{case.solver.velocity_tol:g}, set-up "
        f"{time.perf_counter() - t0:.1f} s; no kernel on this path (fused solves "
        f"{ns.fused_v is not None}, K4 {ns.mixed is not None})")
    if (sem.nelem != growth["nelem"] or tuple(base.shape) != tuple(sem.bm.shape) + (3,)
            or ns._scheme != "pnpn2" or ns.fused_v is not None or ns.mixed is not None):
        fail(f"the cube case: {sem.nelem} elements, base {tuple(base.shape)}, scheme "
             f"{ns._scheme}")

    # ---- C1. a march from the loaded base flow ---------------------------
    iters = []
    with recording_pcg(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = ns.advance(ns.make_state(base), CUBE_MARCH)
        torch.cuda.synchronize()
        t_march = time.perf_counter() - t0
    res = ex.velocity_change(sem, st.u - base) / (CUBE_MARCH * case.dt)
    r_restart = abs(res / CUBE_RESTART - 1.0)
    log(f"cube3d: {CUBE_MARCH} steps from the loaded base flow (zero pressure, BDF ramp): "
        f"|du/dt| ~ {res:.10e}, the JAX step's {CUBE_RESTART:.10e} (rel {r_restart:.3e}, bound "
        f"1e-3; the JAX march stopped at {bf.meta['residual']:.3e} with its pressure), "
        f"{1e3 * t_march / CUBE_MARCH:.2f} ms a step (a host sync a solve); CG iterations a "
        f"solve: {iteration_summary(iters, 'velocity')}, {iteration_summary(iters, 'pressure')}")
    if not (bool(torch.isfinite(st.u).all()) and r_restart < 1e-3):
        fail(f"the 3-D step moves the loaded base flow at |du/dt| {res:.4e}, not the JAX "
             f"step's {CUBE_RESTART:.4e}")

    # ---- C2. the G(2.0) matvec and rmatvec, the adjoint identity ---------
    point = next(p for p in growth["points"] if p["t"] == CUBE_G_T)
    nsteps = max(int(round(CUBE_G_T / case.dt)), 1)
    if nsteps != point["nsteps"]:
        fail(f"G({CUBE_G_T}) takes {nsteps} steps here, {point['nsteps']} in {CUBE_OUT}")
    op = LinearizedOperator(ns, base, nsteps=nsteps)
    space = velocity_space(sem)
    rng = np.random.default_rng(11)
    x0, yv = (sem.vmask * torch.as_tensor(rng.standard_normal(tuple(base.shape)), device=dev)
              for _ in range(2))
    # the identity's two calls are the timed ones (the rmatvec's first call
    # builds its three per-stage vjps: one tangent step each)
    times, out = {}, {}
    for name, fn, arg in (("matvec", op.matvec, x0), ("rmatvec", op.rmatvec, yv)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(arg)
        torch.cuda.synchronize()
        times[name] = 1e3 * (time.perf_counter() - t0)
    Mx, Mty = out["matvec"], out["rmatvec"]
    a1, a2 = float(space.dot(Mx, yv)), float(space.dot(x0, Mty))
    adj = abs(a1 - a2) / abs(a1)
    log(f"cube3d: G({CUBE_G_T}) operator, {nsteps} steps: adjoint identity <Mq,w> "
        f"{a1:.15e} vs <q,M*w> {a2:.15e}, rel {adj:.3e} (bound 1e-6, the example's gate); "
        f"matvec {times['matvec']:.1f} ms ({times['matvec'] / nsteps:.2f} ms a step), rmatvec "
        f"{times['rmatvec']:.1f} ms ({times['rmatvec'] / nsteps:.2f} ms a step, its vjps' "
        f"build included)")
    if not (adj < 1e-6 and bool(torch.isfinite(Mx).all()) and bool(torch.isfinite(Mty).all())):
        fail(f"the 3-D adjoint identity: rel {adj:.3e}")

    # ---- C3. projected minutes of the example ----------------------------
    pair_step = (times["matvec"] + times["rmatvec"]) / nsteps
    with open(os.path.join(root, CUBE_OUT, "report.json")) as f:
        march_steps = json.load(f)["baseflow"]["steps"]
    parts = [f"march {march_steps} steps x {1e3 * t_march / CUBE_MARCH:.2f} ms = "
             f"{march_steps * t_march / CUBE_MARCH / 60:.1f} min"]
    for p in growth["points"]:
        parts.append(f"G({p['t']:g}) {p['n_matvecs']} matvec + rmatvec pairs x {p['nsteps']} "
                     f"steps x {pair_step:.2f} ms = {p['n_matvecs'] * p['nsteps'] * pair_step / 6e4:.1f} min")
    log(f"projection {tag} cube3d: " + "; ".join(parts))

    # ---- C4. 'block' and 'schwarz' beside 'fdm' ---------------------------
    steps = {}
    for pp in ("fdm", "block", "schwarz"):
        c = dataclasses.replace(case, solver=dataclasses.replace(case.solver, pressure_precond=pp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nsp = c.make_ns()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        it = []
        with recording_pcg(it):
            u1 = nsp.step(nsp.make_state(base)).u
        steps[pp] = u1
        k = [k for n, k in it if n == "pressure"]
        log(f"cube3d: '{pp}' pressure preconditioner: set-up {t_setup:.2f} s, one step from the "
            f"base flow: pressure CG {k} iterations to {c.solver.pressure_tol:g}, velocity "
            f"{[k for n, k in it if n == 'velocity']}, |u1 - u1(fdm)| rel "
            f"{rel(u1, steps['fdm']):.3e} (bound 1e-6)")
        if not (bool(torch.isfinite(u1).all()) and rel(u1, steps["fdm"]) < 1e-6):
            fail(f"the '{pp}' step: rel {rel(u1, steps['fdm']):.3e} from the 'fdm' step")

    # ---- C5. the 3-D rung: 'pnpn2' beside 'laplacian' on the larger cube --
    s3 = cube["sem"]
    ns3 = NavierStokes(s3, viscosity=cube["nu"], dt=cube["dt"], u_bc=cube["u_bc"],
                       solver=SolverConfig(**CUBE_TOL))
    op3 = LinearizedOperator(ns3, cube["base"], nsteps=CUBE_NSTEPS)
    q = {"x": cube["q"]}

    def chained():
        q["x"] = op3.matvec(q["x"])

    ms = cuda_ms(chained, 1)
    if not bool(torch.isfinite(q["x"]).all()):
        fail("the 1,472-element 'pnpn2' matvec is not finite")
    log(f"timing {tag} cube matvec ({CUBE_NSTEPS} steps) f64 'pnpn2', example tolerances, "
        f"'fdm': {ms:.2f} ms/matvec ({ms / CUBE_NSTEPS:.2f} ms a step, {s3.nelem} elements, "
        f"n={s3.n}), f64 'laplacian' (phase 2) {cube['laplacian_ms']:.2f} ms/matvec")
    return {"march_step_ms": 1e3 * t_march / CUBE_MARCH, "matvec_ms": times["matvec"],
            "rmatvec_ms": times["rmatvec"], "adjoint_rel": adj, "residual": res,
            "rung_ms": ms}


def rb_rung(dtype, solver: dict, dev):
    """The rung: ``RayleighBenardCase(nx=64, ny=8, order=6,
    wavenumber=K_CRITICAL/8)``, eight critical wavelengths wide."""
    import torch
    from nekstab_next_tpu_torch.cases.rayleigh_benard import K_CRITICAL, RayleighBenardCase
    from nekstab_next_tpu_torch.config import SolverConfig

    return RayleighBenardCase(**dict(RB_SMALL, nx=64, ny=8), wavenumber=K_CRITICAL / 8,
                              solver=SolverConfig(**solver), dtype=dtype,
                              device=torch.device(dev) if isinstance(dev, str) else dev)


def rb_start(case, seed: int = 4):
    """A perturbed conduction state with its hydrostatic pressure
    Ra Pr (y - y^2/2) on the Gauss points (mean removed), as (u, p, T)
    tensors: from p = 0 the first steps carry a pressure transient of
    O(Ra Pr), beyond f32."""
    import torch

    s, m = case.sem, case.mesh
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=s.dtype, device=s.device)
    u0 = s.vmask * f(0.2 * rng.standard_normal(tuple(case.base_u.shape)))
    T0 = case.base_T + s.tmask[..., None] * f(0.05 * rng.standard_normal(
        tuple(case.base_T.shape)))
    ph = case.rayleigh * case.prandtl * (m.y - m.y ** 2 / 2)
    return u0, s.p_from_gll(f(ph - ph.mean())), T0


def coupled_rel(a, b) -> float:
    """Relative distance of two (u, T) pairs over both blocks."""
    import torch

    a = torch.cat([x.double().reshape(-1) for x in a])
    b = torch.cat([x.double().reshape(-1) for x in b])
    return float((a - b).norm() / b.norm())


def fst_step(device):
    """Three f64 steps of a channel with the FST inflow lift
    (``u_bc_fn``) on ``device``; the velocity on the CPU."""
    import torch
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.mesh import box_mesh_2d
    from nekstab_next_tpu_torch.ops.core import SEM
    from nekstab_next_tpu_torch.stepper.fst import (
        FSTInflow, isotropic_modes, von_karman_amplitudes)
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    mesh = box_mesh_2d(8, 4, order=6, x1=3.0, y1=1.0)
    sem = SEM(mesh, device=device)
    yprof = np.linspace(0.0, 1.0, 64)
    omega, beta, prof = isotropic_modes(4, 3, 1.0, 6.0, yprof, seed=3)
    amps = np.repeat(von_karman_amplitudes(1.0, 6.0, 4, 3, tu=0.05, length=1.0), 3)
    fst = FSTInflow.from_modes(mesh, omega, beta, yprof, prof, amps, device=device)
    ns = NavierStokes(sem, viscosity=0.05, dt=0.004, u_bc_fn=fst,
                      solver=SolverConfig(pressure_tol=1e-12, velocity_tol=1e-12))
    u = np.zeros(mesh.x.shape + (2,))
    u[..., 0] = 4.0 * mesh.y * (1.0 - mesh.y)
    return ns.advance(ns.make_state(torch.as_tensor(u, device=device)), 3).u.cpu()


def consistent_step(device):
    """Three f64 steps of a channel (Dirichlet inflow, outflow) with the
    ``'consistent'`` pressure scheme on ``device``; the velocity on the
    CPU."""
    import torch
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.mesh import box_mesh_2d
    from nekstab_next_tpu_torch.mesh.mesh import BoundaryCondition as BC
    from nekstab_next_tpu_torch.ops.core import SEM
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    mesh = box_mesh_2d(8, 4, order=6, x1=3.0, y1=1.0,
                       bc={"left": BC.DIRICHLET, "right": BC.OUTFLOW})
    sem = SEM(mesh, device=device)
    u_bc = np.zeros(mesh.x.shape + (2,))
    u_bc[..., 0] = 4.0 * mesh.y * (1.0 - mesh.y)
    u_bc = u_bc * (1.0 - mesh.vmask)
    ns = NavierStokes(sem, viscosity=0.1, dt=0.01, u_bc=torch.as_tensor(u_bc, device=device),
                      solver=SolverConfig(pressure_tol=1e-12, velocity_tol=1e-12,
                                          pressure_operator="consistent"))
    u0 = torch.as_tensor(mesh.vmask * 0.5 + u_bc, device=device)
    return ns.advance(ns.make_state(u0), 3).u.cpu()


def thermal_phase(tag: str, dev) -> dict:
    """The thermal (Boussinesq) path: the coupled (u, T) step, tangent and
    adjoint and ``linear_stability_analysis(base_T=...)`` on the
    Rayleigh-Benard case (f64 plain: the adjoint identity and sigma against
    the exact relation); on the 512-element rung in f32 through K1/K2 (the
    first path whose K1 masks differ by component and whose stepping K2
    removes the mean): K1/K2 against their plain versions on one coupled
    step's solves, launches and times of a coupled matvec and rmatvec,
    sigma; one fused-IR coupled step against f64; one FST ``u_bc_fn`` step
    and one ``'consistent'`` step against the same steps on the CPU.  Fails
    on any check."""
    import torch
    from nekstab_next_tpu_torch.algorithms.stability import linear_stability_analysis
    from nekstab_next_tpu_torch.cases.rayleigh_benard import RayleighBenardCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    out = {}
    # ---- T1. the JAX test's case, f64 plain: identity and sigma ----------
    t0 = time.perf_counter()
    case = RayleighBenardCase(**RB_SMALL, solver=SolverConfig(
        velocity_tol=1e-13, pressure_tol=1e-13, scalar_tol=1e-13, **RB_PRECOND), device=dev)
    s = case.sem
    op = LinearizedOperator(case.make_ns(), case.base_u, base_T=case.base_T,
                            nsteps=RB_IDENTITY_STEPS)
    rng = np.random.default_rng(7)
    mk = lambda: (s.vmask * torch.as_tensor(rng.standard_normal(tuple(case.base_u.shape)),
                                            device=dev),
                  s.tmask[..., None] * torch.as_tensor(
                      rng.standard_normal(tuple(case.base_T.shape)), device=dev))
    q, w = mk(), mk()
    Mq, Mw = op.matvec(q), op.rmatvec(w)
    ip = lambda a, b: float(s.inner(a[0], b[0], masked=False) + s.inner(a[1], b[1], masked=False))
    a1, a2 = ip(Mq, w), ip(q, Mw)
    adj = abs(a1 - a2) / max(abs(a1), abs(a2))
    log(f"thermal: RB Ra=2000 Pr=1 4x2 elements n={s.n} f64, {RB_IDENTITY_STEPS}-step coupled "
        f"adjoint identity <Mq,w> {a1:.15e} vs <q,M*w> {a2:.15e}: rel {adj:.3e} (bound 1e-11)")
    if not (adj <= 1e-11):
        fail(f"the coupled adjoint identity: rel {adj:.3e}")
    small = RayleighBenardCase(**RB_SMALL, solver=SolverConfig(**RB_PRECOND), device=dev)
    res = linear_stability_analysis(small.make_ns(), small.base_u, horizon=RB_STEPS * small.dt,
                                    nsteps=RB_STEPS, base_T=small.base_T, **RB_EIGS)
    sig, im = float(np.real(res.lam[0])), float(np.imag(res.lam[0]))
    r_sig = abs(sig / RB_SIGMA - 1.0)
    log(f"thermal: RB sigma {sig:.6f} (Im {im:.2e}) vs exact {small.exact_growth_rate():.6f}: "
        f"rel {r_sig:.3e} (bound 1.5e-2, |Im| < 1e-3), k_dim {RB_EIGS['k_dim']}, "
        f"{len(res.eigresult.history) - 1} restart(s), {res.n_matvecs} matvecs of "
        f"{RB_STEPS} steps, f64 plain with '{RB_PRECOND['pressure_precond']}' "
        f"({RB_PRECOND['pressure_patch_overlap']} overlap), identity and "
        f"sigma {time.perf_counter() - t0:.1f} s")
    if not (r_sig < 0.015 and abs(im) < 1e-3):
        fail(f"RB sigma {sig} (Im {im}) against {RB_SIGMA}")
    out["sigma"] = sig

    # ---- T2. the rung in f32 through K1/K2 --------------------------------
    t0 = time.perf_counter()
    rung = rb_rung(torch.float32, RB_F32, dev)
    rs = rung.sem
    ns = rung.make_ns()
    fv, fp = ns.fused_v, ns.fused_p
    nv = rung.mesh.npoints
    vm = fv.mask
    log(f"thermal rung: {rs.nelem} elements, n={rs.n}, {2 * nv} velocity dof + {nv} temperature "
        f"dof, dt={rung.dt:g}, f32 fused_solves at {RB_F32['pressure_tol']:g}/"
        f"{RB_F32['velocity_tol']:g}/{RB_F32['scalar_tol']:g}; K1 component masks min "
        f"{float(vm[..., 0].min()):g}/{float(vm[..., 1].min()):g}, K2 project_mean "
        f"{fp.project_mean}, set-up {time.perf_counter() - t0:.1f} s")
    if not (fv is not None and fp.project_mean and float(vm[..., 0].min()) == 1.0
            and float(vm[..., 1].min()) == 0.0):
        fail("the rung does not put differing component masks on K1 and project_mean on K2")
    u0, p0, T0 = rb_start(rung)
    calls = []
    with recording_solves(ns, calls):
        st = ns.step(ns.make_state(u0, p=p0, T=T0))
    torch.cuda.synchronize()
    errs = {"fused_helmholtz_cg": 0.0, "fused_pressure_cg": 0.0}
    rels = {"fused_helmholtz_cg": 0.0, "fused_pressure_cg": 0.0}
    for name, rhs, args, iters in calls:
        k = fv if name == "fused_helmholtz_cg" else fp
        got, ref = k.solve(rhs, *args), k.plain(rhs, *args)
        torch.cuda.synchronize()
        rels[name] = max(rels[name], rel(got, ref))
        errs[name] = max(errs[name], float((got - ref).abs().max()))
    its = {n: [i for m, _, _, i in calls if m == n] for n in errs}
    log(f"thermal rung: K1/K2 vs plain on one coupled step's solves: K1 rel "
        f"{rels['fused_helmholtz_cg']:.3e} (bound 1e-5), K2 rel {rels['fused_pressure_cg']:.3e} "
        f"(bound 1e-4), iterations {its}")
    if not (rels["fused_helmholtz_cg"] < 1e-5 and rels["fused_pressure_cg"] < 1e-4
            and all(its.values()) and bool(torch.isfinite(st.u).all())):
        fail(f"K1/K2 on the rung's coupled step: rel {rels}, iterations {its}")
    out["max_abs_err"] = errs

    op = LinearizedOperator(ns, rung.base_u, base_T=rung.base_T, nsteps=RB_STEPS)
    rng = np.random.default_rng(8)
    f32 = lambda shape: torch.as_tensor(rng.standard_normal(tuple(shape)), dtype=torch.float32,
                                        device=dev)
    x = (rs.vmask * f32(rung.base_u.shape), rs.tmask[..., None] * f32(rung.base_T.shape))
    # the counted calls are the timed ones (the rmatvec's first call builds
    # its three per-stage vjps)
    fv.launches = fp.launches = 0
    y, ms_mv = cuda_call(lambda: op.matvec(x))
    mv_launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    op.rmatvec(y)
    fv.launches = fp.launches = 0
    z, ms_rmv = cuda_call(lambda: op.rmatvec(y))
    rmv_launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    log(f"thermal rung: launches per {RB_STEPS}-step coupled matvec {mv_launches}, per rmatvec "
        f"{rmv_launches}")
    if not (mv_launches == {k: RB_STEPS for k in mv_launches}
            and rmv_launches == {k: RB_STEPS for k in rmv_launches}
            and all(bool(torch.isfinite(t).all()) for t in y + z)):
        fail(f"the rung's coupled matvec/rmatvec: launches {mv_launches} / {rmv_launches}")
    ms = {"matvec": ms_mv, "rmatvec": ms_rmv}
    rate = 3 * nv * RB_STEPS / (ms["matvec"] / 1e3)
    log(f"timing {tag} thermal rung coupled matvec ({RB_STEPS} steps, f32 K1/K2): "
        f"{ms['matvec']:.2f} ms/matvec ({ms['matvec'] / RB_STEPS:.3f} ms a step, {rate:.4e} "
        f"dof-steps/s over {3 * nv} velocity + scalar dof); rmatvec {ms['rmatvec']:.2f} ms "
        f"(ratio {ms['rmatvec'] / ms['matvec']:.2f})")
    out.update(matvec_launches=mv_launches, rmatvec_launches=rmv_launches, ms=ms,
               dof_steps_per_s=rate)
    t0 = time.perf_counter()
    res = linear_stability_analysis(ns, rung.base_u, horizon=RB_STEPS * rung.dt,
                                    nsteps=RB_STEPS, base_T=rung.base_T, **RB_RUNG_EIGS)
    torch.cuda.synchronize()
    sig = float(np.real(res.lam[0]))
    r_sig = abs(sig / RB_RUNG_SIGMA - 1.0)
    log(f"thermal rung: sigma {sig:.6f} (Im {float(np.imag(res.lam[0])):.2e}) vs "
        f"{RB_RUNG_SIGMA} (k = 10 K_CRITICAL/8; k = 11 gives 11.9756): rel {r_sig:.3e} (bound "
        f"1.5e-2), k_dim {RB_RUNG_EIGS['k_dim']}, {len(res.eigresult.history) - 1} restart(s), "
        f"{res.n_matvecs} matvecs, residual {res.residuals[0]:.2e}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not (r_sig < 0.015):
        fail(f"the rung's sigma {sig} against {RB_RUNG_SIGMA}")
    out["rung_sigma"] = sig

    # ---- T3. one fused-IR coupled step on the rung against f64 -----------
    ir = rb_rung(torch.float64, dict(fused_solves=True), dev)
    nsi = ir.make_ns(mixed_precision=True)
    u0, p0, T0 = rb_start(ir)
    nsi.fused_v.launches = nsi.fused_p.launches = 0
    st_ir = nsi.step(nsi.make_state(u0, p=p0, T=T0))
    torch.cuda.synchronize()
    ir_launches = {"fused_helmholtz_cg": nsi.fused_v.launches,
                   "fused_pressure_cg": nsi.fused_p.launches}
    ns64 = rb_rung(torch.float64, RB_TIGHT, dev).make_ns()
    st64 = ns64.step(ns64.make_state(u0, p=p0, T=T0))
    r_ir = coupled_rel((st_ir.u, st_ir.T), (st64.u, st64.T))
    log(f"thermal rung: one fused-IR coupled step vs the f64 step at 1e-12: rel {r_ir:.3e} "
        f"(bound 1e-7), launches {ir_launches} ({nsi._ir_cycles} refinement cycles)")
    if not (nsi._mixed_ir and r_ir <= 1e-7 and min(ir_launches.values()) > 0):
        fail(f"the fused-IR coupled step: rel {r_ir:.3e}, launches {ir_launches}")
    out["ir_step_launches"] = ir_launches

    # ---- T4. an FST step and a 'consistent' step, card against CPU --------
    for name, fn in (("FST u_bc_fn", fst_step), ("'consistent'", consistent_step)):
        gpu, cpu = fn(dev), fn("cpu")
        r = float((gpu - cpu).abs().max() / cpu.abs().max())
        log(f"thermal: 3 f64 steps with {name} on the card vs the CPU: rel {r:.3e} (bound 1e-12, "
            f"the CPU tests' gate), finite {bool(torch.isfinite(gpu).all())}")
        if not (bool(torch.isfinite(gpu).all()) and r <= 1e-12):
            fail(f"the {name} step on the card: rel {r:.3e} from the CPU")
    return out


def main() -> None:
    t_start = time.perf_counter()
    # ---- 1. device -----------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import nekstab_next_tpu_torch  # noqa: F401  (the port, beside this script)
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.ops import _cuda
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi name, power.limit: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, all sources at once, "
        f"{lib.build_seconds:.1f} s) -> {', '.join(p.name for p in lib.paths)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t_phase = phase_wall("0 device and build", t_start)

    # ---- 3. K1, K2 against their plain versions: flagship, larger mesh -
    case = make_case(torch.float32, CAPS_F32, fused=True)
    sem = case.sem
    ns = case.make_ns()
    fv, fp = ns.fused_v, ns.fused_p
    log(f"flagship: {sem.nelem} elements, n={sem.n}, {case.mesh.npoints * 2} velocity dof, "
        f"{sem.pc_nc} coarse vertices, dt={case.dt:.6g}")
    rng = np.random.default_rng(0)
    dev = sem.device
    h1, h2 = 1.0 / 60.0, (11.0 / 6.0) / case.dt
    rhs_v, rhs_p, k1, err = check_cg_kernels("flagship", sem, h1, h2, rng)
    t0 = time.perf_counter()
    large = CylinderCase(**LARGE, dtype=torch.float32, device=dev)
    log(f"larger mesh: {large.sem.nelem} elements, n={large.sem.n}, "
        f"{large.sem.pc_nc} coarse vertices, set-up {time.perf_counter() - t0:.1f} s")
    err_large = check_cg_kernels("larger mesh", large.sem, h1, h2,
                                 np.random.default_rng(1), grid_stride=True)[3]
    err = {k: max(v, err_large[k]) for k, v in err.items()}
    del large

    # ---- 4. flagship tangent matvec through the kernels ----------------
    base = case.uniform_flow()
    q = sem.vmask * base  # bench.py's input
    op = LinearizedOperator(ns, base, nsteps=NSTEPS)
    fv.launches = fp.launches = 0
    t0 = time.perf_counter()
    out_k = op.matvec(q)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    log(f"matvec f32 kernels: first call {t_first:.2f} s, launches {launches}")
    if tuple(out_k.shape) != tuple(q.shape) or out_k.dtype != torch.float32:
        fail(f"flagship matvec output has shape {tuple(out_k.shape)}, {out_k.dtype}")
    if not bool(torch.isfinite(out_k).all()):
        fail("flagship matvec output is not finite")
    if launches != {"fused_helmholtz_cg": NSTEPS, "fused_pressure_cg": NSTEPS}:
        fail(f"expected {NSTEPS} launches of each kernel per matvec, got {launches}")
    # (each plain path's one timed matvec is its check's own)
    with plain_solves(ns):
        out_p, ms_plain = cuda_call(lambda: op.matvec(q))
    r_plain = rel(out_k, out_p)
    log(f"matvec f32 kernels vs f32 plain versions: rel {r_plain:.3e} (bound 1e-3)")
    if not (r_plain < 1e-3):
        fail(f"kernel matvec disagrees with the plain-version matvec: {r_plain:.3e}")
    case64 = make_case(torch.float64, CAPS_TIGHT, fused=False)
    ns64 = case64.make_ns()
    op64 = LinearizedOperator(ns64, case64.uniform_flow(), nsteps=NSTEPS)
    q64 = case64.sem.vmask * case64.uniform_flow()
    out_64, ms_64 = cuda_call(lambda: op64.matvec(q64))
    drift = rel(out_k, out_64)
    log(f"f32 drift: matvec f32 kernels vs f64 plain at tight tolerances (1e-10): rel {drift:.3e} (bound 1e-3)")
    if not (drift < 1e-3):
        fail(f"f32 drift {drift:.3e} against the f64 reference")

    # ---- 5. nonlinear steps --------------------------------------------
    st = ns.advance(ns.make_state(case.uniform_flow()), 20)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(st.u).all()) and bool(torch.isfinite(st.p).all())):
        fail("20 nonlinear steps gave non-finite fields")
    log(f"nonlinear: 20 steps of ns.advance from uniform_flow(): finite, |u|max {float(st.u.abs().max()):.4f}")

    # ---- 6. timing (CUDA events; warm-up + REPS chained matvecs) --------
    ndof = case.mesh.npoints * 2
    tag = f"[{card}]"
    rates = {}

    def chained(o, x0):
        state = {"x": x0}

        def fn():
            state["x"] = o.matvec(state["x"])
        return fn

    rates["f32 kernels"] = cuda_ms(chained(op, q), REPS)
    rates["f32 plain versions"] = ms_plain
    case64c = make_case(torch.float64, CAPS_F32, fused=False)
    op64c = LinearizedOperator(case64c.make_ns(), case64c.uniform_flow(), nsteps=NSTEPS)
    rates["f64 plain, f32 caps 16/10"] = cuda_call(
        lambda: op64c.matvec(case64c.sem.vmask * case64c.uniform_flow()))[1]
    rates["f64 plain, tight 1e-10"] = ms_64
    for name, ms in rates.items():
        log(f"timing {tag} matvec {name}: {ms:.2f} ms/matvec, "
            f"{ndof * NSTEPS / (ms / 1e3):.4e} dof-steps/s")

    solve_ms = {
        "fused_helmholtz_cg": (kernel_ms(lambda: k1.solve(rhs_v, h1, h2), 20),
                               cuda_ms(lambda: k1.plain(rhs_v, h1, h2), 20)),
        "fused_pressure_cg": (kernel_ms(lambda: fp.solve(rhs_p), 20),
                              cuda_ms(lambda: fp.plain(rhs_p), 20)),
    }
    for name, (ms_k, ms_p) in solve_ms.items():
        log(f"timing {tag} one {name} solve (flagship caps): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    k1.solve(rhs_v, h1, h2)
    fp.solve(rhs_p)
    phases = {"fused_helmholtz_cg": k1.last_barriers(), "fused_pressure_cg": fp.last_barriers()}
    log(f"grid barriers of the timed solves: {phases}")
    sweep = cg_sweep(sem, rhs_v, rhs_p, h1, h2, tag)

    # bounds of the two timed solves: inputs read once, the output written
    # once, the iterations these inputs need (counted by the plain versions)
    it1 = k1.plain(rhs_v, h1, h2, return_iters=True)[1]
    it2 = fp.plain(rhs_p, return_iters=True)[1]
    bounds = {
        "fused_helmholtz_cg": roofline(
            nbytes(rhs_v, rhs_v, *k1._dev.values()),
            k1_flops(sem.nelem, sem.n, 2, it1)),
        "fused_pressure_cg": roofline(
            nbytes(rhs_p, rhs_p, *fp._dev.values()),
            k2_flops(sem.nelem, sem.n, sem.pc_nc, it2)),
    }
    log(f"bounds: K1 {it1} iterations -> {bounds['fused_helmholtz_cg']}, "
        f"K2 {it2} iterations -> {bounds['fused_pressure_cg']}")

    t_phase = phase_wall("1 flagship (K1, K2)", t_phase)

    # ==== the 3-D mixed-precision path (K4) ==============================
    from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.ops.fused_helmholtz import FusedHelmholtz
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    # ---- 7, 8. K4 against its plain version at both paths' shapes -------
    # (label, SEM, components or None for no component axis, (h1, h2)): the
    # cube's solves apply K4 to the velocity (C = 3) and to the pressure
    # (one component, h1 = 1, h2 = 0)
    t0 = time.perf_counter()
    cube = CubeRoughnessCase(**CUBE, solver=SolverConfig(**CUBE_TOL),
                             device=torch.device("cuda", 0))
    s3 = cube.sem
    log(f"cube: {s3.nelem} elements, n={s3.n}, {cube.mesh.npoints * 3} velocity dof, "
        f"{s3.pc_nc} coarse vertices, dt={cube.dt:.6g}, set-up {time.perf_counter() - t0:.1f} s")
    k4_err, k4_in = [], {}
    for label, ksem, C, hh in k4_shapes(sem, cube, h1, h2):
        k4 = FusedHelmholtz(ksem)
        u = torch.as_tensor(rng.standard_normal(k4.node_shape + ((C,) if C else ())),
                            dtype=torch.float32, device=dev)
        got, ref = k4.apply(u, *hh), k4.plain(u, *hh)
        torch.cuda.synchronize()
        r4 = rel(got, ref)
        k4_err.append(float((got - ref).abs().max()))
        k4_in[label] = (k4, u, hh, C)
        geo = k4.geometry(C or 1)
        log(f"K4 fused_helmholtz vs plain at the {label} shape {tuple(u.shape)}, "
            f"h1={hh[0]:.6g}, h2={hh[1]:.6g}: rel {r4:.3e} (bound 1e-5), launches {k4.launches}, "
            f"digest {digest(got)}, grid {geo['grid']} blocks of {geo['per_block']} elements "
            f"({geo['per_sm']} an SM)")
        if k4.launches != 1:
            fail(f"K4 at the {label} shape launched {k4.launches} times, expected 1")
        if not (r4 < 1e-5):
            fail(f"K4 disagrees with its plain version at the {label} shape: rel {r4:.3e}")
    k4_err.append(check_k4_sweep(dev))
    err["fused_helmholtz"] = max(k4_err)

    # ---- 9. the cube's 10-step mixed tangent matvec through K4 -----------
    nu3 = cube.h / cube.reynolds
    nsm = NavierStokes(s3, viscosity=nu3, dt=cube.dt, u_bc=cube.u_bc,
                       solver=cube.solver, mixed_precision=True)
    base3 = cube.initial_flow()
    op3 = LinearizedOperator(nsm, base3, nsteps=CUBE_NSTEPS)
    q3 = s3.vmask * torch.as_tensor(rng.standard_normal(tuple(base3.shape)),
                                    dtype=torch.float64, device=dev)
    k4m = nsm.mixed.fused
    calls = {"cube velocity": 0, "cube pressure": 0}
    helm32 = nsm.mixed.helmholtz32

    def counting_helmholtz32(u, a, b):
        calls["cube velocity" if u.dim() == 5 else "cube pressure"] += 1
        return helm32(u, a, b)

    nsm.mixed.helmholtz32 = counting_helmholtz32
    fv.launches = fp.launches = k4m.launches = 0
    t0 = time.perf_counter()
    out3 = op3.matvec(q3)
    torch.cuda.synchronize()
    t_first3 = time.perf_counter() - t0
    launches3 = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches,
                 "fused_helmholtz": k4m.launches}
    log(f"cube matvec mixed (K4): first call {t_first3:.2f} s, launches {launches3}, "
        f"helmholtz32 calls by shape {calls}")
    nsm.mixed.helmholtz32 = helm32
    if tuple(out3.shape) != tuple(q3.shape) or out3.dtype != torch.float64:
        fail(f"cube matvec output has shape {tuple(out3.shape)}, {out3.dtype}")
    if not bool(torch.isfinite(out3).all()):
        fail("cube matvec output is not finite")
    if not (min(calls.values()) > 0 and k4m.launches == sum(calls.values())):
        fail(f"K4 launched {k4m.launches} times for helmholtz32 calls {calls}")
    if launches3["fused_helmholtz_cg"] or launches3["fused_pressure_cg"]:
        fail(f"the cube path launched K1/K2: {launches3}")
    with plain_k4(nsm):  # (the plain path's one timed matvec)
        out3_p, ms3_plain = cuda_call(lambda: op3.matvec(q3))
    r3 = rel(out3, out3_p)
    log(f"cube matvec K4 vs K4's plain version: rel {r3:.3e} (bound 1e-7)")
    if not (r3 < 1e-7):
        fail(f"cube matvec through K4 disagrees with the plain version: {r3:.3e}")
    ns64_3 = NavierStokes(s3, viscosity=nu3, dt=cube.dt, u_bc=cube.u_bc,
                          solver=SolverConfig(**CUBE_TIGHT, pressure_operator="laplacian"))
    op64_3 = LinearizedOperator(ns64_3, base3, nsteps=CUBE_NSTEPS)
    out3_64 = op64_3.matvec(q3)
    drift3 = rel(out3, out3_64)
    log(f"cube drift: mixed matvec (K4) vs f64 'laplacian' at 1e-12: rel {drift3:.3e} (bound 1e-7)")
    if not (drift3 < 1e-7):
        fail(f"cube mixed drift {drift3:.3e} against the f64 'laplacian' matvec")

    # ---- 10. nonlinear mixed steps ---------------------------------------
    st3 = nsm.advance(nsm.make_state(base3), 5)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(st3.u).all()) and bool(torch.isfinite(st3.p).all())):
        fail("5 nonlinear mixed cube steps gave non-finite fields")
    log(f"cube nonlinear: 5 mixed steps of ns.advance from initial_flow(): finite, "
        f"|u|max {float(st3.u.abs().max()):.4f}")

    # ---- 11. timing of the cube path and of K4 ---------------------------
    ndof3 = cube.mesh.npoints * 3
    # (the check's matvec was the K4 path's warm-up)
    rates3 = {"mixed, K4 kernel": cuda_ms(chained(op3, out3), CUBE_REPS, warm_up=False),
              "mixed, K4 plain version": ms3_plain}
    ns64e = NavierStokes(s3, viscosity=nu3, dt=cube.dt, u_bc=cube.u_bc,
                         solver=SolverConfig(**CUBE_TOL, pressure_operator="laplacian"))
    rates3["f64 'laplacian', example tolerances"] = cuda_ms(
        chained(LinearizedOperator(ns64e, base3, nsteps=CUBE_NSTEPS), q3), CUBE_REPS)
    for name, ms in rates3.items():
        log(f"timing {tag} cube matvec ({CUBE_NSTEPS} steps) {name}: {ms:.2f} ms/matvec, "
            f"{ndof3 * CUBE_NSTEPS / (ms / 1e3):.4e} dof-steps/s")
    k4_ms = {}
    for label, (k4, u, hh, C) in k4_in.items():
        ms_warm = kernel_ms(lambda: k4.apply(u, *hh), 200)
        ms_cold = kernel_ms(lambda: k4.apply(u, *hh), 50, cold=True)
        ms_plain = cuda_ms(lambda: k4.plain(u, *hh), 50)
        b4 = k4_bound(k4, u, hh[1], C)
        k4_ms[label] = (ms_cold, ms_plain, b4, ms_warm)
        log(f"timing {tag} one K4 apply at the {label} shape: kernel {ms_cold:.4f} ms "
            f"(L2 flushed; {ms_warm:.4f} ms back to back), plain {ms_plain:.4f} ms, "
            f"bound {b4['bound_ms']:.4f} ms ({b4['bound_by']}), share "
            f"{100 * b4['bound_ms'] / ms_cold:.1f} % flushed, "
            f"{100 * b4['bound_ms'] / ms_warm:.1f} % back to back")

    t_phase = phase_wall("2 cube mixed (K4)", t_phase)

    # ==== the Krylov layer and the cylinder pipeline (K1, K2 again) ======
    pipe = pipeline_phase(tag, dev)
    t_phase = phase_wall("3 pipeline", t_phase)

    # ==== the fused-IR mixed-precision path (K1, K2 under f64 state) ======
    ir = fused_ir_phase(tag, dev, pipe)
    t_phase = phase_wall("4 fused-IR", t_phase)

    # ==== the backward-facing step: 'schwarz', K1/K2 on a graded mesh ====
    bfs = bfs_phase(tag, dev)
    t_phase = phase_wall("5 bfs", t_phase)

    # ==== periodic bases and forced response (K1, K2 along an orbit) =====
    per = periodic_phase(tag, dev)
    t_phase = phase_wall("6 periodic", t_phase)

    # ==== the 3-D PnPn-2 step: the cube example's case (no kernel) =======
    fv.launches = fp.launches = k4m.launches = 0
    cube3d_phase(tag, dev, {
        "sem": s3, "nu": nu3, "dt": cube.dt, "u_bc": cube.u_bc, "base": base3, "q": q3,
        "laplacian_ms": rates3["f64 'laplacian', example tolerances"]})
    torch.cuda.synchronize()
    stray = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches,
             "fused_helmholtz": k4m.launches}
    if any(stray.values()):
        fail(f"the 3-D 'pnpn2' path launched a kernel: {stray}")
    t_phase = phase_wall("7 cube3d", t_phase)

    # ==== the thermal path: RB on K1/K2, FST and 'consistent' steps =======
    fv.launches = fp.launches = k4m.launches = 0
    th = thermal_phase(tag, dev)
    torch.cuda.synchronize()
    stray = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches,
             "fused_helmholtz": k4m.launches}
    if any(stray.values()):
        fail(f"the thermal phase launched the flagship's kernels: {stray}")
    t_phase = phase_wall("8 thermal", t_phase)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": TPU_KERNEL[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": solve_ms[name][0], "plain_ms": solve_ms[name][1],
         **bounds[name], "library_ms": None,
         "per_iter_ms": sweep[name]["per_iter_ms"], "phases": phases[name],
         "rmatvec_launches": pipe["rmatvec_launches"][name],
         "fused_ir": {"launches_per_step": ir["per_step"][name],
                      "matvec_launches": ir["matvec"][name],
                      "rmatvec_launches": ir["rmatvec"][name],
                      "path_launches": ir["path"][name],
                      "iterations": ir["iterations"][name], **ir["solve"][name]},
         "bfs": {"launches": bfs["launches"][name], "max_abs_err": bfs["max_abs_err"][name],
                 "iterations": bfs["iterations"][name], "bdf3_solve": bfs["solve"][name],
                 "step_ms": bfs["step_ms"]},
         "periodic": {"launches": per["launches"][name],
                      "max_abs_err": per["max_abs_err"][name],
                      "orbit_two_matvecs": per["orbit_matvec"][name],
                      "floquet_rmatvec_backward": per["rmatvec_launches"][name],
                      "particular_solution": per["particular"][name], "ms": per["ms"]},
         "thermal": {"matvec_launches": th["matvec_launches"][name],
                     "rmatvec_launches": th["rmatvec_launches"][name],
                     "ir_step_launches": th["ir_step_launches"][name],
                     "max_abs_err": th["max_abs_err"][name], "ms": th["ms"],
                     "dof_steps_per_s": th["dof_steps_per_s"]}}
        for name in ("fused_helmholtz_cg", "fused_pressure_cg")
    ] + [
        # K4 once per cube shape: its launches on the cube matvec at that shape
        {"name": name, "shape": label, "route": "cuda", "source": SOURCE["fused_helmholtz"],
         "replaces": TPU_KERNEL["fused_helmholtz"], "launches": calls[label],
         "max_abs_err": err["fused_helmholtz"], "ms": k4_ms[label][0],
         "plain_ms": k4_ms[label][1], **k4_ms[label][2], "library_ms": None,
         "back_to_back_ms": k4_ms[label][3]}
        for name, label in (("fused_helmholtz", "cube velocity"),
                            ("fused_helmholtz/pressure", "cube pressure"))
    ]
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
