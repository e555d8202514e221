"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  This file imports no jax, so it also runs on a machine
without it:  ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``tests/conftest.py`` imports jax).
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.mesh import box_mesh_3d
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.ops.elliptic import make_projector
from nekstab_next_tpu_torch.ops.fused_cg import FusedHelmholtzCG, FusedPressureCG
from nekstab_next_tpu_torch.ops.fused_helmholtz import FusedHelmholtz
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

pytestmark = pytest.mark.cuda
MESH = dict(nr=4, ntheta=8, order=6)
TIGHT_F32 = dict(pressure_tol=1e-6, velocity_tol=1e-7, pressure_maxiter=80,
                 velocity_maxiter=40, pressure_precond="block")


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return CylinderCase(**MESH, dtype=torch.float32, device="cuda",
                        solver=SolverConfig(**TIGHT_F32, fused_solves=True))


def rel(got, ref) -> float:
    return float((got - ref).double().norm() / ref.double().norm())


def test_helmholtz_kernel_matches_plain(case):
    sem = case.sem
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(sem.bm.shape) + (2,)), dtype=torch.float32, device="cuda")
    rhsP = make_projector(sem, sem.vmask)(rhs)
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    got, ref = k1.solve(rhsP, 0.0167, 100.0), k1.plain(rhsP, 0.0167, 100.0)
    torch.cuda.synchronize()
    assert k1.launches == 1
    # two f32 CG paths, different summation order (bound of test_fused_cg.py:90)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("maxiter,project_mean,bound", [
    (300, False, 1e-4),  # converged
    (16, False, 1e-3),   # capped: iterates are roundoff-sensitive
    (300, True, 1e-4),   # enclosed-flow mean projection
])
def test_pressure_kernel_matches_plain(case, maxiter, project_mean, bound):
    sem = case.sem
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(sem.p_shape),
                          dtype=torch.float32, device="cuda")
    k2 = FusedPressureCG(sem, maxiter=maxiter, tol=1e-6, project_mean=project_mean)
    got, ref = k2.solve(rhs), k2.plain(rhs)
    torch.cuda.synchronize()
    assert k2.launches == 1
    assert rel(got, ref) < bound


def test_kernel_runs_are_bit_reproducible(case):
    # no float atomics: the same solve twice gives the same bits
    sem = case.sem
    rhs = torch.as_tensor(np.random.default_rng(1).standard_normal(sem.p_shape),
                          dtype=torch.float32, device="cuda")
    k2 = FusedPressureCG(sem, maxiter=16, tol=1e-6)
    assert torch.equal(k2.solve(rhs), k2.solve(rhs))


def test_matvec_kernels_match_plain(case):
    ns = case.make_ns()
    op = LinearizedOperator(ns, case.uniform_flow(), nsteps=3)
    q = case.sem.vmask * torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(case.sem.bm.shape) + (2,)),
        dtype=torch.float32, device="cuda")
    got = op.matvec(q)
    assert ns.fused_v.launches == 3 and ns.fused_p.launches == 3
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    ref = op.matvec(q)
    # near-converged inner solves (80/40 caps): the bound of
    # test_fused_cg.py:177 between two f32 paths
    assert rel(got, ref) < 1e-4


def test_rmatvec_launches_the_kernels_in_its_backward(case):
    # the adjoint's backward pass re-solves every step's two systems on the
    # cotangent through K1 and K2: one launch of each per step; the first
    # call also builds each BDF stage's vjp (one forward step each)
    ns = case.make_ns()
    op = LinearizedOperator(ns, case.uniform_flow(), nsteps=4)
    w = case.sem.vmask * case.uniform_flow()
    op.rmatvec(w)
    assert ns.fused_v.launches == 3 + 4 and ns.fused_p.launches == 3 + 4
    ns.fused_v.launches = ns.fused_p.launches = 0
    got = op.rmatvec(w)
    torch.cuda.synchronize()
    assert ns.fused_v.launches == 4 and ns.fused_p.launches == 4
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())


def test_rmatvec_kernels_match_plain(case):
    ns = case.make_ns()
    op = LinearizedOperator(ns, case.uniform_flow(), nsteps=3)
    w = case.sem.vmask * case.uniform_flow()
    got = op.rmatvec(w)
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    ref = op.rmatvec(w)
    # near-converged inner solves (80/40 caps), as the matvec's test
    assert rel(got, ref) < 1e-4


def test_orbit_tangent_kernels_match_plain(case):
    # the stored-orbit tangent (FloquetOperator) along 3 steps from the
    # uniform flow: the orbit is integrated once (3 launches of each
    # kernel), every matvec replays it (3 more each); its transpose
    # launches each once per step in the backward, after one forward step
    # per BDF stage for the vjps; kernels against the plain versions
    # (the smoke's f32 bound: the orbit starts impulsively from the uniform
    # flow)
    from nekstab_next_tpu_torch.stepper.linearized import FloquetOperator

    ns = case.make_ns()
    q = case.sem.vmask * case.uniform_flow()
    op = FloquetOperator(ns, case.uniform_flow(), nsteps=3)
    got = op.matvec(q)
    assert ns.fused_v.launches == 6 and ns.fused_p.launches == 6
    op.matvec(q)
    assert ns.fused_v.launches == 9 and ns.fused_p.launches == 9
    got_t = op.rmatvec(q)
    assert ns.fused_v.launches == 9 + 3 + 3 and ns.fused_p.launches == 9 + 3 + 3
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    ref = FloquetOperator(ns, case.uniform_flow(), nsteps=3)
    r, r_t = rel(got, ref.matvec(q)), rel(got_t, ref.rmatvec(q))
    print(f"orbit tangent vs plain: matvec {r:.4e}, rmatvec {r_t:.4e}")
    assert r < 1e-3
    assert r_t < 1e-3


def test_forced_integration_kernels_match_plain(case):
    # the resolvent's forced tangent integration (a period of 8 steps of
    # the case's dt, the forcing phase advanced each step) and its
    # transpose: one launch of each kernel a step; kernels against the
    # plain versions (the smoke's f32 bound)
    from nekstab_next_tpu_torch.algorithms.resolvent import ResolventOperator

    ns = case.make_ns()
    f = case.sem.vmask * case.uniform_flow()
    op = ResolventOperator(ns, case.uniform_flow(), 2 * np.pi / (8 * case.dt),
                           steps_per_period=8)
    got = op._apply((f, 0.5 * f))
    assert ns.fused_v.launches == 8 and ns.fused_p.launches == 8
    ct = [torch.zeros_like(f), torch.zeros_like(f)]
    got_t = op._integrate_t(f, 8, ct)
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    r = rel(got, op._apply((f, 0.5 * f)))
    ref_ct = [torch.zeros_like(f), torch.zeros_like(f)]
    r_t = rel(got_t, op._integrate_t(f, 8, ref_ct))
    r_ct = max(rel(a, b) for a, b in zip(ct, ref_ct))
    print(f"forced integration vs plain: {r:.4e}, transpose {r_t:.4e}, "
          f"forcing cotangents {r_ct:.4e}")
    assert r < 1e-3
    assert r_t < 1e-3
    assert r_ct < 1e-3


# examples/cylinder_stability.py's --precision mixed solver (fused-IR path)
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)


def test_cg_kernels_take_f64_on_the_fused_ir_route(case):
    # an f64 SEM: the kernels solve an f64 right-hand side at f32 (constants
    # cast from the f64 factors) and return f64; the plain versions compute
    # at f32 on the same constants
    sem = CylinderCase(**MESH, device="cuda").sem
    assert sem.dtype == torch.float64
    rng = np.random.default_rng(2)
    rhs_v = make_projector(sem, sem.vmask)(torch.as_tensor(
        rng.standard_normal(tuple(sem.bm.shape) + (2,)), device="cuda"))
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), device="cuda")
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=100, tol=3e-6, ir=True)
    k2 = FusedPressureCG(sem, maxiter=150, tol=3e-6, ir=True)
    for k, args, bound in ((k1, (rhs_v, 0.0167, 100.0), 1e-5), (k2, (rhs_p,), 1e-4)):
        got, ref = k.solve(*args), k.plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype == torch.float64 and k.launches == 1
        assert rel(got, ref) < bound
    with pytest.raises(ValueError, match="float32"):
        FusedPressureCG(sem, maxiter=150, tol=3e-6)


def test_fused_ir_matvec_and_rmatvec_kernels_match_plain(case):
    # the fused-IR tangent and adjoint: mixed_ir_cycles launches of each
    # kernel per step; refined to f64 class, kernels and plain versions agree
    # far below the f32 inner tolerance
    cyl = CylinderCase(**MESH, device="cuda", mixed_precision=True,
                       solver=SolverConfig(**MIXED))
    ns = cyl.make_ns()
    assert ns._mixed_ir
    cycles = ns.solver.mixed_ir_cycles
    op = LinearizedOperator(ns, cyl.uniform_flow(), nsteps=3)
    q = cyl.sem.vmask * torch.as_tensor(
        np.random.default_rng(1).standard_normal(tuple(cyl.sem.bm.shape) + (2,)),
        device="cuda")
    got_m = op.matvec(q)
    assert ns.fused_v.launches == 3 * cycles and ns.fused_p.launches == 3 * cycles
    op.rmatvec(q)
    ns.fused_v.launches = ns.fused_p.launches = 0
    got_r = op.rmatvec(q)
    torch.cuda.synchronize()
    assert ns.fused_v.launches == 3 * cycles and ns.fused_p.launches == 3 * cycles
    assert got_m.dtype == got_r.dtype == torch.float64
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    assert rel(got_m, op.matvec(q)) < 1e-8
    assert rel(got_r, op.rmatvec(q)) < 1e-8


@pytest.mark.parametrize("order", [4, 7])
def test_kernels_at_other_orders(case, order):
    # the kernels are templated on n = order + 1; the flagship runs n = 7.
    # Also the single-component (C = 1) velocity path.
    other = CylinderCase(nr=3, ntheta=8, order=order, dtype=torch.float32, device="cuda",
                         solver=SolverConfig(**TIGHT_F32, fused_solves=True))
    sem = other.sem
    rng = np.random.default_rng(order)
    rhs = torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape)),
                          dtype=torch.float32, device="cuda")
    mask = sem.vmask[..., 0]
    rhsP = make_projector(sem, mask)(rhs)
    k1 = FusedHelmholtzCG(sem, mask, maxiter=10, tol=1e-6)
    assert rel(k1.solve(rhsP, 0.0167, 100.0), k1.plain(rhsP, 0.0167, 100.0)) < 1e-5
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32,
                            device="cuda")
    k2 = FusedPressureCG(sem, maxiter=300, tol=1e-6)
    assert rel(k2.solve(rhs_p), k2.plain(rhs_p)) < 1e-4
    assert k1.launches == 1 and k2.launches == 1


@pytest.mark.parametrize("maxiter", [1, 4, 16])
def test_cg_kernels_at_tol_zero(case, maxiter):
    # chip_smoke.py's timing sweep: at tol 0 every solve runs exactly maxiter
    # iterations; each crosses 2 + 4 maxiter grid barriers
    sem = case.sem
    rng = np.random.default_rng(maxiter)
    rhs = make_projector(sem, sem.vmask)(torch.as_tensor(
        rng.standard_normal(tuple(sem.bm.shape) + (2,)), dtype=torch.float32, device="cuda"))
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=maxiter, tol=0.0)
    got, (ref, it) = k1.solve(rhs, 0.0167, 100.0), k1.plain(rhs, 0.0167, 100.0, return_iters=True)
    assert it == maxiter and k1.last_barriers() == 2 + 4 * maxiter
    assert rel(got, ref) < 1e-5
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32, device="cuda")
    k2 = FusedPressureCG(sem, maxiter=maxiter, tol=0.0)
    got, (ref, it) = k2.solve(rhs_p), k2.plain(rhs_p, return_iters=True)
    assert it == maxiter and k2.last_barriers() == 2 + 4 * maxiter
    assert rel(got, ref) < 1e-3  # capped iterates: roundoff-sensitive


def test_cg_kernels_on_a_mesh_larger_than_the_grid(case):
    # 4,608 elements: more element groups (1,152) than blocks fit on an
    # H100 at once, so blocks own several groups and re-read their operands
    large = CylinderCase(nr=32, ntheta=144, order=6, dtype=torch.float32, device="cuda")
    sem = large.sem
    rng = np.random.default_rng(7)
    rhs = make_projector(sem, sem.vmask)(torch.as_tensor(
        rng.standard_normal(tuple(sem.bm.shape) + (2,)), dtype=torch.float32, device="cuda"))
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    assert rel(k1.solve(rhs, 0.0167, 100.0), k1.plain(rhs, 0.0167, 100.0)) < 1e-5
    assert k1.grid < sem.nelem // 4
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32, device="cuda")
    for maxiter, bound in ((300, 1e-4), (16, 1e-3)):
        k2 = FusedPressureCG(sem, maxiter=maxiter, tol=1e-6)
        assert rel(k2.solve(rhs_p), k2.plain(rhs_p)) < bound
        assert k2.grid < sem.nelem // 4


# ---- K4: the fused local Helmholtz apply ------------------------------------
CUBE = dict(reynolds=60.0, h=1.0, lx=5.0, ly=3.0, lz=3.0, cube_x=2.5,
            nx=5, ny=3, nz=3, order=3, delta=1.0, target_cfl=0.2)


def _k4_case(dim, order):
    if dim == 2:
        return CylinderCase(nr=3, ntheta=8, order=order, device="cuda").sem
    return SEM3(box_mesh_3d(3, 2, 3, order=order, periodic_z=True), device="cuda")


@pytest.mark.parametrize("dim,order,C", [
    (2, 6, 2), (2, 3, 1), (2, 7, 3), (3, 6, 3), (3, 3, 1), (3, 4, 2), (3, 7, 3),
])
def test_fused_helmholtz_kernel_matches_plain(case, dim, order, C):
    # n = order + 1 in 4..8, d = 2 and 3, 1..3 components in one launch;
    # partial last blocks (several elements per block at small n)
    sem = _k4_case(dim, order)
    k4 = FusedHelmholtz(sem)
    u = torch.as_tensor(np.random.default_rng(order * C).standard_normal(
        k4.node_shape + ((C,) if C > 1 else ())), dtype=torch.float32, device="cuda")
    got, ref = k4.apply(u, 0.0167, 100.0), k4.plain(u, 0.0167, 100.0)
    torch.cuda.synchronize()
    assert k4.launches == 1
    # f32 in another summation order (sum-factorised vs einsum)
    assert rel(got, ref) < 1e-5


def _k4_fields(sem, nelem):
    """The fields K4 reads from a SEM, tiled to ``nelem`` elements."""
    keys = (("g11", "g12", "g22") if sem.ndim == 2
            else ("g11", "g22", "g33", "g12", "g13", "g23"))
    reps = -(-nelem // sem.nelem)
    tile = lambda t: torch.cat([t] * reps)[:nelem].contiguous()
    return types.SimpleNamespace(n=sem.n, ndim=sem.ndim, nelem=nelem, D=sem.D,
                                 bm=tile(sem.bm), **{k: tile(getattr(sem, k)) for k in keys})


def _k4_count(sem, C, count):
    """(element count, elements per block, blocks that fit) for one element,
    a partial last group, or more groups than the persistent grid holds."""
    geo = FusedHelmholtz(sem).geometry(C)
    per, fit = geo["per_block"], geo["per_sm"] * geo["sms"]
    return {"one": 1, "tail": 2 * per + 1, "beyond_grid": per * (fit + 1) + 1}[count], per, fit


@pytest.mark.parametrize("count", ["one", "tail", "beyond_grid"])
@pytest.mark.parametrize("dim,order,C", [
    (3, 6, 3), (3, 6, 1), (3, 3, 2), (3, 7, 1), (2, 6, 2), (2, 3, 3),
])
def test_fused_helmholtz_kernel_at_element_counts(case, dim, order, C, count):
    # a block owns a group of elements and walks the groups with a stride
    # of the grid: one element, a partial last group, and blocks that own
    # several groups
    sem = _k4_case(dim, order)
    E, per, fit = _k4_count(sem, C, count)
    k4 = FusedHelmholtz(_k4_fields(sem, E))
    u = torch.as_tensor(np.random.default_rng(E).standard_normal(
        k4.node_shape + ((C,) if C > 1 else ())), dtype=torch.float32, device="cuda")
    for h2 in (100.0, 0.0):  # h2 = 0: the kernel does not read bm
        got, ref = k4.apply(u, 0.0167, h2), k4.plain(u, 0.0167, h2)
        torch.cuda.synchronize()
        assert rel(got, ref) < 1e-5
    assert k4.launches == 2
    if count == "beyond_grid":
        assert k4.grid == fit < -(-E // per)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fused_helmholtz_kernel_takes_unaligned_tensors(case, offset):
    # u at a storage offset of 1..3 floats: the copies and stores that do
    # not share u's 16-byte phase take their 4-byte path
    sem = _k4_case(3, 6)
    E, _, _ = _k4_count(sem, 3, "beyond_grid")
    k4 = FusedHelmholtz(_k4_fields(sem, E))
    n = int(np.prod(k4.node_shape)) * 3
    flat = torch.as_tensor(np.random.default_rng(offset).standard_normal(n + offset),
                           dtype=torch.float32, device="cuda")
    u = flat[offset:].view(k4.node_shape + (3,))
    assert u.is_contiguous() and u.data_ptr() % 16 != 0
    got, ref = k4.apply(u, 0.0167, 100.0), k4.plain(u, 0.0167, 100.0)
    torch.cuda.synchronize()
    assert rel(got, ref) < 1e-5


def test_fused_helmholtz_kernel_is_bit_reproducible(case):
    # no atomics, a fixed order of every sum: two launches give equal bits
    sem = _k4_case(3, 6)
    E, _, _ = _k4_count(sem, 3, "beyond_grid")
    k4 = FusedHelmholtz(_k4_fields(sem, E))
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(k4.node_shape + (3,)),
                        dtype=torch.float32, device="cuda")
    assert torch.equal(k4.apply(u, 0.0167, 100.0), k4.apply(u, 0.0167, 100.0))


def test_fused_helmholtz_kernel_rejects_what_it_cannot_take(case):
    k4 = FusedHelmholtz(case.sem)
    u = torch.zeros(k4.node_shape + (2,), dtype=torch.float32, device="cuda")
    for bad, match in ((u.double(), "float32"), (u[..., :1].expand_as(u), "contiguous"),
                       (u[:-1], "shape"), (torch.zeros(k4.node_shape + (4,), device="cuda"),
                                            "shape")):
        with pytest.raises(ValueError, match=match):
            k4.apply(bad, 1.0, 1.0)
    assert k4.launches == 0


def test_mixed_cube_matvec_kernel_matches_plain(case):
    cube = CubeRoughnessCase(**CUBE, device="cuda",
                             solver=SolverConfig(pressure_tol=1e-7, velocity_tol=1e-8,
                                                 pressure_maxiter=300, velocity_maxiter=120))
    ns = NavierStokes(cube.sem, viscosity=cube.h / cube.reynolds, dt=cube.dt,
                      u_bc=cube.u_bc, solver=cube.solver, mixed_precision=True)
    op = LinearizedOperator(ns, cube.initial_flow(), nsteps=2)
    q = cube.sem.vmask * torch.as_tensor(
        np.random.default_rng(3).standard_normal(tuple(cube.sem.bm.shape) + (3,)),
        device="cuda")
    got = op.matvec(q)
    assert ns.mixed.fused.launches > 0
    ns.mixed.fused.apply = ns.mixed.fused.plain
    ref = op.matvec(q)
    # both refine every solve to f64
    assert rel(got, ref) < 1e-9


# a graded backward-facing step at order 5 (n = 6): the carved re-entrant
# corner (a vertex of 3 elements) and the outflow pressure Dirichlet
BFS_SMALL = dict(reynolds=500.0, order=5, elems_upstream=3, elems_downstream=8,
                 elems_y=4, inflow_length=4.0, outflow_length=16.0, step_dx=0.22)


def test_cg_kernels_on_the_step_mesh(case):
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase

    bfs = BackwardFacingStepCase(**BFS_SMALL, dtype=torch.float32, device="cuda")
    sem = bfs.sem
    assert sem.has_pressure_dirichlet and sem.n == 6
    rng = np.random.default_rng(6)
    rhs = make_projector(sem, sem.vmask)(torch.as_tensor(
        rng.standard_normal(tuple(sem.bm.shape) + (2,)), dtype=torch.float32, device="cuda"))
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=40, tol=1e-6)
    h2 = (11.0 / 6.0) / bfs.dt
    assert rel(k1.solve(rhs, 1.0 / 500.0, h2), k1.plain(rhs, 1.0 / 500.0, h2)) < 1e-5
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32,
                            device="cuda")
    for maxiter, bound in ((350, 1e-4), (16, 1e-3)):
        k2 = FusedPressureCG(sem, maxiter=maxiter, tol=1e-5)
        assert rel(k2.solve(rhs_p), k2.plain(rhs_p)) < bound
        assert k2.launches == 1
    # three steps of the f32 route of tools_torch/bfs_march.py --fused; the
    # solves stop at 1e-5/1e-6, so two f32 CG paths part at that level in
    # every increment (the bound of chip_smoke.py's f32 matvec checks)
    fused = BackwardFacingStepCase(**BFS_SMALL, dtype=torch.float32, device="cuda",
                                   solver=SolverConfig(
                                       pressure_tol=1e-5, velocity_tol=1e-6,
                                       pressure_maxiter=350, velocity_maxiter=40,
                                       pressure_precond="block", fused_solves=True))
    ns = fused.make_ns()
    u0 = fused.initial_flow()
    got = ns.advance(ns.make_state(u0), 3).u
    assert ns.fused_v.launches == 3 and ns.fused_p.launches == 3
    ns.fused_v.solve, ns.fused_p.solve = ns.fused_v.plain, ns.fused_p.plain
    assert rel(got, ns.advance(ns.make_state(u0), 3).u) < 1e-3


def test_schwarz_apply_on_the_card_matches_the_cpu(case):
    # the f64 'schwarz' preconditioner built on each device: the patch
    # inverses come from the same host inversion, the applies agree to
    # roundoff, and the card's apply (a gather, no atomics) is bit for bit
    # reproducible
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase

    sems = [BackwardFacingStepCase(**BFS_SMALL, device=d).sem for d in ("cuda", "cpu")]
    for s in sems:
        s.setup_pressure_schwarz()
    r = np.random.default_rng(7).standard_normal(sems[0].p_shape)
    got, ref = (s.pressure_precond_schwarz(torch.as_tensor(r, device=s.device))
                for s in sems)
    assert rel(got.cpu(), ref) < 1e-12
    assert torch.equal(got, sems[0].pressure_precond_schwarz(
        torch.as_tensor(r, device="cuda")))


@pytest.mark.parametrize("precond", ["fdm", "schwarz"])
def test_pnpn2_cube_matvec_on_the_card_matches_the_cpu(case, precond):
    # the f64 3-D 'pnpn2' tangent (3 steps) on each device, solves at 1e-12
    tight = SolverConfig(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=2000,
                         velocity_maxiter=2000, pressure_precond=precond)
    out = []
    for dev in ("cuda", "cpu"):
        cube = CubeRoughnessCase(**CUBE, device=dev, solver=tight)
        q = cube.sem.vmask * torch.as_tensor(
            np.random.default_rng(8).standard_normal(tuple(cube.sem.bm.shape) + (3,)),
            device=dev)
        op = LinearizedOperator(cube.make_ns(), cube.initial_flow(), nsteps=3)
        out.append(op.matvec(q).cpu())
    assert rel(out[0], out[1]) < 1e-10


# ---- the thermal path (Rayleigh-Benard on K1/K2), FST and 'consistent' ----
def test_coupled_rb_step_kernels_match_plain(case):
    """The RB rung (512 elements, eight critical wavelengths) in f32: K1
    with the free-slip walls' differing component masks and K2 with the
    mean projection, three coupled steps through the kernels against the
    same through their plain versions, and a 10-step coupled matvec's
    launches (``chip_smoke.py``'s phase 8 rung and start)."""
    rb = chip_smoke.rb_rung(torch.float32, chip_smoke.RB_F32, "cuda")
    ns = rb.make_ns()
    fv, fp = ns.fused_v, ns.fused_p
    assert fp.project_mean and float(fv.mask[..., 1].min()) == 0.0
    u0, p0, T0 = chip_smoke.rb_start(rb)
    got = ns.advance(ns.make_state(u0, p=p0, T=T0), 3)
    fv.solve, fp.solve = fv.plain, fp.plain
    try:
        ref = ns.advance(ns.make_state(u0, p=p0, T=T0), 3)
    finally:
        del fv.solve, fp.solve
    assert rel(got.u, ref.u) < 1e-4 and rel(got.T, ref.T) < 1e-5
    op = LinearizedOperator(ns, rb.base_u, base_T=rb.base_T, nsteps=10)
    fv.launches = fp.launches = 0
    Mq = op.matvec((rb.sem.vmask * u0, rb.sem.tmask[..., None] * (T0 - rb.base_T)))
    torch.cuda.synchronize()
    assert fv.launches == fp.launches == 10
    assert all(bool(torch.isfinite(x).all()) for x in Mq)


@pytest.mark.parametrize("path", ["fst", "consistent"])
def test_fst_and_consistent_steps_on_the_card_match_the_cpu(case, path):
    """Three f64 steps with the FST inflow lift or the 'consistent'
    pressure scheme on the card against the same on the CPU (1e-12):
    ``chip_smoke.py``'s phase 8 steps."""
    run = chip_smoke.fst_step if path == "fst" else chip_smoke.consistent_step
    gpu, cpu = run("cuda"), run("cpu")
    assert bool(torch.isfinite(gpu).all())
    assert float((gpu - cpu).abs().max() / cpu.abs().max()) <= 1e-12
