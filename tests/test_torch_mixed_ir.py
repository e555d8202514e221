"""The fused-IR mixed-precision path (f64 state on the PnPn-2 step, each
inner solve ``mixed_ir_cycles`` cycles of iterative refinement around the
f32 kernels K1/K2) against the JAX package's.

On the 32-element cylinder with the mixed settings of
``examples/cylinder_stability.py`` (1e-8/1e-9, caps 500/200, ``'block'``,
``fused_solves``): JAX runs its Pallas kernels in interpret mode, the port
its kernels' plain versions (a CPU tensor never reaches a kernel).  Both
are held against the f64 path with solves at 1e-12, which JAX's own
fused-IR meets to 1.4e-9 (step), 1.6e-8 (tangent) and 3.1e-8 (rmatvec)
here; the port's plain f32 solves meet it to 3e-12, 2e-10 and 8e-11.  The
f64 step is JAX's; the f64 tangent and rmatvec are the port's, which
``test_torch_linearized.py`` and ``test_torch_adjoint.py`` hold to JAX's
f64 ones (compiling JAX's would take this file past its time).  Also: the
copied predicate (``ops/exchange.py``) against JAX's on five meshes, the
refined ``cg_solve``, the solves per step, the adjoint identity, and an
enclosed box, whose pressure solve projects the mean inside every cycle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.ops.exchange import build_shift_exchange as jax_build_shift_exchange
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import cylinder_mesh
from nekstab_next_tpu_torch.ops.cg import cg_solve, pcg
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.ops.exchange import get_exchange, shift_decomposes
from nekstab_next_tpu_torch.ops.fused_cg import FusedPressureCG
from nekstab_next_tpu_torch.ops.schwarz import make_pressure_operator
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

MESH = dict(nr=4, ntheta=8, order=6)
# examples/cylinder_stability.py's --precision mixed solver
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=500,
             velocity_maxiter=300, pressure_precond="block")
NSTEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def port_stepper(jcase, jns, mixed: bool) -> NavierStokes:
    """The port's stepper on the JAX case's factors and config."""
    sem = sem_from_arrays(sem_arrays(jcase.sem), device="cpu")
    return NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                        u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                        sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                        solver=SolverConfig(**dataclasses.asdict(jns.solver)),
                        mixed_precision=mixed)


def continuous(jsem, seed):
    """A seeded C0 (dsavg) masked velocity field, as tests/test_linearized.py's."""
    vm = np.asarray(jsem.vmask)
    q = np.random.default_rng(seed).standard_normal(vm.shape)
    q = np.stack([np.asarray(jsem.dsavg(jnp.asarray(q[..., d]))) for d in range(2)], -1)
    return vm * q


@pytest.fixture(scope="module")
def runs():
    """On the 32-element cylinder about the uniform flow, built once: JAX's
    fused-IR steps, tangent and rmatvec, JAX's f64 steps, the port's f64
    tangent and rmatvec, and the port's fused-IR stepper and tangent
    operator on the same factors."""
    jcase = JaxCylinderCase(**MESH, solver=JaxSolverConfig(**MIXED), mixed_precision=True)
    jns = jcase.make_ns()
    assert jns._mixed_ir
    jns64 = JaxNavierStokes(jcase.sem, viscosity=jns.nu, dt=jns.dt, u_bc=jcase.u_bc,
                            sponge_ref=jcase.sponge_ref, solver=JaxSolverConfig(**TIGHT))
    u0 = np.array(jcase.uniform_flow())
    q = continuous(jcase.sem, 1)
    ref = {}
    for tag, j in (("ir", jns), ("f64", jns64)):
        st = jax.jit(lambda s, j=j: j.advance(s, NSTEPS))(j.make_state(jnp.asarray(u0)))
        ref[tag] = dict(u=np.asarray(st.u), p=np.asarray(st.p))
    op = JaxLinearizedOperator(jns, jnp.asarray(u0), nsteps=NSTEPS)
    ref["ir"].update(matvec=np.asarray(op.matvec(jnp.asarray(q))),
                     rmatvec=np.asarray(op.rmatvec(jnp.asarray(q))))
    op64 = LinearizedOperator(port_stepper(jcase, jns64, False), torch.as_tensor(u0),
                              nsteps=NSTEPS)
    ref["f64"].update(matvec=op64.matvec(torch.as_tensor(q)).numpy(),
                      rmatvec=op64.rmatvec(torch.as_tensor(q)).numpy())
    ns = port_stepper(jcase, jns, True)
    return dict(jcase=jcase, ns=ns, u0=u0, q=q, ref=ref,
                op=LinearizedOperator(ns, torch.as_tensor(u0), nsteps=NSTEPS))


# ---- the predicate ------------------------------------------------------

def shuffled(mesh, seed: int = 0):
    """The mesh with its elements in a seeded random order: the same
    geometry, a numbering whose exchange does not shift-decompose."""
    perm = np.random.default_rng(seed).permutation(mesh.nelem)
    return dataclasses.replace(mesh, **{
        f.name: getattr(mesh, f.name)[perm] for f in dataclasses.fields(mesh)
        if isinstance(getattr(mesh, f.name), np.ndarray)})


PREDICATE_MESHES = {
    "cylinder32": lambda m: m.cylinder_mesh(**MESH),
    "cylinder96": lambda m: m.cylinder_mesh(nr=6, ntheta=16, order=6, outer_radius=20.0),
    "cylinder768": lambda m: m.cylinder_mesh(nr=16, ntheta=48, order=6, outer_radius=40.0),
    "taylor_green": lambda m: m.box_mesh_2d(3, 3, order=5, x1=2 * np.pi, y1=2 * np.pi,
                                            periodic_x=True, periodic_y=True),
    "shuffled": lambda m: shuffled(m.cylinder_mesh(**MESH)),
}


def same_exchange(a, b) -> bool:
    if a is None or b is None:
        return a is b
    eq = lambda x, y: np.array_equal(np.asarray(x), np.asarray(y))
    groups = lambda g1, g2: len(g1) == len(g2) and all(
        k1 == k2 and eq(m1, m2) for (k1, m1), (k2, m2) in zip(g1, g2))
    return (all(getattr(a, k) == getattr(b, k) for k in ("n", "nelem", "nep", "n2p", "nfpad"))
            and all(eq(getattr(a, k), getattr(b, k)) for k in ("fsel", "fscat", "csel", "cscat"))
            and len(a.face_buckets) == len(b.face_buckets)
            and all(eq(x.ext, y.ext) and x.dst_face == y.dst_face and groups(x.groups, y.groups)
                    for x, y in zip(a.face_buckets, b.face_buckets))
            and len(a.corner_buckets) == len(b.corner_buckets)
            and all((x.cs, x.cd) == (y.cs, y.cd) and groups(x.groups, y.groups)
                    for x, y in zip(a.corner_buckets, b.corner_buckets)))


@pytest.mark.parametrize("name", sorted(PREDICATE_MESHES))
def test_predicate_matches_jax(name):
    import nekstab_next_tpu.mesh as jax_mesh
    import nekstab_next_tpu_torch.mesh as port_mesh

    jmesh = PREDICATE_MESHES[name](jax_mesh)
    ref = jax_build_shift_exchange(np.asarray(jmesh.gid), jmesh.n)
    sem = SEM(PREDICATE_MESHES[name](port_mesh), device="cpu")
    assert shift_decomposes(sem) == (ref is not None) == (name != "shuffled")
    assert same_exchange(get_exchange(sem), ref)
    assert sem._shift_exchange is get_exchange(sem)  # built once, cached on the SEM


# ---- the refined solve --------------------------------------------------

def test_refined_cg_solve_reaches_f64(runs):
    # the pressure system E = D M^-1 D^T of the 32-element cylinder: two
    # cycles around the f32 plain K2 at 3e-6 against f64 CG at 1e-14
    sem = runs["ns"].sem
    E_op = make_pressure_operator(sem)
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(sem.p_shape))
    ref = pcg(E_op, rhs, precond=sem.pressure_precond_block, tol=1e-14, maxiter=2000)
    k2 = FusedPressureCG(sem, maxiter=150, tol=3e-6, ir=True)
    errs = [rel(cg_solve(E_op, rhs, fused_solve=k2.solve, ir_cycles=c).numpy(), ref.numpy())
            for c in (1, 2, 3)]
    # one cycle is the f32 inner solve (~3e-6); each more multiplies the
    # error by about the inner tolerance (measured ~3e-6, 2e-11, 2e-13)
    assert errs[0] > 1e-7 and errs[1] <= 1e-9 and errs[2] <= errs[1]
    assert cg_solve(E_op, rhs, fused_solve=k2.solve, ir_cycles=2).dtype == torch.float64
    assert k2.launches == 0


def test_fused_ir_kernels_take_f64_only_for_refinement():
    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        FusedPressureCG(sem, maxiter=10, tol=1e-6)
    k2 = FusedPressureCG(sem, maxiter=10, tol=1e-6, ir=True)
    x = k2.solve(torch.ones(sem.p_shape, dtype=torch.float64))
    assert x.dtype == torch.float64 and k2._ops.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in k2._ops._buffers.values()
               if v is not None and v.is_floating_point())
    assert sem.bm.dtype == torch.float64  # the SEM itself is not cast


# ---- the step, the tangent, the adjoint ---------------------------------

def test_fused_ir_step_matches_jax(runs):
    ns, u0, ref = runs["ns"], runs["u0"], runs["ref"]
    assert ns._mixed_ir and ns.mixed is None and ns._scheme == "pnpn2"
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), NSTEPS)
    assert st.u.dtype == torch.float64 and tuple(st.p.shape) == ns.sem.p_shape
    # JAX's fused-IR is 1.4e-9 from its f64 path; the port's 2.7e-12
    assert rel(st.u.numpy(), ref["ir"]["u"]) <= 1e-8
    assert rel(st.u.numpy(), ref["f64"]["u"]) <= 1e-8
    assert rel(st.p.numpy(), ref["f64"]["p"]) <= 1e-6


def test_fused_ir_tangent_matches_jax(runs):
    ref = runs["ref"]
    got = runs["op"].matvec(torch.as_tensor(runs["q"])).numpy()
    # JAX's fused-IR 1.6e-8 from f64; the port's 2.0e-10
    assert rel(got, ref["ir"]["matvec"]) <= 1e-7
    assert rel(got, ref["f64"]["matvec"]) <= 1e-7


def test_fused_ir_rmatvec_matches_jax(runs):
    ref = runs["ref"]
    got = runs["op"].rmatvec(torch.as_tensor(runs["q"])).numpy()
    # JAX's fused-IR 3.1e-8 from f64; the port's 7.9e-11
    assert rel(got, ref["ir"]["rmatvec"]) <= 1e-7
    assert rel(got, ref["f64"]["rmatvec"]) <= 1e-7


def test_fused_ir_adjoint_identity(runs):
    # <M q, w> = <q, M* w> in the sponge-masked product, for fields outside
    # the sponge.  A refined solve with an early exit is symmetric only to
    # its accuracy: JAX's own fused-IR gives 5.9e-10 here
    jsem, op = runs["jcase"].sem, runs["op"]
    outside = np.asarray(jsem.bms > 0)[..., None]
    q, w = (torch.as_tensor(outside * continuous(jsem, s)) for s in (4, 5))
    bms = op.sem.bms[..., None]
    a = float(torch.sum(op.matvec(q) * w * bms))
    b = float(torch.sum(q * op.rmatvec(w) * bms))
    assert abs(a - b) <= 1e-8 * abs(a), (a, b)


def test_fused_ir_solves_per_step(runs):
    # every step, tangent step and transposed step runs mixed_ir_cycles
    # K1 and K2 solves (on the card, launches; here, plain versions)
    ns, u0, q, op = runs["ns"], runs["u0"], torch.as_tensor(runs["q"]), runs["op"]
    calls = {"v": 0, "p": 0}
    fv, fp = ns.fused_v, ns.fused_p
    solve_v, solve_p = fv.solve, fp.solve

    def count(key, fn):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    fv.solve, fp.solve = count("v", solve_v), count("p", solve_p)
    try:
        cycles = ns.solver.mixed_ir_cycles
        assert (fv.maxiter, fp.maxiter, fv.tol, fp.tol) == (100, 150, 3e-6, 3e-6)
        ns.step(ns.make_state(torch.as_tensor(u0)))
        assert calls == {"v": cycles, "p": cycles}
        calls.update(v=0, p=0)
        op.matvec(q)
        assert calls == {"v": NSTEPS * cycles, "p": NSTEPS * cycles}
        op._stage_vjps()  # built once (their forward steps solve too)
        calls.update(v=0, p=0)
        op.rmatvec(q)  # the backward only
        assert calls == {"v": NSTEPS * cycles, "p": NSTEPS * cycles}
    finally:
        del fv.solve, fp.solve
    assert fv.launches == 0 and fp.launches == 0  # CPU tensors never launch


def test_fused_ir_enclosed_box_matches_jax_f64():
    # the periodic Taylor-Green box: no pressure Dirichlet, so the mean is
    # projected out of every cycle's residual and correction
    mesh = box_mesh_2d(3, 3, order=5, x1=2 * np.pi, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    jsem = JaxSEM(mesh)
    assert not jsem.has_pressure_dirichlet
    u0 = np.stack([-np.cos(mesh.x) * np.sin(mesh.y),
                   np.sin(mesh.x) * np.cos(mesh.y)], axis=-1)
    kw = dict(viscosity=0.05, dt=0.01)
    jns = JaxNavierStokes(jsem, solver=JaxSolverConfig(**TIGHT), **kw)
    ref = jax.jit(lambda s: jns.advance(s, NSTEPS))(jns.make_state(jnp.asarray(u0)))
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, solver=SolverConfig(**MIXED), mixed_precision=True, **kw)
    assert ns._mixed_ir and ns.fused_p.project_mean
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), NSTEPS)
    assert rel(st.u.numpy(), ref.u) <= 1e-8
    # the pressure is defined up to a constant: compare mean-free
    p, jp = st.p.numpy(), np.asarray(ref.p)
    assert rel(p - p.mean(), jp - jp.mean()) <= 1e-6
