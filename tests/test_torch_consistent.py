"""The ``'consistent'`` pressure scheme (E = D M^-1 D^T with D = B div on
the continuous velocity GLL grid, an assembled elliptic pressure solve)
against the JAX package's: the Taylor-Green box of ``tests/test_stepper.py``
(enclosed: the mean is removed) and a small channel with an outflow
(pressure Dirichlet nodes), f64 steps to 1e-12, the tangent of a step, and
the decay of the Taylor-Green vortex; and the weak gradient ``divv_weak_t``
as the exact transpose of ``B div`` in 2-D and 3-D."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_2d, box_mesh_3d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_operator="consistent")
NSTEPS = 5


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (the test suite runs several worker processes at once)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def taylor_green(x, y, t, nu):
    f = np.exp(-2.0 * nu * t)
    u = -np.cos(x) * np.sin(y) * f
    v = np.sin(x) * np.cos(y) * f
    p = -0.25 * (np.cos(2 * x) + np.cos(2 * y)) * f * f
    return u, v, p


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def tg_mesh(box):
    return box(6, 6, order=6, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
               periodic_x=True, periodic_y=True)


def channel_mesh(box):
    """Inflow on the left, outflow on the right, walls top and bottom."""
    return box(4, 2, order=5, x1=3.0, y1=1.0,
               bc={"left": JaxBC.DIRICHLET, "right": JaxBC.OUTFLOW})


MESHES = {"taylor_green": tg_mesh, "channel": channel_mesh}


def start(mesh, name, exact_p=False):
    """(u0, p0, u_bc); the Taylor-Green start takes its exact pressure only
    with ``exact_p``."""
    if name == "taylor_green":
        u, v, p = taylor_green(mesh.x, mesh.y, 0.0, 0.1)
        return np.stack([u, v], axis=-1), (p if exact_p else None), None
    u_bc = np.zeros(mesh.x.shape + (2,))
    u_bc[..., 0] = 4.0 * mesh.y * (1.0 - mesh.y)
    u_bc = u_bc * (1.0 - np.asarray(mesh.vmask))
    return np.asarray(mesh.vmask) * 0.5 + u_bc, None, u_bc


# (solver, gate) by mesh.  On the enclosed Taylor-Green box the same-order
# scheme's spurious pressure modes grow through the warm start when the
# pressure solve is pushed past ~1e-9: at 1e-10 and 1e-12 both packages'
# pressure reaches 1e13 within five steps (the JAX scheme's own behaviour,
# copied); at the default 1e-8 both stay at the solution and agree to the
# solve's accuracy.
CASES = {"channel": (TIGHT, 1e-12),
         "taylor_green": (dict(TIGHT, pressure_tol=1e-8), 1e-9)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_consistent_steps_match_jax(name):
    mesh = MESHES[name](jax_box_mesh_2d)
    jsem = JaxSEM(mesh)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    u0, p0, u_bc = start(mesh, name)
    cfg, gate = CASES[name]
    jns = JaxNavierStokes(jsem, viscosity=0.1, dt=0.01, solver=JaxSolverConfig(**cfg),
                          u_bc=None if u_bc is None else jnp.asarray(u_bc))
    ns = NavierStokes(sem, viscosity=0.1, dt=0.01, solver=SolverConfig(**cfg),
                      u_bc=None if u_bc is None else torch.as_tensor(u_bc))
    assert ns._scheme == "consistent" and ns.p_shape == tuple(sem.bm.shape)
    assert sem.has_pressure_dirichlet == (name == "channel")
    ref = jax.jit(lambda s: jns.advance(s, NSTEPS))(
        jns.make_state(jnp.asarray(u0), p=None if p0 is None else jnp.asarray(p0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0),
                                  p=None if p0 is None else torch.as_tensor(p0)), NSTEPS)
    for field in ("u", "p"):
        assert rel(getattr(st, field).numpy(), getattr(ref, field)) <= gate, field
    # the last increment alone is small: its error relative to itself is the
    # solve's (the tolerance on the residual, times the condition number)
    assert rel(st.dp.numpy(), ref.dp) <= 100 * gate
    # the assembled weak (B div) divergence of the new velocity vanishes to
    # the solve's tolerance
    div = sem.pmask * sem.dssum(sem.bm * sem.divv(st.u))
    assert float(div.abs().max()) < 1e3 * cfg["pressure_tol"] * float(st.u.abs().max())


def test_consistent_tangent_matches_jax():
    """Three tangent steps of the 'consistent' stepper on the channel about
    its inflow profile against JAX's ``jax.linearize`` operator (1e-10)."""
    mesh = channel_mesh(jax_box_mesh_2d)
    jsem = JaxSEM(mesh)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    _, _, u_bc = start(mesh, "channel")
    jns = JaxNavierStokes(jsem, viscosity=0.1, dt=0.01, solver=JaxSolverConfig(**TIGHT),
                          u_bc=jnp.asarray(u_bc))
    ns = NavierStokes(sem, viscosity=0.1, dt=0.01, solver=SolverConfig(**TIGHT),
                      u_bc=torch.as_tensor(u_bc))
    q = np.asarray(jsem.vmask) * np.random.default_rng(2).standard_normal(u_bc.shape)
    ref = JaxLinearizedOperator(jns, jnp.asarray(u_bc), nsteps=3).matvec(jnp.asarray(q))
    got = LinearizedOperator(ns, torch.as_tensor(u_bc), nsteps=3).matvec(torch.as_tensor(q))
    assert rel(got.numpy(), ref) <= 1e-10


def test_consistent_taylor_green_decay():
    """100 steps of the decaying vortex: the velocity within 3e-4 of the
    exact solution (the 'pnpn2' gate of ``tests/test_stepper.py``)."""
    mesh = tg_mesh(box_mesh_2d)
    sem = SEM(mesh, device="cpu")
    nu, dt, nsteps = 0.1, 0.01, 100
    u0, p0, _ = start(mesh, "taylor_green", exact_p=True)
    ns = NavierStokes(sem, viscosity=nu, dt=dt,
                      solver=SolverConfig(pressure_operator="consistent"))
    st = ns.advance(ns.make_state(torch.as_tensor(u0), p=torch.as_tensor(p0)), nsteps)
    ue, _, _ = taylor_green(mesh.x, mesh.y, dt * nsteps, nu)
    err = float(sem.norm(st.u[..., 0] - torch.as_tensor(ue)) / sem.norm(torch.as_tensor(ue)))
    assert err < 3e-4, err


@pytest.mark.parametrize("dim", [2, 3])
def test_weak_gradient_is_the_transpose_of_weak_divergence(dim):
    if dim == 2:
        sem = SEM(box_mesh_2d(3, 2, order=4, grading_x=1.3), device="cpu")
    else:
        sem = SEM3(box_mesh_3d(2, 2, 2, order=3, periodic_z=True), device="cpu")
    rng = np.random.default_rng(dim)
    u = torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape) + (dim,)))
    q = torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape)))
    a = float(torch.sum(sem.bm * sem.divv(u) * q))
    b = float(torch.sum(u * sem.divv_weak_t(q)))
    assert abs(a - b) <= 1e-13 * abs(a)
