"""The port's scalar step (``stepper/navier_stokes.py`` with
``scalar_diff``: the advection-diffusion solves, the buoyancy, the scalar
source and the scalar sponge) against the JAX package's, in 2-D on a small
Rayleigh-Benard box and in 3-D on a small walled box, f64, solves at 1e-13;
the exact advection-diffusion mode of ``tests/test_scalars.py``; and the
thermal case carried across by ``interop.thermal_case_arrays`` and
``thermal_case_from_arrays``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.rayleigh_benard import RayleighBenardCase as JaxRB
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.mesh import box_mesh_3d as jax_box_mesh_3d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.ops.core3 import SEM3 as JaxSEM3
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.cases.rayleigh_benard import RayleighBenardCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import (
    sem3_arrays,
    sem3_from_arrays,
    sem_arrays,
    sem_from_arrays,
    thermal_case_arrays,
    thermal_case_from_arrays,
)
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

TIGHT = dict(pressure_tol=1e-13, velocity_tol=1e-13, scalar_tol=1e-13)
NSTEPS = 3
RB = dict(rayleigh=2000.0, prandtl=1.0, nx=4, ny=2, order=5, dt=2.5e-3)


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


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def hooks(cos, stack, RaPr: float):
    """A nonlinear buoyancy and a scalar source q(u, T, t), in one array
    module's ``stack`` (the time is traced in JAX, a host float in the
    port: ``cos`` of the matching module)."""

    def buoyancy(T):
        return stack([0.3 * T[..., 0] ** 2, RaPr * T[..., 0]], -1)

    def t_forcing(u, T, t):
        return 0.5 * T * u[..., :1] + 0.1 * cos(3.0 * t) * T ** 2

    return buoyancy, t_forcing


@pytest.fixture(scope="module")
def rb_pair():
    """Both packages' RB cases on one mesh, with a sponge over the top
    fifth of the layer (the scalar sponge's strength field)."""
    jcase = JaxRB(**RB, solver=JaxSolverConfig(**TIGHT))
    m = jcase.mesh
    lam = 5.0 * np.clip((m.y - 0.8) / 0.2, 0.0, 1.0)
    jcase.sem.set_sponge(lam)
    case = thermal_case_from_arrays(
        RayleighBenardCase(**RB, solver=SolverConfig(**TIGHT), device="cpu"),
        thermal_case_arrays(jcase))
    rng = np.random.default_rng(5)
    u0 = np.asarray(jcase.sem.vmask) * 0.1 * rng.standard_normal(m.x.shape + (2,))
    T0 = np.asarray(jcase.base_T) + np.asarray(jcase.sem.tmask)[..., None] * 0.05 * \
        rng.standard_normal(m.x.shape + (1,))
    return jcase, case, u0, T0


def test_thermal_case_crosses_bit_identically(rb_pair):
    """The overwritten tmask (not the mesh's), base_T and t_bc cross
    bit-identically, and the port's own case builds the same ones."""
    jcase, case, _, _ = rb_pair
    assert np.array_equal(case.sem.tmask.numpy(), np.asarray(jcase.sem.tmask))
    assert np.array_equal(case.base_T.numpy(), np.asarray(jcase.base_T))
    assert np.array_equal(case.t_bc.numpy(), np.asarray(jcase.t_bc))
    assert float(np.asarray(jcase.mesh.tmask).min()) == 1.0  # the mesh's is all free
    own = RayleighBenardCase(**RB, device="cpu")
    assert np.array_equal(own.sem.tmask.numpy(), np.asarray(jcase.sem.tmask))
    assert np.array_equal(own.base_T.numpy(), np.asarray(jcase.base_T))
    assert np.array_equal(own.t_bc.numpy(), np.asarray(jcase.t_bc))
    # the free-slip walls mask u_y and leave u_x free
    vm = case.sem.vmask.numpy()
    assert vm[..., 0].min() == 1.0 and vm[..., 1].min() == 0.0
    assert not case.sem.has_pressure_dirichlet


@pytest.mark.parametrize("extras", ["plain", "hooks"])
def test_rb_scalar_steps_match_jax(rb_pair, extras):
    """NSTEPS coupled steps (BDF1 -> 3) from a perturbed conduction state:
    the RB case's own stepper, and one with a nonlinear buoyancy, a scalar
    source and the scalar sponge; velocity, pressure and T to 1e-12."""
    jcase, case, u0, T0 = rb_pair
    if extras == "plain":
        jns, ns = jcase.make_ns(), case.make_ns()
    else:
        RaPr = jcase.rayleigh * jcase.prandtl
        jb, jq = hooks(jnp.cos, jnp.stack, RaPr)
        tb, tq = hooks(np.cos, torch.stack, RaPr)
        ref_T = np.asarray(jcase.base_T) * 0.5
        jns = JaxNavierStokes(jcase.sem, viscosity=1.0, dt=jcase.dt,
                              solver=JaxSolverConfig(**TIGHT), scalar_diff=(1.0,),
                              t_bc=jcase.t_bc, buoyancy=jb, t_forcing=jq,
                              sponge_ref_T=jnp.asarray(ref_T))
        ns = NavierStokes(case.sem, viscosity=1.0, dt=case.dt, solver=SolverConfig(**TIGHT),
                          scalar_diff=(1.0,), t_bc=case.t_bc, buoyancy=tb, t_forcing=tq,
                          sponge_ref_T=torch.as_tensor(ref_T))
    ref = jax.jit(lambda st: jns.advance(st, NSTEPS))(
        jns.make_state(jnp.asarray(u0), T=jnp.asarray(T0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0), T=torch.as_tensor(T0)), NSTEPS)
    for name in ("u", "p", "T", "tlag", "ntlag", "nlag"):
        assert rel(getattr(st, name).numpy(), getattr(ref, name)) <= 1e-12, name
    assert st.step == NSTEPS and abs(st.time - NSTEPS * case.dt) < 1e-15


def test_scalar_step_3d_matches_jax():
    """A 3-D scalar step (two scalars, Dirichlet walls at two temperatures,
    buoyancy on the first) on a 2 x 2 x 2 walled box, against JAX's."""
    mesh = jax_box_mesh_3d(2, 2, 2, order=4, periodic_x=True)
    jsem = JaxSEM3(mesh)
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    rng = np.random.default_rng(8)
    t_bc = np.stack([1.0 - mesh.y, 0.5 * mesh.z], axis=-1)
    u0 = np.asarray(jsem.vmask) * 0.2 * rng.standard_normal(mesh.x.shape + (3,))
    T0 = t_bc + np.asarray(jsem.tmask)[..., None] * 0.1 * rng.standard_normal(t_bc.shape)

    def make(pkg, sem_, xp, stack):
        def buoyancy(T):
            z = xp.zeros_like(T[..., 0])
            return stack([z, 10.0 * T[..., 0], z], -1)
        cfg = (JaxSolverConfig if pkg is JaxNavierStokes else SolverConfig)(**TIGHT)
        conv = jnp.asarray if pkg is JaxNavierStokes else torch.as_tensor
        return pkg(sem_, viscosity=0.2, dt=0.01, solver=cfg, scalar_diff=(0.1, 0.05),
                   t_bc=conv(t_bc), buoyancy=buoyancy)

    jns = make(JaxNavierStokes, jsem, jnp, jnp.stack)
    ns = make(NavierStokes, sem, torch, torch.stack)
    ref = jax.jit(lambda st: jns.advance(st, NSTEPS))(
        jns.make_state(jnp.asarray(u0), T=jnp.asarray(T0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0), T=torch.as_tensor(T0)), NSTEPS)
    for name in ("u", "p", "T"):
        assert rel(getattr(st, name).numpy(), getattr(ref, name)) <= 1e-12, name


def test_advection_diffusion_exact():
    """T advected by a uniform flow decays and translates like the exact
    mode (the gate of ``tests/test_scalars.py``: 2e-5), the velocity stays
    the uniform flow."""
    mesh = box_mesh_2d(4, 4, order=7, x0=0.0, x1=2 * np.pi, y0=0.0,
                       y1=2 * np.pi, periodic_x=True, periodic_y=True)
    sem = SEM(mesh, device="cpu")
    alpha, dt, nsteps = 0.1, 2e-3, 50
    ns = NavierStokes(sem, viscosity=0.05, dt=dt, scalar_diff=(alpha,))
    u0 = torch.stack([torch.ones_like(sem.bm), torch.zeros_like(sem.bm)], dim=-1)
    T0 = torch.as_tensor(np.sin(mesh.x)[..., None])
    out = ns.advance(ns.make_state(u0, T=T0), nsteps)
    t = nsteps * dt
    T_exact = torch.as_tensor(np.exp(-alpha * t) * np.sin(mesh.x - t))
    err = float(sem.norm(out.T[..., 0] - T_exact) / sem.norm(T_exact))
    assert err < 2e-5, err
    assert float((out.u - u0).abs().max()) < 1e-8
