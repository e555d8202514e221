"""The Rayleigh-Benard case on the fused solves: the f32 ``fused_solves``
step and the fused-IR mixed-precision step (f64 state, K1/K2 as the f32
inner solves of refinement) against the JAX package's, whose Pallas
kernels run in interpret mode here while the port's wrappers run their
plain versions (a CPU tensor never reaches a kernel).  The RB case is the
first stepping path whose K1 takes masks that differ by component (the
free-slip walls mask u_y and leave u_x free) and whose K2 removes the mean
(no pressure Dirichlet node).  The scalar solve stays the plain f64 PCG on
the fused-IR path, as in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nekstab_next_tpu.cases.rayleigh_benard import RayleighBenardCase as JaxRB
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.cases.rayleigh_benard import RayleighBenardCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import thermal_case_arrays, thermal_case_from_arrays

NSTEPS = 3
RB = dict(rayleigh=2000.0, prandtl=1.0, nx=4, ny=2, order=6, dt=2.5e-3)
FUSED = dict(fused_solves=True)
# f32-reachable tolerances (f32 CG past its attainable accuracy drifts)
F32 = dict(fused_solves=True, pressure_tol=1e-5, velocity_tol=1e-6, scalar_tol=1e-6)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, scalar_tol=1e-12)


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
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def jax_case(dtype, solver):
    """JAX's RB case; for float32 its SEM rebuilt at f32 with the case's
    overwritten tmask (the JAX case takes no dtype)."""
    jcase = JaxRB(**RB, solver=solver)
    if dtype == jnp.float32:
        tmask = jcase.sem.tmask
        jcase.sem = JaxSEM(jcase.mesh, dtype=jnp.float32)
        jcase.sem.tmask = tmask.astype(jnp.float32)
        jcase.base_T, jcase.t_bc, jcase.base_u = (
            x.astype(jnp.float32) for x in (jcase.base_T, jcase.t_bc, jcase.base_u))
    return jcase


def start(case):
    """``chip_smoke.rb_start`` (the hydrostatic start: from p = 0 the first
    steps would carry a pressure transient of O(Ra Pr), beyond f32) on the
    port's case, as f64 numpy for both packages."""
    return tuple(x.double().numpy() for x in chip_smoke.rb_start(case))


def run_jax(jns, u0, p0, T0, dtype):
    st = jns.make_state(jnp.asarray(u0, dtype), p=jnp.asarray(p0, dtype),
                        T=jnp.asarray(T0, dtype))
    return jax.jit(lambda s: jns.advance(s, NSTEPS))(st)


def run_port(ns, u0, p0, T0, dtype):
    st = ns.make_state(torch.as_tensor(u0, dtype=dtype), p=torch.as_tensor(p0, dtype=dtype),
                       T=torch.as_tensor(T0, dtype=dtype))
    return ns.advance(st, NSTEPS)


def test_f32_fused_rb_steps_match_jax_interpret():
    """NSTEPS f32 steps on K1/K2's plain versions against JAX's f32 step on
    its interpret-mode kernels at f32-reachable tolerances: u and T to 1e-5,
    the pressure (mean removed) to 1e-4 (f32 roundoff over different
    summation orders), with the kernels' component masks and mean
    projection in place."""
    jcase = jax_case(jnp.float32, JaxSolverConfig(**F32))
    jns = jcase.make_ns()
    assert jns._fused_v is not None and jns._fused_p is not None
    case = thermal_case_from_arrays(
        RayleighBenardCase(**RB, solver=SolverConfig(**F32), device="cpu", dtype=torch.float32),
        thermal_case_arrays(jcase))
    ns = case.make_ns()
    assert ns.fused_v is not None and ns.fused_p.project_mean
    vm = ns.fused_v.mask
    assert float(vm[..., 0].min()) == 1.0 and float(vm[..., 1].min()) == 0.0
    u0, p0, T0 = start(case)
    ref = run_jax(jns, u0, p0, T0, jnp.float32)
    st = run_port(ns, u0, p0, T0, torch.float32)
    assert st.u.dtype == torch.float32 and st.T.dtype == torch.float32
    for name in ("u", "T"):
        assert rel(getattr(st, name).numpy(), getattr(ref, name)) <= 1e-5, name
    p, jp = st.p.numpy(), np.asarray(ref.p, np.float64)
    assert rel(p - p.mean(), jp - jp.mean()) <= 1e-4
    assert ns.fused_v.launches == 0 and ns.fused_p.launches == 0


def test_fused_ir_rb_step_matches_jax_and_f64():
    """NSTEPS fused-IR steps (f64 state, refined f32 inner solves; the
    scalar solve the plain f64 PCG) against JAX's fused-IR step and the
    f64 step at 1e-12 solves: u and T to 1e-8 (the gates of
    ``test_torch_mixed_ir.py``)."""
    jcase = jax_case(jnp.float64, JaxSolverConfig(**FUSED))
    jns = JaxNavierStokes(jcase.sem, viscosity=jcase.prandtl, dt=jcase.dt,
                          solver=jcase.solver, scalar_diff=(1.0,), t_bc=jcase.t_bc,
                          buoyancy=jcase.make_ns().buoyancy, mixed_precision=True)
    assert jns._mixed_ir
    case = thermal_case_from_arrays(
        RayleighBenardCase(**RB, solver=SolverConfig(**FUSED), device="cpu"),
        thermal_case_arrays(jcase))
    ns = case.make_ns(mixed_precision=True)
    assert ns._mixed_ir and ns.mixed is None
    u0, p0, T0 = start(case)
    ref = run_jax(jns, u0, p0, T0, jnp.float64)
    st = run_port(ns, u0, p0, T0, torch.float64)
    c64 = thermal_case_from_arrays(
        RayleighBenardCase(**RB, solver=SolverConfig(**TIGHT), device="cpu"),
        thermal_case_arrays(jcase))
    f64 = run_port(c64.make_ns(), u0, p0, T0, torch.float64)
    for name in ("u", "T"):
        got = getattr(st, name).numpy()
        assert rel(got, getattr(ref, name)) <= 1e-8, name
        assert rel(got, getattr(f64, name).numpy()) <= 1e-8, name
