"""The port's Navier-Stokes stepper and cylinder case against the JAX package.

Both steppers run on the 32-element cylinder case with identical factors
(the port's SEM is built from the JAX SEM's arrays, pressure blocks
included), the same SolverConfig and the same initial field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh.cylinder import cylinder_mesh as jax_cylinder_mesh
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import cylinder_mesh
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

MESH = dict(nr=4, ntheta=8, order=6)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=400,
             velocity_maxiter=200)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_stepper(jcase, jns, dtype):
    """The port's stepper on the JAX case's factors and config."""
    sem = sem_from_arrays(sem_arrays(jcase.sem), dtype=dtype, device="cpu")
    return NavierStokes(
        sem, viscosity=jns.nu, dt=jns.dt,
        u_bc=torch.as_tensor(np.array(jcase.u_bc)),
        sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
        solver=SolverConfig(**dataclasses.asdict(jns.solver)),
    )


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("precond,warm,fdm", [
    ("block", True, True), ("fdm", True, True), ("block", False, True),
    ("block", True, False),  # Jacobi velocity preconditioner
])
def test_advance_matches_jax_f64(precond, warm, fdm):
    cfg = JaxSolverConfig(**TIGHT, pressure_precond=precond, warm_start=warm,
                          fdm_precond=fdm)
    jcase = JaxCylinderCase(**MESH, solver=cfg)
    jns = jcase.make_ns()
    ns = port_stepper(jcase, jns, torch.float64)
    u0 = np.array(jcase.uniform_flow())
    jst = jax.jit(lambda s: jns.advance(s, 3))(jns.make_state(jnp.asarray(u0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), 3)
    # both solve every inner system to 1e-12: the steps agree to f64
    # roundoff amplified by three steps (measured ~5e-15)
    assert rel(jst.u, st.u.numpy()) <= 1e-10
    assert rel(jst.p, st.p.numpy()) <= 1e-10
    assert st.step == 3 and st.time == pytest.approx(3 * jns.dt)
    if warm:
        assert rel(jst.dp, st.dp.numpy()) <= 1e-10
    else:
        assert st.dp is None


def test_advance_without_dealiasing_matches_jax_f64():
    # dealias=False: the collocated convection (SEM.convect_colloc_v) in
    # place of the 3/2-rule one, in both packages
    cfg = JaxSolverConfig(**TIGHT, pressure_precond="block", dealias=False)
    jcase = JaxCylinderCase(**MESH, solver=cfg)
    jns = jcase.make_ns()
    ns = port_stepper(jcase, jns, torch.float64)
    u0 = np.array(jcase.uniform_flow())
    jst = jax.jit(lambda s: jns.advance(s, 3))(jns.make_state(jnp.asarray(u0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), 3)
    assert rel(jst.u, st.u.numpy()) <= 1e-10
    assert rel(jst.p, st.p.numpy()) <= 1e-10
    assert ns._convect.__name__ == "convect_colloc_v"


def test_advance_fused_plain_matches_jax_f32():
    # fused_solves: the port's plain kernel versions against the JAX Pallas
    # kernels in interpret mode, at test_fused_cg.py's stepper settings
    cfg = JaxSolverConfig(pressure_tol=1e-6, velocity_tol=1e-7, pressure_maxiter=80,
                          velocity_maxiter=40, pressure_precond="block",
                          fused_solves=True)
    jcase = JaxCylinderCase(**MESH, solver=cfg, dtype=jnp.float32)
    jns = jcase.make_ns()
    ns = port_stepper(jcase, jns, torch.float32)
    u0 = np.array(jcase.uniform_flow())
    jst = jax.jit(lambda s: jns.advance(s, 3))(jns.make_state(jnp.asarray(u0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), 3)
    # f32 with near-converged inner solves (measured ~2e-6)
    assert rel(jst.u, st.u.numpy()) < 1e-4
    assert ns.fused_v.launches == 0 and ns.fused_p.launches == 0


def test_cylinder_case_matches_jax():
    jcase = JaxCylinderCase(**MESH)
    case = CylinderCase(**MESH, device="cpu")
    assert case.dt == jcase.dt
    np.testing.assert_array_equal(case.u_bc.numpy(), np.asarray(jcase.u_bc))
    np.testing.assert_array_equal(case.uniform_flow().numpy(),
                                  np.asarray(jcase.uniform_flow()))
    np.testing.assert_array_equal(case.sponge_ref.numpy(), np.asarray(jcase.sponge_ref))
    np.testing.assert_array_equal(case.sem.bms.numpy(), np.asarray(jcase.sem.bms))


def test_propagator_is_advance():
    case = CylinderCase(**MESH, device="cpu",
                        solver=SolverConfig(**TIGHT, pressure_precond="block"))
    ns = case.make_ns()
    u0 = case.uniform_flow()
    st = ns.make_state(u0)
    assert st.ulag.shape == (2,) + tuple(u0.shape) and st.p.shape == ns.p_shape
    np.testing.assert_array_equal(ns.propagator(u0, 2).numpy(),
                                  ns.advance(st, 2).u.numpy())


# every option the port does not implement raises where it is read
UNSUPPORTED = {
    "lanes_layout": dict(cfg=dict(lanes_layout=True)),
    "pressure_direct": dict(cfg=dict(pressure_direct=True)),
    "cg_fixed_iters": dict(cfg=dict(cg_fixed_iters=True)),
    "fused_pressure_off": dict(cfg=dict(fused_solves=True, fused_pressure=False)),
}
# once refused as not ported: the time-dependent lift (tests/test_torch_fst.py),
# the scalars (tests/test_torch_scalars.py), the finite-difference
# propagator's flag (read by the analyses, not the stepper) and fused_solves
# on a 'consistent' step (the plain solves in f64, as JAX's; K1 in f32,
# tests/test_torch_laplacian.py)
ACCEPTED = {
    "u_bc_fn": dict(kw=dict(u_bc_fn=lambda t: 0.0)),
    "scalars": dict(kw=dict(scalar_diff=(0.01,))),
    "finite_difference": dict(cfg=dict(finite_difference=True)),
    "pressure_operator": dict(cfg=dict(pressure_operator="consistent", fused_solves=True)),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_option_raises(name):
    spec = UNSUPPORTED[name]
    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        NavierStokes(sem, viscosity=0.01, dt=0.01,
                     solver=SolverConfig(**spec.get("cfg", {})), **spec.get("kw", {}))


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_once_refused_option_is_accepted(name):
    spec = ACCEPTED[name]
    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), device="cpu")
    ns = NavierStokes(sem, viscosity=0.01, dt=0.01,
                      solver=SolverConfig(**spec.get("cfg", {})), **spec.get("kw", {}))
    st = ns.step(ns.make_state(torch.zeros(tuple(sem.bm.shape) + (2,), dtype=torch.float64),
                               T=torch.zeros(ns.t_shape, dtype=torch.float64)
                               if ns.nscal else None))
    assert bool(torch.isfinite(st.u).all()) and (st.T is not None) == (name == "scalars")


@pytest.mark.parametrize("cfg", [dict(pressure_precond="schwarz"),
                                 dict(pressure_precond="schwarz", pressure_patch_overlap="node"),
                                 dict(velocity_precond="block")],
                         ids=["schwarz", "schwarz_node", "velocity_block"])
def test_ported_preconditioners_are_built(cfg):
    # once refused as not ported: the constructor builds them, as JAX's does
    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), dtype=torch.float32, device="cpu")
    ns = NavierStokes(sem, viscosity=0.01, dt=0.01, solver=SolverConfig(**cfg))
    schwarz = cfg.get("pressure_precond") == "schwarz"
    assert (sem.pschwarz is not None) == schwarz and (sem.p0Acinv is not None) == schwarz
    assert (ns._vblocks is not None) == ("velocity_precond" in cfg)


@pytest.mark.parametrize("cfg", [dict(pressure_precond="jacobi"),
                                 dict(pressure_patch_overlap="edge"),
                                 dict(velocity_precond="jacobi")])
def test_unknown_preconditioner_names_raise(cfg):
    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        NavierStokes(sem, viscosity=0.01, dt=0.01, solver=SolverConfig(**cfg))


def test_fused_solves_raise_outside_kernel_scope():
    # (f64 fields, once refused here too, now run the plain solves as JAX's:
    # tests/test_torch_laplacian.py)
    with pytest.raises(ValueError, match="order"):  # n = 10: no 64-thread slot
        CylinderCase(nr=2, ntheta=4, order=9, dtype=torch.float32, device="cpu",
                     solver=SolverConfig(fused_solves=True)).make_ns()


def test_bdf_order_is_ignored_as_in_jax():
    # JAX reads SolverConfig.bdf_order nowhere and always ramps BDF1 -> 3:
    # bdf_order=2 steps bit for bit as the default
    steps = []
    for order in (3, 2):
        case = CylinderCase(nr=2, ntheta=4, order=4, device="cpu",
                            solver=SolverConfig(**TIGHT, bdf_order=order))
        ns = case.make_ns()
        steps.append(ns.advance(ns.make_state(case.uniform_flow()), 4))
    assert torch.equal(steps[0].u, steps[1].u) and torch.equal(steps[0].p, steps[1].p)


def shuffled(mesh, seed: int = 0):
    """The mesh with its elements in a seeded random order: the same
    geometry, a numbering whose exchange does not shift-decompose."""
    perm = np.random.default_rng(seed).permutation(mesh.nelem)
    return dataclasses.replace(mesh, **{
        f.name: getattr(mesh, f.name)[perm] for f in dataclasses.fields(mesh)
        if isinstance(getattr(mesh, f.name), np.ndarray)})


@pytest.mark.parametrize("numbering", ["decomposable", "shuffled"])
def test_mixed_precision_takes_fused_ir_where_jax_does(numbering):
    # 2-D 'pnpn2' + fused_solves + mixed_precision: JAX's fused-IR path on a
    # mesh whose exchange shift-decomposes, its legacy path elsewhere
    pick = (lambda m: m) if numbering == "decomposable" else shuffled
    cfg = dict(pressure_precond="block", fused_solves=True)
    jns = JaxNavierStokes(JaxSEM(pick(jax_cylinder_mesh(**MESH))), viscosity=0.01, dt=0.01,
                          solver=JaxSolverConfig(**cfg), mixed_precision=True)
    sem = SEM(pick(cylinder_mesh(**MESH)), device="cpu")
    ns = NavierStokes(sem, viscosity=0.01, dt=0.01, solver=SolverConfig(**cfg),
                      mixed_precision=True)
    assert ns._mixed_ir == jns._mixed_ir == (numbering == "decomposable")
    assert ns._scheme == jns._scheme and ns.p_shape == tuple(jns.p_shape)
    if ns._mixed_ir:
        assert ns.mixed is None and ns.p_shape == sem.p_shape
        assert ns.fused_v is not None and ns.fused_p is not None
        assert ns._ir_cycles == SolverConfig().mixed_ir_cycles == 2
    else:
        assert ns.mixed is not None and ns._scheme == "laplacian"
        assert ns.fused_v is None and ns.fused_p is None and ns._ir_cycles == 0
