"""The port's 3-D PnPn-2 tangent propagator and its adjoint against the JAX
package's, and ``svds`` on it through ``transient_growth_analysis`` on the
tiny cube of ``tests/test_cube_case.py``.

The port's SEM3 takes the JAX SEM3's factors (``interop``); inputs come
from numpy with a seed.  ``tests/test_torch_generic3.py`` has the 3-D
resolvent and SFD checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import transient_growth_analysis as jax_growth
from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_3d as jax_box_mesh_3d
from nekstab_next_tpu.ops import SEM3 as JaxSEM3
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JaxLinearizedOperator
from nekstab_next_tpu_torch.algorithms import transient_growth_analysis
from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem3_arrays, sem3_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_3d
from nekstab_next_tpu_torch.ops.core3 import SEM3
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=2000,
             velocity_maxiter=2000)
NU, DT, NSTEPS = 0.05, 0.01, 4
# the tiny cube of tests/test_cube_case.py
TINY_CUBE = dict(reynolds=200.0, h=1.0, lx=6.0, ly=2.0, lz=2.0, cube_x=2.5, cube_z=0.5,
                 nx=6, ny=2, nz=2, order=4, delta=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and no ``opt_einsum`` path search while this
    module runs (see ``tests/test_torch_orbit.py``)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture(scope="module")
def periodic3():
    """``tests/test_3d.py``'s periodic3 in both packages (the port on the
    JAX factors), its seeded base and the pair (q, w) of
    ``test_adjoint_consistency_3d``."""
    L = 2 * np.pi
    mesh = jax_box_mesh_3d(3, 3, 3, order=5, x1=L, y1=L, z1=L,
                           periodic_x=True, periodic_y=True, periodic_z=True)
    jsem = JaxSEM3(mesh)
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    rng = np.random.default_rng(7)
    shape = mesh.x.shape + (3,)
    base = 0.1 * rng.standard_normal(shape)
    q = rng.standard_normal(shape)
    w = rng.standard_normal(shape)
    return jsem, sem, base, q, w


def bm_dot(sem, a, b) -> float:
    return float(torch.sum(sem.bm[..., None] * a * b))


def test_tangent_matvec_and_rmatvec_match_jax(periodic3):
    jsem, sem, base, q, w = periodic3
    jns = JaxNavierStokes(jsem, viscosity=NU, dt=DT, solver=JaxSolverConfig(**TIGHT))
    jop = JaxLinearizedOperator(jns, jnp.asarray(base), nsteps=NSTEPS)
    ns = NavierStokes(sem, viscosity=NU, dt=DT, solver=SolverConfig(**TIGHT))
    op = LinearizedOperator(ns, torch.as_tensor(base), nsteps=NSTEPS)
    Mq = op.matvec(torch.as_tensor(q))
    assert rel(jop.matvec(jnp.asarray(q)), Mq) < 1e-10
    Mtw = op.rmatvec(torch.as_tensor(w))
    assert rel(jop.rmatvec(jnp.asarray(w)), Mtw) < 1e-10
    # the adjoint identity in the bm product, at inner tolerances of 1e-12
    lhs = bm_dot(sem, Mq, torch.as_tensor(w))
    rhs = bm_dot(sem, torch.as_tensor(q), Mtw)
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1e-3), (lhs, rhs)


def test_adjoint_consistency_3d():
    """``tests/test_3d.py``'s check on the port at the default tolerances,
    with its bound."""
    L = 2 * np.pi
    mesh = box_mesh_3d(3, 3, 3, order=5, x1=L, y1=L, z1=L,
                       periodic_x=True, periodic_y=True, periodic_z=True)
    sem = SEM3(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=NU, dt=DT)
    rng = np.random.default_rng(7)
    shape = mesh.x.shape + (3,)
    base = torch.as_tensor(0.1 * rng.standard_normal(shape))
    q = torch.as_tensor(rng.standard_normal(shape))
    w = torch.as_tensor(rng.standard_normal(shape))
    op = LinearizedOperator(ns, base, nsteps=NSTEPS)
    lhs = bm_dot(sem, op.matvec(q), w)
    rhs = bm_dot(sem, q, op.rmatvec(w))
    assert abs(lhs - rhs) < 1e-6 * max(abs(lhs), 1e-3), (lhs, rhs)


def test_cube_transient_growth_matches_jax():
    """``test_cube_transient_growth_smoke``'s svds in both packages from one
    seeded start: the same Golub-Kahan iteration on the same operator, so G
    agrees whatever the tolerance (a short one here, for time: 3 steps,
    k_dim 4, tol 0.1, 12 matvecs)."""
    jcase = JaxCube(**TINY_CUBE)
    case = CubeRoughnessCase(**TINY_CUBE, device="cpu")
    assert case.dt == jcase.dt
    base = np.array(jcase.initial_flow())
    x0 = np.random.default_rng(11).standard_normal(base.shape) * np.asarray(jcase.sem.vmask)
    kw = dict(horizon=3 * case.dt, nsteps=3, nsv=1, k_dim=4, tol=1e-1)
    ref = jax_growth(jcase.make_ns(), jnp.asarray(base), x0=jnp.asarray(x0), **kw)
    got = transient_growth_analysis(case.make_ns(), torch.as_tensor(base),
                                    x0=torch.as_tensor(x0), **kw)
    assert got.gains.shape[0] >= 1 and np.isfinite(got.gains[0]) and got.gains[0] > 0.0
    assert got.n_matvecs == ref.n_matvecs
    assert abs(got.gains[0] / ref.gains[0] - 1.0) < 1e-6, (got.gains, ref.gains)
