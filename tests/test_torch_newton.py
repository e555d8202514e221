"""The port's Newton-Krylov (``algorithms/newton.py``) against the JAX
package's, on the Kovasznay case of ``tests/test_algorithms.py``: the same
mesh family, Dirichlet data, perturbed start and Newton settings, cut to
order 5 and a 5-step horizon of 0.1 for the test's time."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import newton_krylov as jax_newton_krylov
from nekstab_next_tpu.config import NewtonConfig as JaxNewtonConfig
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.mesh.mesh import BoundaryCondition as JaxBC
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.algorithms import newton_krylov
from nekstab_next_tpu_torch.config import NewtonConfig, SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes

RE = 40.0
NEWTON = dict(tol=1e-7, max_iter=20)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kovasznay(x, y):
    lam = RE / 2.0 - np.sqrt(RE**2 / 4.0 + 4.0 * np.pi**2)
    u = 1.0 - np.exp(lam * x) * np.cos(2 * np.pi * y)
    v = lam / (2 * np.pi) * np.exp(lam * x) * np.sin(2 * np.pi * y)
    return np.stack([u, v], axis=-1)


@pytest.fixture(scope="module")
def runs():
    dirichlet = {side: JaxBC.DIRICHLET for side in ("left", "right", "bottom", "top")}
    mesh = box_mesh_2d(4, 4, order=5, x0=-0.5, x1=1.0, y0=-0.5, y1=1.5, bc=dirichlet)
    jsem = JaxSEM(mesh)
    exact = kovasznay(mesh.x, mesh.y)
    cfg = JaxSolverConfig(pressure_precond="block")
    jns = JaxNavierStokes(jsem, viscosity=1.0 / RE, dt=0.01, u_bc=jnp.asarray(exact),
                          solver=cfg)
    pert = 0.02 * np.random.default_rng(0).standard_normal(exact.shape)
    u0 = exact + np.asarray(jsem.vmask) * np.asarray(jsem.dsavg(jnp.asarray(pert)))
    kw = dict(horizon=0.1, nsteps=5, k_dim=30)
    ref = jax_newton_krylov(jns, jnp.asarray(u0), cfg=JaxNewtonConfig(**NEWTON), **kw)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    ns = NavierStokes(sem, viscosity=1.0 / RE, dt=0.01, u_bc=torch.as_tensor(exact),
                      solver=SolverConfig(**dataclasses.asdict(cfg)))
    calls = []
    got = newton_krylov(ns, torch.as_tensor(u0), cfg=NewtonConfig(**NEWTON),
                        callback=lambda *a: calls.append(a), **kw)
    return ref, got, calls, exact, ns, u0


def test_newton_matches_jax(runs):
    ref, got, calls, exact = runs[:4]
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations and got.n_matvecs == ref.n_matvecs
    assert calls == got.history
    # the residual history, iteration by iteration (measured <= 1.3e-8)
    for (i, r, T), (ji, jr, jT) in zip(got.history, ref.history):
        assert i == ji and T == jT
        assert abs(r - jr) <= 1e-6 * jr
    ju = np.asarray(ref.u)
    assert np.linalg.norm(got.u.numpy() - ju) <= 1e-8 * np.linalg.norm(ju)
    # the steady pressure of a few steps from the fixed point
    jp = np.asarray(ref.p)
    assert got.p.shape == jp.shape
    assert np.linalg.norm(got.p.numpy() - jp) <= 1e-6 * np.linalg.norm(jp)
    # the converged field is the Kovasznay flow up to this resolution's
    # spatial and splitting error (dt 0.02)
    assert np.linalg.norm(got.u.numpy() - exact) <= 2e-3 * np.linalg.norm(exact)


def test_newton_config_matches_jax():
    assert dataclasses.asdict(NewtonConfig()) == dataclasses.asdict(JaxNewtonConfig())


@pytest.mark.parametrize("kw", [dict(upo=True), dict(forced=True)], ids=["upo", "forced"])
def test_unported_newton_options_raise(runs, kw):
    # both orbit options are ported (tests/test_torch_upo*.py); together
    # they raise, as in JAX, and each alone runs: one iteration on a 2-step
    # horizon returns the period (moved by the bordered solve for a UPO,
    # the fixed forcing period for a forced orbit)
    with pytest.raises(ValueError, match="mutually exclusive"):
        newton_krylov(None, None, 1.0, 1, upo=True, forced=True)
    ns, u0 = runs[4], runs[5]
    res = newton_krylov(ns, torch.as_tensor(u0), horizon=0.02, nsteps=2, k_dim=3,
                        cfg=NewtonConfig(**dict(NEWTON, max_iter=1, gmres_restarts=1)), **kw)
    assert len(res.history) == 1 and np.isfinite(res.period)
    assert (res.period != 0.02) if kw.get("upo") else (res.period == 0.02)


def test_finite_difference_is_ignored_as_in_jax(runs):
    # JAX's newton_krylov never reads NewtonConfig.finite_difference: Newton
    # takes the exact tangent either way, so the history is the default's,
    # bit for bit (two iterations on a 2-step horizon, GMRES k_dim 3, one
    # cycle: the test's time)
    ns, u0 = runs[4], runs[5]
    kw = dict(horizon=0.02, nsteps=2, k_dim=3)
    cfg = dict(NEWTON, max_iter=2, gmres_restarts=1)
    default = newton_krylov(ns, torch.as_tensor(u0), cfg=NewtonConfig(**cfg), **kw)
    fd = newton_krylov(ns, torch.as_tensor(u0),
                       cfg=NewtonConfig(**cfg, finite_difference=True), **kw)
    assert len(fd.history) == 2 and fd.history == default.history
    assert fd.n_matvecs == default.n_matvecs and torch.equal(fd.u, default.u)
