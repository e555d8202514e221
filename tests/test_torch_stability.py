"""The port's stability pipeline (``algorithms/stability.py`` and the
wavemaker of ``postproc/sensitivity.py``) against the JAX package's, on the
32-element cylinder with the same noise seed; and the port's direct and
adjoint spectra against each other where Krylov-Schur converges (the 4x4
cavity box)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms import linear_stability_analysis as jax_lsa
from nekstab_next_tpu.cases.cylinder import CylinderCase as JaxCylinderCase
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.postproc import wave_maker as jax_wave_maker
from nekstab_next_tpu_torch.algorithms import (
    linear_stability_analysis,
    velocity_space,
)
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.postproc import wave_maker
from nekstab_next_tpu_torch.stepper import NavierStokes

MESH = dict(nr=4, ntheta=8, order=6)
# 3 steps a matvec (cut for the test's time), one Krylov-Schur pass
# (tests/test_torch_krylov.py holds the restart path against JAX)
EIGS = dict(nsteps=3, k_dim=12, nev=2, tol=1e-6, max_restarts=0, seed=1234)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def results():
    """Direct and adjoint analyses about the uniform flow in both packages,
    f64, solves at 1e-12 (the Ritz values of an unconverged pass follow
    the solver tolerance, amplified by 1/T in lambda)."""
    cfg = JaxSolverConfig(pressure_tol=1e-12, velocity_tol=1e-12, pressure_precond="block")
    jcase = JaxCylinderCase(**MESH, solver=cfg)
    jns = jcase.make_ns()
    sem = sem_from_arrays(sem_arrays(jcase.sem), device="cpu")
    ns = NavierStokes(sem, viscosity=jns.nu, dt=jns.dt,
                      u_bc=torch.as_tensor(np.array(jcase.u_bc)),
                      sponge_ref=torch.as_tensor(np.array(jcase.sponge_ref)),
                      solver=SolverConfig(**dataclasses.asdict(cfg)))
    base = np.array(jcase.uniform_flow())
    out = {}
    for mode in ("direct", "adjoint"):
        out[mode] = (
            jax_lsa(jns, jnp.asarray(base), horizon=3 * jns.dt, mode=mode, **EIGS),
            linear_stability_analysis(ns, torch.as_tensor(base), horizon=3 * jns.dt,
                                      mode=mode, **EIGS),
        )
    return jcase, sem, out


@pytest.mark.parametrize("mode", ["direct", "adjoint"])
def test_cylinder_spectrum_matches_jax(results, mode):
    _, _, out = results
    ref, got = out[mode]
    assert got.n_matvecs == ref.n_matvecs == 12
    np.testing.assert_allclose(got.lam[:2], ref.lam[:2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.residuals[:2], ref.residuals[:2], rtol=1e-6)
    assert got.horizon == pytest.approx(ref.horizon, rel=1e-15)
    for (re, im), (jre, jim) in zip(got.modes, ref.modes):
        for a, b in ((re, jre), (im, jim)):
            b = np.asarray(b)
            assert np.linalg.norm(a.numpy() - b) <= 1e-6 * np.linalg.norm(b)
    np.testing.assert_allclose(got.mode_gradient_norms, ref.mode_gradient_norms, rtol=1e-6)
    assert got.eigresult.orthonormality_audit(velocity_space(results[1])) < 1e-12


def test_cylinder_wavemaker_matches_jax(results):
    jcase, sem, out = results
    (jd, d), (ja, a) = out["direct"], out["adjoint"]
    ref = np.asarray(jax_wave_maker(jcase.sem, *jd.modes[0], *ja.modes[0]))
    got = wave_maker(sem, *d.modes[0], *a.modes[0]).numpy()
    assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref)


def test_cavity_adjoint_spectrum_equals_direct():
    # the adjoint operator has the direct operator's eigenvalues; on the
    # cavity of tests/test_linearized.py (dt 0.08, so the leading Stokes-like
    # modes separate within 3 steps) both runs converge in one pass
    mesh = box_mesh_2d(4, 4, order=5, x0=0, x1=1, y0=0, y1=1)
    sem = SEM(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=0.05, dt=0.08, solver=SolverConfig(
        velocity_tol=1e-12, pressure_tol=1e-12, pressure_precond="block"))
    q = 0.1 * np.random.default_rng(0).standard_normal(tuple(sem.bm.shape) + (2,))
    base = sem.vmask * sem.dsavg(torch.as_tensor(q))
    kw = dict(horizon=0.24, nsteps=3, k_dim=16, nev=2, tol=1e-7, max_restarts=0)
    d = linear_stability_analysis(ns, base, mode="direct", **kw)
    a = linear_stability_analysis(ns, base, mode="adjoint", **kw)
    assert np.all(d.residuals[:2] < 1e-7) and np.all(a.residuals[:2] < 1e-7)
    np.testing.assert_allclose(a.lam[:2], d.lam[:2], rtol=0, atol=1e-8)


def test_unported_analyses_raise(results):
    # floquet=True is ported (tests/test_torch_orbit.py holds its
    # operator), and so are coupled scalars (tests/test_torch_rb_stability.py):
    # what raises is an adjoint analysis on the finite-difference
    # propagator, which has none (as in JAX), and an unknown mode
    _, sem, _ = results
    ns = NavierStokes(sem, viscosity=0.05, dt=0.08, solver=SolverConfig(finite_difference=True))
    base = torch.zeros(tuple(sem.bm.shape) + (2,), dtype=sem.dtype)
    with pytest.raises(NotImplementedError, match="no adjoint"):
        linear_stability_analysis(ns, base, 1.0, 1, mode="adjoint", k_dim=4)
    with pytest.raises(ValueError, match="mode"):
        linear_stability_analysis(ns, base, 1.0, 1, mode="transpose")
