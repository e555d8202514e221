"""The port's Floquet-preconditioned harmonic resolvent
(``algorithms/harmonic.py``): the spectral preconditioner on operators with
known spectra (tests/test_harmonic.py:33,71) and the whole analysis against
the JAX package's on the same box, seeds and settings (f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.algorithms.harmonic import (
    harmonic_resolvent_analysis as jax_harmonic_resolvent_analysis)
from nekstab_next_tpu.mesh import box_mesh_2d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.stepper import NavierStokes as JaxNavierStokes
from nekstab_next_tpu_torch.algorithms import harmonic_resolvent_analysis
from nekstab_next_tpu_torch.algorithms.harmonic import (
    SpectralPreconditioner,
    preconditioned_gmres,
)
from nekstab_next_tpu_torch.algorithms.stability import velocity_space
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.stepper import NavierStokes
from nekstab_next_tpu_torch.utils.noise import velocity_noise


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores.  And no
    ``opt_einsum`` path search: on these tiny tensors it is most of the
    plain step's host time (it changes only the contraction order)."""
    threads = torch.get_num_threads()
    opt = torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    yield
    torch.set_num_threads(threads)
    torch.backends.opt_einsum.enabled = opt


@pytest.fixture(scope="module")
def cavity():
    """The 2 x 2 order-5 cavity of tests/test_harmonic.py in both packages."""
    mesh = box_mesh_2d(2, 2, order=5)
    jsem = JaxSEM(mesh)
    return mesh, jsem, sem_from_arrays(sem_arrays(jsem), device="cpu")


def orthonormal_fields(sem, space, k, seed=0):
    vs = []
    for i in range(k):
        v = velocity_noise(sem, seed=seed + 17 * i)
        for w in vs:
            v = v - space.dot(w, v) * w
        vs.append(v / torch.sqrt(space.dot(v, v)))
    return vs


def test_spectral_preconditioner_near_singular_real_mode(cavity):
    """(I - M) with a multiplier at 0.999: the preconditioned GMRES converges
    in a handful of iterations to the analytic inverse."""
    sem = cavity[2]
    space = velocity_space(sem)
    e1, e2 = orthonormal_fields(sem, space, 2, seed=5)
    mu1, mu2, rest = 0.999, 0.6, 0.1

    def M(x):
        c1, c2 = space.dot(e1, x), space.dot(e2, x)
        return mu1 * c1 * e1 + mu2 * c2 * e2 + rest * (x - c1 * e1 - c2 * e2)

    zero = torch.zeros_like(e1)
    pc = SpectralPreconditioner(sem, [(mu1, (e1, zero), (e1, zero)),
                                      (mu2, (e2, zero), (e2, zero))])
    b = velocity_noise(sem, seed=99)
    b = b / torch.sqrt(space.dot(b, b))
    x, info = preconditioned_gmres(lambda x: x - M(x), space, b, pc, k_dim=8, tol=1e-10)
    assert info["converged"] and info["iterations"] <= 6, info
    c1, c2 = space.dot(e1, b), space.dot(e2, b)
    exact = (c1 / (1 - mu1) * e1 + c2 / (1 - mu2) * e2
             + (b - c1 * e1 - c2 * e2) / (1 - rest))
    assert float(torch.sqrt(space.dot(x - exact, x - exact))) < 1e-8


def test_spectral_preconditioner_complex_pair(cavity):
    """A complex multiplier pair rho e^{+-i th} rotating a 2-plane: one
    listed mode (factor 2) captures both partners."""
    sem = cavity[2]
    space = velocity_space(sem)
    e1, e2 = orthonormal_fields(sem, space, 2, seed=11)
    rho, th = 0.995, 0.3

    def M(x):
        c1, c2 = space.dot(e1, x), space.dot(e2, x)
        r1 = rho * (np.cos(th) * c1 - np.sin(th) * c2)
        r2 = rho * (np.sin(th) * c1 + np.cos(th) * c2)
        return r1 * e1 + r2 * e2 + 0.2 * (x - c1 * e1 - c2 * e2)

    v_re, v_im = e1 / np.sqrt(2), -e2 / np.sqrt(2)
    pc = SpectralPreconditioner(sem, [(rho * np.exp(1j * th), (v_re, v_im), (v_re, v_im))])
    b = velocity_noise(sem, seed=123)
    A = lambda x: x - M(x)
    x, info = preconditioned_gmres(A, space, b, pc, k_dim=10, tol=1e-10)
    assert info["converged"] and info["iterations"] <= 8, info
    r = A(x) - b
    assert float(torch.sqrt(space.dot(r, r))) < 1e-8 * float(torch.sqrt(space.dot(b, b)))


def test_harmonic_resolvent_matches_jax(cavity):
    """tests/test_harmonic.py:101's Stokes-like cavity end to end (two
    eigensolves, the multiplier pairing, the preconditioned periodicity
    solve, the quarter-period phase): the gain, the response and the
    multipliers against JAX's (1e-6)."""
    mesh, jsem, sem = cavity
    dt = 2 * np.pi / 8
    f = np.asarray(velocity_noise(sem, seed=7))
    kw = dict(omega=1.0, n_precond_modes=1, eig_k_dim=6, eig_tol=1e-4,
              steps_per_period=8, gmres_k_dim=10, gmres_tol=1e-7)
    ref = jax_harmonic_resolvent_analysis(
        JaxNavierStokes(jsem, viscosity=0.5, dt=dt), jnp.zeros(f.shape), f_re=jnp.asarray(f),
        **kw)
    got = harmonic_resolvent_analysis(
        NavierStokes(sem, viscosity=0.5, dt=dt), torch.zeros(f.shape, dtype=torch.float64),
        f_re=torch.as_tensor(f), **kw)
    assert np.isfinite(got.gain) and abs(got.gain - ref.gain) <= 1e-6 * ref.gain
    assert got.precond_rank == ref.precond_rank >= 1
    np.testing.assert_allclose(got.floquet_multipliers, np.asarray(ref.floquet_multipliers),
                               rtol=0, atol=1e-6)
    assert np.all(np.abs(got.floquet_multipliers) < 1.0)  # Stokes: stable
    for g, r in zip(got.response, ref.response):
        r = np.asarray(r)
        assert np.linalg.norm(g.numpy() - r) <= 1e-6 * np.linalg.norm(r)
