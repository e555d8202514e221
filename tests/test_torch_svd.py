"""The port's singular-value solvers (``krylov/svd.py``: Golub-Kahan
``svds`` with thick restarts, and ``svds_normal``) against dense SVD and
the JAX package's, on the dense fixtures of ``tests/test_krylov.py`` (N =
200, the same matrices and seed vectors).

Tolerances: against JAX the same algorithm in the same order, so the
singular values agree to 1e-12 relative, the right vectors to 1e-7 up to
sign, and the matvec counts are equal; against dense SVD ``svds`` to 1e-9
relative and ``svds_normal`` to 1e-6 (its sigma^2 conditioning, as
``tests/test_krylov.py`` holds it).  And ``svds`` on the Stokes
propagator through ``transient_growth_analysis`` (the
``tests/test_algorithms.py`` ``test_transient_growth_stokes`` analog):
G = 1 within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from nekstab_next_tpu.krylov import VectorSpace as JaxVectorSpace
from nekstab_next_tpu.krylov.svd import svds as jax_svds
from nekstab_next_tpu.krylov.svd import svds_normal as jax_svds_normal
from nekstab_next_tpu_torch.algorithms import transient_growth_analysis
from nekstab_next_tpu_torch.krylov import VectorSpace, svds, svds_normal
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

N = 200


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs: the test suite runs
    several worker processes at once, and torch's thread pools on tiny
    tensors slow down many-fold when they contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def with_spectrum(seed: int, s: np.ndarray):
    """A random N x N matrix (tests/test_krylov.py's construction) with its
    singular values replaced by ``s``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) / np.sqrt(N)
    U, _, Vt = sla.svd(A)
    return U @ np.diag(s) @ Vt, rng


def spread(seed: int) -> np.ndarray:
    """test_svds_matches_dense's spectrum: the random one with its top two
    singular values spread to 3 and 2."""
    rng = np.random.default_rng(seed)
    s = sla.svd(rng.standard_normal((N, N)) / np.sqrt(N), compute_uv=False)
    s[0], s[1] = 3.0, 2.0
    return s


CASES = {
    # test_svds_matches_dense
    "dense": dict(seed=8, s=spread(8), kw=dict(nsv=2, k_dim=30, tol=1e-10)),
    # test_svds_ill_conditioned: condition number 1e6
    "ill_conditioned": dict(seed=11, s=np.logspace(3, -3, N),
                            kw=dict(nsv=3, k_dim=30, tol=1e-12)),
    # test_svds_thick_restart_converges: k_dim too small for one sweep
    "thick_restart": dict(seed=12, s=1.0 + np.arange(N)[::-1] * 0.1,
                          kw=dict(nsv=2, k_dim=12, tol=1e-10, max_restarts=40)),
}


def operators(A):
    At = torch.as_tensor(A)
    Aj = jnp.asarray(A)
    return ((lambda v: At @ v, lambda v: At.T @ v),
            (lambda v: Aj @ v, lambda v: Aj.T @ v))


@pytest.mark.parametrize("name", sorted(CASES))
def test_svds_matches_dense_and_jax(name):
    c = CASES[name]
    A, rng = with_spectrum(c["seed"], c["s"])
    x0 = rng.standard_normal(N)
    (mv, rmv), (jmv, jrmv) = operators(A)
    res = svds(mv, rmv, VectorSpace(lambda a, b: torch.dot(a, b)), torch.as_tensor(x0),
               **c["kw"])
    ref = jax_svds(jmv, jrmv, JaxVectorSpace(lambda a, b: jnp.vdot(a, b)),
                   jnp.asarray(x0), **c["kw"])
    s = np.sort(c["s"])[::-1]
    nsv = c["kw"]["nsv"]
    np.testing.assert_allclose(res.sigma, s[:nsv], rtol=1e-9, atol=0)
    np.testing.assert_allclose(res.sigma, ref.sigma, rtol=1e-12, atol=0)
    assert res.n_matvecs == ref.n_matvecs
    assert np.all(res.residuals <= c["kw"]["tol"] * np.maximum(res.sigma, 1.0))
    for i in range(nsv):
        # A v = sigma u, and the vectors are JAX's up to sign
        av = A @ res.right[i].numpy()
        assert np.linalg.norm(av - res.sigma[i] * res.left[i].numpy()) < 1e-6 * s[i]
        sign = np.sign(np.dot(res.right[i].numpy(), np.asarray(ref.right[i])))
        np.testing.assert_allclose(sign * res.right[i].numpy(), np.asarray(ref.right[i]),
                                   rtol=0, atol=1e-7)


def test_svds_normal_matches_dense_and_jax():
    c = CASES["ill_conditioned"]
    A, rng = with_spectrum(c["seed"], c["s"])
    x0 = rng.standard_normal(N)
    (mv, rmv), (jmv, jrmv) = operators(A)
    kw = dict(nsv=2, k_dim=30, tol=1e-10)
    res = svds_normal(mv, rmv, VectorSpace(lambda a, b: torch.dot(a, b)),
                      torch.as_tensor(x0), **kw)
    ref = jax_svds_normal(jmv, jrmv, JaxVectorSpace(lambda a, b: jnp.vdot(a, b)),
                          jnp.asarray(x0), **kw)
    s = c["s"]
    assert np.max(np.abs(res.sigma - s[:2]) / s[:2]) < 1e-6
    np.testing.assert_allclose(res.sigma, ref.sigma, rtol=1e-12, atol=0)
    assert res.n_matvecs == ref.n_matvecs
    for i in range(2):
        av = A @ res.right[i].numpy()
        assert np.linalg.norm(av - res.sigma[i] * res.left[i].numpy()) < 1e-6 * s[i]


def test_svds_keeps_a_float32_basis_float32():
    # host f64 coefficients must not promote the f32 Lanczos bases
    A, rng = with_spectrum(8, spread(8))
    At = torch.as_tensor(A, dtype=torch.float32)
    res = svds(lambda v: At @ v, lambda v: At.T @ v,
               VectorSpace(lambda a, b: torch.dot(a, b)),
               torch.as_tensor(rng.standard_normal(N), dtype=torch.float32),
               nsv=1, k_dim=30, tol=1e-5)
    assert res.right[0].dtype == res.left[0].dtype == torch.float32
    assert abs(res.sigma[0] - 3.0) < 1e-4


def test_transient_growth_stokes():
    # the Stokes operator about u = 0 in a periodic box is normal: G(T) =
    # |mu_max|^2 = 1 (the constant modes); viscosity 1 (JAX's test: 0.1 over
    # 20 steps) spreads the other modes, e^{-nu |k|^2 T}, from 1 in 3 steps
    mesh = box_mesh_2d(3, 3, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    sem = SEM(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=1.0, dt=0.02)
    base = torch.zeros(tuple(sem.bm.shape) + (2,), dtype=sem.dtype)
    nsteps = 3
    res = transient_growth_analysis(ns, base, horizon=ns.dt * nsteps, nsteps=nsteps,
                                    nsv=1, k_dim=8, tol=1e-8)
    assert abs(res.gains[0] - 1.0) < 1e-6
