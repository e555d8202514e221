"""The port's Krylov layer (``nekstab_next_tpu_torch/krylov``) against the
JAX package's, on the dense fixtures of ``tests/test_krylov.py``: the same
operator, the same seed vector, the same dimensions."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from nekstab_next_tpu.krylov import Basis as JaxBasis
from nekstab_next_tpu.krylov import VectorSpace as JaxVectorSpace
from nekstab_next_tpu.krylov import arnoldi_step as jax_arnoldi_step
from nekstab_next_tpu.krylov import eigs as jax_eigs
from nekstab_next_tpu.krylov import gmres as jax_gmres
from nekstab_next_tpu_torch.krylov import (
    Basis,
    VectorSpace,
    arnoldi_factorization,
    arnoldi_step,
    eigs,
    gmres,
    orthogonalize,
)

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


def random_operator(seed=0, decay=0.9):
    """tests/test_krylov.py's operator: a rotated block-diagonal matrix with
    a |mu| ~ 0.996 complex pair, 1.05 and 0.85 leading a decaying tail."""
    rng = np.random.default_rng(seed)
    Q = sla.qr(rng.standard_normal((N, N)))[0]
    A = sla.block_diag(np.array([[0.95, 0.30], [-0.30, 0.95]]), np.diag([1.05, 0.85]),
                       np.diag(decay * rng.uniform(0.0, 0.6, N - 4)))
    return Q @ A @ Q.T


def jax_space():
    return JaxVectorSpace(dot=lambda a, b: jnp.vdot(a, b))


def space():
    return VectorSpace(dot=lambda a, b: torch.dot(a, b))


def seed_vector(seed):
    return np.random.default_rng(seed).standard_normal(N)


def test_arnoldi_matches_jax():
    A = random_operator(1)
    x0 = seed_vector(2)
    k = 30
    jb = JaxBasis(jax_space(), jnp.asarray(x0), capacity=k + 1)
    jb.set(0, jnp.asarray(x0 / np.linalg.norm(x0)))
    jH = np.zeros((k + 1, k))
    for j in range(k):
        jax_arnoldi_step(lambda v: jnp.asarray(A) @ v, jax_space(), jb, jH, j)
    At = torch.as_tensor(A)
    b = Basis(space(), torch.as_tensor(x0), capacity=k + 1)
    b.set(0, torch.as_tensor(x0 / np.linalg.norm(x0)))
    H = np.zeros((k + 1, k))
    for j in range(k):
        arnoldi_step(lambda v: At @ v, space(), b, H, j)
    # the same factorization: H to 1e-12 of its norm
    assert np.linalg.norm(H - jH) < 1e-12 * np.linalg.norm(jH)
    Q = b.Q.numpy().T
    assert np.linalg.norm(A @ Q[:, :k] - Q @ H) < 1e-12 * np.linalg.norm(H)
    assert np.max(np.abs(Q.T @ Q - np.eye(k + 1))) < 1e-12


def test_arnoldi_factorization_and_orthogonalize():
    A = torch.as_tensor(random_operator(1))
    x0 = torch.as_tensor(seed_vector(2))
    k = 12
    b = Basis(space(), x0, capacity=k + 1)
    b.set(0, x0 / x0.norm())
    H = np.zeros((k + 1, k))
    arnoldi_factorization(lambda v: A @ v, space(), b, H, 0, k)
    # the next Arnoldi vector by the unfused path equals the fused one
    w, h = orthogonalize(space(), b, A @ b.get(k - 1), k)
    assert np.allclose(h.numpy()[:k], H[:k, k - 1], rtol=0, atol=1e-12)
    assert float((w / w.norm() - b.get(k)).norm()) < 1e-10


@pytest.mark.parametrize("k_dim,nev,tol,restarts", [(40, 4, 1e-9, 60), (16, 2, 1e-8, 80)],
                         ids=["one-pass", "restart-path"])
def test_eigs_matches_jax(k_dim, nev, tol, restarts):
    seed = 3 if k_dim == 40 else 5
    A = random_operator(seed)
    x0 = seed_vector(seed + 1)
    ref = jax_eigs(lambda v: jnp.asarray(A) @ v, jax_space(), jnp.asarray(x0),
                   k_dim=k_dim, nev=nev, tol=tol, max_restarts=restarts)
    At = torch.as_tensor(A)
    got = eigs(lambda v: At @ v, space(), torch.as_tensor(x0), k_dim=k_dim, nev=nev,
               tol=tol, max_restarts=restarts)
    assert got.n_matvecs == ref.n_matvecs
    assert len(got.history) == len(ref.history)
    if k_dim == 16:
        assert len(got.history) > 1  # actually restarted
    np.testing.assert_allclose(got.eigenvalues[:nev], ref.eigenvalues[:nev],
                               rtol=0, atol=1e-10)
    assert np.all(got.residuals[:nev] < tol)
    # the leading Ritz vector is an eigenvector of A
    re, im = got.mode(0)
    x = re.numpy() + 1j * im.numpy()
    mu = got.eigenvalues[0]
    assert np.linalg.norm(A @ x - mu * x) < 1e-7 * np.linalg.norm(x)


def test_orthonormality_audit_matches_jax():
    A = random_operator(9)
    x0 = seed_vector(3)
    ref = jax_eigs(lambda v: jnp.asarray(A) @ v, jax_space(), jnp.asarray(x0),
                   k_dim=20, nev=2, tol=1e-8, max_restarts=20)
    At = torch.as_tensor(A)
    got = eigs(lambda v: At @ v, space(), torch.as_tensor(x0), k_dim=20, nev=2,
               tol=1e-8, max_restarts=20)
    a, b = got.orthonormality_audit(space(), ncols=10), ref.orthonormality_audit(jax_space(), ncols=10)
    assert a < 1e-12 and b < 1e-12
    assert got.orthonormality_audit(space()) < 1e-12


def test_gmres_matches_jax():
    rng = np.random.default_rng(7)
    A = np.eye(N) + 0.5 * rng.standard_normal((N, N)) / np.sqrt(N)
    b = rng.standard_normal(N)
    xj, infoj = jax_gmres(lambda v: jnp.asarray(A) @ v, jax_space(), jnp.asarray(b),
                          k_dim=40, tol=1e-10, max_restarts=20)
    At = torch.as_tensor(A)
    x, info = gmres(lambda v: At @ v, space(), torch.as_tensor(b), k_dim=40,
                    tol=1e-10, max_restarts=20)
    assert info["converged"] and info["iterations"] == infoj["iterations"]
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) < 1e-10 * np.linalg.norm(np.asarray(xj))
    assert np.linalg.norm(A @ x.numpy() - b) < 1e-8


def test_gmres_restarts_match_jax():
    # k_dim 8 forces restarts (and the x0 path of every later restart)
    rng = np.random.default_rng(8)
    A = np.eye(N) + 0.3 * rng.standard_normal((N, N)) / np.sqrt(N)
    b = rng.standard_normal(N)
    xj, infoj = jax_gmres(lambda v: jnp.asarray(A) @ v, jax_space(), jnp.asarray(b),
                          k_dim=8, tol=1e-10, max_restarts=40)
    At = torch.as_tensor(A)
    x, info = gmres(lambda v: At @ v, space(), torch.as_tensor(b), k_dim=8, tol=1e-10,
                    max_restarts=40)
    assert info["iterations"] == infoj["iterations"] > 9
    assert np.linalg.norm(x.numpy() - np.asarray(xj)) < 1e-10 * np.linalg.norm(np.asarray(xj))


def test_batched_dots_and_tuple_vectors():
    # a vector that is a tuple of tensors: the batched dots equal the
    # column-by-column ones, and the combination is the weighted sum
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (6, 5)))
    sp = VectorSpace(lambda a, b: torch.sum(a[0] * b[0] * w) + a[1] @ b[1])
    cols = [(torch.as_tensor(rng.standard_normal((6, 5))), torch.as_tensor(rng.standard_normal(3)))
            for _ in range(4)]
    b = Basis(sp, cols[0], capacity=5)
    for j, c in enumerate(cols):
        b.set(j, c)
    v = cols[1]
    d = b.dots(v, ncols=3).numpy()
    assert d.shape == (5,) and d[3] == 0 and d[4] == 0
    for j in range(3):
        assert abs(d[j] - float(sp.dot(cols[j], v))) < 1e-13 * abs(d[j])
    y = np.array([0.5, -1.0, 2.0, 0.25, 0.0])
    comb = b.combine(y)
    ref = [sum(y[j] * cols[j][i] for j in range(4)) for i in range(2)]
    for c, r in zip(comb, ref):
        assert torch.allclose(c, r, rtol=0, atol=1e-13)


def test_f32_basis_stays_f32():
    A = torch.as_tensor(random_operator(3), dtype=torch.float32)
    x0 = torch.as_tensor(seed_vector(4), dtype=torch.float32)
    b = Basis(space(), x0, capacity=6)
    assert b.Q.dtype == torch.float32
    # host f64 coefficients do not promote the f32 basis
    assert b.combine(np.ones(6)).dtype == torch.float32
    res = eigs(lambda v: A @ v, space(), x0, k_dim=24, nev=2, tol=1e-4, max_restarts=10)
    assert res.basis.Q.dtype == torch.float32
    assert res.mode(0)[0].dtype == torch.float32
    assert res.orthonormality_audit(space()) < 1e-5
    dense = sla.eigvals(A.double().numpy())
    dense = dense[np.argsort(-np.abs(dense))]
    assert np.min(np.abs(dense[:3] - res.eigenvalues[0])) < 1e-4


def test_eigs_checkpoint_raises():
    # the checkpoint resume is ported (tests/test_torch_checkpoint.py); a
    # checkpoint that cannot load raises before any matvec
    A = torch.as_tensor(random_operator(3))
    calls = []
    with pytest.raises(AttributeError, match="load"):
        eigs(lambda v: calls.append(1) or A @ v, space(), torch.ones(N), k_dim=4,
             checkpoint=object())
    assert not calls
