"""The port's Arnoldi checkpoint/restart (``io/checkpoint.py``,
``krylov/krylov_schur.py`` ``eigs(checkpoint=, checkpoint_steps=)``): the
analogs of ``tests/test_krylov.py``'s resume tests on its dense operator,
the resume from a checkpoint the JAX package wrote (after a restart and
mid-factorization), and ``linear_stability_analysis`` passing both on."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from nekstab_next_tpu.io.checkpoint import ArnoldiCheckpoint as JaxArnoldiCheckpoint
from nekstab_next_tpu.krylov import VectorSpace as JaxVectorSpace
from nekstab_next_tpu.krylov import eigs as jax_eigs
from nekstab_next_tpu_torch.algorithms.stability import linear_stability_analysis
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.io import ArnoldiCheckpoint
from nekstab_next_tpu_torch.krylov import VectorSpace, eigs
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.stepper import NavierStokes

N = 200


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread while this module runs (the test suite runs
    several worker processes at once)."""
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


def space():
    return VectorSpace(dot=lambda a, b: torch.dot(a, b))


@pytest.fixture(scope="module")
def op():
    A = random_operator(7)
    x0 = np.random.default_rng(2).standard_normal(N)
    At = torch.as_tensor(A)
    return A, x0, (lambda v: At @ v)


def test_checkpoint_roundtrip_reads_either_package(tmp_path):
    Q = np.random.default_rng(2).standard_normal((6, 4, 5, 5, 2))
    H = np.random.default_rng(3).standard_normal((6, 5))
    for writer, reader in ((ArnoldiCheckpoint, JaxArnoldiCheckpoint),
                           (JaxArnoldiCheckpoint, ArnoldiCheckpoint)):
        writer(str(tmp_path), session="t").save([Q], H, ncols=3, restart=2)
        ck = reader(str(tmp_path), session="t")
        leaves, H2, ncols, meta = ck.load()
        assert np.array_equal(leaves[0], Q) and np.array_equal(H2, H)
        assert ncols == 3 and int(meta["restart"]) == 2
        ck.clear()
        assert ck.load() is None


def test_eigs_checkpoint_resume(op, tmp_path):
    """(basis, H) persist per restart; a fresh eigs resumes from the saved
    condensed basis, converges, and needs no more matvecs than a cold run."""
    A, x0, mv = op
    ck = ArnoldiCheckpoint(str(tmp_path), session="t")
    eigs(mv, space(), torch.as_tensor(x0), k_dim=12, nev=2, tol=1e-12, max_restarts=2,
         checkpoint=ck)
    assert ck.load() is not None
    r2 = eigs(mv, space(), torch.as_tensor(x0), k_dim=12, nev=2, tol=1e-10, max_restarts=30,
              checkpoint=ck)
    lam = np.sort_complex(np.linalg.eigvals(A))[::-1]
    assert abs(r2.eigenvalues[0] - lam[0]) < 1e-8
    r3 = eigs(mv, space(), torch.as_tensor(x0), k_dim=12, nev=2, tol=1e-10, max_restarts=30)
    assert r2.n_matvecs <= r3.n_matvecs


def test_eigs_midfactorization_resume(op, tmp_path):
    """Killed after 7 matvecs with step checkpointing: the resume runs only
    the remaining matvecs and gives the uninterrupted factorization."""
    A, x0, mv = op
    calls = [0]

    def mv_crash(v):
        calls[0] += 1
        if calls[0] > 7:
            raise RuntimeError("simulated crash")
        return mv(v)

    ck = ArnoldiCheckpoint(str(tmp_path), session="mid")
    with pytest.raises(RuntimeError):
        eigs(mv_crash, space(), torch.as_tensor(x0), k_dim=20, nev=2, tol=1e-10,
             max_restarts=10, checkpoint=ck, checkpoint_steps=True)
    st = ck.load_columns()
    assert st is not None and st[2] == 7
    r2 = eigs(mv, space(), torch.as_tensor(x0), k_dim=20, nev=2, tol=1e-10, max_restarts=0,
              checkpoint=ck, checkpoint_steps=True)
    ref = eigs(mv, space(), torch.as_tensor(x0), k_dim=20, nev=2, tol=1e-10, max_restarts=0)
    assert r2.n_matvecs == ref.n_matvecs - 7
    np.testing.assert_allclose(r2.H, ref.H, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r2.eigenvalues, ref.eigenvalues, rtol=0, atol=1e-12)
    # a bundle-only resume ignores the step files of an earlier stepped run
    fresh = eigs(mv, space(), torch.as_tensor(x0), k_dim=20, nev=2, tol=1e-10,
                 max_restarts=0, checkpoint=ck)
    assert fresh.n_matvecs == ref.n_matvecs


@pytest.mark.parametrize("steps", [False, True], ids=["restart", "midfactorization"])
def test_eigs_resumes_a_checkpoint_jax_wrote(op, tmp_path, steps):
    """JAX's eigs stops (after two restarts, or mid-factorization with step
    files); the port's eigs resumes from its files with the matvecs and to
    the spectrum JAX's own resume reaches."""
    A, x0, mv = op
    jmv = lambda v: jnp.asarray(A) @ v
    jspace = JaxVectorSpace(dot=lambda a, b: jnp.vdot(a, b))
    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    kw = dict(k_dim=12, nev=2, checkpoint_steps=steps)
    for d in (d_port, d_jax):
        if steps:
            calls = [0]

            def crash(v):
                calls[0] += 1
                if calls[0] > 5:
                    raise RuntimeError("simulated crash")
                return jmv(v)

            with pytest.raises(RuntimeError):
                jax_eigs(crash, jspace, jnp.asarray(x0), tol=1e-10, max_restarts=4,
                         checkpoint=JaxArnoldiCheckpoint(str(d), session="s"), **kw)
        else:
            jax_eigs(jmv, jspace, jnp.asarray(x0), tol=1e-14, max_restarts=2,
                     checkpoint=JaxArnoldiCheckpoint(str(d), session="s"), **kw)
    got = eigs(mv, space(), torch.as_tensor(x0), tol=1e-10, max_restarts=30,
               checkpoint=ArnoldiCheckpoint(str(d_port), session="s"), **kw)
    ref = jax_eigs(jmv, jspace, jnp.asarray(x0), tol=1e-10, max_restarts=30,
                   checkpoint=JaxArnoldiCheckpoint(str(d_jax), session="s"), **kw)
    # the two packages' roundoff parts over the remaining restarts: the
    # Schur basis of the converged cluster need not agree, the spectrum does
    assert got.n_matvecs == ref.n_matvecs
    assert np.all(got.residuals[:2] < 1e-10)
    np.testing.assert_allclose(got.eigenvalues[:2], ref.eigenvalues[:2], rtol=0, atol=1e-10)


def test_stability_analysis_passes_the_checkpoint_on(tmp_path):
    """linear_stability_analysis with a checkpoint and step files: a run cut
    after 3 matvecs resumes to the uninterrupted run's eigenvalues."""
    mesh = box_mesh_2d(3, 3, order=4, x0=0, x1=2 * np.pi, y0=0, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    sem = SEM(mesh, device="cpu")
    ns = NavierStokes(sem, viscosity=0.05, dt=0.08,
                      solver=SolverConfig(velocity_tol=1e-12, pressure_tol=1e-12))
    base = torch.zeros(tuple(sem.bm.shape) + (2,), dtype=torch.float64)
    base[..., 0] = 1.0
    kw = dict(horizon=0.16, nsteps=2, k_dim=6, nev=1, tol=1e-9, max_restarts=0)
    ref = linear_stability_analysis(ns, base, **kw)
    ck = ArnoldiCheckpoint(str(tmp_path), session="lsa")
    import nekstab_next_tpu_torch.stepper.linearized as lin
    matvec, calls = lin.LinearizedOperator.matvec, [0]

    def crash(self, q):
        calls[0] += 1
        if calls[0] > 3:
            raise RuntimeError("simulated crash")
        return matvec(self, q)

    lin.LinearizedOperator.matvec = crash
    try:
        with pytest.raises(RuntimeError):
            linear_stability_analysis(ns, base, checkpoint=ck, checkpoint_steps=True, **kw)
    finally:
        lin.LinearizedOperator.matvec = matvec
    got = linear_stability_analysis(ns, base, checkpoint=ck, checkpoint_steps=True, **kw)
    assert got.n_matvecs == ref.n_matvecs - 3
    np.testing.assert_allclose(got.lam[:1], ref.lam[:1], rtol=0, atol=1e-10)
