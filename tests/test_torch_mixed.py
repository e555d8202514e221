"""The port's fused local Helmholtz apply (K4, ops/fused_helmholtz.py) and
mixed-precision solves (ops/mixed.py) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version (a CPU tensor never
reaches the kernel); the JAX kernel runs through the Pallas interpreter, as
in test_pallas.py, on the same meshes: the graded 3 x 3 box at order 6 of
that file, and a carved cube (cube-roughness geometry, 44 elements at
order 3).  The port's SEMs are built from the JAX SEMs' arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.ops.core import SEM as JaxSEM
from nekstab_next_tpu.ops.mixed import MixedPrecision as JaxMixed
from nekstab_next_tpu.ops.mixed import elliptic_solve_mixed as jax_solve_mixed
from nekstab_next_tpu.ops.pallas_kernels import FusedHelmholtz as JaxFused
from nekstab_next_tpu_torch.interop import (
    sem3_arrays,
    sem3_from_arrays,
    sem_arrays,
    sem_from_arrays,
)
from nekstab_next_tpu_torch.mesh import box_mesh_2d
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.ops.fused_helmholtz import FusedHelmholtz
from nekstab_next_tpu_torch.ops.mixed import MixedPrecision, elliptic_solve_mixed

CUBE = dict(reynolds=60.0, h=1.0, lx=5.0, ly=3.0, lz=3.0, cube_x=2.5,
            nx=5, ny=3, nz=3, order=3, delta=1.0, target_cfl=0.2)


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
def sem2():
    jsem = JaxSEM(jax_box_mesh_2d(3, 3, order=6, grading_x=1.3))
    return jsem, sem_from_arrays(sem_arrays(jsem), device="cpu")


@pytest.fixture(scope="module")
def sem3():
    jsem = JaxCube(**CUBE).sem
    return jsem, sem3_from_arrays(sem3_arrays(jsem), device="cpu")


def _field(sem, seed, C=None):
    shape = (sem.nelem,) + (sem.n,) * sem.ndim + ((C,) if C else ())
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("dim,C,h1,h2", [
    (2, None, 0.7, 1.3), (2, 2, 1.0 / 60.0, 110.0), (3, None, 1.0, 0.4), (3, 3, 0.03, 50.0),
])
def test_fused_helmholtz_plain_matches_jax_kernel(sem2, sem3, dim, C, h1, h2):
    jsem, sem = sem2 if dim == 2 else sem3
    u = _field(sem, dim + (C or 0), C).astype(np.float32)
    jk = JaxFused(jsem, block_e=8, interpret=True)
    cols = [u] if C is None else [u[..., c] for c in range(C)]
    ref = np.stack([np.asarray(jk.apply(jnp.asarray(v), h1, h2)) for v in cols], axis=-1)
    ref = ref[..., 0] if C is None else ref
    k4 = FusedHelmholtz(sem)
    got = k4.apply(torch.as_tensor(u), h1, h2)
    assert got.dtype == torch.float32 and tuple(got.shape) == u.shape
    # both are f32 (Kronecker matmuls against sum-factorised einsums): the
    # JAX kernel's own gate against helmholtz_local (test_pallas.py:25-44)
    scale = float(np.max(np.abs(ref)))
    assert np.allclose(got.numpy(), ref, atol=2e-5 * scale)
    assert k4.launches == 0  # a CPU tensor runs the plain version


def test_fused_helmholtz_plain_is_f32_helmholtz_local(sem3):
    _, sem = sem3
    u = torch.as_tensor(_field(sem, 7, 3))
    got = FusedHelmholtz(sem).plain(u.float(), 0.5, 2.0)
    ref = torch.stack([sem.helmholtz_local(u[..., c], 0.5, 2.0) for c in range(3)], -1)
    # f32 factors and arithmetic against the f64 operator
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < 1e-5


def test_fused_helmholtz_launch_checks(sem2):
    # the kernel path takes only CUDA tensors; anything else raises before a
    # pointer reaches C, and nothing falls back to the plain version
    _, sem = sem2
    k4 = FusedHelmholtz(sem)
    x = torch.zeros(k4.node_shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k4._check(x)
    with pytest.raises(ValueError, match="CUDA"):
        k4.apply(x.to("meta"), 1.0, 1.0)
    assert k4.launches == 0
    with pytest.raises(ValueError, match="order"):
        FusedHelmholtz(SEM(box_mesh_2d(2, 2, order=2), device="cpu"))


def test_mixed_precision_refinement_matches_jax(sem2):
    # test_pallas.py:47-64's Dirichlet Helmholtz problem.  Both refine to
    # f64 (3 cycles at inner accuracy 3e-6): agreement well past f32
    jsem, sem = sem2
    rhs = np.asarray(jsem.bm) * _field(sem, 2)
    h1, h2 = 1.0, 0.5
    ref = jax_solve_mixed(jsem, JaxMixed(jsem, block_e=8, interpret=True), h1, h2,
                          jnp.asarray(rhs), jsem.tmask, maxiter=400)
    got = elliptic_solve_mixed(sem, MixedPrecision(sem), h1, h2, torch.as_tensor(rhs),
                               sem.tmask, maxiter=400)
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-9


def test_mixed_precision_pressure_poisson_matches_jax(sem2):
    # test_pallas.py:67-84's pure-Neumann Poisson: nullspace projection and
    # the f32 Q1 coarse level
    jsem, sem = sem2
    raw = _field(sem, 3)
    rhs = np.array(jsem.bm * (jnp.asarray(raw) - jsem.mean(jnp.asarray(raw))))
    ref = jax_solve_mixed(jsem, JaxMixed(jsem, block_e=8, interpret=True), 1.0, 0.0,
                          jnp.asarray(rhs), jsem.pmask, maxiter=600,
                          project_mean=True, coarse=True, cycles=4)
    got = elliptic_solve_mixed(sem, MixedPrecision(sem), 1.0, 0.0, torch.as_tensor(rhs),
                               sem.pmask, maxiter=600, project_mean=True, coarse=True,
                               cycles=4)
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-9


@pytest.mark.parametrize("which", ["velocity", "pressure"])
def test_mixed_precision_3d_matches_jax(sem3, which):
    # the cube step's two solves: velocity Helmholtz (3 components, vmask)
    # and the outflow-pinned pressure Poisson with the 3-D coarse level
    jsem, sem = sem3
    if which == "velocity":
        rhs, mask, h1, h2, kw = _field(sem, 4, 3), "vmask", 1.0 / 60.0, 110.0, {}
    else:
        rhs, mask, h1, h2, kw = _field(sem, 5), "pmask", 1.0, 0.0, dict(coarse=True)
    rhs = rhs * (np.asarray(jsem.bm)[..., None] if rhs.ndim == 5 else np.asarray(jsem.bm))
    ref = jax_solve_mixed(jsem, JaxMixed(jsem, block_e=8, interpret=True), h1, h2,
                          jnp.asarray(rhs), getattr(jsem, mask), maxiter=300, **kw)
    mixed = MixedPrecision(sem)
    calls = []
    mixed.helmholtz32 = lambda u, a, b: calls.append(1) or MixedPrecision.helmholtz32(
        mixed, u, a, b)
    got = elliptic_solve_mixed(sem, mixed, h1, h2, torch.as_tensor(rhs),
                               getattr(sem, mask), maxiter=300, **kw)
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)) <= 1e-9
    assert len(calls) > 0 and mixed.fused.launches == 0


def test_dot32_accumulates_in_f64():
    # f32 products, summed in f64: 1e8 + 1 - 1e8 is 0 in f32, 1 here
    a = torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32)
    got = MixedPrecision.dot32(a, torch.ones_like(a))
    assert got.dtype == torch.float32 and float(got) == 1.0
