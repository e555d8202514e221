"""The port's whole-solve CG wrappers (ops/fused_cg.py) against the JAX
Pallas kernels, and the host-side tables the CUDA kernels read.

On the CPU the wrappers run their plain PyTorch versions (a CPU tensor never
reaches a kernel); the JAX kernels run through the Pallas interpreter, as in
test_fused_cg.py, on the same 32-element cylinder mesh and f32 factors.  The
kernels themselves run on a GPU only (tests/test_torch_cuda.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.mesh import cylinder_mesh as jax_cylinder_mesh
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.ops.elliptic import make_projector as jax_make_projector
from nekstab_next_tpu.ops.fused_cg import FusedHelmholtzCG as JaxHelmholtzCG
from nekstab_next_tpu.ops.fused_cg import FusedPressureCG as JaxPressureCG
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import cylinder_mesh
from nekstab_next_tpu_torch.ops import _cuda
from nekstab_next_tpu_torch.ops.core import SEM
from nekstab_next_tpu_torch.ops.fused_cg import (
    FusedHelmholtzCG,
    FusedPressureCG,
    check_kernel_scope,
)

H1, H2 = 0.0167, 100.0  # test_fused_cg.py's Helmholtz coefficients


@pytest.fixture(scope="module")
def sems():
    jsem = JaxSEM(jax_cylinder_mesh(nr=4, ntheta=8, order=6), dtype=jnp.float32)
    jsem.setup_pressure_blocks()
    return jsem, sem_from_arrays(sem_arrays(jsem), dtype=torch.float32, device="cpu")


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_helmholtz_cg_matches_jax_kernel(sems, seed):
    jsem, sem = sems
    rng = np.random.default_rng(seed)
    rhs = jnp.asarray(rng.standard_normal(jsem.bm.shape + (2,)), jnp.float32)
    rhsP = jax_make_projector(jsem, jsem.vmask)(rhs)
    ref = JaxHelmholtzCG(jsem, jsem.vmask, maxiter=10, tol=1e-6).solve(rhsP, H1, H2)
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    got = k1.solve(torch.as_tensor(np.array(rhsP)), H1, H2)
    # f32 solves in different summation orders: the bound of
    # test_fused_cg.py:90 (measured ~1e-7)
    assert rel(ref, got.numpy()) < 1e-5
    assert k1.launches == 0  # a CPU tensor runs the plain version


@pytest.mark.parametrize("maxiter,tol,bound", [
    # converged: solutions agree whatever the path (measured ~3e-7)
    (300, 1e-6, 1e-4),
    # capped at the bench's 16 iterations: CG iterates are far more
    # sensitive to roundoff than converged solutions (measured 2e-5..7e-5)
    (16, 1e-5, 1e-3),
])
def test_plain_pressure_cg_matches_jax_kernel(sems, maxiter, tol, bound):
    jsem, sem = sems
    rhs = np.random.default_rng(0).standard_normal(jsem.p_shape).astype(np.float32)
    ref = JaxPressureCG(jsem, maxiter=maxiter, tol=tol).solve(jnp.asarray(rhs))
    k2 = FusedPressureCG(sem, maxiter=maxiter, tol=tol)
    got = k2.solve(torch.as_tensor(rhs))
    assert rel(ref, got.numpy()) < bound
    assert k2.launches == 0


def test_plain_pressure_cg_mean_projection(sems):
    # enclosed-flow mode: rhs and solution leave the constant out
    _, sem = sems
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(sem.p_shape),
                          dtype=torch.float32)
    x = FusedPressureCG(sem, maxiter=50, tol=1e-6, project_mean=True).solve(rhs)
    assert abs(float(x.double().mean())) < 1e-6 * float(x.double().abs().max())


def test_kernel_scope_raises():
    with pytest.raises(ValueError, match="float32"):
        check_kernel_scope(SEM(cylinder_mesh(nr=2, ntheta=4, order=6), device="cpu"))
    with pytest.raises(ValueError, match="order"):
        check_kernel_scope(SEM(cylinder_mesh(nr=2, ntheta=4, order=8),
                               dtype=torch.float32, device="cpu"))


def test_launch_checks_raise(sems):
    # the kernel path takes only contiguous float32 CUDA tensors of its
    # shape; anything else raises before a pointer reaches C
    _, sem = sems
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    x = torch.zeros(tuple(sem.bm.shape) + (2,))
    with pytest.raises(ValueError, match="CUDA"):
        k1._check(x, x.shape)
    with pytest.raises(ValueError, match="CUDA"):
        k1.solve(x.to("meta"), H1, H2)
    assert k1.launches == 0


def kernel_gather(lists: np.ndarray, u: np.ndarray) -> np.ndarray:
    """The kernels' gather in their order: for every row of the padded
    lists, the sum over its entries left to right, -1 pads skipped."""
    out = np.zeros(lists.shape[0], u.dtype)
    for q in range(lists.shape[1]):
        k = lists[:, q]
        out = out + np.where(k >= 0, u[np.maximum(k, 0)], 0.0)
    return out


def test_gather_tables_reproduce_dssum(sems):
    # the K1/K2 gather: each local node sums its global node's copies from
    # its own padded list (increasing local index, -1 pads), left to right
    _, sem = sems
    c = FusedHelmholtzCG(sem, sem.vmask, maxiter=1, tol=1e-6)._gather_consts("cpu")
    copies = c["copies"].numpy()
    assert copies.dtype == np.int32 and copies.shape == (sem.gid_np.size, 4)
    for row, g in zip(copies, sem.gid_np):  # exactly the copies, in order
        own = row[row >= 0]
        assert np.all(row[own.size:] == -1) and np.all(np.diff(own) > 0)
        assert np.array_equal(own, np.flatnonzero(sem.gid_np == g))
    u = np.random.default_rng(3).standard_normal(copies.shape[0])
    ref = sem.dssum(torch.as_tensor(u).reshape(sem.bm.shape)).reshape(-1).numpy()
    assert np.allclose(kernel_gather(copies, u), ref, rtol=1e-12, atol=1e-12)


def test_pressure_kernel_constants(sems):
    # K2 folds the Q1 restriction with the Gauss->GLL lift into Kc, and sums
    # vertices through padded vertex lists: check both against the SEM ops
    _, sem = sems
    k2 = FusedPressureCG(sem, maxiter=1, tol=1e-6)
    c = k2._device_consts("cpu")
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(sem.p_shape),
                        dtype=torch.float32)
    Kc = c["Kc"].double().reshape(4, -1)
    rc = (r.double().reshape(sem.nelem, 1, -1) * Kc[None]).sum(-1)  # (E, 4)
    ref_rc = torch.einsum("cij,eij->ec", sem.pc_Jc, sem.lift_p(r)).double()
    # f32 factors and f32 reference arithmetic: a few f32 roundoffs
    assert torch.allclose(rc, ref_rc, rtol=1e-5, atol=1e-5)
    flat = rc.reshape(-1).numpy()
    V = kernel_gather(c["vtx"].numpy(), flat)
    ref_V = np.zeros(sem.pc_nc)
    np.add.at(ref_V, sem.pc_cid_np.reshape(-1), flat)
    assert np.allclose(V, ref_V, rtol=1e-12, atol=1e-12)
    for key, shape in {"pinv": (sem.nelem, 25, 25), "Acinv": (sem.pc_nc,) * 2,
                       "vmask": (sem.nelem, 7, 7, 2), "Jg": (7, 5),
                       "vtx": (sem.pc_nc, 4), "cid": (sem.nelem, 4)}.items():
        assert tuple(c[key].shape) == shape and c[key].is_contiguous()
        assert c[key].dtype == (torch.int32 if key in ("vtx", "cid") else torch.float32)


def test_pressure_kernel_preconditioner(sems):
    # K2's preconditioner from the operands it reads: each Gauss node's row
    # of the block inverse, the corner residuals rc = Kc r, the vertex sums
    # V over the padded lists, xc = Acinv V read at each element's corners
    # (the rows a block computes for its own elements), prolonged by Kc^T;
    # against the plain version's sem.pressure_precond_block
    _, sem = sems
    c = FusedPressureCG(sem, maxiter=1, tol=1e-6)._device_consts("cpu")
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(sem.p_shape),
                        dtype=torch.float32)
    E, m = sem.nelem, sem.npr ** 2
    rf = r.double().reshape(E, m)
    Kc = c["Kc"].double().reshape(4, m)
    z = torch.einsum("etk,ek->et", c["pinv"].double(), rf)
    V = kernel_gather(c["vtx"].numpy(), (rf @ Kc.T).reshape(-1).numpy())
    rows = c["Acinv"].double()[c["cid"].long()]  # (E, 4, nc): the rows at the corners
    xc = rows @ torch.as_tensor(V)  # (E, 4)
    got = (z + xc @ Kc).reshape(sem.p_shape)
    ref = sem.pressure_precond_block(r).double()
    assert rel(ref.numpy(), got.numpy()) < 1e-5  # f32 factors, f32 reference


def test_cuda_sources_and_flags():
    cu, cuh = _cuda._sources()
    assert [f.name for f in cu] == ["fused_helmholtz.cu", "fused_helmholtz_cg.cu",
                                    "fused_pressure_cg.cu"]
    assert [f.name for f in cuh] == ["sem_device.cuh"]
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    stems = [f.stem for f in cu]
    for f in cu:  # the C entry points are exactly those ctypes binds
        src = f.read_text()
        bound = {n for n in _cuda._SIGNATURES if _cuda._source_of(n, stems) == f.stem}
        assert set(re.findall(r'extern "C" int (nsk_\w+)\(', src)) == bound
        assert f"nsk_{f.stem}" in bound  # and nsk_<stem> launches its kernel
        assert "cudaLaunchCooperativeKernel" not in src  # via sem_device.cuh
