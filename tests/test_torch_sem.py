"""The port's host setup and SEM operators against the JAX package.

Both packages build the 32-element cylinder O-mesh (the fixture of
test_fused_cg.py); inputs come from numpy with a seed and pass between the
packages as numpy arrays.  The port's own construction (mesh, FDM, coarse
level, pressure blocks) must reproduce the JAX factors; its operators, built
from those factors, must agree with the JAX operators in float64.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.mesh import cylinder_mesh as jax_cylinder_mesh
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.mesh import cylinder_mesh
from nekstab_next_tpu_torch.ops.core import FLOAT_KEYS, SEM

MESH = dict(nr=4, ntheta=8, order=6)
# f64 operators: the same arithmetic in another summation order, a few
# roundoffs of 1e-16 each
OP_RTOL = 1e-12


@pytest.fixture(scope="module")
def sems():
    jsem = JaxSEM(jax_cylinder_mesh(**MESH))
    jsem.setup_pressure_blocks()
    own = SEM(cylinder_mesh(**MESH), device="cpu")
    own.setup_pressure_blocks()
    return jsem, own, sem_from_arrays(sem_arrays(jsem), device="cpu")


def relerr(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-300))


def test_port_imports_no_jax():
    code = ("import sys, nekstab_next_tpu_torch.cases.cylinder, "
            "nekstab_next_tpu_torch.cases.cube, nekstab_next_tpu_torch.ops.mixed, "
            "nekstab_next_tpu_torch.stepper.linearized, nekstab_next_tpu_torch.interop, "
            "nekstab_next_tpu_torch.ops.fused_cg; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_solver_config_fields_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(SolverConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxSolverConfig)]
    assert ours == ref
    cfg = JaxSolverConfig(pressure_precond="block", fused_solves=True)
    assert SolverConfig(**dataclasses.asdict(cfg)) == SolverConfig(
        pressure_precond="block", fused_solves=True)


def test_mesh_gid_matches_exactly(sems):
    jsem, own, _ = sems
    assert own.nglobal == jsem.nglobal
    np.testing.assert_array_equal(own.gid.numpy(), np.asarray(jsem.gid))
    np.testing.assert_array_equal(own.pc_cid.numpy(), np.asarray(jsem.pc_cid))
    assert own.has_pressure_dirichlet == jsem.has_pressure_dirichlet


@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_own_factor_matches_jax(sems, key):
    # the same numpy code on the same inputs: 1e-13 leaves room for a
    # different BLAS summation order only
    jsem, own, _ = sems
    assert relerr(getattr(jsem, key), getattr(own, key).numpy()) <= 1e-13


def test_pressure_blocks_match_jax(sems):
    # extraction by different f64 operator code, then inversion of blocks
    # with condition numbers ~1e3: 1e-10 bounds the amplified roundoff
    jsem, own, _ = sems
    assert relerr(jsem.pblock_inv, own.pblock_inv.numpy()) <= 1e-10


def test_sem_from_arrays_installs_factors(sems):
    jsem, _, port = sems
    for key in FLOAT_KEYS + ("pblock_inv",):
        np.testing.assert_array_equal(getattr(port, key).numpy(),
                                      np.asarray(getattr(jsem, key)))
    assert port.dtype == torch.float64
    f32 = sem_from_arrays(sem_arrays(jsem), dtype=torch.float32, device="cpu")
    assert f32.bm.dtype == torch.float32 and f32.gid.dtype == torch.int64


def test_sem_rejects_3d_factors(sems):
    # the port's SEM is 2-D: 3-D factor arrays raise instead of misbehaving
    jsem = sems[0]
    arrays = sem_arrays(jsem)
    arrays["bm"] = np.asarray(arrays["bm"])[..., None].repeat(7, axis=-1)
    with pytest.raises(NotImplementedError):
        sem_from_arrays(arrays, device="cpu")


def test_sem_shard_view_of_one_rank_is_the_sem():
    # once refused (the JAX SEM's axis_name): a shard view over a one-rank
    # gloo group holds every element and makes no collective, so its sums,
    # reductions and coarse level give the whole SEM's bits; the host's
    # 'schwarz' patches do not pass into the view
    from nekstab_next_tpu_torch.parallel import make_device_mesh

    sem = SEM(cylinder_mesh(nr=2, ntheta=4, order=4), device="cpu")
    sem.setup_pressure_schwarz()
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(sem.bm.shape) + (2,)))
    dm = make_device_mesh(1, device="cpu")
    try:
        v = sem.shard_view(sem.elem_arrays(), dm.group)
        assert v.sharded and not sem.sharded
        assert v.group is None and v.nshards == 1 and v.pschwarz is None
        assert v.pblock_inv is None and sem.pschwarz is not None
        assert torch.equal(v.dssum(u), sem.dssum(u))
        assert torch.equal(v.inner(u[..., 0], u[..., 1]), sem.inner(u[..., 0], u[..., 1]))
        assert torch.equal(v.glmax(u), sem.glmax(u))
        r = u[..., 0]
        assert torch.equal(v.coarse_apply_pressure(r), sem.coarse_apply_pressure(r))
    finally:
        dm.close()


def _inputs(jsem):
    rng = np.random.default_rng(0)
    u = rng.standard_normal(tuple(jsem.bm.shape) + (2,))
    q = rng.standard_normal(jsem.p_shape)
    return u, q


# each case: (JAX op, port op) on (velocity u (E,n,n,2), pressure q)
OPS = {
    "dssum": (lambda s, u, q: s.dssum(u)),
    "dsavg": (lambda s, u, q: s.dsavg(u)),
    "dsavg_mass": (lambda s, u, q: s.dsavg_mass(u)),
    "grad": (lambda s, u, q: s.grad(u[..., 0])[0] + 2.0 * s.grad(u[..., 0])[1]),
    "divv": (lambda s, u, q: s.divv(u)),
    "stiffness_local": (lambda s, u, q: s.stiffness_local(u[..., 1])),
    "stiffness_diag": (lambda s, u, q: s.stiffness_diag()),
    "helmholtz_local": (lambda s, u, q: s.helmholtz_local(u[..., 0], 0.0167, 100.0)),
    "fdm_apply": (lambda s, u, q: s.fdm_apply(u, 0.0167, 100.0)),
    "fdm_apply_h2_zero": (lambda s, u, q: s.fdm_apply(u[..., 0], 1.0, 0.0)),
    "div_to_p": (lambda s, u, q: s.div_to_p(u)),
    "pressure_precond_block": (lambda s, u, q: s.pressure_precond_block(q)),
    "pressure_precond_pnpn2": (lambda s, u, q: s.pressure_precond_pnpn2(q)),
    "coarse_apply_pressure": (lambda s, u, q: s.coarse_apply_pressure(u[..., 1])),
    "convect": (lambda s, u, q: s.convect(u, u[..., 1])),
    "inner": (lambda s, u, q: s.inner(u, 2.0 * u + 1.0)),
    "norm_unmasked": (lambda s, u, q: s.norm(u, masked=False)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_matches_jax(sems, name):
    jsem, _, port = sems
    u, q = _inputs(jsem)
    fn = OPS[name]
    ref = fn(jsem, jnp.asarray(u), jnp.asarray(q))
    got = fn(port, torch.as_tensor(u), torch.as_tensor(q))
    assert relerr(ref, got.numpy()) <= OP_RTOL


def test_grad_from_p_is_jax_transpose(sems):
    # the port writes D^T out; JAX takes jax.linear_transpose of div_to_p
    jsem, _, port = sems
    u, q = _inputs(jsem)
    ref = jax.linear_transpose(jsem.div_to_p, jnp.asarray(u))(jnp.asarray(q))[0]
    got = port.grad_from_p(torch.as_tensor(q))
    assert relerr(ref, got.numpy()) <= OP_RTOL


def test_div_grad_adjoint_identity(sems):
    # <div_to_p u, q> = <u, grad_from_p q> exactly up to f64 roundoff
    _, _, port = sems
    u, q = _inputs(port)
    u, q = torch.as_tensor(u), torch.as_tensor(q)
    lhs = float(torch.sum(port.div_to_p(u) * q))
    rhs = float(torch.sum(u * port.grad_from_p(q)))
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0)


def test_dssum_copies_bit_identical(sems):
    # the gather sums every copy of a global node in the same order
    _, _, port = sems
    u, _ = _inputs(port)
    s = port.dssum(torch.as_tensor(u)).reshape(-1, 2).numpy()
    gid = port.gid_np
    for g in np.unique(gid[np.bincount(gid)[gid] > 1])[:200]:
        rows = s[gid == g]
        assert (rows == rows[0]).all()


def test_set_sponge_matches_jax():
    jsem = JaxSEM(jax_cylinder_mesh(**MESH))
    port = SEM(cylinder_mesh(**MESH), device="cpu")
    lam = np.clip(np.asarray(jsem.mesh.x) / 10.0, 0.0, None)
    jsem.set_sponge(lam)
    port.set_sponge(lam)
    np.testing.assert_array_equal(port.bms.numpy(), np.asarray(jsem.bms))
    np.testing.assert_array_equal(port.sponge.numpy(), np.asarray(jsem.sponge))
