"""The port's PnPn-2 pressure space on hexahedra (``SEM3.div_to_p``,
``p_to_gll``, ``grad_from_p``, the ``'fdm'``, ``'block'`` and ``'schwarz'``
preconditioners), the rest of ``SEM3`` (``curl``, ``cfl``, the collocated
convection, ``cgdot``, ``glmax``) and the 2-D ``SEM``'s matching pieces,
against the JAX package.

Two 3-D meshes: ``tests/test_3d.py``'s ``box3`` (2 x 2 x 2 elements on
[-1, 1]^3 at order 5, all walls) and the cube-roughness geometry carved
from a 4 x 2 x 2 lattice at order 4 (15 elements, z periodic, outflow at
x = Lx).  The port's SEM3 takes the JAX SEM3's factors (``interop``), so
both compute with the same numbers; inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nekstab_next_tpu.cases.cube import CubeRoughnessCase as JaxCube
from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.mesh import box_mesh_3d as jax_box_mesh_3d
from nekstab_next_tpu.ops import SEM as JaxSEM
from nekstab_next_tpu.ops import SEM3 as JaxSEM3
from nekstab_next_tpu_torch.interop import (
    sem3_arrays, sem3_from_arrays, sem_arrays, sem_from_arrays)
from nekstab_next_tpu_torch.mesh import box_mesh_3d
from nekstab_next_tpu_torch.ops.core3 import SEM3

# f64 operators on the same factors: the same arithmetic in another
# contraction order
TOL = 1e-12
# the tiny carved cube: 4 x 2 x 2 lattice, the element at x in [1, 2],
# y in [0, 1], z in [0, 1] carved out
CUBE = dict(reynolds=60.0, h=1.0, lx=4.0, ly=2.0, lz=2.0, cube_x=1.5, cube_z=0.5,
            nx=4, ny=2, nz=2, order=4, delta=1.0, target_cfl=0.2)


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


def _box3():
    return JaxSEM3(jax_box_mesh_3d(2, 2, 2, order=5, x0=-1, x1=1, y0=-1, y1=1,
                                   z0=-1, z1=1))


def _cube():
    return JaxCube(**CUBE).sem


MESHES = {"box3": _box3, "cube": _cube}


@pytest.fixture(scope="module", params=sorted(MESHES))
def pair(request):
    """(JAX SEM3, the port's SEM3 on its factors, seeded inputs)."""
    jsem = MESHES[request.param]()
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    rng = np.random.default_rng(3)
    shape = tuple(jsem.bm.shape)
    inputs = dict(u=rng.standard_normal(shape + (3,)),
                  c=rng.standard_normal(shape + (3,)),
                  f=rng.standard_normal(shape),
                  p=rng.standard_normal(tuple(jsem.p_shape)))
    return jsem, sem, inputs


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-300))


def both(jsem, sem, inputs, call):
    """``call`` on the JAX SEM3 (jnp inputs) and on the port (torch)."""
    ref = call(jsem, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = call(sem, {k: torch.as_tensor(v) for k, v in inputs.items()})
    return ref, got


def _stack(parts):
    return torch.stack(parts) if isinstance(parts[0], torch.Tensor) else jnp.stack(parts)


OPS = {
    "div_to_p": lambda s, a: s.div_to_p(a["u"]),
    "p_to_gll": lambda s, a: s.p_to_gll(a["p"]),
    "pnpn2_precond": lambda s, a: s.pressure_precond_pnpn2(a["p"]),
    "curl": lambda s, a: _stack(s.curl(a["u"][..., 0], a["u"][..., 1], a["u"][..., 2])),
    "cfl": lambda s, a: s.cfl(a["u"], 0.013),
    "convect_colloc": lambda s, a: s.convect_colloc(a["c"], a["f"]),
    "convect_colloc_v": lambda s, a: s.convect_colloc_v(a["c"], a["f"]),
    "cgdot": lambda s, a: s.cgdot(a["u"], a["c"]),
    "glmax": lambda s, a: s.glmax(a["f"]),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_sem3_operator_matches_jax(pair, op):
    jsem, sem, inputs = pair
    ref, got = both(jsem, sem, inputs, OPS[op])
    assert tuple(got.shape) == tuple(np.shape(ref))
    assert rel(ref, got) < TOL, (op, rel(ref, got))


def test_p_shape_and_weak_gradient_is_the_transpose(pair):
    jsem, sem, inputs = pair
    assert sem.p_shape == tuple(jsem.p_shape) == (sem.nelem,) + (sem.n - 2,) * 3
    u = torch.as_tensor(inputs["u"])
    q = torch.as_tensor(inputs["p"])
    lhs = float(torch.sum(q * sem.div_to_p(u)))
    rhs = float(torch.sum(sem.grad_from_p(q) * u))
    assert abs(lhs - rhs) < 1e-12 * max(abs(lhs), 1.0)


def test_own_factors_match_jax(pair):
    # the P_(N-2) factors the port's SEM3 builds from its own mesh
    jsem = pair[0]
    if jsem.nelem == 8:
        mesh = box_mesh_3d(2, 2, 2, order=5, x0=-1, x1=1, y0=-1, y1=1, z0=-1, z1=1)
    else:
        from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase

        mesh = CubeRoughnessCase(**CUBE, device="cpu").mesh
    own = SEM3(mesh, device="cpu")
    for key in ("Jp", "Jpg", "bp"):
        assert rel(getattr(jsem, key), getattr(own, key)) < 1e-13, key


PRECONDS = {
    "block": (lambda s: s.setup_pressure_blocks(), "pressure_precond_block"),
    "schwarz_face": (lambda s: s.setup_pressure_schwarz("face"), "pressure_precond_schwarz"),
    "schwarz_node": (lambda s: s.setup_pressure_schwarz("node"), "pressure_precond_schwarz"),
}


# box3's node patch is the whole enclosed box, whose E is singular (the
# constant), so its patch inverse is roundoff in both packages: the node
# patches are held on the cube, whose outflow makes E definite
@pytest.mark.parametrize("mesh,name", [
    ("box3", "block"), ("box3", "schwarz_face"),
    ("cube", "block"), ("cube", "schwarz_face"), ("cube", "schwarz_node"),
])
def test_exact_pressure_preconditioner_matches_jax(mesh, name):
    """Both packages build the preconditioner from their own operator
    applies on the same factors; its apply agrees, and so does the port's
    apply of the JAX-built arrays carried through ``sem3_arrays``."""
    setup, method = PRECONDS[name]
    jsem = MESHES[mesh]()
    sem = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    setup(jsem)
    setup(sem)
    carried = sem3_from_arrays(sem3_arrays(jsem), device="cpu")
    r = np.random.default_rng(5).standard_normal(tuple(jsem.p_shape))
    ref = getattr(jsem, method)(jnp.asarray(r))
    for port in (sem, carried):
        got = getattr(port, method)(torch.as_tensor(r))
        assert rel(ref, got) < TOL, (mesh, name, rel(ref, got))
    if name == "block":
        assert rel(jsem.pblock_inv, sem.pblock_inv) < 1e-10
    else:
        assert rel(jsem.p0Acinv, sem.p0Acinv) < 1e-10
        np.testing.assert_array_equal(np.asarray(jsem.pschwarz[0]), sem.pschwarz[0].numpy())


# -- the 2-D SEM's matching pieces --------------------------------------
@pytest.fixture(scope="module")
def pair2():
    mesh = jax_box_mesh_2d(3, 2, order=5, x0=0.0, x1=3.0, y0=0.0, y1=1.5,
                           periodic_x=True)
    jsem = JaxSEM(mesh)
    sem = sem_from_arrays(sem_arrays(jsem), device="cpu")
    rng = np.random.default_rng(4)
    shape = tuple(jsem.bm.shape)
    inputs = dict(u=rng.standard_normal(shape + (2,)), c=rng.standard_normal(shape + (2,)),
                  f=rng.standard_normal(shape), g=rng.standard_normal(shape))
    return jsem, sem, inputs


OPS2 = {
    "curl": lambda s, a: s.curl(a["u"][..., 0], a["u"][..., 1]),
    "cfl": lambda s, a: s.cfl(a["u"][..., 0], a["u"][..., 1], 0.021),
    "convect_colloc": lambda s, a: s.convect_colloc(a["c"][..., 0], a["c"][..., 1], a["f"]),
    "convect_colloc_v": lambda s, a: s.convect_colloc_v(a["c"], a["f"]),
    "p_from_gll": lambda s, a: s.p_from_gll(a["g"]),
    "cgdot": lambda s, a: s.cgdot(a["u"], a["c"]),
    "glmax": lambda s, a: s.glmax(a["f"]),
}


@pytest.mark.parametrize("op", sorted(OPS2))
def test_sem_2d_operator_matches_jax(pair2, op):
    jsem, sem, inputs = pair2
    ref, got = both(jsem, sem, inputs, OPS2[op])
    assert tuple(got.shape) == tuple(np.shape(ref))
    assert rel(ref, got) < TOL, (op, rel(ref, got))
