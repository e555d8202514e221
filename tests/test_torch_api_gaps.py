"""``Mesh2D.integrate``, the JAX mesh method the port gained last, held
against the JAX package on the same seeded numpy inputs: the 32-element
cylinder O-mesh of test_torch_sem.py and the graded box of
test_torch_mixed.py, each built by both packages.
"""

import numpy as np
import pytest

from nekstab_next_tpu.mesh import box_mesh_2d as jax_box_mesh_2d
from nekstab_next_tpu.mesh import cylinder_mesh as jax_cylinder_mesh
from nekstab_next_tpu_torch.mesh import box_mesh_2d, cylinder_mesh

MESHES = {
    "cylinder": (jax_cylinder_mesh, cylinder_mesh, dict(nr=4, ntheta=8, order=6)),
    "box": (jax_box_mesh_2d, box_mesh_2d, dict(nx=3, ny=3, order=6, grading_x=1.3)),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_integrate_matches_jax(mesh):
    make_jax, make, kw = MESHES[mesh]
    jm, m = make_jax(**kw), make(**kw)
    f = np.random.default_rng(0).standard_normal(m.x.shape)
    ref, got = jm.integrate(f), m.integrate(f)
    # the same quadrature sum over the same weights, in another order
    assert isinstance(got, float) and abs(got - ref) <= 1e-14 * abs(ref)
    area = m.integrate(np.ones_like(f))
    assert abs(area - jm.integrate(np.ones_like(f))) <= 1e-14 * area


def test_mesh_integrate_gives_the_box_area():
    # the JAX package's own check (tests/test_mesh_ops.py)
    m = box_mesh_2d(4, 3, order=6, x0=0.0, x1=2.0, y0=0.0, y1=1.5)
    assert abs(m.integrate(np.ones_like(m.x)) - 3.0) < 1e-12
