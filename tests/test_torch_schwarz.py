"""The port's ``'schwarz'`` pressure preconditioner (overlapping patches, P0
and Q1 coarse levels) and exact velocity blocks (``ops/schwarz.py``,
``SEM.setup_pressure_schwarz``, ``velocity_precond='block'``) against the
JAX package's, on the quick preset of the backward-facing step (180
elements at order 5, uniform in x) and a small graded step.

Tolerances: the colorings, neighbour lists, patch indices and P0 sources
are integers and must be equal; the extracted blocks and everything
inverted from them agree to 1e-12 relative in the Frobenius norm (the
same f64 numpy inversion of operator applies that differ in their last
bits); the applies to 1e-12;
the pressure CG iterations to 1e-5 within one of JAX's; a step to 1e-10
at solver tolerances 1e-12."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from examples.bfs_transient_growth import PRESETS, build_case
from nekstab_next_tpu.cases.bfs import BackwardFacingStepCase as JaxBFS
from nekstab_next_tpu.config import SolverConfig as JaxSolverConfig
from nekstab_next_tpu.ops import schwarz as jsz
from nekstab_next_tpu.ops.cg import pcg as jax_pcg
from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
from nekstab_next_tpu_torch.config import SolverConfig
from nekstab_next_tpu_torch.interop import sem_arrays, sem_from_arrays
from nekstab_next_tpu_torch.ops import schwarz as psz
from nekstab_next_tpu_torch.ops.cg import pcg

# a small graded step: 28 elements at order 4, graded into the corner
SMALL = dict(reynolds=500.0, order=4, elems_upstream=2, elems_downstream=6, elems_y=4,
             inflow_length=3.0, outflow_length=9.0, step_dx=0.3)
TIGHT = dict(pressure_tol=1e-12, velocity_tol=1e-12, pressure_maxiter=3000,
             velocity_maxiter=1000)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread and one BLAS thread while this module runs: the
    test suite runs several worker processes at once, and torch's thread
    pools on tiny tensors, like numpy's BLAS threads in the batched patch
    inversions of both packages, slow down many-fold when they contend for
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def quick():
    """The quick preset in both packages: the JAX SEM, the port's own SEM
    (built from the port's mesh), and both sparse-E extractions."""
    P = PRESETS["quick"]
    jsem = build_case(P).sem
    sem = BackwardFacingStepCase(
        reynolds=500.0, order=P["order"], elems_upstream=P["eu"],
        elems_downstream=P["ed"], elems_y=P["ey"], outflow_length=P["outflow"],
        device="cpu").sem
    return jsem, sem, jsz.extract_sparse_E(jsem), psz.extract_sparse_E(sem)


def gid_of(sem):
    return sem.gid_np.reshape(sem.nelem, -1)


@pytest.mark.parametrize("distance", [1, 2])
def test_colorings_match_jax(quick, distance):
    _, sem, _, _ = quick
    gid = gid_of(sem)
    colors = psz.element_coupling_colors(gid, distance=distance)
    np.testing.assert_array_equal(colors, jsz.element_coupling_colors(gid, distance=distance))
    # distance 2: no two elements of one color share a responder
    if distance == 2:
        adj = psz.element_adjacency(gid)
        for e in range(sem.nelem):
            near = set().union(*(adj[nb] for nb in adj[e])) - {e}
            assert colors[e] not in {colors[x] for x in near}


def test_face_adjacency_and_sources_match_jax(quick):
    jsem, sem, _, _ = quick
    gid = gid_of(sem)
    assert psz.face_adjacency(gid) == jsz.face_adjacency(gid)
    colors = psz.element_coupling_colors(gid, distance=2)
    for c in range(int(colors.max()) + 1):
        np.testing.assert_array_equal(psz._nearest_colored_source(gid, colors, c),
                                      jsz._nearest_colored_source(jsem.mesh, colors, c))


def test_sparse_E_matches_jax_and_operator(quick):
    _, sem, JB, B = quick
    assert set(B) == set(JB)
    scale = max(np.abs(b).max() for b in JB.values())
    assert max(np.abs(B[k] - JB[k]).max() for k in B) <= 1e-12 * scale
    # the blocks reproduce E on a random field
    rng = np.random.default_rng(3)
    q = rng.standard_normal(sem.p_shape)
    qf = q.reshape(sem.nelem, -1)
    out = np.zeros_like(qf)
    for (e, es), blk in B.items():
        out[e] += blk @ qf[es]
    ref = psz.make_pressure_operator(sem)(torch.as_tensor(q)).reshape(sem.nelem, -1).numpy()
    assert relerr(out, ref) <= 1e-13


@pytest.mark.parametrize("adjacency", ["face", "node"])
@pytest.mark.parametrize("weighted", [False, True])
def test_patches_match_jax(quick, adjacency, weighted):
    jsem, sem, JB, B = quick
    jp = jsz.build_pressure_patches(jsem, weighted=weighted, B=JB, adjacency=adjacency)
    pp = psz.build_pressure_patches(sem, weighted=weighted, B=B, adjacency=adjacency)
    np.testing.assert_array_equal(pp[0].numpy(), np.asarray(jp[0]))
    assert relerr(pp[1].numpy(), jp[1]) <= 1e-12
    assert relerr(pp[2].numpy(), jp[2]) <= 1e-12
    r = np.random.default_rng(1).standard_normal(sem.p_shape)
    got = psz.patch_apply(*pp, torch.as_tensor(r)).numpy()
    assert relerr(got, jsz.patch_apply(*jp, jnp.asarray(r))) <= 1e-12


def test_p0_coarse_matches_jax(quick):
    jsem, sem, JB, B = quick
    got = psz.build_p0_coarse(sem, B=B)
    assert relerr(got, jsz.build_p0_coarse(jsem, B=JB)) <= 1e-12
    r = np.random.default_rng(2).standard_normal(sem.p_shape)
    z = psz.p0_coarse_apply(torch.as_tensor(got), torch.as_tensor(r)).numpy()
    zj = jsz.p0_coarse_apply(jnp.asarray(got), jnp.asarray(r))
    assert relerr(z, zj) <= 1e-14


def test_velocity_blocks_match_jax(quick):
    jsem, sem, _, _ = quick
    h1, h2 = 1.0 / 500.0, (11.0 / 6.0) / 0.013
    got = sem.setup_velocity_blocks(h1, h2)
    assert sem.setup_velocity_blocks(h1, h2) is got  # cached by (h1, h2)
    ref = jsem.setup_velocity_blocks(h1, h2)
    assert relerr(got.numpy(), ref) <= 1e-12
    r = np.random.default_rng(4).standard_normal(tuple(sem.bm.shape) + (2,))
    z = psz.velocity_block_apply(got, torch.as_tensor(r)).numpy()
    assert relerr(z, jsz.velocity_block_apply(ref, jnp.asarray(r))) <= 1e-12


@pytest.fixture(scope="module")
def schwarz_sems(quick):
    """Both SEMs with 'schwarz' (face) built, and the port's SEM built from
    the JAX SEM's arrays (its patches carried across)."""
    jsem, sem, _, _ = quick
    jsem.setup_pressure_schwarz()
    sem.setup_pressure_schwarz()
    return jsem, sem, sem_from_arrays(sem_arrays(jsem), device="cpu")


def test_pressure_precond_schwarz_spd_and_matches_jax(schwarz_sems):
    jsem, sem, carried = schwarz_sems
    rng = np.random.default_rng(5)
    r1, r2 = (torch.as_tensor(rng.standard_normal(sem.p_shape)) for _ in range(2))
    M = sem.pressure_precond_schwarz
    a, b = float(torch.sum(M(r1) * r2)), float(torch.sum(M(r2) * r1))
    assert abs(a - b) < 1e-12 * max(abs(a), 1.0)
    assert float(torch.sum(M(r1) * r1)) > 0.0
    ref = np.asarray(jsem.pressure_precond_schwarz(jnp.asarray(r1.numpy())))
    assert relerr(M(r1).numpy(), ref) <= 1e-12
    # the carried-in patches apply as JAX's to roundoff
    assert relerr(carried.pressure_precond_schwarz(r1).numpy(), ref) <= 1e-13


def test_pressure_iterations_match_jax(schwarz_sems):
    # JAX's docstring measured 20 iterations to 1e-5 on this preset
    jsem, sem, _ = schwarz_sems
    b = np.random.default_rng(7).standard_normal(sem.p_shape)
    E_j = jsz.make_pressure_operator(jsem)
    _, kj = jax.jit(lambda bb: jax_pcg(E_j, bb, precond=jsem.pressure_precond_schwarz,
                                       tol=1e-5, maxiter=500,
                                       dot=lambda x, y: jnp.sum(x * y),
                                       return_iters=True))(jnp.asarray(b))
    _, k = pcg(psz.make_pressure_operator(sem), torch.as_tensor(b),
               precond=sem.pressure_precond_schwarz, tol=1e-5, maxiter=500,
               return_iters=True)
    assert abs(k - int(kj)) <= 1 and k <= 30, (k, int(kj))


@pytest.mark.parametrize("pressure,velocity,overlap", [
    ("schwarz", "fdm", "face"), ("schwarz", "fdm", "node"), ("schwarz", "block", "face"),
    ("block", "block", "face")])
def test_steps_match_jax(pressure, velocity, overlap):
    # three steps (BDF1, 2, 3) of the small graded step from the JAX case's
    # initial flow
    cfg = JaxSolverConfig(**TIGHT, pressure_precond=pressure, velocity_precond=velocity,
                          pressure_patch_overlap=overlap)
    jcase = JaxBFS(**SMALL, solver=cfg)
    jns = jcase.make_ns()
    case = BackwardFacingStepCase(**SMALL, solver=SolverConfig(**dataclasses.asdict(cfg)),
                                  device="cpu")
    ns = case.make_ns()
    u0 = np.array(jcase.initial_flow())
    np.testing.assert_array_equal(case.initial_flow().numpy(), u0)
    jst = jax.jit(lambda s: jns.advance(s, 3))(jns.make_state(jnp.asarray(u0)))
    st = ns.advance(ns.make_state(torch.as_tensor(u0)), 3)
    assert relerr(st.u.numpy(), jst.u) <= 1e-10
    assert relerr(st.p.numpy(), jst.p) <= 1e-10
    assert (ns._vblocks is not None) == (velocity == "block")
