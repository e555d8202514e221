"""The port's sharding (``nekstab_next_tpu_torch/parallel``) on the CPU.

The analogs of ``tests/test_parallel.py``'s seven checks and of
``tests/test_cube_case.py``'s sharded 3-D step, plus the sharded
``rmatvec`` (the matvec, rmatvec and ``eigs`` about a nonzero base, so the
transposed convective terms cross the ranks' boundaries) and the cube
example's sharded stages with their gate over two ranks: gloo process
groups of 2 and 4 ranks on the CPU, one thread a
rank, joined through a ``FileStore`` in ``tmp_path`` (no TCP port to
pick).  One module fixture starts both groups at once, each rank running
this file as a script (:func:`run_rank`, which imports no jax), and rank 0
writes the gathered results; while they run, this process computes the
references: the JAX single-device functions, jitted, and the port's own
single-device runs, on the same meshes, inputs and ``SolverConfig``.  The
parametrised tests read the results, so each check counts as a test.
JAX's ``ShardedContext`` is not run here: ``tests/test_parallel.py``
already holds it to its single-device path.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLDS = (2, 4)
TG = dict(nx=8, ny=8, order=4)  # tests/test_parallel.py's box, 64 elements
TG_STEPS, TG_NU, TG_DT = 4, 0.1, 0.01
MV_STEPS, MV_DT = 2, 0.02  # the matvec, rmatvec and eigs' operator
MV_BASE = 0.5  # its base flow: the Taylor-Green field scaled
EIGS = dict(k_dim=6, nev=2, tol=1e-10, max_restarts=1)
EIGS_SEED = 7
CYL = dict(nr=8, ntheta=16, order=4, outer_radius=15.0, grading=20.0)  # 128 elements
CYL_NU, CYL_DT, CYL_STEPS = 1.0 / 40.0, 5e-3, 4
BOX3 = dict(nx=4, ny=2, nz=2, order=3)  # 16 elements
BOX3_NU, BOX3_DT, BOX3_STEPS = 0.05, 0.01, 4
BFS_SOLVER = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=120,
                  velocity_maxiter=60)
BFS_NU, BFS_DT, BFS_STEPS = 1.0 / 500.0, 2e-3, 3
# tests/test_torch_cube_example.py's tiny cube with nx=5: 20 elements, so
# the cube example's stages run over two ranks
CUBE = dict(reynolds=200.0, h=1.0, lx=6.0, ly=2.0, lz=2.0, cube_x=2.5, cube_z=0.5,
            nx=5, ny=2, nz=2, order=4, delta=1.0)
CUBE_WORLD = 2
TIMEOUT = 600
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# inputs (numpy; the ranks and the references build the same)
# ---------------------------------------------------------------------------
def tg_velocity(m) -> np.ndarray:
    return np.stack([-np.cos(m.x) * np.sin(m.y), np.sin(m.x) * np.cos(m.y)], axis=-1)


def tg_weight(m) -> np.ndarray:
    """The rmatvec's input: a smooth field that is not a multiple of the
    matvec's but overlaps it."""
    return tg_velocity(m) + np.stack([np.sin(2 * m.y), np.cos(m.x + m.y)], axis=-1)


def cylinder_fields(m, smooth_step):
    """(u_bc, sponge strength, sponge_ref, u0) of tests/test_parallel.py's
    cylinder; u0 before masking."""
    r = np.sqrt(m.x**2 + m.y**2)
    ubc = np.zeros(m.x.shape + (2,))
    ubc[m.dirichlet_nodes & (r > 1.0), 0] = 1.0
    lam = 1.0 * smooth_step((r - 7.5) / 7.5)
    ref = np.stack([np.ones_like(m.x), np.zeros_like(m.x)], axis=-1)
    return ubc, lam, ref, ref.copy()


def box3_velocity(m) -> np.ndarray:
    return np.stack([-np.cos(m.x) * np.sin(m.y), np.sin(m.x) * np.cos(m.y),
                     np.zeros_like(m.x)], axis=-1)


def tg_mesh(box_mesh_2d):
    L = 2 * np.pi
    return box_mesh_2d(TG["nx"], TG["ny"], order=TG["order"], x0=0, x1=L, y0=0, y1=L,
                       periodic_x=True, periodic_y=True)


def box3_mesh(box_mesh_3d):
    L = 2 * np.pi
    return box_mesh_3d(BOX3["nx"], BOX3["ny"], BOX3["nz"], order=BOX3["order"], x1=L,
                       y1=L, z1=L, periodic_x=True, periodic_y=True, periodic_z=True)


# ---------------------------------------------------------------------------
# one rank (python tests/test_torch_parallel.py RANK WORLD STORE OUT)
# ---------------------------------------------------------------------------
def run_rank(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    from nekstab_next_tpu_torch.algorithms.stability import velocity_space
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
    from nekstab_next_tpu_torch.cases.cylinder import smooth_step
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.krylov import eigs
    from nekstab_next_tpu_torch.mesh import box_mesh_2d, cylinder_mesh
    from nekstab_next_tpu_torch.mesh.mesh3 import box_mesh_3d
    from nekstab_next_tpu_torch.parallel import ShardedContext, make_device_mesh
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu_torch.utils.noise import velocity_noise

    dm = make_device_mesh(world, rank=rank, device="cpu", init_method="file://" + store)
    T = lambda a: torch.as_tensor(a)
    res = {}

    def advance(ctx, u0, nsteps):
        st = ctx.shard_state(ctx.make_host_state(u0))
        st = ctx.compile(lambda ns, s: ns.advance(s, nsteps))(st)
        return ctx.gather_state(st)

    # the Taylor-Green box: state slicing, step, dot, matvec, rmatvec, eigs
    m = tg_mesh(box_mesh_2d)
    u0 = T(tg_velocity(m))
    ctx = ShardedContext(m, dm, viscosity=TG_NU, dt=TG_DT)
    # a thermal state with filled histories and the warm-start slot, sliced
    # on each field's element axis and gathered back
    g = torch.Generator().manual_seed(0)
    full = ctx.make_host_state(u0, T=torch.randn(tuple(u0.shape[:-1]) + (2,), generator=g))
    full.ulag, full.nlag = torch.randn(full.ulag.shape, generator=g), torch.randn(
        full.nlag.shape, generator=g)
    full.tlag, full.dp = torch.randn(full.tlag.shape, generator=g), torch.randn(
        full.dp.shape, generator=g)
    part = ctx.shard_state(full)
    back = ctx.gather_state(part)
    res["state_roundtrip"] = torch.tensor(
        part.tlag.shape[1] == part.T.shape[0] == m.nelem // world
        and all(torch.equal(getattr(back, f), getattr(full, f))
                for f in ("u", "p", "ulag", "nlag", "T", "tlag", "ntlag", "dp")))
    st = advance(ctx, u0, TG_STEPS)
    res["tg_u"], res["tg_p"] = st.u, st.p
    res["dot"] = ctx.compile(lambda ns, q: ns.sem.inner(q[..., 0], q[..., 0]))(
        ctx.shard_field(u0))

    # about a nonzero base, so the transpose of the convective terms
    # crosses the ranks' boundaries
    ctx = ShardedContext(m, dm, viscosity=TG_NU, dt=MV_DT)
    base = ctx.shard_field(MV_BASE * u0)
    op = LinearizedOperator(ctx.ns, base, nsteps=MV_STEPS)
    q, w = ctx.shard_field(u0), ctx.shard_field(T(tg_weight(m)))
    Mq, Mw = op.matvec(q), op.rmatvec(w)
    space = velocity_space(ctx.sem)
    res["matvec"], res["rmatvec"] = ctx.gather_field(Mq), ctx.gather_field(Mw)
    res["identity"] = torch.stack([space.dot(Mq, w), space.dot(q, Mw)])

    x0 = velocity_noise(ctx.sem, seed=EIGS_SEED)
    got = eigs(op.matvec, space, x0, **EIGS)
    res["eigs_H"], res["eigs_ritz"] = torch.as_tensor(got.H), torch.as_tensor(got.eigenvalues)
    res["eigs_matvecs"] = torch.tensor(got.n_matvecs)
    res["basis_nelem"] = torch.tensor(got.basis.Q.shape[1])
    res["audit"] = torch.tensor(got.orthonormality_audit(space, ncols=6))
    re, im = got.mode(0)
    res["mode_norm"] = space.norm(re)
    res["mode_finite"] = torch.tensor(bool(torch.isfinite(re).all() and torch.isfinite(im).all()))

    # the cylinder: Dirichlet and wall BCs, the sponge, the masked product
    m = cylinder_mesh(**CYL)
    ubc, lam, ref, u0 = (T(a) for a in cylinder_fields(m, smooth_step))
    ctx = ShardedContext(m, dm, viscosity=CYL_NU, dt=CYL_DT, u_bc=ubc, sponge_strength=lam,
                         sponge_ref=ref)
    vmask = ctx._sem_host.vmask
    st = advance(ctx, u0 * vmask + (1.0 - vmask) * ubc, CYL_STEPS)
    res["cyl_u"] = st.u
    u = ctx.shard_field(st.u)[..., 0]
    res["cyl_energy"] = ctx.sem.inner(u, u)

    # the 3-D periodic box
    m = box3_mesh(box_mesh_3d)
    ctx = ShardedContext(m, dm, viscosity=BOX3_NU, dt=BOX3_DT)
    res["box3_u"] = advance(ctx, T(box3_velocity(m)), BOX3_STEPS).u

    # the graded BFS: 'schwarz' asked, on a host SEM that holds patches (a
    # stand-in that fails if applied), falls back to the sharded exact blocks
    case = BackwardFacingStepCase(device="cpu")
    cfg = SolverConfig(**BFS_SOLVER, pressure_precond="schwarz")
    ctx = ShardedContext(case.mesh, dm, viscosity=BFS_NU, dt=BFS_DT, u_bc=case.u_bc,
                         solver=cfg)
    ctx._sem_host.pschwarz, ctx._sem_host.p0Acinv = ("not element-local",), torch.zeros(1)
    ctx.sem = ctx._sem_host.shard_view(ctx.arrays, dm.group)
    ns = ctx.ns
    res["bfs_scrubbed"] = torch.tensor(ns.sem.pschwarz is None and ns.sem.p0Acinv is None
                                       and ns.sem.pblock_inv is not None)
    st = ctx.shard_state(ctx.make_host_state(case.u_bc))
    res["bfs_u"] = ctx.gather_field(ns.advance(st, BFS_STEPS).u)

    if world == CUBE_WORLD:
        cube_example(out + ".cube")
    if rank == 0:
        np.savez(out, **{k: v.detach().cpu().numpy() for k, v in res.items()})
    dm.close()


def cube_example(outdir: str) -> None:
    """``examples_torch/cube_transient_growth.py``'s stages on this process
    group (cut as tests/test_torch_cube_example.py cuts them): the sharded
    growth stage with its 1e-6 gate against the single-device svds, which
    runs over two or more ranks; rank 0 writes ``growth.json``."""
    import importlib.util

    from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase

    spec = importlib.util.spec_from_file_location(
        "cube_example", os.path.join(ROOT, "examples_torch", "cube_transient_growth.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    case = CubeRoughnessCase(**CUBE, device="cpu")
    example.CHUNK, example.MAX_STEPS, example.HORIZONS = 2, 4, (case.dt,)
    example.SVDS_TOL = 5e-2
    example.main(["--outdir", outdir, "--k-dim", "6"], case=case)


# ---------------------------------------------------------------------------
# the references and the checks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        store, out = str(tmp / f"store{world}"), str(tmp / f"out{world}.npz")
        ranks = []
        for r in range(world):
            with open(tmp / f"log{world}_{r}.txt", "w") as log:
                ranks.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), str(world), store, out],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        procs[world] = (out, ranks)
    try:
        refs = references()
        results = {}
        for world, (out, ranks) in procs.items():
            codes = [p.wait(timeout=TIMEOUT) for p in ranks]
            logs = "".join((tmp / f"log{world}_{r}.txt").read_text() for r in range(world))
            assert codes == [0] * world, logs[-4000:]
            with np.load(out) as f:
                results[world] = dict(f)
            if world == CUBE_WORLD:
                with open(os.path.join(out + ".cube", "growth.json")) as fh:
                    results[world]["cube_growth"] = json.load(fh)
    finally:
        for _, ranks in procs.values():
            for p in ranks:
                p.kill()
                p.wait()
    return refs, results


def references() -> dict:
    """The JAX single-device functions (jitted) and the port's single-device
    runs on the same inputs: ``{name: (jax, port)}``."""
    import jax
    import jax.numpy as jnp

    from nekstab_next_tpu.algorithms.stability import velocity_space as jvelocity_space
    from nekstab_next_tpu.cases.bfs import BackwardFacingStepCase as JBFS
    from nekstab_next_tpu.cases.cylinder import smooth_step as jsmooth_step
    from nekstab_next_tpu.config import SolverConfig as JSolverConfig
    from nekstab_next_tpu.krylov import eigs as jeigs
    from nekstab_next_tpu.mesh import box_mesh_2d as jbox_mesh_2d
    from nekstab_next_tpu.mesh.cylinder import cylinder_mesh as jcylinder_mesh
    from nekstab_next_tpu.mesh.mesh3 import box_mesh_3d as jbox_mesh_3d
    from nekstab_next_tpu.ops import SEM as JSEM
    from nekstab_next_tpu.ops.core3 import SEM3 as JSEM3
    from nekstab_next_tpu.stepper import NavierStokes as JNS
    from nekstab_next_tpu.stepper.linearized import LinearizedOperator as JLin
    from nekstab_next_tpu.utils.noise import velocity_noise as jvelocity_noise
    from nekstab_next_tpu_torch.algorithms.stability import velocity_space
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.krylov import eigs
    from nekstab_next_tpu_torch.mesh import box_mesh_2d, cylinder_mesh
    from nekstab_next_tpu_torch.mesh.mesh3 import box_mesh_3d
    from nekstab_next_tpu_torch.ops.core import SEM
    from nekstab_next_tpu_torch.ops.core3 import SEM3
    from nekstab_next_tpu_torch.stepper import NavierStokes
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu_torch.utils.noise import velocity_noise

    threads, opt = torch.get_num_threads(), torch.backends.opt_einsum.enabled
    torch.set_num_threads(1)
    torch.backends.opt_einsum.enabled = False
    J, T = jnp.asarray, torch.as_tensor
    jadvance = lambda ns, u0, n: jax.jit(lambda s: ns.advance(s, n))(ns.make_state(J(u0)))
    padvance = lambda ns, u0, n: ns.advance(ns.make_state(T(u0)), n)
    ref = {}
    try:
        # the Taylor-Green box
        jm, m = tg_mesh(jbox_mesh_2d), tg_mesh(box_mesh_2d)
        np.testing.assert_array_equal(jm.x, m.x)
        u0 = tg_velocity(m)
        jsem, sem = JSEM(jm), SEM(m, device="cpu")
        js = jadvance(JNS(jsem, viscosity=TG_NU, dt=TG_DT), u0, TG_STEPS)
        ps = padvance(NavierStokes(sem, viscosity=TG_NU, dt=TG_DT), u0, TG_STEPS)
        ref["tg_u"], ref["tg_p"] = (js.u, ps.u), (js.p, ps.p)
        ref["dot"] = (jsem.inner(J(u0[..., 0]), J(u0[..., 0])),
                      sem.inner(T(u0[..., 0]), T(u0[..., 0])))

        jns, ns = JNS(jsem, viscosity=TG_NU, dt=MV_DT), NavierStokes(sem, viscosity=TG_NU, dt=MV_DT)
        w = tg_weight(m)
        jop = JLin(jns, MV_BASE * J(u0), nsteps=MV_STEPS)
        op = LinearizedOperator(ns, MV_BASE * T(u0), nsteps=MV_STEPS)
        ref["matvec"] = (jop.matvec(J(u0)), op.matvec(T(u0)))
        ref["rmatvec"] = (jop.rmatvec(J(w)), op.rmatvec(T(w)))
        jr = jeigs(jop.matvec, jvelocity_space(jsem), jvelocity_noise(jsem, seed=EIGS_SEED),
                   **EIGS)
        pr = eigs(op.matvec, velocity_space(sem), velocity_noise(sem, seed=EIGS_SEED), **EIGS)
        ref["eigs_H"] = (jr.H, pr.H)
        ref["eigs_ritz"] = (jr.eigenvalues, pr.eigenvalues)

        # the cylinder
        jm, m = jcylinder_mesh(**CYL), cylinder_mesh(**CYL)
        np.testing.assert_array_equal(jm.x, m.x)
        ubc, lam, sref, u0 = cylinder_fields(m, jsmooth_step)
        jsem, sem = JSEM(jm), SEM(m, device="cpu")
        jsem.set_sponge(lam)
        sem.set_sponge(lam)
        jns = JNS(jsem, viscosity=CYL_NU, dt=CYL_DT, u_bc=J(ubc), sponge_ref=J(sref))
        ns = NavierStokes(sem, viscosity=CYL_NU, dt=CYL_DT, u_bc=T(ubc), sponge_ref=T(sref))
        u0 = np.array(J(u0) * jsem.vmask + jns.u_bc)
        js, ps = jadvance(jns, u0, CYL_STEPS), padvance(ns, u0, CYL_STEPS)
        ref["cyl_u"] = (js.u, ps.u)
        ref["cyl_energy"] = (jsem.inner(js.u[..., 0], js.u[..., 0]),
                             sem.inner(ps.u[..., 0], ps.u[..., 0]))

        # the 3-D box
        jm, m = box3_mesh(jbox_mesh_3d), box3_mesh(box_mesh_3d)
        u0 = box3_velocity(m)
        ref["box3_u"] = (
            jadvance(JNS(JSEM3(jm), viscosity=BOX3_NU, dt=BOX3_DT), u0, BOX3_STEPS).u,
            padvance(NavierStokes(SEM3(m, device="cpu"), viscosity=BOX3_NU, dt=BOX3_DT),
                     u0, BOX3_STEPS).u)

        # the graded BFS under 'block'
        jcase, case = JBFS(), BackwardFacingStepCase(device="cpu")
        np.testing.assert_array_equal(np.asarray(jcase.u_bc), case.u_bc.numpy())
        jns = JNS(JSEM(jcase.mesh), viscosity=BFS_NU, dt=BFS_DT, u_bc=jcase.u_bc,
                  solver=JSolverConfig(**BFS_SOLVER, pressure_precond="block"))
        ns = NavierStokes(case.sem, viscosity=BFS_NU, dt=BFS_DT, u_bc=case.u_bc,
                          solver=SolverConfig(**BFS_SOLVER, pressure_precond="block"))
        u0 = case.u_bc.numpy()
        ref["bfs_u"] = (jadvance(jns, u0, BFS_STEPS).u, padvance(ns, u0, BFS_STEPS).u)
    finally:
        torch.set_num_threads(threads)
        torch.backends.opt_einsum.enabled = opt
    return {k: tuple(np.asarray(x) for x in v) for k, v in ref.items()}


def rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


# (name, tolerance) of each gathered field: max abs error over max |ref|
FIELDS = {
    "tg_u": 1e-10, "tg_p": 1e-9, "matvec": 1e-10, "rmatvec": 1e-10,
    "cyl_u": 1e-10, "box3_u": 1e-10,
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sharded_field_matches_single_device(runs, world, name):
    refs, results = runs
    got = results[world][name]
    for ref in refs[name]:
        assert got.shape == ref.shape
        assert rel(got, ref) < FIELDS[name], (name, world, rel(got, ref))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bfs_block_step_matches(runs, world):
    # tests/test_parallel.py's graded BFS: 'block' at 1e-9 x max(scale, 1);
    # the shard view scrubbed the host's 'schwarz' patches
    refs, results = runs
    got = results[world]["bfs_u"]
    assert bool(results[world]["bfs_scrubbed"])
    for ref in refs["bfs_u"]:
        scale = float(np.max(np.abs(ref)))
        assert float(np.max(np.abs(got - ref))) < 1e-9 * max(scale, 1.0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_round_trip(runs, world):
    # shard_state slices every field of a thermal, warm-started state on its
    # element axis (the lag axes on their second); gather_state undoes it
    assert bool(runs[1][world]["state_roundtrip"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dots_match(runs, world):
    refs, results = runs
    r = results[world]
    for ref in refs["dot"]:
        assert abs(float(r["dot"]) - float(ref)) < 1e-12 * abs(float(ref))
    for ref in refs["cyl_energy"]:  # the sponge-masked product
        assert abs(float(r["cyl_energy"]) - float(ref)) < 1e-10 * abs(float(ref))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_rmatvec_adjoint_identity(runs, world):
    a, b = runs[1][world]["identity"]
    assert abs(a - b) < 1e-12 * abs(a), (a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eigs_matches(runs, world):
    refs, results = runs
    r = results[world]
    # the basis holds this rank's elements of every column
    assert int(r["basis_nelem"]) == TG["nx"] * TG["ny"] // world
    for H, ritz in zip(refs["eigs_H"], refs["eigs_ritz"]):
        np.testing.assert_allclose(r["eigs_H"], H, atol=1e-8)
        np.testing.assert_allclose(np.sort_complex(r["eigs_ritz"][:4]),
                                   np.sort_complex(ritz[:4]), rtol=1e-8, atol=1e-12)
    assert float(r["audit"]) < 1e-10
    assert bool(r["mode_finite"]) and float(r["mode_norm"]) > 0.0


def test_cube_example_sharded_gate(runs):
    """The cube example over two ranks: ``devices`` is the world size, and
    its sharded G(T) passed the adjoint gate and the 1e-6 gate against the
    single-device svds from the same start."""
    growth = runs[1][CUBE_WORLD]["cube_growth"]
    assert growth["devices"] == CUBE_WORLD and growth["nelem"] == 20
    (point,) = growth["points"]
    assert np.isfinite(point["G"]) and point["G"] > 0.0 and point["adjoint_rel"] < 1e-6
    assert point["sharded_vs_single_rel"] < 1e-6
    assert point["G_single_device"] == pytest.approx(point["G"], rel=1e-6)


def test_sharded_context_refusals():
    """``nelem % world_size`` raises with JAX's message, and a sharded
    stepper with ``mixed_precision=True`` raises (JAX cannot trace it)."""
    from nekstab_next_tpu_torch.mesh import box_mesh_2d
    from nekstab_next_tpu_torch.parallel import DeviceMesh, ShardedContext, make_device_mesh

    m = box_mesh_2d(3, 3, order=4)
    with pytest.raises(ValueError, match="must be divisible by the 2-device mesh"):
        ShardedContext(m, DeviceMesh(None, 0, 2, torch.device("cpu"), "gloo"))
    dm = make_device_mesh(1, device="cpu")
    try:
        ctx = ShardedContext(m, dm, viscosity=0.05, dt=0.01, mixed_precision=True)
        with pytest.raises(NotImplementedError, match="cannot trace"):
            ctx.make_ns()
    finally:
        dm.close()


def test_one_rank_view_is_the_single_device_step():
    """Over a one-rank group the shard view makes no collective: its step
    is the single-device step bit for bit, and it still takes the sharded
    branches (no kernel, no host-only preconditioner)."""
    from nekstab_next_tpu_torch.mesh import box_mesh_2d
    from nekstab_next_tpu_torch.ops.core import SEM
    from nekstab_next_tpu_torch.parallel import ShardedContext, make_device_mesh
    from nekstab_next_tpu_torch.stepper import NavierStokes

    m = tg_mesh(box_mesh_2d)
    u0 = torch.as_tensor(tg_velocity(m))
    dm = make_device_mesh(1, device="cpu")
    try:
        ctx = ShardedContext(m, dm, viscosity=TG_NU, dt=TG_DT)
        assert ctx.sem.sharded and ctx.sem.group is None and ctx.sem.nshards == 1
        got = ctx.gather_state(ctx.compile(lambda ns, s: ns.advance(s, 2))(
            ctx.shard_state(ctx.make_host_state(u0))))
    finally:
        dm.close()
    ns = NavierStokes(SEM(m, device="cpu"), viscosity=TG_NU, dt=TG_DT)
    ref = ns.advance(ns.make_state(u0), 2)
    assert torch.equal(got.u, ref.u) and torch.equal(got.p, ref.p)


def test_device_mesh_needs_its_device_and_backend(monkeypatch):
    from nekstab_next_tpu_torch.parallel import make_device_mesh

    # no CUDA device and none given: raises, no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_mesh(1)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        make_device_mesh(1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        make_device_mesh(1, device="cpu", backend="mpi-ish")


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
