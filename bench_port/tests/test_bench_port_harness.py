"""CPU tests of the port's benchmark harness (``bench_port/``).

Run from the checkout's root:  python -m pytest bench_port/tests -q
(about two minutes on a CPU).  The tiny cells run the program's plain
CPU versions of the kernels; the test marked ``cuda`` runs a real cell on
the card and skips elsewhere."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port.harness import guard, roofline, spec  # noqa: E402
from bench_port.harness.main import run_cell  # noqa: E402
from bench_port.harness.trace import Trace  # noqa: E402
from bench_port.tests import tiny  # noqa: E402

SEED = 4294967311  # larger than 32 signed bits hold


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


# -- the tiny cells end to end ---------------------------------------------
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_end_to_end(tiny_root, cell):
    root, bench = tiny_root
    r = run_cell(root, cell, SEED, 2.0, trace=False, device="cpu", bench_dir=bench)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"dof_steps_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(tiny.LIMITS[cell])


def test_tiny_traced_run(tiny_root):
    root, bench = tiny_root
    r = run_cell(root, "tiny_bfs_tg", SEED + 1, 6.0, trace=True, device="cpu", bench_dir=bench)
    assert r["correct"], r["checks"]
    # no card: the program's counters and host spans, no device metric
    assert {"krylov.ortho_ms", "prop.apply_ms"} <= set(r["metrics"])
    assert not {"k1_roofline", "k2_roofline", "device.idle_pct"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0


def test_same_seed_same_inputs():
    from bench_port.harness.main import start_vectors
    from bench_port.reference import mesh2d

    m = mesh2d.build(tiny.BFS)
    traffic = spec.load_json(os.path.join(ROOT, "bench_port", "traffic", "tg_svds.json"))
    draw = lambda seed: start_vectors(m, traffic, seed, torch.device("cpu"), torch.float32)
    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert torch.equal(a(0), b(0)) and torch.equal(a(1), b(1))
    assert not torch.equal(a(0), c(0)) and not torch.equal(a(0), a(1))
    # continuous, admissible and outside the sponge
    assert float(torch.sum(a(0) ** 2 * torch.as_tensor(m.bms)[..., None])) > 0
    assert float(torch.abs(a(0) * torch.as_tensor(1.0 - m.vmask)[..., None]).max()) == 0.0
    assert float(torch.abs(a(0) * torch.as_tensor(m.sponge > 0)[..., None]).max()) == 0.0


# -- the control and the faults come out not correct -------------------------
@pytest.mark.parametrize("cell", ["tiny_cyl_direct", "tiny_bfs_tg"])
def test_control_is_not_correct(tiny_root, cell):
    """The reference in the next precision below the configuration's, put
    in the program's place, fails a compared number."""
    root, bench = tiny_root
    r = run_cell(root, cell, SEED, 1.5, trace=False, device="cpu", bench_dir=bench,
                 control=True)
    assert not r["correct"], r["checks"]


def _fault(kind):
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    mv, rmv = LinearizedOperator.matvec, LinearizedOperator.rmatvec

    def unchanged(self, q):  # every step returns its state unchanged
        return q.clone()

    def altered(f):  # one answer altered where it is produced
        def g(self, q):
            y = f(self, q).clone()
            flat = y.view(-1)
            i = int(torch.argmax(flat.abs()))
            flat[i] = -flat[i]
            return y
        return g

    if kind == "unchanged":
        return unchanged, unchanged
    return altered(mv), altered(rmv)


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", ["tiny_cyl_direct", "tiny_cyl_adjoint", "tiny_bfs_tg"])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, kind):
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    mv, rmv = _fault(kind)
    root, bench = tiny_root
    monkeypatch.setattr(LinearizedOperator, "matvec", mv)
    monkeypatch.setattr(LinearizedOperator, "rmatvec", rmv)
    r = run_cell(root, cell, SEED, 1.0, trace=False, device="cpu", bench_dir=bench)
    assert r["attempted"] >= 1
    assert not r["correct"], r["checks"]


# -- the guard ---------------------------------------------------------------
def test_guard_compares_top_level_names_whole():
    mods = ["jax.numpy", "jaxlib.xla", "flax", "nekstab_next_tpu.ops.core",
            "nekstab_next_tpu_torch.ops.core", "jaxtyping", "numpy", "flaxen"]
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib", "nekstab_next_tpu"]
    assert guard.forbidden_modules(["nekstab_next_tpu_torch", "nekstab_next_tpu_torch.x"]) == []


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.harness.main, bench_port.harness.check, bench_port.harness.trace\n"
            "import bench_port.cases.cylinder, bench_port.cases.backward_facing_step\n"
            "import bench_port.reference.pnpn2_2d\n"
            "import nekstab_next_tpu_torch.cases.cylinder, nekstab_next_tpu_torch.cases.bfs\n"
            "import nekstab_next_tpu_torch.stepper.linearized, nekstab_next_tpu_torch.krylov\n"
            "import nekstab_next_tpu_torch.algorithms.stability\n"
            "from bench_port.harness import guard\n"
            "print(guard.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_neither_jax_nor_the_program():
    ref = os.path.join(ROOT, "bench_port", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            src = open(os.path.join(ref, f)).read()
            assert "nekstab_next_tpu" not in src and "import jax" not in src, f


# -- everything found by name --------------------------------------------------
def test_every_cell_and_metric_resolves():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for w in bench["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        cell.case_module(), cell.reference_module()
        sha = hashlib.sha256(open(cell.path(cell.config["base_flow"]["file"]), "rb").read())
        assert sha.hexdigest() == cell.config["base_flow"]["sha256"]
        for m in cell.per_layer:
            r = cell.readers[m["name"]]
            assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES) == (
                m["layer"], m["unit"], m["better"], m["source"], m["moves"])
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def _tree_digest(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            if "__pycache__" not in d:
                h.update(open(os.path.join(d, f), "rb").read())
    return h.hexdigest()


POWER_LOOP = '''"""A power iteration on one direction: a loop that no existing file names."""

from bench_port.harness import check

KEYS = {"direction"}


def directions(traffic):
    return [traffic["direction"]]


def analysis(traffic, krylov, op, space, x0, rec, control):
    d = traffic["direction"]
    apply = rec.wrap(d, op.matvec if d == "matvec" else op.rmatvec)
    x = x0 / space.dot(x0, x0) ** 0.5
    for _ in range(krylov["k_dim"]):
        y = apply(x)
        x = y / space.dot(y, y) ** 0.5


def judge(ref, apps, pending, traffic, krylov, nsteps, x0, seed):
    numbers = check.start_vector(ref, apps, x0)
    for i in check.sample(apps, directions(traffic), traffic["checked_applications"], seed):
        check.propagator(ref, apps[i], nsteps, numbers)
    return numbers
'''


def test_new_files_are_picked_up_without_edits(tmp_path):
    """A new configuration, traffic mix, loop, metric and cell are files
    and entries: the harness finds them and runs the new loop, and no file
    that was there changes."""
    import shutil

    bench_src = os.path.join(ROOT, "bench_port")
    before = _tree_digest(bench_src)
    root, bench = tiny.make_root(str(tmp_path))
    bdir = tmp_path / "root" / "bench_port"
    cfg = spec.load_json(str(bdir / "configs" / "tiny_cyl.json"))
    cfg = dict(cfg, name="tiny_cyl_longer", steps_per_application=5,
               krylov=dict(cfg["krylov"], k_dim=32))
    (bdir / "configs" / "tiny_cyl_longer.json").write_text(json.dumps(cfg))
    (bdir / "loops" / "power.py").write_text(POWER_LOOP)
    traffic = {"name": "power_direct", "loop": "power", "direction": "matvec",
               "start_outside_sponge": False, "traced_applications": 1,
               "checked_applications": 2}
    (bdir / "traffic" / "power_direct.json").write_text(json.dumps(traffic))
    (bdir / "limits" / "cyl_power.json").write_text(
        json.dumps({"prop_matvec": 1e-7, "start_vector": 1e-12}))
    (bdir / "metrics" / "krylov.apps_per_analysis.py").write_text(
        'LAYER = "Krylov layer"\nUNIT = "applications"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nMOVES = "dof_steps_per_s"\n\n\n'
        'def read(run):\n    return float(len(run.apps))\n')
    bench = json.loads((tmp_path / "root" / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny_cyl_longer",
                                 file="bench_port/configs/tiny_cyl_longer.json"))
    bench["workloads"].append({"name": "cyl_power", "config": "tiny_cyl_longer",
                               "traffic": "power_direct", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "krylov.apps_per_analysis", "unit": "applications",
                               "better": "higher", "source": "program_counter",
                               "layer": "Krylov layer", "moves": "dof_steps_per_s",
                               "workloads": ["cyl_power"]})
    (tmp_path / "root" / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(root, "cyl_power", str(bdir))
    assert cell.config["steps_per_application"] == 5 and cell.config["krylov"]["k_dim"] == 32
    assert cell.loop.directions(cell.traffic) == ["matvec"]
    assert "krylov.apps_per_analysis" in cell.readers
    r = run_cell(root, "cyl_power", SEED, 1.5, trace=False, device="cpu", bench_dir=str(bdir))
    assert r["correct"] and set(r["checks"]) == {"prop_matvec", "start_vector"}, r["checks"]
    old = spec.load_cell(root, "tiny_cyl_direct", str(bdir))
    assert "krylov.apps_per_analysis" not in old.readers
    assert _tree_digest(bench_src) == before


def test_traffic_key_that_nothing_reads_is_refused(tmp_path):
    root, bench = tiny.make_root(str(tmp_path))
    f = os.path.join(bench, "traffic", "eigs_direct.json")
    traffic = dict(spec.load_json(f), clients=4)
    with open(f, "w") as fh:
        json.dump(traffic, fh)
    with pytest.raises(ValueError, match="clients"):
        spec.load_cell(root, "tiny_cyl_direct", bench)


# -- the arithmetic ------------------------------------------------------------
def test_busy_us_is_the_union_of_intervals():
    assert roofline.busy_us([]) == 0.0
    assert roofline.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.8)]) == 4.0
    assert roofline.busy_us([(4, 5), (0, 1)]) == 2.0


def test_least_time_takes_the_larger_bound():
    assert roofline.least_time(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_time(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.iterations(2 + 4 * 17) == 17


def _run_stub(trace=None, apps=(), gaps=(), launches=None, nsteps=10):
    from bench_port.harness.main import Run

    r = Run(None, dof=100, nsteps=nsteps)
    r.apps, r.gaps, r.trace = list(apps), list(gaps), trace
    r.launches = launches or {}
    return r


def test_readers_on_synthetic_inputs():
    import types

    readers = {n: spec.metric_reader(n) for n in
               ("k1_roofline", "k2_roofline", "device.idle_pct", "krylov.ortho_ms",
                "prop.apply_ms", "step.kernel_launches")}
    s1 = dict(E=10, n=7, C=2, M=4)
    s2 = dict(E=10, n=7, nc=12, M=4, MV=4)
    t1 = sum(roofline.least_time(roofline.k1_bytes(10, 7, 2, 4), roofline.k1_flops(10, 7, 2, k))
             for k in (5, 6))
    t2 = roofline.least_time(roofline.k2_bytes(10, 7, 12, 4, 4),
                             roofline.k2_flops(10, 7, 12, 300))
    tr = Trace(window_s=2.0, busy_s=0.5, kernels=[("x", 0, 1)],
               kernel_s={"k1": 2 * t1, "k2": 4 * t2},
               launches={"k1": [5, 6], "k2": [300]}, shapes={"k1": s1, "k2": s2})
    run = _run_stub(tr)
    assert readers["k1_roofline"].read(run) == pytest.approx(50.0)
    assert readers["k2_roofline"].read(run) == pytest.approx(25.0)
    assert readers["device.idle_pct"].read(run) == pytest.approx(75.0)
    assert readers["k1_roofline"].read(_run_stub(None)) is None
    app = lambda t0, t1: types.SimpleNamespace(t0=t0, t1=t1)
    run = _run_stub(None, apps=[app(0, 1), app(1.5, 3.5), app(4, 5)],
                    gaps=[(1, 0.5), (2, 0.5)], launches={"k1": 60, "k2": 60})
    assert readers["prop.apply_ms"].read(run) == pytest.approx(1000.0)
    assert readers["krylov.ortho_ms"].read(run) == pytest.approx(500.0)
    assert readers["step.kernel_launches"].read(run) == pytest.approx(4.0)
    run.traced = 1  # the first application ran under the profiler
    assert readers["prop.apply_ms"].read(run) == pytest.approx(1500.0)
    assert readers["krylov.ortho_ms"].read(run) == pytest.approx(500.0)


def test_rate_is_work_over_the_whole_window(tiny_root):
    root, bench = tiny_root
    r = run_cell(root, "tiny_cyl_direct", SEED, 1.0, trace=False, device="cpu", bench_dir=bench)
    cfg = tiny.CYL
    from bench_port.reference import mesh2d

    m = mesh2d.build(cfg)
    dof = m.nelem * m.n * m.n * 2
    rate = r["metrics"]["dof_steps_per_s"]["value"]
    # attempted applications of 3 steps each over a window of at least 1 s
    assert rate <= dof * 3 * r["attempted"] / 1.0 + 1e-9
    assert rate > 0


def test_kernel_bytes_count_the_kernels_inputs():
    """k1_bytes and k2_bytes equal rhs + x + every constant the kernels
    read, as the program builds them (on the CPU here)."""
    from bench_port.harness.trace import kernel_shape

    cfg = tiny.BFS
    case = __import__("bench_port.cases.backward_facing_step", fromlist=["build"])
    c = case.build(cfg, torch.device("cpu"), tiny.base_flow(cfg))
    for key, inst in c.kernels.items():
        consts = inst._device_consts(torch.device("cpu"))
        nbytes = sum(t.numel() * t.element_size() for t in consts.values())
        s = kernel_shape(inst)
        if key == "k1":
            rhs = inst.E * inst.n * inst.n * inst.C * 4
            assert roofline.k1_bytes(s["E"], s["n"], s["C"], s["M"]) == 2 * rhs + nbytes
        else:
            rhs = inst.E * (inst.n - 2) ** 2 * 4
            assert roofline.k2_bytes(s["E"], s["n"], s["nc"], s["M"], s["MV"]) == 2 * rhs + nbytes


# -- the frozen reference against the program's float64 plain step --------------
@pytest.mark.parametrize("cfg", [tiny.CYL, tiny.BFS], ids=["cylinder", "bfs"])
def test_reference_matches_the_program_f64_plain_step(cfg):
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    from bench_port.reference.pnpn2_2d import Tangent

    tight = dict(pressure_tol=1e-14, velocity_tol=1e-14, pressure_maxiter=20000,
                 velocity_maxiter=20000, pressure_precond="block")
    cfg64 = dict(cfg, dtype="float64", mixed_precision=False, solver=tight)
    base = tiny.base_flow(cfg)
    mod = __import__(f"bench_port.cases.{cfg['case']}", fromlist=["build"])
    c = mod.build(cfg64, torch.device("cpu"), base)
    op = LinearizedOperator(c.ns, c.base, nsteps=5)
    ref = Tangent(cfg64, base, "cpu")
    rng = np.random.default_rng(3)
    q = c.sem.vmask * c.sem.dsavg(torch.as_tensor(rng.standard_normal(tuple(c.base.shape))))
    for direction, fn in (("matvec", op.matvec), ("rmatvec", op.rmatvec)):
        y, yr = fn(q), ref.apply(direction, q, 5)
        assert float((y - yr).norm() / yr.norm()) < 1e-11, direction


# -- the base flows' interpolation ------------------------------------------------
@pytest.mark.parametrize("cfg", [tiny.CYL, tiny.BFS], ids=["cylinder", "bfs"])
def test_base_flow_interpolation_is_exact_on_polynomials(cfg):
    """A field polynomial in each element's tensor coordinates moves from
    one mesh of a case to another of other counts and order exactly."""
    from bench_port.reference import mesh2d
    from bench_port.tools.base_flow import interpolate

    if cfg["case"] == "cylinder":
        other = dict(cfg, order=6, nr=2, ntheta=7)
        f = lambda x, y: np.hypot(x, y) ** 3 - 2.0 * np.hypot(x, y)
    else:
        other = dict(cfg, order=5, elems_upstream=2, elems_downstream=5, elems_y=2)
        f = lambda x, y: x ** 3 - 2.0 * x * y ** 2 + y
    m = mesh2d.build(other)
    u = np.stack([f(m.x, m.y), -f(m.x, m.y)], axis=-1)
    out = interpolate(u, other, cfg)
    t = mesh2d.build(cfg)
    exact = f(t.x, t.y)
    scale = np.abs(exact).max()
    assert np.abs(out[..., 0] - exact).max() < 1e-13 * scale
    assert np.abs(out[..., 1] + exact).max() < 1e-13 * scale


# -- the contract's form of BENCHMARK.json ---------------------------------------
def test_benchmark_json_form():
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert all(name.match(n) for n in names)
    assert len(set(e["name"] for e in bench["end_to_end"] + bench["per_layer"])) == len(
        bench["end_to_end"]) + len(bench["per_layer"])
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert unit.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_on_the_card(card):
    # a window that completes applications after the two profiled ones
    r = run_cell(ROOT, "cyl_eigs_direct", SEED, 12.0, trace=True, device=str(card))
    assert r["correct"], r["checks"]
    assert {"k1_roofline", "k2_roofline", "device.idle_pct"} <= set(r["metrics"])
    assert 0 < r["metrics"]["k2_roofline"]["value"] <= 100
