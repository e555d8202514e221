"""The port's public names cover the JAX package's: every public class,
function and method of every JAX module, with each of its parameter names,
has a counterpart of that name in the port, apart from what ``NOT_PORTED``
lists with its reason (the same list as ROADMAP.md's "Not to port").  The
test checks names only: not parameter order, defaults or behaviour, which
the other ``test_torch_*`` files hold against JAX.

Two kinds of entry say why a JAX name needs no port, and the test checks
that each still holds: ``unused``, a parameter the JAX function accepts and
deletes (``del``), and ``uncalled``, a name or parameter that nothing in the
JAX repository (its package, examples, tools, tests and root scripts) uses
outside its own module, or passes.  Once JAX code uses such a name, its
entry fails and the name wants its port.

The JAX side is read with ``ast``, so no JAX module is imported (``native/``
needs a compiler) and nothing of JAX runs.  The port side is imported and
read with ``inspect``, so methods a class inherits (those on ``SEMBase``)
count.  ``ops.pallas_kernels`` maps to ``ops.fused_helmholtz``; every other
module keeps its path.  What a package ``__init__`` imports from its
modules is its export, and the port's package must export it too.
"""

import ast
import importlib
import importlib.util
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "nekstab_next_tpu"
RENAMED = {"ops.pallas_kernels": "ops.fused_helmholtz"}

# (kind, what, reason).  kind: "module" (a JAX module, by its path in the
# package), "name" (module:qualified name), "method" (a method name on any
# JAX class), "parameter" (a parameter name of any JAX function or method),
# "option" (module:Class.field, a config field the port keeps so configs
# carry across but whose non-default value it refuses), "unused"
# (module:Qual(parameter), deleted by the JAX function) and "uncalled"
# (module:Qual or module:Qual(parameter), used by no JAX code).
NOT_PORTED = (
    ("module", "native", "the C++ node numbering; the port's numpy "
     "global_numbering reproduces it (mesh/mesh.py)"),
    ("module", "ops.lanes", "the TPU lanes layout (lanes_layout, "
     "pressure_direct): measured slower, and VERDICT Weak #8 deletes it"),
    ("name", "ops.pallas_kernels:FusedHelmholtz.to_lanes", "the lanes layout"),
    ("name", "ops.pallas_kernels:FusedHelmholtz.from_lanes", "the lanes layout"),
    ("name", "ops.pallas_kernels:FusedHelmholtz.apply_lanes", "the lanes layout"),
    ("name", "ops.fused_cg:get_exchange", "the roll-and-mask shift exchange as "
     "K1/K2's data path exists because Pallas has no gather; the port keeps "
     "only its predicate (ops/exchange.py shift_decomposes)"),
    ("name", "ops.cg:LANES_UNROLL_CAP", "a workaround for XLA While trips on the TPU"),
    ("name", "algorithms.resolvent:_gmres_device", "a fixed-iteration on-device "
     "GMRES, so the TPU path can be transposed under jit; the port has one "
     "map, host GMRES to gmres_tol"),
    ("method", "tree_flatten", "pytree registration, JAX machinery"),
    ("method", "tree_unflatten", "pytree registration, JAX machinery"),
    ("parameter", "interpret", "the Pallas interpreter switch; a CPU tensor "
     "runs a kernel's plain version"),
    ("parameter", "block_e", "the Pallas block size; K4 picks its own launch geometry"),
    ("parameter", "fixed_iters", "cg_fixed_iters, a workaround for XLA While "
     "trips on the TPU"),
    ("parameter", "unroll", "CG iterations per XLA While trip on the TPU"),
    ("parameter", "lanes", "the lanes layout"),
    ("parameter", "axis_name", "shard_map's axis; a shard view holds its "
     "torch.distributed group instead"),
    ("parameter", "axis", "shard_map's axis"),
    ("parameter", "jmesh", "the jax.sharding.Mesh; the port takes a DeviceMesh"),
    ("parameter", "in_specs", "shard_map's partition specs"),
    ("parameter", "out_specs", "shard_map's partition specs"),
    ("parameter", "local_arrays", "shard_map's per-shard arrays; every rank "
     "builds its own element block"),
    ("option", "config:SolverConfig.fused_pressure", "False is a workaround for "
     "the remote TPU compiler"),
    ("option", "config:SolverConfig.lanes_layout", "True is the lanes layout"),
    ("option", "config:SolverConfig.pressure_direct", "True is the lanes "
     "layout's dense pressure inverse"),
    ("option", "config:SolverConfig.cg_fixed_iters", "True is a workaround for "
     "XLA While trips on the TPU"),
    ("unused", "krylov.arnoldi:arnoldi_step(breakdown_tol)", "deleted by JAX; "
     "arnoldi_factorization tests its breakdown itself"),
    ("unused", "krylov.vector:Basis.rotate(ncols_out)", "deleted by JAX; the "
     "column count is read from V"),
    ("uncalled", "config:AnalysisMode", "the reference's uparam(1) codes; no "
     "JAX code dispatches on them"),
    ("uncalled", "config:Config", "no JAX code builds the top-level config; "
     "callers pass SolverConfig and NewtonConfig, which are ported"),
    ("uncalled", "config:SpongeConfig", "read only by config.Config"),
    ("uncalled", "config:KrylovConfig", "read only by config.Config"),
    ("uncalled", "config:SFDConfig", "read only by config.Config"),
    ("uncalled", "config:BoostConvConfig", "read only by config.Config"),
    ("uncalled", "stepper.linearized:compute_dt_nsteps", "no JAX code calls it; "
     "the cases and examples set dt and the step count themselves"),
    ("uncalled", "stepper.state:FlowState.replace", "no JAX code calls it"),
    ("uncalled", "ops.cg:pcg(x0)", "every JAX solve starts from zero"),
    ("uncalled", "ops.mixed:MixedPrecision(inner_tol)", "JAX builds it with the "
     "default 3e-6 only, the port's INNER_TOL"),
    ("uncalled", "ops.mixed:MixedPrecision(cycles)", "JAX builds it with the "
     "default 3 only, the port's CYCLES; ir_solve(cycles=) sets a solve's count"),
    ("uncalled", "ops.mixed:MixedPrecision.ir_solve(use_fdm)", "JAX solves with "
     "the FDM preconditioner only"),
    ("uncalled", "ops.schwarz:build_pressure_blocks(E_op)", "JAX takes the "
     "blocks of make_pressure_operator(sem) only"),
)

KINDS = ("module", "name", "method", "parameter", "option", "unused", "uncalled")


def _kinds(kind):
    return {what for k, what, _ in NOT_PORTED if k == kind}


def _split(what: str):
    """'module:Qual(param)' -> (module, Qual, param or None)."""
    module, qual = what.split(":")
    qual, _, param = qual.partition("(")
    return module, qual, param.rstrip(")") or None


def _needless():
    """The unused and uncalled entries as (names, {(module, Qual): params})."""
    names, params = set(), {}
    for what in _kinds("unused") | _kinds("uncalled"):
        module, qual, param = _split(what)
        if param is None:
            names.add(f"{module}:{qual}")
        else:
            params.setdefault((module, qual), set()).add(param)
    return names, params


def _jax_modules():
    """{module path in the package ('' for the top package): file}."""
    out = {}
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(JAX_PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


MODULES = _jax_modules()


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(ast.unparse(d).endswith(("property", ".setter")) for d in fn.decorator_list)


def _class_surface(node: ast.ClassDef):
    """(constructor parameters or None, {public member: parameters, or None
    for a property or class attribute})."""
    init, fields, members = None, [], {}
    dataclass = any("dataclass" in ast.unparse(d) for d in node.decorator_list)
    for b in node.body:
        if isinstance(b, ast.FunctionDef):
            if b.name == "__init__":
                init = _params(b)
            elif not b.name.startswith("_"):
                members[b.name] = None if _is_property(b) else _params(b)
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            fields.append(b.target.id)
        elif isinstance(b, ast.Assign):
            members.update({t.id: None for t in b.targets
                            if isinstance(t, ast.Name) and not t.id.startswith("_")})
    if init is None and dataclass:
        init = fields
    return init, members


def jax_surface(module: str):
    """{public name: ('function', params, {}) | ('class', params, members)}
    of a JAX module, and the names its package ``__init__`` exports."""
    path = MODULES[module]
    tree = ast.parse(path.read_text())
    surface = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            surface[node.name] = ("function", _params(node), {})
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            surface[node.name] = ("class",) + _class_surface(node)
    exports = []
    if path.name == "__init__.py":
        exports = [a.asname or a.name for n in tree.body
                   if isinstance(n, ast.ImportFrom) and n.level >= 1 for a in n.names]
    return surface, exports


def _defined_names(module: str):
    """Every top-level name a JAX module binds, private ones included, with
    each class's methods and annotated fields as 'Class.member'."""
    names = set()
    for node in ast.parse(MODULES[module].read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names |= {f"{node.name}.{b.name}" for b in node.body
                      if isinstance(b, ast.FunctionDef)}
            names |= {f"{node.name}.{b.target.id}" for b in node.body
                      if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def port_module_name(module: str) -> str:
    return ".".join(filter(None, ("nekstab_next_tpu_torch", RENAMED.get(module, module))))


def _port_params(obj):
    out = []
    for p in inspect.signature(obj).parameters.values():
        if p.name in ("self", "cls"):
            continue
        out.append({p.VAR_POSITIONAL: "*", p.VAR_KEYWORD: "**"}.get(p.kind, "") + p.name)
    return out


def _missing_params(where: str, ref, obj, skip=frozenset()):
    skip = _kinds("parameter") | skip
    got = _port_params(obj)
    return [f"{where}({p})" for p in ref if p not in got and p.lstrip("*") not in skip]


def gaps(module: str):
    """What the port lacks of one JAX module's public surface."""
    surface, exports = jax_surface(module)
    port = importlib.import_module(port_module_name(module))
    needless, needless_params = _needless()
    skip_names, skip_methods = _kinds("name") | needless, _kinds("method")
    skip_exports = {n.split(":")[1] for n in skip_names}
    out = [f"export {n}" for n in exports if not hasattr(port, n) and n not in skip_exports]
    skip = lambda qual: needless_params.get((module, qual), frozenset())
    for name, (kind, params, members) in surface.items():
        if f"{module}:{name}" in skip_names:
            continue
        obj = getattr(port, name, None)
        if obj is None:
            out.append(name)
            continue
        if params is not None:
            out += _missing_params(name, params, obj, skip(name))
        for member, mparams in members.items():
            qual = f"{name}.{member}"
            if member in skip_methods or f"{module}:{qual}" in skip_names:
                continue
            if not hasattr(obj, member):
                out.append(qual)
            elif mparams is not None:
                out += _missing_params(qual, mparams, getattr(obj, member), skip(qual))
    return out


def _jax_def(module: str, qual: str):
    """The ast node of a JAX module's top-level 'Name' or 'Class.method'."""
    nodes = ast.parse(MODULES[module].read_text()).body
    for part in qual.split("."):
        nodes = [n for n in nodes if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                 and n.name == part]
        assert nodes, f"nekstab_next_tpu.{module} defines no {qual}"
        node, nodes = nodes[0], nodes[0].body
    return node


def _jax_repo_files():
    """Every Python file of the JAX repository: the package, its examples,
    tools and tests, and the root scripts; none of the port's."""
    port = ("chip_smoke.py",)
    files = list(MODULES.values())
    for d in ("examples", "tools", "tests"):
        files += sorted((ROOT / d).glob("*.py"))
    files += sorted(p for p in ROOT.glob("*.py") if p.name not in port)
    return [p for p in files if not p.name.startswith("test_torch_")]


def _uses(module: str, qual: str, param=None):
    """Where JAX code uses a name outside its own module, or passes a
    parameter to it (by keyword, by position, or through * and ** as
    possibly): a list of 'file:line'."""
    node = _jax_def(module, qual)
    name = qual.split(".")[-1]
    if param is not None:
        fn = node
        if isinstance(node, ast.ClassDef):
            fn = next(b for b in node.body
                      if isinstance(b, ast.FunctionDef) and b.name == "__init__")
        pos = _params(fn).index(param)
    hits = []
    for path in _jax_repo_files():
        tree = ast.parse(path.read_text())
        # attributes of an imported module (os.replace) are not the method
        modules = {a.asname or a.name.split(".")[0] for n in ast.walk(tree)
                   if isinstance(n, ast.Import) for a in n.names}
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute):
                hit = n.attr == name and not (
                    isinstance(n.value, ast.Name) and n.value.id in modules)
            elif isinstance(n, ast.Name):
                hit = n.id == name and "." not in qual
            else:
                continue
            if not hit:
                continue
            if param is None:
                if path != MODULES[module] or "." in qual:
                    hits.append(f"{path.relative_to(ROOT)}:{n.lineno}")
                continue
            for call in ast.walk(tree):
                if not (isinstance(call, ast.Call) and call.func is n):
                    continue
                starred = any(isinstance(a, ast.Starred) for a in call.args)
                if (len(call.args) > pos or starred
                        or any(k.arg in (param, None) for k in call.keywords)):
                    hits.append(f"{path.relative_to(ROOT)}:{call.lineno}")
    return hits


@pytest.mark.parametrize("module", sorted(MODULES))
def test_port_has_the_jax_module_surface(module):
    if module in _kinds("module"):
        # not ported: the port has no such module
        assert importlib.util.find_spec(port_module_name(module)) is None
        return
    assert gaps(module) == [], f"the port lacks of nekstab_next_tpu.{module}"


@pytest.mark.parametrize("kind,what", [(k, w) for k, w, _ in NOT_PORTED])
def test_not_ported_entry_names_something_in_jax(kind, what):
    # a stale entry (one that names nothing in the JAX package any more)
    # would let the surface test pass over a gap that no longer exists
    if kind == "module":
        assert what in MODULES
    elif kind in ("name", "option"):
        module, name = what.split(":")
        assert name in _defined_names(module)
    elif kind == "method":
        assert any(what in {n.split(".")[-1] for n in _defined_names(m) if "." in n}
                   for m in MODULES)
    elif kind == "unused":
        module, qual, param = _split(what)
        fn = _jax_def(module, qual)
        assert param in _params(fn)
        assert any(isinstance(d, ast.Delete) and param in {t.id for t in d.targets
                                                            if isinstance(t, ast.Name)}
                   for d in ast.walk(fn)), f"JAX reads {what}"
    elif kind == "uncalled":
        module, qual, param = _split(what)
        assert _uses(module, qual, param) == [], f"JAX code uses {what}"
    else:
        assert any(what in [p.lstrip("*") for p in _params(node)]
                   for path in MODULES.values()
                   for node in ast.walk(ast.parse(path.read_text()))
                   if isinstance(node, ast.FunctionDef))


def test_not_ported_entries_have_reasons_and_are_distinct():
    assert all(reason.strip() for _, _, reason in NOT_PORTED)
    keys = [(k, w) for k, w, _ in NOT_PORTED]
    assert len(keys) == len(set(keys))
    assert {k for k, _ in keys} <= set(KINDS)


def test_surface_reader_sees_a_removed_method(monkeypatch):
    # the reader finds what a port module lacks: with Mesh2D.integrate
    # taken away (restored after the test) the gap shows
    from nekstab_next_tpu_torch.mesh import mesh as port_mesh

    monkeypatch.delattr(port_mesh.Mesh2D, "integrate")
    assert gaps("mesh.mesh") == ["Mesh2D.integrate"]


@pytest.mark.parametrize("what,where", [
    ("mesh.mesh:Mesh2D.integrate", "tests/test_mesh_ops.py:26"),
    ("ops.mixed:MixedPrecision(block_e)", "tests/test_pallas.py:51"),
    ("ops.mixed:MixedPrecision.ir_solve(cycles)", "nekstab_next_tpu/ops/mixed.py:226"),
    ("ops.schwarz:build_pressure_blocks", "nekstab_next_tpu/ops/core.py:382"),
])
def test_use_reader_sees_a_known_use(what, where):
    # the reader behind the "uncalled" entries finds a use JAX code makes
    assert where in _uses(*_split(what))
