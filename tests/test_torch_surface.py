"""The port covers gpd_tpu's surface: every public top-level name of each
module of gpd_tpu/ has a same-named counterpart in the module of the same
path in gpd_tpu_torch/, or stands in ABSENT with where it went or why it is
absent; and every parameter of gpd_tpu's public functions and methods has a
same-named counterpart in the port's signature, or stands in RENAMED with
what takes its place and why.

Both packages are read with ``ast``; neither is imported. A public name is
a function, a class or an assigned name at module level (inside a
module-level ``if`` or ``try`` too) without a leading underscore. In the
port an imported name counts as well: a module may re-export what it
keeps elsewhere. A public method is one of a public class without a leading
underscore, or its ``__init__`` or ``__call__``.
"""

import ast
import pathlib

import pytest

from test_torch_threads import set_cpu_share

set_cpu_share()

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = REPO / "gpd_tpu"
PORT = REPO / "gpd_tpu_torch"

# (module of gpd_tpu, name): (the port's file and name that does its work,
# or None; why the name has no same-named counterpart).
ABSENT = {
    ("cem.py", "draw_sum_of_gaussians"): (
        "ops/draws.py", "sum_of_gaussians",
        "every draw of the port sits in ops/draws.py, where tests "
        "substitute gpd_tpu's numbers"),
    ("cem.py", "draw_max_of_gaussians"): (
        "ops/draws.py", "max_of_gaussians",
        "every draw of the port sits in ops/draws.py"),
    ("cem.py", "draw_uniform_cloud_samples"): (
        "ops/draws.py", "uniform_cloud_samples",
        "every draw of the port sits in ops/draws.py"),
    ("net/lenet.py", "Params"): (
        "net/lenet.py", "LeNet",
        "the parameter dict type gives way to an nn.Module"),
    ("net/lenet.py", "forward"): (
        "net/lenet.py", "LeNet",
        "the forward function is LeNet.forward"),
    ("apps/convert_weights.py", "export_onnx"): (
        None, None,
        "it needs the onnx package, which neither the test host nor the "
        "card's host has; gpd_tpu's CLI writes ONNX through onnx_io, and so "
        "does the port's"),
}


# gpd_tpu's parameter: (the port's parameters that take its place in the
# same signature, any one of which must be there, or () where the port
# carries it elsewhere; why).
RENAMED = {
    "key": (
        ("generator", "noise", "uniforms"),
        "a torch.Generator stands where gpd_tpu passes a PRNG key; a "
        "function that only consumes drawn numbers takes the numbers "
        "(image_inputs_stage's noise, compute_shadows' uniforms and jitter)"),
    "params": (
        ("net",),
        "gpd_tpu's parameter dict gives way to an nn.Module, LeNet"),
    "axis": (
        (),
        "a mesh of the port is a torch.distributed process group of one "
        "axis (parallel/sharded.py Mesh): the group stands for gpd_tpu's "
        "mesh and axis name together, passed as mesh"),
    "mesh_axis": (
        ("mesh",),
        "SequentialImportanceSampling's mesh is a process group of one "
        "axis, so it needs no axis name"),
    "opt_state": (
        ("opt",),
        "a torch optimizer holds its own state"),
    "tx": (
        ("opt",),
        "the optax transformation and its state are one torch optimizer"),
    "canonical": (
        (),
        "score_candidates always gets the hand search's sample-major batch, "
        "so the port's _sample_activity always takes the reshape that "
        "canonical=True selects"),
    "conv_relu": (
        (),
        "the module carries it (LeNet(conv_relu=...), "
        "lenet.params_from_numpy(..., conv_relu=...)); lenet.score runs "
        "the module as it is"),
    "sample_uid": (
        (),
        "compute_shadows takes the drawn numbers (uniforms, jitter); the "
        "detector's _per_sample_inputs draws them by each sample's id"),
}

def _bound_names(target):
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _top_level(body, imports):
    """Names that ``body``'s statements bind, with module-level if/try
    blocks entered."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                out |= _bound_names(target)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            out |= _bound_names(node.target)
        elif isinstance(node, ast.If):
            out |= _top_level(node.body + node.orelse, imports)
        elif isinstance(node, ast.Try):
            out |= _top_level(node.body + node.orelse + node.finalbody
                              + [s for h in node.handlers for s in h.body],
                              imports)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def public_names(path, imports=False):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n for n in _top_level(tree.body, imports) if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REFERENCE))
                 for p in REFERENCE.rglob("*.py"))


def test_every_module_has_a_counterpart():
    missing = [m for m in MODULES if not (PORT / m).is_file()]
    assert MODULES and not missing, missing


def test_absences_name_their_reason_and_destination():
    for (module, name), (dest, dest_name, why) in ABSENT.items():
        assert module in MODULES and why
        if dest is not None:
            assert dest_name in public_names(PORT / dest), (module, name)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_counterparts(module):
    ours = public_names(PORT / module, imports=True)
    theirs = public_names(REFERENCE / module)
    allowed = {name for (m, name) in ABSENT if m == module}
    assert allowed <= theirs, f"ABSENT lists names gpd_tpu/{module} lacks"
    assert not allowed & ours, f"ABSENT lists names the port's {module} has"
    missing = sorted(theirs - ours - allowed)
    assert not missing, (f"gpd_tpu/{module} names {missing}, which "
                         f"gpd_tpu_torch/{module} lacks")


def _defs(body):
    """Functions and classes at module level, module-level if/try entered."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node
        elif isinstance(node, ast.If):
            yield from _defs(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _defs(node.body + node.orelse + node.finalbody
                             + [s for h in node.handlers for s in h.body])


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def signatures(path, private=False):
    """{function or Class.method: its parameter names}, public ones only
    unless ``private``."""
    def shown(name):
        return private or not name.startswith("_")

    out = {}
    for node in _defs(ast.parse(path.read_text(), filename=str(path)).body):
        if not shown(node.name):
            continue
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (shown(m.name)
                             or m.name in ("__init__", "__call__")):
                    out[f"{node.name}.{m.name}"] = _params(m)
        else:
            out[node.name] = _params(node)
    return out


def test_renames_give_their_reason_and_are_used():
    """Each RENAMED entry is a parameter some public function of gpd_tpu
    has and its port counterpart lacks."""
    used = set()
    for module in MODULES:
        ours = signatures(PORT / module, private=True)
        for fn, params in signatures(REFERENCE / module).items():
            used |= set(params) - set(ours.get(fn, params))
    for name, (counterparts, why) in RENAMED.items():
        assert why and name in used, name


@pytest.mark.parametrize("module", MODULES)
def test_parameters_have_counterparts(module):
    ours = signatures(PORT / module, private=True)
    absent = {name for (m, name) in ABSENT if m == module}
    missing = []
    for fn, params in signatures(REFERENCE / module).items():
        if fn.split(".")[0] in absent:
            continue
        assert fn in ours, f"gpd_tpu_torch/{module} lacks {fn}"
        for name in params:
            if name in ours[fn]:
                continue
            counterparts, _ = RENAMED.get(name, (None, None))
            if counterparts is None or (
                    counterparts and not set(counterparts) & set(ours[fn])):
                missing.append(f"{fn}({name})")
    assert not missing, (f"gpd_tpu/{module}'s parameters {missing} have no "
                         f"counterpart in gpd_tpu_torch/{module}")
