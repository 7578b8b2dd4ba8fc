"""The port covers gpd_tpu's surface: every public top-level name of each
module of gpd_tpu/ has a same-named counterpart in the module of the same
path in gpd_tpu_torch/, or stands in ABSENT with where it went or why it is
absent.

Both packages are read with ``ast``; neither is imported. A public name is
a function, a class or an assigned name at module level (inside a
module-level ``if`` or ``try`` too) without a leading underscore. In the
port an imported name counts as well: a module may re-export what it
keeps elsewhere.
"""

import ast
import pathlib

import pytest

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
    ("ops/neighbors.py", "FORCE_EXACT"): (
        None, None,
        "it only turns off approx_min_k, a TPU-only route; the port always "
        "takes exact neighbors"),
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
