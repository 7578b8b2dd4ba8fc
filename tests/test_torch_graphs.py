"""The port's graph layer (gpd_tpu_torch/graphs.py) on the CPU, where every
program runs eagerly: ``Programs.run`` calls the program and records no
key, a drawing program leaves its generator where an eager run leaves it,
and the layer stands beneath every program, importing none of their
modules. Its card route is held by the graph tests of each program
(tests/test_torch_*_graph.py, marked ``cuda``).
"""

import ast

import pytest
import torch

from gpd_tpu_torch import graphs
from test_torch_threads import set_cpu_share

set_cpu_share()


def runs_eagerly_and_records_nothing():
    programs = graphs.Programs("cpu")
    calls = []

    def program(g, x):
        calls.append(g)
        return x * 2
    x = torch.arange(3.0)
    for _ in range(2):
        assert torch.equal(programs.run(("double", 3), program, (x,)), x * 2)
    assert calls == [None, None]
    assert programs.graphs == {} and programs.last_graphs == []
    assert programs.pool is None


def draws_as_an_eager_run():
    programs = graphs.Programs("cpu")
    run, eager = (torch.Generator().manual_seed(7) for _ in range(2))
    out = programs.run(("draw", 5), lambda g: torch.rand(5, generator=g),
                       (), run)
    assert torch.equal(out, torch.rand(5, generator=eager))
    assert torch.equal(run.get_state(), eager.get_state())


def imports_no_program_module():
    with open(graphs.__file__) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [f"{node.module}.{a.name}" for a in node.names]
    ours = [n for n in names if n.startswith("gpd_tpu_torch.")]
    assert sorted(ours) == ["gpd_tpu_torch.ops._build",
                            "gpd_tpu_torch.profiling"]


@pytest.mark.parametrize("case", [runs_eagerly_and_records_nothing,
                                  draws_as_an_eager_run,
                                  imports_no_program_module])
def test_graph_layer_on_the_cpu(case):
    case()
