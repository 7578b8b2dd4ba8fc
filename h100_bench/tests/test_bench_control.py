"""Card test: on three seeds at the traffic's tiny sizes, the program
passes every number of its cell and the cell's controls, the plain
reference computed in the precision below one that the configuration
states (TF32 geometry, float8 classifier operands) or a training fault put
in the program's place, fail at least one of them. Each control's own
separation is read at the cells' own sizes by ``h100_bench/calibrate.py``
(PERF.md): at the tiny sizes a 15-channel request scores a few dozen
hands, too few for its score statistic to tell float8 operands from the
program's own shadow draw. On the card:

    python -m pytest h100_bench/tests/test_bench_control.py -m cuda
"""

import time

import pytest

from h100_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls are read on the "
                    "card (TF32 exists only there)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_control_fails_a_number(cell, card, tmp_path):
    for seed in (11, 12, 13):
        r = harness.cell_run(cell, seed, 1.0, False, card,
                             time.perf_counter(), str(tmp_path), tiny=True)
        r.controls = tuple(r.workload["controls"])
        out = harness.entry(r).run(r)
        assert all(c.ok for c in out.checks), out.checks
        limits = r.workload["limits"]
        failed = [name for name, readings in out.control.items()
                  if any(max(n[k] for n in readings) > v
                         for k, v in limits.items())]
        assert failed, out.control
