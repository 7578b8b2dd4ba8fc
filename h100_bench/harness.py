"""The benchmark's harness: one run of one cell, driven by data.

``BENCHMARK.json`` at the root names the cells, the configurations and the
metrics. A cell's files are found by name: ``workloads/<cell>.json`` (its
configuration, traffic mix and entry), ``configs/<config>.json``,
``traffic/<mix>.json``, ``entries/<entry>.py`` and one reader
``metrics/<metric>.py`` per per-layer metric. A later cell, configuration
or metric is added as files and a manifest entry, with no edit here.

An entry's ``run(run)`` sets up, warms every shape its traffic uses,
measures for ``run.seconds`` (``run.trace`` 0) or traces a short window
(``run.trace`` 1), then checks what the timed path produced against the
plain reference under ``reference/``. It returns an ``Outcome``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "gpd_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file of the benchmark, loaded by path (its name may hold
    dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit; a run is
    correct when every number is at or under its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What an entry's run returns."""
    setup_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: Optional[int] = None
    # For the traced run: the readers' inputs (``layer``), and the trace's
    # busy seconds, window seconds and breakdown.
    layer: dict = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    # The compared numbers of each checked item, and (``Run.controls``) each
    # control's or fault's in the program's place: the calibration's
    # readings.
    numbers: List[dict] = dataclasses.field(default_factory=list)
    control: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """One run's settings and inputs, as the entries read them."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    traffic: dict
    device: str
    t_start: float
    tmp: str
    # Controls (and faults) to run in the program's place (calibrate.py):
    # the workload's "controls".
    controls: Tuple[str, ...] = ()

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def sync(self) -> None:
        """Waits for the card (nothing on the CPU)."""
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def path(self, rel: str) -> str:
        """A path of the repository (weights named by a config)."""
        return os.path.join(ROOT, rel)


def cell_run(cell: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, tmp: str, tiny: bool = False
             ) -> Run:
    """The Run of ``cell``, its files found by name; ``tiny`` takes the
    traffic's "tiny" overrides (the CPU tests' sizes) and the workload's
    "tiny_limits"."""
    w = load_json(BENCH, "workloads", f"{cell}.json")
    traffic = load_json(BENCH, "traffic", f"{w['traffic']}.json")
    config = load_json(BENCH, "configs", f"{w['config']}.json")
    if tiny:
        small = dict(traffic.get("tiny", {}))
        config["detector"].update(small.pop("detector", {}))
        traffic = {**traffic, **small}
        # A statistic over a request's hands swings more over the tiny
        # requests' few dozen: the cell may give it a limit of its own.
        w = {**w, "limits": {**w["limits"], **w.get("tiny_limits", {})}}
    return Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
               workload=w, config=config, traffic=traffic, device=device,
               t_start=t_start, tmp=tmp)


def entry(run: Run):
    return load_module(os.path.join(BENCH, "entries",
                                    f"{run.workload['entry']}.py"),
                       f"h100_bench_entry_{run.workload['entry']}")


def cell_metrics(cell: str, man: dict) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metrics the manifest gives ``cell``: those
    whose ``workloads`` list it, or that have no such list and move (or
    are) a metric the cell reports."""
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def read_layer(metrics: List[dict], out: Outcome) -> Dict[str, dict]:
    """Each per-layer metric from its reader ``metrics/<name>.py``; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    res = {}
    for m in metrics:
        mod = load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                          "h100_bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(out.layer)
        if value is not None:
            res[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return res


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``gpd_tpu_torch`` is not ``gpd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_record() -> str:
    """The card as nvidia-smi reads it: name, power limit and draw, SM
    clocks (now and maximum), temperature."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
         "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return f"# card ({q}): {out}"


def result_line(out: Outcome, metrics: Dict[str, dict], device: dict,
                trace: bool) -> str:
    res = {"correct": all(c.ok for c in out.checks),
           "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": device}
    if trace and out.breakdown is not None:
        res["breakdown"] = out.breakdown
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return json.dumps(res)


def print_checks(checks: List[Check]) -> None:
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)


NOT_MEASURED = "not measured"


def cpu_pass(cell: str, seed: int, trace: bool, tmp: str) -> Tuple[str, Outcome]:
    """A run of ``cell`` at its traffic's tiny sizes on the CPU, for the
    tests: (the result line, the outcome). A CPU run measures no
    card, so every metric and device reading says "not measured"."""
    man = manifest()
    run = cell_run(cell, seed, 1.0, trace, "cpu", time.perf_counter(), tmp,
                   tiny=True)
    out = entry(run).run(run)
    e2e, layer = cell_metrics(cell, man)
    metrics = {m["name"]: {"value": NOT_MEASURED, "unit": m["unit"]}
               for m in (layer if trace else e2e)}
    device = {"platform": "cpu", "kind": NOT_MEASURED, "count": 0,
              "memory_peak_bytes": NOT_MEASURED}
    if trace:
        device.update(busy_s=NOT_MEASURED, window_s=NOT_MEASURED)
    return result_line(out, metrics, device, trace), out


def main(argv: List[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest()
    spec = {w["name"]: w for w in man["workloads"]}.get(args.workload)
    if spec is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    print(card_record(), flush=True)
    print(f"# device: {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    import tempfile
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        run = cell_run(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t_start, tmp)
        out = entry(run).run(run)
    print(card_record(), flush=True)

    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 4
    e2e, layer = cell_metrics(args.workload, man)
    if args.trace:
        metrics = read_layer(layer, out)
    else:
        units = {m["name"]: m["unit"] for m in e2e}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in out.end_to_end.items() if k in units}
        missing = set(units) - set(metrics)
        if missing:
            print(f"the run did not measure {sorted(missing)}",
                  file=sys.stderr)
            return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    print_checks(out.checks)
    print(result_line(out, metrics, device, bool(args.trace)), flush=True)
    return 0
