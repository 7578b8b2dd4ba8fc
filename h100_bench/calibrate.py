"""The readings that the limits of ``correct`` are set from: a cell's
program on several seeds, and each of the cell's controls (its
workload's ``controls``: the plain reference computed in the precision
below one that the configuration states, or a training fault, put in the
program's place) on the same checked items. One process, on the card:

    python3 h100_bench/calibrate.py --workload CELL --seconds S --seeds A,B,C

Prints per seed the largest reading of each number by the program and by
each control, then per number the largest program reading (the lower
reading) and each control's smallest (an upper reading). The benchmark's
own runs run no control.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def _worst(items):
    return {k: max(n[k] for n in items) for k in items[0]} if items else {}


def main(argv) -> int:
    import argparse
    import gc
    import json
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--checks", type=int, default=0,
                    help="checked requests per seed (default: the mix's)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    print(harness.card_record(), flush=True)
    lows, highs = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory() as tmp:
            r = harness.cell_run(args.workload, seed, args.seconds, False,
                                 args.device, time.perf_counter(), tmp,
                                 tiny=args.tiny)
            r.controls = tuple(r.workload["controls"])
            if args.checks:
                r.traffic = {**r.traffic, "check_requests": args.checks}
            out = harness.entry(r).run(r)
        prog = _worst(out.numbers)
        ctrl = {c: _worst(v) for c, v in out.control.items()}
        print(json.dumps({"seed": seed, "program": prog, **ctrl}),
              flush=True)
        for k in prog:
            lows[k] = max(lows.get(k, 0.0), prog[k])
        for c, v in ctrl.items():
            h = highs.setdefault(c, {})
            for k in v:
                h[k] = min(h.get(k, float("inf")), v[k])
        del out
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"lower": lows, "upper": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
