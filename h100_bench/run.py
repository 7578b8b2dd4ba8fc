"""One run of one cell of the H100 benchmark of gpd_tpu_torch.

    python3 h100_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with an NVIDIA card. Prints
the card's record and progress first, the numbers compared with the plain
reference last on standard error, and as the last line of standard output
one JSON object: correct, attempted, failed, metrics, device (and, traced,
breakdown), then the checks. Exits non-zero, with no result, without a
card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
