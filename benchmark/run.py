"""Run one cell of the benchmark and print its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``harness.py`` says what it does)."""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    # the checkout's root in place of this directory, whose module names
    # (trace, ...) would shadow the standard library's
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
