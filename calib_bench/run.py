"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 calib_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output, and each number the
check compared, with its limit, as the last lines of standard error.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from calib_bench import harness

    sys.exit(harness.main(t0=T0))
