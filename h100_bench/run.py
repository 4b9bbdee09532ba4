"""Run one cell of the benchmark once and print its result as the last line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
