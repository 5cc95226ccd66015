"""Run one cell of BENCHMARK.json once, on the CUDA device this machine has.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON result line on standard output (the last line) and the
numbers that decide `correct`, each beside its limit, as the last lines of
standard error. See benchmark/README.md.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
