"""chip_smoke.py's phase 13 (from scratch through the curriculum) alone,
after the kernels' build.

    python3 tools/chip_phase13.py

Runs (a), (b) and (c) on one card. Prints phase 13's lines and its JSON,
and exits non-zero if a check fails.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import chip_smoke as C
    from chip_phase10 import setup

    _, cfgs, counts, zero_counts, dev, smi = setup("chip_phase13")
    print(json.dumps(C.phase13(cfgs, counts, zero_counts, C.PER_FORWARD, dev, smi), default=str))
