"""chip_smoke.py's phase 12 (tensor parallelism in the training step) alone,
after the kernels' build.

    python3 tools/chip_phase12.py

On one card it runs (a), (b), (c) and (e); where torch.cuda.device_count()
>= 2, also (d), two ranks over NCCL across two cards. Prints phase 12's
lines and its JSON, and exits non-zero if a check fails.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import chip_smoke as C
    from chip_phase10 import setup

    variables, cfgs, counts, start_counts, dev, smi = setup("chip_phase12")
    print(json.dumps(C.phase12(variables, counts, start_counts, dev, smi), default=str))
