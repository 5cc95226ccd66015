"""chip_smoke.py's phase 11 (the server on a mesh) alone, after the kernels'
build.

    python3 tools/chip_phase11.py

On one card it runs (a), (b), (c) and (e); where torch.cuda.device_count()
>= 2, also (d), two ranks over NCCL across two cards. Prints phase 11's
lines and its JSON, and exits non-zero if a check fails.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import chip_smoke as C
    from chip_phase10 import setup

    variables, cfgs, counts, start_counts, dev, smi = setup("chip_phase11")
    per_forward = {"conv3x3": 10, "relu6_pool_bn": 10, "residual_bn": 3, "dense_head": 1}
    print(json.dumps(C.phase11(variables, cfgs, counts, start_counts, per_forward, dev, smi), default=str))
