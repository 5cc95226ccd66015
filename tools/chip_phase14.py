"""chip_smoke.py's phase 14 (the bench and the val-scale parity run) alone,
after the kernels' build and phase 5's bf16 device forward, which (a) is
held against.

    python3 tools/chip_phase14.py

Runs (a) and (b) on one card. Prints phase 14's lines and its JSON, and
exits non-zero if a check fails.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import numpy as np
    import torch

    import chip_smoke as C
    from chip_phase10 import setup
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier

    variables, cfgs, counts, start_counts, dev, smi = setup("chip_phase14")
    clf = RoomNetClassifier(variables, cfgs["bf16"], batch_size=256, device=dev)
    xb = torch.from_numpy(np.random.RandomState(0).randint(0, 256, size=(256, 224, 224, 3), dtype=np.uint8)).to(dev)
    serving = {"bf16": {"device_forward_ms_batch256": C.cuda_ms(lambda: clf._predict(clf.variables, xb))}}
    clf.close()
    del clf, xb
    print(json.dumps(C.phase14(counts, start_counts, C.PER_FORWARD, serving, dev, smi), default=str))
