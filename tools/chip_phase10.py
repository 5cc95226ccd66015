"""chip_smoke.py's phase 10 (scale-out) alone, after the kernels' build.

    python3 tools/chip_phase10.py

On one card it runs (a)-(e); where torch.cuda.device_count() >= 2, also (f),
two ranks over NCCL across two cards. Prints phase 10's lines and its JSON,
and exits non-zero if a check fails.
"""

import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def setup(script: str):
    """What chip_smoke.main hands a phase, after building the kernels: the
    converted weights on the card, the f32 and bf16 configs, the launch
    counters' read and its start, the device and the card's name and power
    limit. Exits where there is no CUDA device."""
    import torch

    import chip_smoke as C
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.ops.kernels import _build
    from roomnet_tpu_torch.params.schema import load_npz

    if not torch.cuda.is_available():
        sys.exit(f"{script}: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    C.log(f"build: {time.perf_counter() - t0:.1f} s; {torch.cuda.device_count()} cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    variables = load_npz(pathlib.Path(C.__file__).resolve().parent / "artifacts" / "roomnet_params.npz", device=dev)
    base = _build.launch_counts()

    def counts():
        return _build.card_launches_since(base, C.PER_FORWARD)

    def start_counts():
        base.update(_build.launch_counts())

    return variables, {"f32": M.DEFAULT_CONFIG, "bf16": M.FAST_CONFIG}, counts, start_counts, dev, smi


if __name__ == "__main__":
    import chip_smoke as C

    variables, cfgs, counts, start_counts, dev, smi = setup("chip_phase10")
    print(json.dumps(C.phase10(variables, cfgs, counts, start_counts, dev, smi), default=str))
