"""chip_smoke.py phase 10 (b)'s moment gate under rounding-level changes.

    python3 tools/dp_gate_torch.py --parent DIR [--seeds 0 1 2]

Phase 10 (b) holds two gloo ranks on one card (f32 Trainer, batch 46, 6
steps) against one process, and gates their Adam moments at twice a floor
it measures once: one process on the same batches with their rows
reversed. This runs those three runs for each seed (0: the converted
weights as they are; else every weight scaled by 1 + 2e-7 N(0, 1) from
numpy's RandomState(seed), a rounding-level change) and for two f32 convs:
this checkout's kernel ("this") and DIR's csrc/conv3x3.cu in its CUDA-core
f32 layout (pack_f32; "DIR"), built beside the kernels as `chip_smoke.py
--parent` builds it. Prints each run's floor, the two ranks' share, the
gate and its verdict, and the tensors with the largest shares; exits 0
whatever the verdicts (it measures the gate, it is not one).
"""

import argparse
import contextlib
import ctypes
import io
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from roomnet_tpu_torch.ops.kernels import _build  # noqa: E402
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC  # noqa: E402

DIR_LIB = _build.BUILD_DIR / "parent" / "libconv3x3.so"  # where chip_smoke.parent_conv3x3 builds DIR's


def use_dir_conv():
    """KC.conv3x3 on f32 CUDA tensors -> DIR's library (pack_f32's layout);
    anything else -> this checkout's wrapper. Launches count on it as ever."""
    fn = ctypes.CDLL(str(DIR_LIB)).rn_conv3x3
    fn.argtypes, fn.restype = KC._ARGS, ctypes.c_int
    real = KC.conv3x3

    def conv(x, kernel, bias=None):
        if x.device.type == "cuda" and x.dtype == torch.float32:
            B, H, W, cin = x.shape
            packed = KC.packed_kernel(kernel, torch.float32)
            y = torch.empty((B, H - 2, W - 2, kernel.shape[3]), dtype=x.dtype, device=x.device)
            b = None if bias is None else bias.float().contiguous()
            rc = fn(x.contiguous().data_ptr(), packed.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                    B, H, W, cin, kernel.shape[3], packed.shape[-1], 0, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{DIR_LIB}: rn_conv3x3 returned CUDA error {rc}")
            real.launches += 1
        else:
            y = real(x, kernel, bias)
        conv.launches = real.launches
        return y

    conv.launches = real.launches
    KC.conv3x3 = conv


def dir_rank(rank, world, backend, devices, store, jobs, out_dir):
    """chip_smoke.dp_rank with DIR's f32 conv."""
    use_dir_conv()
    CS.dp_rank(rank, world, backend, devices, store, jobs, out_dir)


def perturbed(variables, seed: int):
    if seed == 0:
        return variables
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        if t is None:
            return None
        return t * torch.from_numpy((1 + 2e-7 * rng.randn(*t.shape)).astype(np.float32)).to(t.device)

    return walk(variables)


def largest_shares(got: dict, want: dict, n: int = 3) -> str:
    out = sorted(((float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k])).max())
                   / max(float(np.abs(np.asarray(want[k])).max()), 1e-30), k)
                  for k in want if k.startswith(("opt/mu/", "opt/nu/"))), reverse=True)
    return ", ".join(f"{k} {v:.3g}" for v, k in out[:n])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True, metavar="DIR",
                    help="another checkout whose csrc/conv3x3.cu gives the CUDA-core f32 conv")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dp_gate_torch: needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    finish = CS.parent_conv3x3(opts.parent.resolve())
    _build.build()
    finish()

    from roomnet_tpu_torch.data import loader
    from roomnet_tpu_torch.data.dataset import extract_fpaths
    from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG
    from roomnet_tpu_torch.params.checkpoint import CheckpointStore
    from roomnet_tpu_torch.params.schema import load_npz
    from roomnet_tpu_torch.train.loop import TrainConfig, Trainer
    from tools.make_synth_dataset import generate

    base = load_npz(ROOT / "artifacts" / "roomnet_params.npz", device=torch.device("cuda"))
    this_conv = KC.conv3x3
    with tempfile.TemporaryDirectory(prefix="dp_gate_") as root:
        data = os.path.join(root, "data")
        with contextlib.redirect_stdout(io.StringIO()):
            generate(data, per_class=20, seed=1)  # phase 10's data
        lists = {"train_list_fpath": os.path.join(root, "train_list.txt"),
                 "val_list_fpath": os.path.join(root, "val_list.txt"),
                 "label_mappings_fpath": os.path.join(root, "label_mappings.json")}
        extract_fpaths(data, *lists.values(), seed=0)
        made = []

        def config(variables):
            name = f"run{len(made)}"
            made.append(name)
            tc = TrainConfig(data_dir=data, stats_fpath=os.path.join(root, f"stats_{name}.json"),
                             model_dir=os.path.join(root, f"models_{name}"), phases=CS.dp_phases(46),
                             save_freq=5, stall_timeout_s=0, **lists)
            CheckpointStore(tc.model_dir).save(variables, 0)
            return tc

        def host(state):
            return {k: v.detach().cpu().numpy() for k, v in CS.state_tensors(state).items()}

        for seed in opts.seeds:
            for conv in ("this", "DIR"):
                KC.conv3x3 = this_conv
                if conv == "DIR":
                    use_dir_conv()
                variables = perturbed(base, seed)
                with CS.deterministic(), contextlib.redirect_stdout(io.StringIO()):
                    one = host(Trainer(config(variables), DEFAULT_CONFIG).train(total_steps=CS.DP_STEPS))
                    real_dequeue = loader.TrainFeeder.dequeue

                    def reversed_rows(feeder):
                        x, y = real_dequeue(feeder)
                        return (x[::-1].copy(), y[::-1].copy()) if feeder.shuffle else (x, y)

                    loader.TrainFeeder.dequeue = reversed_rows
                    try:
                        rev = host(Trainer(config(variables), DEFAULT_CONFIG).train(total_steps=CS.DP_STEPS))
                    finally:
                        loader.TrainFeeder.dequeue = real_dequeue
                ranks = CS.spawn_ranks("gloo", ["cuda:0", "cuda:0"], [("replicated", config(variables), CS.DP_STEPS)],
                                       root, fn=dir_rank if conv == "DIR" else None)
                two = ranks[0]["replicated"]["state"]
                floor, share = CS.moment_share(rev, one), CS.moment_share(two, one)
                gate = max(CS.DP_MOMENT_SHARE, CS.DP_FLOOR_TIMES * floor)
                print(f"dp gate [{smi}] seed {seed}, {conv} f32 conv: Adam moments, rows reversed {floor:.3g}, "
                      f"two ranks {share:.3g}, gate {gate:.3g} -> {'pass' if share <= gate else 'FAIL'}; "
                      f"largest: {largest_shares(two, one)}", flush=True)
        KC.conv3x3 = this_conv


if __name__ == "__main__":
    main()
