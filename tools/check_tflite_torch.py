"""Check the port's TFLite exports against the golden fixtures (offline:
needs TensorFlow, no card): the counterpart of tools/check_tflite.py.

    python tools/check_tflite_torch.py [model.tflite]   # check one file
    python tools/check_tflite_torch.py --variants       # float/dynamic/int8: export and score each

A missing model file is exported first, through the port's
params/export.export_tflite from artifacts/roomnet_params.npz (weights on the
CPU). One file is held to the 7-image golden batch: argmax equal to the TF
graph's on every image and softmax within 1e-4. --variants exports every
quantization variant and scores each against the 64-image wide golden batch
(argmax flips against the TF graph, worst softmax |diff|, size).

Imports neither jax nor roomnet_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "tests", "golden")
PARAMS = os.path.join(REPO, "artifacts", "roomnet_params.npz")


def score(model_path: str, golden: dict) -> tuple[int, int, float]:
    """(argmax matches, n, worst softmax |diff|) on a golden fixture."""
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=model_path)
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    worst = 0.0
    n_match = 0
    n = len(golden["x_uint8_bgr"])
    for i in range(n):
        x = ((golden["x_uint8_bgr"][i:i + 1, :, :, ::-1].astype(np.float32) / 255.0) * 2.0) - 1.0
        interp.set_tensor(inp["index"], x)
        interp.invoke()
        probs = interp.get_tensor(out["index"])
        worst = max(worst, float(np.abs(probs - golden["softmax"][i:i + 1]).max()))
        n_match += int(probs.argmax() == golden["argmax"][i])
    return n_match, n, worst


def _variables():
    from roomnet_tpu_torch.params.schema import load_npz

    return load_npz(PARAMS, device="cpu")


def main(model_path: str = os.path.join(REPO, "artifacts", "roomnet.tflite")) -> None:
    from roomnet_tpu_torch.params.export import export_tflite

    g = dict(np.load(os.path.join(GOLDEN, "forward_golden.npz")))
    if not os.path.exists(model_path):
        export_tflite(_variables(), model_path)
        print("exported", model_path)
    n_match, n, worst = score(model_path, g)
    print(f"softmax max |diff| vs reference graph: {worst:.2e}")
    print(f"argmax matches: {n_match}/{n}")
    if not (n_match == n and worst < 1e-4):
        raise SystemExit("TFLite export diverged from reference")
    print("OK")


def variants(out_dir: str = os.path.join(REPO, "artifacts")) -> None:
    """Export the float, dynamic and int8 variants into out_dir and score
    each on the wide golden batch."""
    from roomnet_tpu_torch.params.export import export_tflite

    variables = _variables()
    g = dict(np.load(os.path.join(GOLDEN, "forward_golden_wide.npz")))
    print(f"scoring on the {len(g['x_uint8_bgr'])}-image wide golden batch")
    for name, quant in [("float", None), ("dynamic", "dynamic"), ("int8", "int8")]:
        path = os.path.join(out_dir, f"roomnet_{name}.tflite")
        export_tflite(variables, path, quantize=quant)
        n_match, n, worst = score(path, g)
        size_kb = os.path.getsize(path) / 1024
        flips = n - n_match
        print(f"{name:8s}: {size_kb:7.1f} KB  argmax flips {flips}/{n} "
              f"({100 * flips / n:.1f}%)  softmax max|diff| {worst:.2e}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tools/check_tflite_torch.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", nargs="?", default=os.path.join(REPO, "artifacts", "roomnet.tflite"),
                   help="the .tflite file to check (exported first where missing)")
    p.add_argument("--variants", action="store_true", help="export and score the float, dynamic and int8 variants")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    if args.variants:
        variants()
    else:
        main(args.model)
