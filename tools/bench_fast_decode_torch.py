"""A/B of fast_decode's safety factor with the PyTorch port: the counterpart
of tools/bench_fast_decode.py.

fast_decode uses libjpeg's DCT-domain scaled decode in the native decoder
(roomnet_tpu_torch/csrc/roomnet_io.cpp): the largest 1/2^k reduction whose
short side stays >= min_decode_side. With min_decode_side = im_side
(safety 1) the decode may land just above 224 and the bilinear resample
after it flips argmaxes; safety 2 asks for 2x supersampling. Per source size
(128 make_image JPEGs at 640x480 and at 2560x1920, q88) and safety factor it
measures the argmax flip rate of the port's bf16 forward (FAST_CONFIG, the
converted weights, batches of 64) against the full decode, the host
decode+preprocess rate, and the mean pixel difference.

    python tools/bench_fast_decode_torch.py [--device cpu]

Needs the native decoder (data/native.py builds it with g++ against the
libjpeg and libpng headers); raises where it is not built. The forward runs
on the CUDA card unless --device says otherwise; the decode rate is the
host's.

Imports neither jax nor roomnet_tpu.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PARAMS = os.path.join(REPO, "artifacts", "roomnet_params.npz")
N_IMAGES = 128
BATCH = 64


def decode_all(paths, im_side, min_decode_side):
    """Host only: the native decoder's fused decode/crop/resize of every
    path; (batch, images per second)."""
    from roomnet_tpu_torch.data import native
    from roomnet_tpu_torch.data.loader import draw_crop_rect

    crops = []
    for p in paths:
        h, w = native.probe(p)
        crops.append(draw_crop_rect(h, w, random_crop=False, rng=None))
    crops = np.asarray(crops, np.int32)
    t0 = time.perf_counter()
    batch, ok = native.load_preprocess_batch(paths, crops, im_side, np.zeros((len(paths), 2), np.int32),
                                             min_decode_side=min_decode_side)
    dt = time.perf_counter() - t0
    if not ok.all():
        raise RuntimeError(f"the native decoder failed on {int((~ok).sum())} of {len(paths)} files")
    return batch, len(paths) / dt


def main(device=None) -> None:
    import cv2
    import torch

    from roomnet_tpu_torch import default_device
    from roomnet_tpu_torch.data import native
    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.params.schema import load_npz
    from tools.make_synth_dataset import make_image

    if not native.available():
        raise RuntimeError("the native decoder is not built (roomnet_tpu_torch/csrc/roomnet_io.cpp needs g++ and "
                           "the libjpeg and libpng headers); fast_decode has nothing to measure without it")
    dev = default_device(device)
    cfg = M.FAST_CONFIG
    folded = M.fold_variables(load_npz(PARAMS, cfg, dev), cfg)

    def argmax_of(batch: np.ndarray) -> np.ndarray:
        out = []
        with torch.no_grad():
            for s in range(0, len(batch), BATCH):
                x = M.normalize_bgr_uint8(torch.from_numpy(batch[s:s + BATCH]).to(dev))
                _, probs = M.forward_folded(folded, x, cfg)
                out.append(probs.argmax(-1).cpu().numpy())
        return np.concatenate(out)

    gen = np.random.RandomState(0)
    for label, (h, w) in [("640x480 (canonical)", (480, 640)), ("2560x1920 (large photo)", (1920, 2560))]:
        tmp = tempfile.mkdtemp(prefix="fastdec_")
        try:
            paths = []
            for i in range(N_IMAGES):
                p = os.path.join(tmp, f"img_{i:03d}.jpg")
                cv2.imwrite(p, make_image(i % 6, gen, h, w)[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 88])
                paths.append(p)
            exact, ips_exact = decode_all(paths, cfg.im_side, 0)
            ref_ids = argmax_of(exact)
            print(f"\n== {label}: exact decode {ips_exact:.0f} img/s (host)")
            for safety in (1, 2):
                fast, ips_fast = decode_all(paths, cfg.im_side, safety * cfg.im_side)
                flips = int((argmax_of(fast) != ref_ids).sum())
                px = float(np.abs(fast.astype(np.int16) - exact.astype(np.int16)).mean())
                print(f"   safety={safety}: {ips_fast:.0f} img/s host decode ({ips_fast / ips_exact:.2f}x), "
                      f"argmax flips {flips}/{N_IMAGES} ({100 * flips / N_IMAGES:.1f}%), mean |dpx| {px:.2f}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tools/bench_fast_decode_torch.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="device of the forward (default: the CUDA card; 'cpu' runs the kernels' plain versions)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args().device)
