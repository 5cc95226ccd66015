"""The val-scale parity run of the PyTorch port (roomnet_tpu_torch) against
the frozen TF graph: the counterpart of tools/valset.py's decoders and of the
JAX package's full-valset run (tests/test_valset_parity.py,
test_full_valset_parity).

    python tools/valset_torch.py                          # the 1,609 undocumented images, on the card
    python tools/valset_torch.py --indices all            # all 1,839 (needs the reference's PNGs)
    python tools/valset_torch.py --device cpu --out-dir D # the plain versions; keep the JPEGs in D

tools/valset.py makes each of its 1,839 JPEGs a pure function of its index,
and tests/golden/valset_golden.npz holds the TF graph's argmax of every one
(`argmax_cv2`, `argmax_native`: the pixels of each decoder) and the f32
logits of 64 of them. Kinds 11 and 12 (`i % 16`) crop the reference's
documentation PNGs; without those files they come out as other images, so
`--indices undocumented` scores the 1,609 images whose bytes do not depend
on them.

The run builds the JPEGs on a pool of processes, then checks that its
inputs are the fixture's before it scores anything: image 0's JPEG sha256
(the encoder and the generator), the documentation image's where the PNGs
are present, and a sha256 of the decoded pixels of the 56 undocumented
logits-sample images (SAMPLE_PIXEL_SHA256, per decoder). A mismatch raises
DriftError naming the drifted part, never a model fault. Then
`RoomNetClassifier.predict_paths` at batch 64 in f32 (DEFAULT_CONFIG, TF32
off) and bf16 (FAST_CONFIG), and the f32 logits of the sample images on
cv2's pixels (the fixture's). The gates are the JAX tests': f32 argmax equal
to the TF graph's on every image (against `argmax_native` where the native
decoder is built, else `argmax_cv2`), f32 logits within 1e-4, and bf16
flips under 1% of the scored images. Prints one JSON line; exits 1 where a
gate fails.

Imports neither jax nor roomnet_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.valset import N_IMAGES, build_valset_jpegs, doc_dir_available, file_sha256  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden", "valset_golden.npz")
PARAMS = os.path.join(REPO, "artifacts", "roomnet_params.npz")
DOC_KINDS = (11, 12)  # i % 16 of the documentation crops (tools/valset.py)
BATCH = 64
LOGITS_TOL = 1e-4
FLIP_GATE = 0.01
# sha256 of the decoded (56, 224, 224, 3) uint8 pixels of the undocumented
# logits-sample images, in index order, by decoder (cv2 5.0.0 and the
# native decoder, x86-64).
SAMPLE_PIXEL_SHA256 = {
    "cv2": "0be1c382ff0535a86a7b64ca6bcb4b1216a536d57747950051ec3933c9125a63",
    "native": "eaee984ac983947661ba2bfbe1486b37cd0ca85ed5558dbdaf3c07e7643532fc",
}


class DriftError(RuntimeError):
    """The regenerated inputs are not the fixture's: a drifted JPEG encoder,
    generator, reference PNG or decoder, not a fault of the model."""


def undocumented_indices() -> list[int]:
    """The 1,609 indices whose JPEG bytes do not depend on the reference's
    documentation PNGs."""
    return [i for i in range(N_IMAGES) if i % 16 not in DOC_KINDS]


def sample_indices(golden) -> list[int]:
    """The fixture's logits-sample indices that are undocumented (56 of 64)."""
    return [int(i) for i in golden["logits_sample_idx"] if i % 16 not in DOC_KINDS]


def build(out_dir: str, indices, workers: int | None = None) -> dict[int, str]:
    """tools/valset.py's JPEGs of `indices` in out_dir, on `workers`
    processes (each image is a pure function of its index); {index: path}."""
    indices = sorted(set(int(i) for i in indices))
    workers = max(1, min(workers or os.cpu_count() or 1, len(indices)))
    if workers == 1:
        build_valset_jpegs(out_dir, indices)
    else:
        chunks = [indices[k::workers] for k in range(workers)]
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(build_valset_jpegs, [out_dir] * workers, chunks))
    return {i: os.path.join(out_dir, f"val_{i:04d}.jpg") for i in indices}


def decode_cv2(paths: list[str], im_side: int = 224) -> np.ndarray:
    """The classifier's cv2 preprocess: center crop, INTER_LINEAR resize,
    BGR uint8, with the port's own crop."""
    import cv2

    from roomnet_tpu_torch.data.loader import center_crop

    out = np.empty((len(paths), im_side, im_side, 3), np.uint8)
    for i, p in enumerate(paths):
        im = center_crop(cv2.imread(p))
        if im.shape[0] != im_side or im.shape[1] != im_side:
            im = cv2.resize(im, (im_side, im_side))
        out[i] = im
    return out


def decode_native(paths: list[str], im_side: int = 224) -> np.ndarray | None:
    """The classifier's native preprocess (roomnet_io's fused pipeline); None
    where the native decoder is not built."""
    from roomnet_tpu_torch.data import native
    from roomnet_tpu_torch.data.loader import draw_crop_rect

    if not native.available():
        return None
    crops = np.asarray([draw_crop_rect(*native.probe(p), random_crop=False, rng=None) for p in paths], np.int32)
    batch, ok = native.load_preprocess_batch(paths, crops, im_side, np.zeros((len(paths), 2), np.int32))
    if not ok.all():
        raise RuntimeError(f"the native decoder failed on {[p for p, k in zip(paths, ok) if not k]}")
    return batch


def backend() -> str:
    """The decoder predict_paths uses here: "native" where it is built."""
    from roomnet_tpu_torch.data import native

    return "native" if native.available() else "cv2"


def backend_key(golden) -> str:
    """The fixture's argmax for this host's decoder."""
    return "argmax_native" if backend() == "native" and "argmax_native" in golden else "argmax_cv2"


def pixel_sha256(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def check_guards(paths: dict[int, str], golden) -> None:
    """Image 0's JPEG sha256, and the first documentation image's (index 11)
    where the reference PNGs are present and it was built."""
    import cv2

    if file_sha256(paths[0]) != bytes(golden["first_jpeg_sha256"]).hex():
        raise DriftError(f"image 0's JPEG sha256 is not the fixture's: the JPEG encoder (cv2 {cv2.__version__}) "
                         "or tools/make_synth_dataset.make_image drifted; no model was run")
    if 11 in paths and doc_dir_available() and "doc_jpeg_sha256" in golden:
        if file_sha256(paths[11]) != bytes(golden["doc_jpeg_sha256"]).hex():
            raise DriftError("image 11's JPEG sha256 is not the fixture's: the reference documentation PNGs "
                             "changed; no model was run")


def check_pixels(paths: dict[int, str], golden, digests: dict | None = None) -> np.ndarray:
    """The decoded pixels of the undocumented logits-sample images against
    SAMPLE_PIXEL_SHA256: cv2's always (the fixture's logits are of cv2's
    pixels), the native decoder's too where predict_paths uses it. Returns
    cv2's pixels."""
    import cv2

    digests = SAMPLE_PIXEL_SHA256 if digests is None else digests
    sample = [paths[i] for i in sample_indices(golden)]
    px = decode_cv2(sample)
    if pixel_sha256(px) != digests["cv2"]:
        raise DriftError(f"the sample images' cv2 pixels are not the fixture's (cv2 {cv2.__version__} decodes "
                         "differently): decoder drift, not a model fault; no model was run")
    if backend() == "native" and pixel_sha256(decode_native(sample)) != digests["native"]:
        raise DriftError("the sample images' native-decoder pixels are not the fixture's: decoder drift "
                         "(roomnet_io or libjpeg), not a model fault; no model was run")
    return px


def score(variables, cfg, paths: list[str], device):
    """(ids, probs) of predict_paths over `paths` at batch BATCH; raises
    where a file did not decode."""
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier

    clf = RoomNetClassifier(variables, cfg, batch_size=BATCH, device=device)
    try:
        ids, probs, ok = clf.predict_paths(paths)
    finally:
        clf.close()
    if not ok.all():
        raise RuntimeError(f"{int((~ok).sum())} valset JPEGs did not decode")
    return ids, probs


def logits_of(variables, pixels: np.ndarray, device) -> np.ndarray:
    """f32 logits (DEFAULT_CONFIG, TF32 off) of uint8 BGR pixels, one forward."""
    import torch

    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.ops.blocks import full_f32

    with torch.no_grad(), full_f32():
        x = M.normalize_bgr_uint8(torch.from_numpy(pixels).to(device))
        return M.forward(variables, x, M.DEFAULT_CONFIG).cpu().numpy()


def bf16_logits_of(variables, pixels: np.ndarray, device) -> np.ndarray:
    """bf16 logits (FAST_CONFIG), as f32, of uint8 BGR pixels: the forward
    `RoomNetClassifier._predict` runs, on `device`."""
    import torch

    from roomnet_tpu_torch.infer.classify import _to_device
    from roomnet_tpu_torch.models import roomnet as M

    with torch.no_grad():
        folded = M.fold_variables(_to_device(variables, device), M.FAST_CONFIG, uint8_input=False)
        x = M.normalize_bgr_uint8(torch.from_numpy(pixels).to(device))
        return M.forward_folded(folded, x, M.FAST_CONFIG)[0].float().cpu().numpy()


def resolve_indices(indices, golden) -> list[int]:
    """The sorted indices to score: "undocumented", "all" or a list. Raises
    DriftError where an index needs the documentation PNGs that the fixture
    was built with and this host lacks."""
    if indices == "undocumented":
        return undocumented_indices()
    if indices == "all":
        idx = list(range(N_IMAGES))
    elif isinstance(indices, str):
        raise ValueError(f"indices must be 'all', 'undocumented' or a list, got {indices!r}")
    else:
        idx = sorted(set(int(i) for i in indices))
    if int(golden.get("used_doc_pngs", 1)) and not doc_dir_available() and any(i % 16 in DOC_KINDS for i in idx):
        raise DriftError("the documentation images (i % 16 in (11, 12)) need the reference's PNGs, which the "
                         "fixture was built with and this host lacks; score --indices undocumented")
    return idx


def run(device=None, out_dir: str | None = None, indices="undocumented", *, workers: int | None = None,
        measure=None) -> dict:
    """Build, check and score; the result (see the module docstring), with
    "ok" false where a gate fails. `indices`: "undocumented", "all" or a list.
    `measure(dtype)`, where given, is a context manager entered around each
    dtype's device work ("f32": predict_paths and the sample logits' forward;
    "bf16": predict_paths); "forwards" counts the forwards inside each."""
    from roomnet_tpu_torch import default_device
    from roomnet_tpu_torch.models.roomnet import DEFAULT_CONFIG, FAST_CONFIG
    from roomnet_tpu_torch.ops.blocks import full_f32
    from roomnet_tpu_torch.params.schema import load_npz

    t_start = time.perf_counter()
    dev = default_device(device)
    golden = dict(np.load(GOLDEN))
    idx = resolve_indices(indices, golden)
    samples = sample_indices(golden)
    measure = measure or (lambda dt: contextlib.nullcontext())
    own_dir = out_dir is None
    out_dir = tempfile.mkdtemp(prefix="valset_torch_") if own_dir else out_dir
    try:
        t0 = time.perf_counter()
        guards = {0, 11} if doc_dir_available() else {0}
        paths = build(out_dir, set(idx) | guards | set(samples), workers)
        build_s = time.perf_counter() - t0
        check_guards(paths, golden)
        pixels = check_pixels(paths, golden)
        variables = load_npz(PARAMS, device=dev)
        key = backend_key(golden)
        want = golden[key][idx].astype(np.int64)
        scored = [paths[i] for i in idx]
        t0 = time.perf_counter()
        with measure("f32"), full_f32():
            ids32, _ = score(variables, DEFAULT_CONFIG, scored, dev)
            logits = logits_of(variables, pixels, dev)
        with measure("bf16"):
            ids16, _ = score(variables, FAST_CONFIG, scored, dev)
        score_s = time.perf_counter() - t0
        at = {int(i): k for k, i in enumerate(golden["logits_sample_idx"])}
        logits_d = float(np.abs(logits - golden["logits_sample"][[at[i] for i in samples]]).max())
        mism = [idx[k] for k in np.flatnonzero(ids32 != want)]
        flips = [idx[k] for k in np.flatnonzero(ids16 != want)]
        # Each bf16 flip on the pixels predict_paths decoded: the f32 top-2
        # logit margin, and the logits in f32 and bf16 on `dev` and in bf16
        # through the kernels' plain versions on the CPU.
        decode = decode_native if key == "argmax_native" else decode_cv2
        margins, flip_logits = {}, {}
        if flips:
            px = decode([paths[i] for i in flips])
            f32 = logits_of(variables, px, dev)
            top2 = np.sort(f32, axis=-1)[:, -2:]
            margins = {i: float(m) for i, m in zip(flips, top2[:, 1] - top2[:, 0])}
            bf16 = bf16_logits_of(variables, px, dev)
            plain = bf16_logits_of(variables, px, "cpu")
            flip_logits = {i: {"f32": f32[k].tolist(), "bf16": bf16[k].tolist(), "bf16_plain_cpu": plain[k].tolist()}
                           for k, i in enumerate(flips)}
    finally:
        if own_dir:
            import shutil

            shutil.rmtree(out_dir, ignore_errors=True)
    n = len(idx)
    batches = -(-n // BATCH)
    return {
        "indices": indices if isinstance(indices, str) else "list", "scored": n, "decoder": backend(),
        "argmax_key": key, "f32_mismatches": len(mism), "f32_mismatch_indices": mism,
        "bf16_flips": len(flips), "bf16_flip_rate": len(flips) / n, "bf16_flip_indices": flips,
        "bf16_flip_f32_top2_margins": margins, "bf16_flip_logits": flip_logits, "sample_images": len(samples),
        "sample_logits_max_abs_diff": logits_d, "forwards": {"f32": batches + 1, "bf16": batches},
        "build_s": build_s, "score_s": score_s, "wall_s": time.perf_counter() - t_start,
        "ok": not mism and len(flips) < FLIP_GATE * n and logits_d <= LOGITS_TOL,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tools/valset_torch.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card; 'cpu' runs the kernels' plain PyTorch versions)")
    p.add_argument("--out-dir", default=None, help="write the JPEGs here and keep them (default: a temp dir)")
    p.add_argument("--indices", choices=["all", "undocumented"], default="undocumented",
                   help="all 1,839 images (needs the reference's documentation PNGs) or the 1,609 without them")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = run(args.device, args.out_dir, args.indices)
    print(f"valset ({r['scored']} images, {r['decoder']} decode): f32 {r['f32_mismatches']} mismatches against "
          f"{r['argmax_key']}, bf16 {r['bf16_flips']} flips ({100 * r['bf16_flip_rate']:.3f}%, gate "
          f"{100 * FLIP_GATE:g}%), sample logits max |d| {r['sample_logits_max_abs_diff']:.3g} over "
          f"{r['sample_images']} images (gate {LOGITS_TOL:g}); build {r['build_s']:.1f} s, score "
          f"{r['score_s']:.1f} s", file=sys.stderr)
    print(json.dumps(r))
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
