"""Batched directory classification on the card (port of
roomnet_tpu/infer/classify.py).

Reference behavior preserved (infer.py:65-100):
  * classify every image in a dir; write `.xls` sheet 'classification_results'
    with IMAGE_NAME / PREDICTED_LABEL / confidence columns (infer.py:75-78,
    96-98 — confidence goes to column 2 with no header, faithfully), and a
    `.csv` twin;
  * one output dir per class, each image dropped into its predicted class
    dir — annotated copy (overlay) or raw copy (infer.py:87-95);
  * per-image preprocess: center-crop -> resize(S,S) -> BGR->RGB -> [-1,1]
    (network.py:148-156); the crop and resize on the host, the rest on the
    device, where the kernel operands (cast convs, folded BNs, the packed
    head) are prepared once at construction.

Images stream through three stages, decode(i+2) ∥ H2D(i+1) ∥ forward(i)
(`predict_stream`): a decode thread fills a ring of pinned host batches in
place, each batch goes to the device on a copy stream of its own, and the
forward waits on the copy's event. Results stay on the device until each
batch's ids and probs are copied into pinned host memory behind its forward,
and one synchronize ends the run. `predict` (uint8 arrays already decoded)
goes through the same pipeline.

Under a mesh (`parallel/mesh.py`) every rank classifies the same items:
each batch's rows are split over the data axis, each rank runs its rows
through the forward, and the probabilities of every rank come back on every
rank (the JAX classifier's batch sharded over 'data').
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from glob import glob

import numpy as np
import torch

from .. import CLASS_LABELS, default_device  # noqa: F401 (RoomNet's labels, as this module has always named them)
from ..data import native
from ..data.loader import center_crop, draw_crop_rect
from ..models import family
from ..models.roomnet import DEFAULT_CONFIG
from ..ops.resize import resize_bilinear_half_pixel
from ..parallel import collectives as C
from ..utils.profiling import SPANS, trace
from ..utils.xls import Workbook

RING = 3  # host batches in flight: decode(i+2) ∥ H2D(i+1) ∥ forward(i)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def force_makedir(d: str):
    os.makedirs(d, exist_ok=True)


def _compact(out: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Move the rows of `out` marked in `ok` to its front, in order; return
    their indices."""
    kept = np.flatnonzero(ok)
    if kept.size < ok.size:
        out[: kept.size] = out[kept]
    return kept


def load_fill(items, load, pool: ThreadPoolExecutor):
    """A `fill` for `RoomNetClassifier.predict_stream` that runs
    ``load(item) -> (S,S,3) uint8 BGR or None`` for each item on `pool` and
    writes each image straight into the host batch."""

    def fill(start: int, stop: int, out: np.ndarray) -> np.ndarray:
        def one(k: int) -> bool:
            im = load(items[start + k])
            if im is None:
                return False
            out[k] = im
            return True

        return _compact(out, np.array(list(pool.map(one, range(stop - start))), bool))

    return fill


class RoomNetClassifier:
    """Batched classifier over converted params (optimized-inference mode),
    of any model family (models/family.py): the configuration picks the
    fold, the forward, the input normalisation and the class labels."""

    def __init__(
        self,
        variables,
        cfg=DEFAULT_CONFIG,
        *,
        batch_size: int = 64,
        class_labels: list[str] | None = None,
        decode_workers: int | None = None,
        fast_decode: bool = False,
        fast_decode_safety: int = 2,
        device_resize_side: int | None = None,
        device=None,
        mesh=None,
    ):
        """fast_decode: DCT-scaled JPEG decode in the native decoder (up to
        8x less decode work for large sources; slight pixel deltas — serving
        mode, not parity mode). fast_decode_safety: the scaled decode must
        land at >= safety * im_side on its short side before the resize.

        device_resize_side: ship center-cropped uint8 at this intermediate
        side and run the final bilinear resample to cfg.im_side on the
        device (ops/resize.py:resize_bilinear_half_pixel, cv2 semantics),
        then round back to uint8. Exact to one uint8 level only when the
        cropped source already has this side (no host resample). Must
        exceed cfg.im_side.

        mesh: split each batch's rows over the mesh's data axis (module
        docstring); the device defaults to the mesh's. Every rank must make
        the same calls. Weights are folded once per rank."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = default_device(device if device is not None or mesh is None else mesh.device)
        self.mesh = mesh
        self._group = mesh.group("data") if mesh is not None else None
        self.cfg = cfg
        self._family = family.of(cfg)
        self.batch_size = batch_size
        self.class_labels = class_labels or self._family.class_labels(cfg)
        self.decode_workers = decode_workers or min(32, (os.cpu_count() or 8) * 2)
        if device_resize_side is not None and device_resize_side <= cfg.im_side:
            raise ValueError(
                f"device_resize_side {device_resize_side} must exceed "
                f"im_side {cfg.im_side} (ship more pixels, resample on device)"
            )
        self.device_resize_side = device_resize_side
        # The side the HOST pipeline resizes to (and ships).
        self.host_side = device_resize_side or cfg.im_side
        self.min_decode_side = fast_decode_safety * self.host_side if fast_decode else 0
        if fast_decode and not native.available():
            logging.getLogger("roomnet_tpu_torch.classify").warning(
                "fast_decode requested but the native decoder is unavailable — "
                "falling back to full cv2 decode with no DCT-scaling speedup")
        self.variables = variables
        # One decode thread and one copy stream for the classifier's life: a
        # thread's first CUDA call costs milliseconds, which a thread per
        # call would add to every request.
        self._decoder = ThreadPoolExecutor(max_workers=1, thread_name_prefix="roomnet-decode")
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def close(self) -> None:
        """Stop the decode thread; later predictions raise."""
        self._decoder.shutdown(wait=True)

    @property
    def variables(self):
        """The serving weights. Assigning a tree moves it to the device and
        folds it (`fold_variables`) before it is published: the tree and its
        fold are one attribute, so a call that reads them never sees one
        without the other."""
        return self._weights[0]

    @variables.setter
    def variables(self, variables):
        tree = _to_device(variables, self.device)
        self._weights = (tree, self._family.fold_variables(tree, self.cfg))

    def _predict(self, variables, x_uint8_bgr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One device batch: (ids, probs) tensors on the device, from a uint8
        BGR device tensor. `variables` is `self.variables` (its published
        fold serves the call) or another tree, folded for this call alone
        (the serving daemon's reload probe)."""
        published, folded = self._weights
        model = self._family
        if variables is not published:
            folded = model.fold_variables(_to_device(variables, self.device), self.cfg)
        n, group = x_uint8_bgr.shape[0], self._group
        if group is not None:
            # This rank's rows of the batch, cycle-padded to a multiple of
            # the data axis; the padding's rows are dropped after the gather.
            per = -(-n // C.size(group))
            i = C.index(group)
            x_uint8_bgr = x_uint8_bgr[torch.arange(i * per, (i + 1) * per, device=x_uint8_bgr.device) % n]
        if self.device_resize_side is not None:
            side = self.cfg.im_side
            xr = resize_bilinear_half_pixel(x_uint8_bgr.float(), (side, side))
            # Back to uint8, as cv2's resize would give (to one level).
            x_uint8_bgr = xr.round().clamp(0, 255).to(torch.uint8)
        _, probs = model.forward_folded(folded, model.normalize(x_uint8_bgr, self.cfg), self.cfg)
        probs = C.gather(probs, group)[:n]
        return probs.argmax(dim=-1), probs

    # -- host preprocess ----------------------------------------------------
    def _load(self, fpath: str) -> np.ndarray | None:
        """Center-crop -> resize -> BGR uint8 (reference network.py:148-152).

        The native decoder when it is built, else (and for the formats it
        cannot read) cv2."""
        if native.available():
            probed = native.probe(fpath)
            if probed is not None:
                crop = draw_crop_rect(*probed, random_crop=False, rng=None)
                out = native.load_preprocess(fpath, crop, self.host_side,
                                             min_decode_side=self.min_decode_side)
                if out is not None:
                    return out
        return self._load_cv2(fpath)

    def _load_cv2(self, fpath: str) -> np.ndarray | None:
        try:
            import cv2
        except ImportError as e:
            why = "cannot read it" if native.available() else "is unavailable on this host"
            raise RuntimeError(
                f"cannot decode {fpath}: the native decoder (roomnet_io) {why} "
                "and cv2 is not installed") from e
        im = cv2.imread(fpath)
        if im is None:
            return None
        return self.prep_decoded(im)

    def prep_decoded(self, im: np.ndarray) -> np.ndarray:
        """Host preprocess for an already-decoded BGR image: center-crop,
        then resize to host_side (cv2, only where the crop has another side)."""
        im = center_crop(im)
        if im.shape[0] != self.host_side or im.shape[1] != self.host_side:
            import cv2

            im = cv2.resize(im, (self.host_side, self.host_side))
        return np.ascontiguousarray(im)

    def path_fill(self, fpaths: list[str], pool: ThreadPoolExecutor):
        """The decode stage of `predict_paths`: a `fill` for `predict_stream`
        that decodes `fpaths` on `pool` into the host batch. The native batch
        call when the decoder is built, with a per-image cv2 retry for files
        it cannot read (it is JPEG/PNG-only); else `_load` per image."""
        if not native.available():
            return load_fill(fpaths, self._load, pool)
        side = self.host_side

        def fill(start: int, stop: int, out: np.ndarray) -> np.ndarray:
            paths = fpaths[start:stop]
            m = len(paths)
            probes = list(pool.map(native.probe, paths))
            crops = np.full((m, 4), -1, np.int32)
            for k, pr in enumerate(probes):
                if pr is not None:
                    crops[k] = draw_crop_rect(*pr, random_crop=False, rng=None)
            _, ok = native.load_preprocess_batch(
                paths, crops, side, np.zeros((m, 2), np.int32),
                min_decode_side=self.min_decode_side, out=out)
            ok &= np.array([pr is not None for pr in probes])
            failed = np.flatnonzero(~ok)
            for k, im in zip(failed, pool.map(self._load_cv2, [paths[k] for k in failed])):
                if im is not None:
                    out[k] = im
                    ok[k] = True
            return _compact(out, ok)

        return fill

    def predict_paths(self, fpaths: list[str]):
        """Stream paths through device batches; returns (ids, confs, ok_mask).

        Unreadable files get id -1 / conf 0; they are left out of their
        batch, so the final batch (and any with unreadable files) is ragged."""
        with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            return self.predict_stream(len(fpaths), self.path_fill(fpaths, pool))

    def predict(self, x_uint8_bgr) -> tuple[np.ndarray, np.ndarray]:
        """(N,S,S,3) uint8 BGR on the host (numpy, or a CPU tensor, pinned
        or not) -> (ids (N,), probs (N, classes)), in device batches of at
        most `batch_size`, through the pipeline of `predict_stream`."""
        x = x_uint8_bgr.numpy() if isinstance(x_uint8_bgr, torch.Tensor) else np.asarray(x_uint8_bgr)
        side = self.host_side
        if x.dtype != np.uint8 or x.ndim != 4 or x.shape[1:] != (side, side, 3):
            raise ValueError(f"expected (N,{side},{side},3) uint8, got {x.shape} {x.dtype}")

        def fill(start: int, stop: int, out: np.ndarray) -> np.ndarray:
            out[: stop - start] = x[start:stop]
            return np.arange(stop - start)

        ids, probs, _ = self.predict_stream(len(x), fill)
        return ids, probs

    def predict_stream(self, n: int, fill):
        """Classify n items in batches of `batch_size`; the pipeline of
        `predict_paths` and `predict`, with its decode stage as `fill`.

        ``fill(start, stop, out)`` loads items [start, stop) into the host
        batch `out`, a (rows, S, S, 3) uint8 view of a pinned ring buffer:
        it writes the rows of the items it could read, in order, to
        out[:k] and returns their offsets from start (k ascending ints).
        It runs on the classifier's decode thread, at most RING batches
        ahead of the forward (in the caller's thread for a single batch).
        Returns (ids (n,) int64, confs (n, classes) f32, ok (n,)), with id
        -1 and conf 0 for the items fill left out.

        On a CUDA device each batch is copied on a dedicated stream and the
        forward waits on the copy's event. A ring slot is refilled only
        after the forward of its previous batch has completed (and so its
        copy too), which also bounds the device work in flight to RING
        batches. The device batch, allocated on the copy stream, is marked
        in use by the compute stream (`record_stream`), so the allocator
        cannot hand it to a later copy before the forward has read it.

        Spans (utils/profiling.SPANS, the JAX package's e2e/* names): per
        batch e2e/decode (fill), e2e/wait_decode (the main loop's wait for
        the decode stage), e2e/dispatch (the forward and the result copies
        enqueued); on a CUDA device also e2e/device_put (the copy enqueued)
        and e2e/wait_put (the compute stream made to wait for it); per call
        e2e/fetch (the one synchronize and the results' assembly). None of
        them adds a synchronize: on a CUDA device the per-batch spans time
        the host's enqueue, not the device's work.

        Beside them, outside e2e/* (`bench.py` reads every e2e/* entry as a
        span), once per batch: the span stage/wait_fill, the part of the
        main loop's e2e/wait_decode that overlaps the awaited batch's fill
        call, from `time.perf_counter` stamps of the fill on the thread
        that runs it and of the wait on the main thread (the rest of the
        wait is the decode stage waiting for its ring slot's last forward,
        the H2D enqueue and the hand-off); and the counter stage/fill_bytes,
        the bytes fill wrote (kept rows x S*S*3), counted on the thread
        that runs it."""
        bs = self.batch_size
        ids = np.full(n, -1, np.int64)
        confs = np.zeros((n, len(self.class_labels)), np.float32)
        if n == 0:
            return ids, confs, ids >= 0
        cuda = self.device.type == "cuda"
        side = self.host_side
        n_batches = -(-n // bs)
        ring = [torch.empty((min(bs, n), side, side, 3), dtype=torch.uint8, pin_memory=cuda)
                for _ in range(min(RING, n_batches))]
        released = [None] * len(ring)  # each slot's event: its last forward is done
        res_ids = torch.empty(n, dtype=torch.int64, pin_memory=cuda)
        res_probs = torch.empty((n, len(self.class_labels)), dtype=torch.float32, pin_memory=cuda)
        copy_stream = self._copy_stream
        compute = torch.cuda.current_stream(self.device) if cuda else None
        # At most RING batches decoded but not yet dispatched. If the main
        # loop aborts (a stage raised), queued decode calls must not block
        # forever in depth.acquire — the abort path waits on them and would
        # deadlock; abort turns them into no-ops.
        depth = threading.Semaphore(RING)
        abort = threading.Event()

        def stage_decode(b: int):
            # Entry check before the semaphore: after an abort every queued
            # call still runs.
            if abort.is_set():
                return None
            while not depth.acquire(timeout=0.2):
                if abort.is_set():
                    return None
            if abort.is_set():
                depth.release()
                return None
            try:
                slot = b % len(ring)
                if released[slot] is not None:
                    released[slot].synchronize()
                with trace("e2e/decode"):
                    f0 = time.perf_counter()
                    kept = np.asarray(fill(b * bs, min(b * bs + bs, n), ring[slot].numpy()), np.int64)
                    filled = (f0, time.perf_counter())
                SPANS.count("stage/fill_bytes", kept.size * side * side * 3)
                if kept.size == 0 or not cuda:
                    return kept, ring[slot][: kept.size], None, filled
                with trace("e2e/device_put"), torch.cuda.stream(copy_stream):
                    x_dev = ring[slot][: kept.size].to(self.device, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(copy_stream)
                return kept, x_dev, copied, filled
            except BaseException:
                depth.release()  # the main loop will never release for us
                raise

        done = []  # (item indices, result rows) of each forward
        # Each future is dropped once read: a future keeps its result, and
        # with it the batch's device tensor, alive. A single batch has
        # nothing to overlap, so its stage runs in the caller's thread: a
        # request pays no hand-off to the decode thread.
        pending = deque(self._decoder.submit(stage_decode, b) for b in range(n_batches)
                        if n_batches > 1)
        variables = self.variables  # one set of weights for the whole call
        try:
            for b in range(n_batches):
                with trace("e2e/wait_decode"):
                    w0 = time.perf_counter()
                    kept, x, event, (f0, f1) = pending.popleft().result() if pending else stage_decode(b)
                    w1 = time.perf_counter()
                SPANS.add("stage/wait_fill", max(0.0, min(w1, f1) - max(w0, f0)))
                if kept.size:
                    if event is not None:
                        with trace("e2e/wait_put"):
                            compute.wait_event(event)
                            x.record_stream(compute)
                    with trace("e2e/dispatch"):
                        bid, bprobs = self._predict(variables, x)
                        rows = slice(b * bs, b * bs + kept.size)
                        res_ids[rows].copy_(bid, non_blocking=True)
                        res_probs[rows].copy_(bprobs, non_blocking=True)
                    done.append((b * bs + kept, rows))
                    if cuda:
                        released[b % len(ring)] = torch.cuda.Event()
                        released[b % len(ring)].record(compute)
                depth.release()  # after `released`: the decode thread reads it next
        except BaseException:
            abort.set()
            wait(pending)  # the stage running now finishes; the rest return at once
            raise
        with trace("e2e/fetch"):
            if cuda:
                compute.synchronize()
            for idx, rows in done:
                ids[idx] = res_ids[rows].numpy()
                confs[idx] = res_probs[rows].numpy()
        return ids, confs, ids >= 0


Classifier = RoomNetClassifier  # the model-neutral name


def dir_images(imgs_dir: str) -> list[str]:
    """The files `classify_im_dir` classifies, in its order."""
    return [p for p in sorted(glob(os.path.join(imgs_dir, "*"))) if os.path.isfile(p)]


def classify_im_dir(
    classifier: RoomNetClassifier,
    imgs_dir: str,
    overlay: bool = True,
    *,
    out_dir: str | None = None,
    progress: bool = True,
) -> str:
    """Directory classification with xls + per-class dir outputs (infer.py:65-100)."""
    labels = classifier.class_labels
    all_im_paths = dir_images(imgs_dir)
    out_dir = out_dir or (imgs_dir.rstrip(os.sep) + "_classified")
    xl_fpath = out_dir + "_results.xls"
    csv_fpath = out_dir + "_results.csv"  # modern-tooling twin of the .xls
    for lbl in labels:
        force_makedir(os.path.join(out_dir, lbl))

    ids, confs, ok = classifier.predict_paths(all_im_paths)

    wb = Workbook()
    sheet = wb.add_sheet("classification_results")
    sheet.write(0, 0, "IMAGE_NAME")
    sheet.write(0, 1, "PREDICTED_LABEL")
    csv_file = open(csv_fpath, "w", newline="")
    csv_writer = csv.writer(csv_file)
    csv_writer.writerow(["IMAGE_NAME", "PREDICTED_LABEL", "CONFIDENCE"])
    it = enumerate(all_im_paths)
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(list(it))
        except ImportError:
            pass
    xls_overflowed = False

    def write_xls_row(i, fname, pred_label, pred_conf):
        # BIFF2 rows are 16-bit; a >65534-image directory keeps its FULL
        # results in the CSV twin while the legacy .xls carries what fits
        # (warn once) — the reference's xlwt writer had the same wall,
        # except it crashed there.
        nonlocal xls_overflowed
        if i + 1 > 0xFFFE:  # Sheet.write's cap (DIMENSIONS packs max+1)
            if not xls_overflowed:
                warnings.warn(
                    "results exceed the .xls (BIFF2) 65535-row limit; "
                    "remaining rows are in the CSV only", stacklevel=2,
                )
                xls_overflowed = True
            return
        sheet.write(i + 1, 0, fname)
        sheet.write(i + 1, 1, pred_label)
        sheet.write(i + 1, 2, str(pred_conf))

    try:
        for i, fpath in it:
            if not ok[i]:
                continue
            pred_label = labels[int(ids[i])]
            pred_conf = float(confs[i, int(ids[i])])
            dst_dir = os.path.join(out_dir, pred_label)
            fname = os.path.basename(fpath)
            if overlay:
                import cv2

                # The prediction path may have decoded this file with the
                # native backend; cv2 can still fail here. The file IS
                # classified — fall back to a raw copy instead of crashing,
                # as the reference's overlay=False branch does (infer.py:94).
                # The WRITE can fail too (an extensionless filename gives
                # cv2.imwrite no encoder) — same fallback.
                im = cv2.imread(fpath)
                if im is None:
                    _warn_copy(fpath, dst_dir, "cv2 could not re-read it")
                else:
                    h, w = im.shape[:2]
                    # Same overlay text/placement as infer.py:89-92.
                    cv2.putText(im, "Predicted Class: " + pred_label,
                                (int(0.5 * w), int(0.90 * h)),
                                cv2.FONT_HERSHEY_SIMPLEX,
                                (h / 720.0) * 0.85, (0, 255, 0), 1,
                                cv2.LINE_AA)
                    cv2.putText(im, "Confidence: "
                                + str(round(pred_conf * 100, 2)) + " %",
                                (int(0.5 * w), int(0.95 * h)),
                                cv2.FONT_HERSHEY_SIMPLEX,
                                (h / 720.0) * 0.85, (255, 0, 0), 1,
                                cv2.LINE_AA)
                    try:
                        if not cv2.imwrite(os.path.join(dst_dir, fname), im):
                            raise OSError("imwrite returned False")
                    except Exception as e:  # noqa: BLE001
                        _warn_copy(fpath, dst_dir, f"annotated write failed ({e})")
            else:
                shutil.copy(fpath, dst_dir)
            write_xls_row(i, fname, pred_label, pred_conf)
            csv_writer.writerow([fname, pred_label, pred_conf])
    finally:
        # One failing row must not discard a fully-classified directory's
        # results: whatever was written so far is flushed either way.
        csv_file.close()
        wb.save(xl_fpath)
    return xl_fpath


def _warn_copy(fpath: str, dst_dir: str, why: str) -> None:
    warnings.warn(f"overlay skipped for {fpath}: {why}; copied unannotated", stacklevel=3)
    shutil.copy(fpath, dst_dir)


def groundtruth_validation(classifier: RoomNetClassifier, list_fpath: str) -> dict:
    """Re-score a labeled list file (reference infer.py:41-57, un-broken:
    the reference's version crashes on a commented-out constant)."""
    from ..data.dataset import parse_list_line
    from ..train.metrics import make_stats_entry

    with open(list_fpath) as f:
        pairs = [parse_list_line(l) for l in f if l.strip()]
    fpaths = [p for p, _ in pairs]
    y_true = [c for _, c in pairs]
    ids, _, ok = classifier.predict_paths(fpaths)
    y_t = [t for t, o in zip(y_true, ok) if o]
    y_p = [int(i) for i, o in zip(ids, ok) if o]
    entry = make_stats_entry(0, y_t, y_p)
    del entry["step"]
    return entry


def evaluate_checkpoints(
    model_dir: str,
    list_fpath: str,
    cfg=DEFAULT_CONFIG,
    *,
    batch_size: int = 64,
    class_labels: list[str] | None = None,
    backend: str = "auto",
    device=None,
    mesh=None,
) -> dict:
    """Re-score every checkpoint in a training dir against one labeled list
    (port of roomnet_tpu/infer/classify.py:evaluate_checkpoints).

    The reference picks its best model by the accuracy in checkpoint file
    names (legacy_plotter.py:19-37), each measured on whatever val set was
    live during its run; this measures all of them on one list, markers
    ('interrupt', 'stall') included. One classifier serves the sweep: each
    checkpoint is assigned to `clf.variables`, which refolds the weights.

    backend: "auto" (`open_store`: npz files win, else DCP directories),
    "npz" or "orbax" (the DCP store, `params/orbax_io.py`). A dir of the JAX
    package's orbax directories raises. mesh: the classifier's
    (`RoomNetClassifier`); every rank runs the sweep.

    Returns {"checkpoints": [{step, checkpoint, name_accuracy, accuracy,
    precisions, recalls, f-scores}...], "best": <entry>}.
    """
    from ..params.checkpoint import CheckpointStore, open_store
    from ..params.orbax_io import OrbaxCheckpointStore
    from ..params.schema import variables_from_numpy

    stores = {"auto": open_store, "npz": CheckpointStore,
              "orbax": lambda d: OrbaxCheckpointStore(d, async_save=False)}
    if backend not in stores:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    store = stores[backend](model_dir)
    ckpts = store.list_checkpoints()
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {model_dir}")
    dev = default_device(device if device is not None or mesh is None else mesh.device)
    clf = None
    entries = []
    for step, suffix, path in ckpts:
        var_flat, _ = store.load(path, cfg=cfg)
        variables = variables_from_numpy(var_flat, cfg, dev)
        if clf is None:
            clf = RoomNetClassifier(variables, cfg, batch_size=batch_size,
                                    class_labels=class_labels, device=dev, mesh=mesh)
        else:
            clf.variables = variables
        try:
            name_acc = float(suffix)
        except ValueError:
            name_acc = None
        entry = {"step": step, "checkpoint": os.path.basename(path), "name_accuracy": name_acc}
        entry.update(groundtruth_validation(clf, list_fpath))
        entries.append(entry)
    clf.close()
    best = max(entries, key=lambda e: (e["accuracy"], e["step"]))
    return {"checkpoints": entries, "best": best}
