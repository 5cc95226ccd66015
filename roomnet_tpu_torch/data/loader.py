"""Host data pipeline: crops, the prefetching train feeder, device staging
(port of roomnet_tpu/data/loader.py).

The feeder is the JAX package's, line for line in what it draws: the same
batches come out of both packages for the same list and seed, byte for
byte (the per-epoch and per-item RNG seeds and the order of the draws are
the contract). By design, as in the JAX package:
  * N decode workers (cv2 releases the GIL) instead of one producer thread;
  * bounded queue with blocking put/get — no busy-wait (the reference
    `dequeue` spins on empty, generator.py:173-177) and no sleep(2) poll;
  * deterministic per-batch RNG derived from (seed, epoch, batch) so runs
    are reproducible — the reference uses global np.random state.

Augmentation/crop semantics preserved exactly:
  * train: random sliding square crop (generator.py:52-67), cv2.resize to
    (S,S) INTER_LINEAR, p=.5 horizontal flip, p=.5 vertical flip
    (generator.py:89-92);
  * val: center crop (generator.py:69-78) + resize, no flips;
  * epoch accounting: batches_per_epoch = N // batch_size, tail dropped,
    shuffle at epoch boundaries (generator.py:39, 126-133);
  * `train_state` dict with the same keys (generator.py:48-49, 134-135).

Device staging (`to_device_async`, `on_stream`, `device_prefetch`): on a
CUDA device each host array is copied into a freshly allocated pinned
tensor and from there to the device on a copy stream, with an event
recorded behind the copies. The consumer's stream waits on the event and
each device tensor is marked in use by that stream (`record_stream`), so
the allocator cannot hand its memory to a later copy before the consumer
has read it. A pinned tensor is never kept and rewritten: PyTorch's caching
host allocator hands a pinned block out again only once the copy that read
it has completed, so the host never overwrites pixels a queued copy has not
read yet.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .dataset import parse_list_line

__all__ = ["TrainFeeder", "random_sliding_square_crop", "center_crop", "draw_crop_rect", "draw_flips",
           "load_and_preprocess", "device_prefetch", "to_device_async", "on_stream"]


def random_sliding_square_crop(im: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Square crop at a random offset along the long side (generator.py:52-67)."""
    h, w = im.shape[:2]
    if h == w:
        return im
    if h < w:
        start = rng.randint(w - h)
        return im[:, start : start + h, :]
    start = rng.randint(h - w)
    return im[start : start + w, :, :]


def center_crop(im: np.ndarray) -> np.ndarray:
    """Centered square crop (generator.py:69-78, network.py:137-146)."""
    h, w = im.shape[:2]
    off = abs((w - h) // 2)
    if h < w:
        return im[:, off : off + h, :]
    if w < h:
        return im[off : off + w, :, :]
    return im


def draw_crop_rect(
    h: int, w: int, *, random_crop: bool, rng: np.random.RandomState | None
) -> tuple[int, int, int, int]:
    """(cx, cy, cw, ch) square crop — random-sliding (generator.py:52-67) or
    centered (generator.py:69-78). Drawn in Python so the native and cv2
    backends consume the identical RNG sequence."""
    if h == w:
        return 0, 0, w, h
    side = min(h, w)
    if random_crop:
        start = int(rng.randint(max(h, w) - side))
    else:
        start = abs((w - h) // 2)
    if h < w:
        return start, 0, side, side
    return 0, start, side, side


def draw_flips(rng: np.random.RandomState, augment: bool) -> tuple[bool, bool]:
    """p=.5 fliplr then p=.5 flipud, same draw order as generator.py:89-92."""
    if not augment:
        return False, False
    return bool(rng.uniform() > 0.5), bool(rng.uniform() > 0.5)


def load_and_preprocess(
    fpath: str,
    im_side: int,
    *,
    random_crop: bool,
    augment: bool,
    rng: np.random.RandomState,
    use_native: bool | None = None,
) -> np.ndarray | None:
    """Decode + square-crop + resize + optional flips -> HWC uint8 BGR.

    The native decoder first (data/native.py: fused decode->crop->resize->
    flip); cv2 where it is not built, and per image for a file it cannot
    read, after the RNG is rewound so the cv2 path draws the same crop and
    flips it would have drawn alone.
    """
    from . import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        rng_state = rng.get_state()
        probed = native.probe(fpath)
        if probed is not None:
            h, w = probed
            crop = draw_crop_rect(h, w, random_crop=random_crop, rng=rng)
            flip_lr, flip_ud = draw_flips(rng, augment)
            out = native.load_preprocess(fpath, crop, im_side, flip_lr, flip_ud)
            if out is not None:
                return out
        rng.set_state(rng_state)

    import cv2

    im = cv2.imread(fpath)
    if im is None:
        return None
    cx, cy, cw, ch = draw_crop_rect(im.shape[0], im.shape[1], random_crop=random_crop, rng=rng)
    im = im[cy : cy + ch, cx : cx + cw]
    if im.shape[0] != im_side or im.shape[1] != im_side:
        im = cv2.resize(im, (im_side, im_side))
    flip_lr, flip_ud = draw_flips(rng, augment)
    if flip_lr:
        im = np.fliplr(im)
    if flip_ud:
        im = np.flipud(im)
    return np.ascontiguousarray(im)


class TrainFeeder:
    """Async batch feeder with the reference's public surface.

    API parity: ``dequeue() -> (x_bgr_uint8[B,S,S,3], y[B])`` and a
    ``train_state`` dict {'epoch','batch','total_iters','previous_epoch_done'}
    (generator.py:48-49, 165-177).
    """

    def __init__(
        self,
        fpaths: list[str],
        shuffle: bool = True,
        batch_size: int = 8,
        preprocess: bool = True,
        batches_per_queue: int = 40,
        random_crop: bool = True,
        im_side: int = 300,
        *,
        seed: int = 0,
        decode_workers: int = 8,
        start: bool = True,
        rows: tuple[int, int] | None = None,
    ):
        """rows=(lo, hi): decode ONLY rows lo..hi of every nominal batch (the
        JAX package's multi-host sharded feed). Epoch order, per-row crop/flip
        RNG, and epoch accounting stay keyed to the GLOBAL row index, so the
        union of all slices is exactly the full batch."""
        self.fpaths = np.array([l for l in fpaths if l.strip()])
        if len(self.fpaths) == 0:
            raise ValueError(
                "TrainFeeder: no usable paths — the list is empty or blank "
                "(stale/empty train_list.txt / val_list.txt?)"
            )
        self.shuffle = shuffle
        self.random_crop = random_crop
        self.augment = preprocess
        self.im_side = im_side
        self.seed = seed
        self.epoch_size_total = len(self.fpaths)
        self.batch_size = min(batch_size, self.epoch_size_total)
        self.batches_per_epoch = self.epoch_size_total // self.batch_size
        self.epoch_size = self.batch_size * self.batches_per_epoch
        if rows is not None:
            lo, hi = rows
            if not (0 <= lo < hi <= self.batch_size):
                raise ValueError(f"rows {rows} out of range for batch_size {self.batch_size}")
        self.rows = rows
        self.train_state = {
            "epoch": 1,
            "batch": 0,
            "total_iters": 0,
            "previous_epoch_done": False,
            "synthetic": False,
        }
        self.last_batch_synthetic = False
        self._q: queue.Queue = queue.Queue(maxsize=batches_per_queue)
        self._stop = threading.Event()
        self._producer_error: BaseException | None = None
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        if start:
            self._thread.start()

    # -- producer ----------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.epoch_size_total)
        if self.shuffle:
            np.random.RandomState((self.seed * 1_000_003 + epoch) & 0x7FFFFFFF).shuffle(idx)
        return idx

    def _item_rng(self, epoch: int, batch_i: int, i: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 2_000_003 + epoch * 9_973 + batch_i * 101 + i) & 0x7FFFFFFF
        )

    def _make_batch(self, epoch: int, batch_i: int, order: np.ndarray):
        from . import native

        start = batch_i * self.batch_size
        lines = self.fpaths[order[start : start + self.batch_size]]
        parsed = [parse_list_line(l) for l in lines]
        # A row slice decodes its rows only; row0 keys every per-row draw
        # to the GLOBAL row index.
        row0 = 0
        if self.rows is not None:
            row0 = self.rows[0]
            parsed = parsed[self.rows[0]: self.rows[1]]

        if native.available():
            # Probe headers (threaded), draw crops/flips in Python (the cv2
            # path's RNG sequence), then ONE C call fills the batch.
            probes = list(self._pool.map(native.probe, [p for p, _ in parsed]))
            n = len(parsed)
            crops = np.full((n, 4), -1, np.int32)
            flips = np.zeros((n, 2), np.int32)
            for i, pr in enumerate(probes):
                rng = self._item_rng(epoch, batch_i, row0 + i)
                if pr is None:
                    continue
                crops[i] = draw_crop_rect(pr[0], pr[1], random_crop=self.random_crop, rng=rng)
                flips[i] = draw_flips(rng, self.augment)
            batch, ok = native.load_preprocess_batch([p for p, _ in parsed], crops, self.im_side, flips)
            ok &= np.array([pr is not None for pr in probes])
            xs, ys, paths = [], [], []
            for i in range(n):
                im = batch[i] if ok[i] else None
                if im is None:
                    # JPEG/PNG only natively: retry through cv2 with a fresh
                    # per-item RNG (the same draws).
                    im = load_and_preprocess(
                        parsed[i][0], self.im_side,
                        random_crop=self.random_crop, augment=self.augment,
                        rng=self._item_rng(epoch, batch_i, row0 + i),
                        use_native=False,
                    )
                if im is not None:
                    xs.append(im)
                    ys.append(parsed[i][1])
                    paths.append(parsed[i][0])
        else:

            def one(args):
                i, (path, label) = args
                im = load_and_preprocess(
                    path,
                    self.im_side,
                    random_crop=self.random_crop,
                    augment=self.augment,
                    rng=self._item_rng(epoch, batch_i, row0 + i),
                )
                return im, label, path

            results = list(self._pool.map(one, enumerate(parsed)))
            xs = [r[0] for r in results if r[0] is not None]
            ys = [r[1] for r in results if r[0] is not None]
            paths = [r[2] for r in results if r[0] is not None]
        synthetic = False
        if not xs:
            # Whole batch unreadable: keep the full shape with zero rows, and
            # flag the batch synthetic so consumers skip it (a gradient step
            # on zeros labelled class 0, or fake rows counted toward val
            # accuracy, would corrupt the run).
            from ..utils.logging import get_logger

            get_logger("loader").error(
                "whole batch unreadable (%d files, e.g. %r) — emitting a "
                "synthetic zero batch flagged for skipping",
                len(parsed), parsed[0][0] if parsed else "?",
            )
            synthetic = True
            n_rows = len(parsed) or self.batch_size
            xs = [np.zeros((self.im_side, self.im_side, 3), np.uint8)] * n_rows
            ys = [0] * n_rows
            paths = [""] * n_rows
        return np.stack(xs), np.asarray(ys, np.int32), np.asarray(paths), synthetic

    def _producer(self):
        try:
            self._producer_loop()
        except BaseException as e:  # noqa: BLE001 — surfaced via dequeue()
            # A daemon thread dying silently would leave dequeue() blocked
            # forever and read as a device stall: record the cause for the
            # consumer to raise once the queue drains.
            self._producer_error = e
            from ..utils.logging import get_logger

            get_logger("loader").error("feeder producer thread died: %r", e)

    def _producer_loop(self):
        epoch = 0
        total = 0
        while not self._stop.is_set():
            order = self._epoch_order(epoch)
            for b in range(self.batches_per_epoch):
                if self._stop.is_set():
                    return
                x, y, paths, synthetic = self._make_batch(epoch, b, order)
                total += 1
                state = {
                    "epoch": epoch + 1,
                    "batch": b + 1,
                    "total_iters": total,
                    # Set on the FIRST batch of a new epoch (generator.py:
                    # 134-135), never on epoch 0.
                    "previous_epoch_done": (b == 0 and epoch > 0),
                    "synthetic": synthetic,
                }
                while not self._stop.is_set():
                    try:
                        self._q.put((x, y, paths, state), timeout=0.5)
                        break
                    except queue.Full:
                        continue
            epoch += 1

    # -- consumer ----------------------------------------------------------
    def dequeue(self) -> tuple[np.ndarray, np.ndarray]:
        from ..utils.logging import get_logger

        while True:
            try:
                # Bounded get: produced batches are served first; once the
                # queue drains after a producer death, raise its cause.
                x, y, paths, state = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._producer_error is not None:
                    raise RuntimeError(
                        f"feeder producer thread died: {self._producer_error!r}"
                    ) from self._producer_error
        self.batch_fpaths = paths
        self.train_state = state
        self.last_batch_synthetic = bool(state.get("synthetic", False))
        if state["previous_epoch_done"]:
            # Epoch-boundary INFO log, like reference generator.py:168-171.
            get_logger("loader").info(
                "EPOCH %d COMPLETE (%d batches/epoch)", state["epoch"] - 1, self.batches_per_epoch)
        return x, y

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.dequeue()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- device staging -------------------------------------------------------------


class Staged(NamedTuple):
    """Host arrays on their way to the device: the device tensors and the
    event recorded behind their copies (None on the CPU)."""

    tensors: tuple
    event: torch.cuda.Event | None


def to_device_async(arrays, device: torch.device, stream: torch.cuda.Stream | None = None) -> Staged:
    """Start the copy of numpy `arrays` to `device`. On a CUDA device each
    array is copied into a fresh pinned tensor and then, on `stream`, to the
    device, with an event recorded behind the copies; read the tensors
    through `on_stream`. On the CPU the tensors share the arrays' memory."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return Staged(tuple(host), None)
    with torch.cuda.stream(stream):
        out = tuple(h.pin_memory().to(device, non_blocking=True) for h in host)
        event = torch.cuda.Event()
        event.record()
    return Staged(out, event)


def on_stream(staged: Staged, stream: torch.cuda.Stream | None = None) -> tuple:
    """The staged tensors, safe to read on `stream` (default: the current
    stream): it waits for the copies, and each tensor is marked in use by it."""
    if staged.event is None:
        return staged.tensors
    stream = stream or torch.cuda.current_stream(staged.tensors[0].device)
    stream.wait_event(staged.event)
    for t in staged.tensors:
        t.record_stream(stream)
    return staged.tensors


def device_prefetch(iterator, *, size: int = 2, device=None):
    """Wrap an iterator of host batches (tuples of numpy arrays) with device
    double-buffering: `size` batches are copied ahead on a copy stream while
    the consumer works, each yielded as a tuple of device tensors that the
    consumer's current stream may read (the replacement for the reference's
    host-side queue between feeder and session, generator.py:159-163).
    `device` defaults to `default_device()` (cuda, or raise)."""
    from .. import default_device

    dev = default_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    buf: deque = deque()
    it = iter(iterator)
    try:
        while True:
            while len(buf) < size:
                buf.append(to_device_async(next(it), dev, stream))
            yield on_stream(buf.popleft())
    except StopIteration:
        while buf:
            yield on_stream(buf.popleft())
