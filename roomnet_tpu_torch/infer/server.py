"""HTTP serving daemon for the classifier (port of roomnet_tpu/infer/server.py).

A persistent process with the forward's kernels built and warm that
micro-batches concurrent requests onto the card.

Endpoints:
  GET  /healthz            -> 200 {"status": "ok"}
  GET  /readyz             -> 200 while the device worker runs; 503 when
                              draining or stopping
  GET  /labels             -> JSON list of class labels
  GET  /version            -> {"step": ..., "path": ...} of the serving
                              weights (updated by /reload)
  GET  /metrics            -> JSON span registry (utils/profiling.SPANS):
                              per-span total_s/count/mean_ms/p50_ms/p99_ms,
                              incl. serve/device_call, serve/fetch and
                              serve/request, and the serve/device_call_bytes
                              counter
  POST /reload             -> hot-swap to the max-step checkpoint in the
                              model_dir fixed at startup (403 without one;
                              404 on an empty dir; 409 keeps the old weights
                              if the new ones fail the structural gate or
                              the probe device call, or if the dir holds
                              the JAX package's orbax directories, which
                              the port does not read)
  POST /classify           -> body = raw image bytes (jpeg/png); response
                              JSON {label, class_id, confidence, probs}
  POST /classify_batch     -> body = JSON {"images": [<base64>, ...]};
                              response JSON {"results": [per-image result
                              or {"error": ...}]}; N images ride one device
                              call when N <= max_batch
  POST /classify_batch?stream=1
                           -> the same body; NDJSON response, one
                              {"index": i, ...result-or-error} line per
                              image, emitted as each max_batch chunk's
                              device call completes; the stream ends by
                              connection close

Stdlib http.server only. A ThreadingHTTPServer front end decodes on a
bounded pool and feeds one device worker through a queue; the worker
coalesces up to `max_batch` pending images per device call, padded to the
next power-of-2 bucket. Admission caps the images in flight at
`max_inflight` and sheds the rest with 429; every request carries a
deadline stamped at admission (504 when it passes) and the worker drops
jobs whose deadline passed or whose client has gone.

On the card the worker thread makes the classifier's device its current
device and touches it once before it reports ready. Each device call copies
its bucket from a freshly allocated pinned host tensor (`non_blocking`);
PyTorch's caching host allocator hands that block out again only once the
copy that read it has completed, so the next chunk never overwrites pixels
a queued copy has not read yet. The ids and probs come back by non-blocking
copies into pinned host tensors behind a recorded event, which the round's
finalize waits on a pipelined round later: the worker never synchronizes
in its dispatch, and a device fault surfaces at that wait, inside the
handler that turns it into a 503 `device_error`.

On a mesh (a classifier built with `mesh=`, `parallel/mesh.py`) the ranks
run in lockstep, one process per card. Rank 0 runs the whole server: HTTP,
admission, the worker. Every other rank is a follower that binds no socket
(`serve_forever` picks the role by rank). Before each collective step rank
0's worker broadcasts a header over the world group (`_Lockstep`: a device
call and its bucket size, a reload and its checkpoint step, the stop, or a
heartbeat when idle), then the bucket of images, and every rank makes the
same `_predict` call: each computes its rows of the bucket and the
probabilities of every rank are gathered on every rank. Buckets start at
the data axis, so each rank gets whole rows. /reload and auto-reload run
as jobs on the worker thread, so their collectives never interleave with
a device call's: every rank loads the step that rank 0 chose from its own
store, the ranks agree that each loaded and gated it, the probe call is
collective, and all ranks swap or none does. A collective that fails (a
rank died; the group's timeout) fails its requests with 503 and ends rank
0's `serve_forever` with an error; nothing waits for the lost rank.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from ..models import family
from ..parallel import collectives as C
from ..params import schema
from ..params.checkpoint import open_store
from ..utils.logging import EventLog, get_logger
from ..utils.profiling import SPANS, trace

# The worker's start-up (set the device, one small CUDA call) on a busy host.
WORKER_START_S = 60.0
# A mesh server's headers: the op, the bucket size, the checkpoint step.
_NOOP, _PREDICT, _RELOAD, _STOP = range(4)
# An idle rank 0 sends a NOOP header this often, so that a follower's wait
# for the next header never reaches the process group's timeout.
HEARTBEAT_S = 5.0


class _Job:
    """One unit of device work: a list of decoded images (None = undecodable
    row). Single requests carry 1 image; /classify_batch carries N. The
    worker fills `results` (per-image dict or None) and sets `event`."""

    __slots__ = ("images", "event", "results", "error", "abandoned", "deadline", "reload", "reply")

    def __init__(self, images, deadline: float = float("inf"), reload: bool = False):
        self.images = images
        # A mesh server's /reload: no images; the worker runs it and sets
        # `reply` to its (status, payload).
        self.reload = reload
        self.reply = None
        self.event = threading.Event()
        self.results = [None] * len(images)
        self.error = None  # "device_error" when the batch's device call failed
        # Set by the handler once its client got a 504: the worker skips
        # abandoned jobs, so zombie work never takes device time.
        self.abandoned = False
        # Absolute monotonic deadline, stamped at admission.
        self.deadline = deadline


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that a non-blocking copy of `t` will fill."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _Lockstep:
    """The headers of a mesh server, over the world group: rank 0 sends one
    before each collective step and every follower receives it, so that
    every rank makes the same calls in the same order."""

    def __init__(self, device: torch.device):
        self.device = device
        self.group = dist.group.WORLD
        self.sent = time.monotonic()

    def send(self, op: int, bucket: int = 0, step: int = 0, *, wait: bool = False):
        """Rank 0: broadcast a header; with `wait`, return once every rank
        has taken part (a header is otherwise asynchronous on NCCL)."""
        hdr = torch.tensor([op, bucket, step], dtype=torch.int64, device=self.device)
        C.broadcast_(hdr, self.group)
        if wait:
            hdr.tolist()
        self.sent = time.monotonic()

    def receive(self) -> list:
        """A follower: the next header, [op, bucket, step]."""
        hdr = torch.zeros(3, dtype=torch.int64, device=self.device)
        return C.broadcast_(hdr, self.group).tolist()

    def share(self, x: torch.Tensor):
        """Rank 0's bucket of images into `x` on every rank, in place."""
        C.broadcast_(x, self.group)


class ClassifierServer:
    def __init__(self, classifier, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int | None = None, warmup: bool = False,
                 max_inflight: int | None = None,
                 decode_workers: int | None = None,
                 request_timeout_s: float = 30.0,
                 model_dir: str | None = None,
                 max_body_bytes: int = 256 << 20,
                 auto_reload_s: float | None = None,
                 access_log: str | None = None,
                 idle_connection_s: float = 65.0,
                 drain_s: float = 0.0):
        """model_dir: enables POST /reload, which re-scans this checkpoint
        dir (resume-latest) and swaps the serving weights without a
        restart: one assignment of `classifier.variables`, whose setter
        publishes the tree and its fold together. The dir is fixed at
        startup; the endpoint never takes a path from the network.

        auto_reload_s: poll model_dir every N seconds and swap when a newer
        max-step checkpoint lands, through the same guarded path as
        /reload; a rejected checkpoint keeps the old weights and is retried
        on the next poll.

        warmup: run every bucket once before the socket binds. On the card
        the first device call also builds the CUDA kernels (nvcc); without
        warmup the first request pays that against its budget.

        A classifier on a mesh makes this a mesh server (module docstring):
        every rank constructs it with the same arguments and calls
        `serve_forever`; rank 0 serves, the others follow."""
        family.require_roomnet(classifier.cfg, "ClassifierServer")
        self.classifier = classifier
        mesh = getattr(classifier, "mesh", None)
        self.rank = 0 if mesh is None else mesh.rank
        self._lockstep = None if mesh is None else _Lockstep(classifier.device)
        # The failure of a mesh collective: rank 0 stops, serve_forever raises.
        self._mesh_error: BaseException | None = None
        self.host = host
        self.port = port
        self.model_dir = model_dir
        self.model_version: dict = {"step": None, "path": "initial"}
        if auto_reload_s is not None and model_dir is None:
            raise ValueError("auto_reload_s needs model_dir")
        self.auto_reload_s = auto_reload_s
        # JSON lines per answered request: {ts, kind: "request", method,
        # path, status, ms}; for the streaming endpoint ms is the time to
        # the 200 head.
        self._access_log = EventLog(access_log)
        # Idle keep-alive reap (the handler's socket timeout); it also
        # bounds a stalled mid-body client, hence > request_timeout_s.
        self.idle_connection_s = idle_connection_s
        # A device call holds at most the classifier's batch size.
        self.max_batch = min(max_batch or classifier.batch_size, classifier.batch_size)
        self.warmup = warmup
        self.request_timeout_s = request_timeout_s
        # Rejected from the Content-Length header, before any read.
        self.max_body_bytes = max_body_bytes
        # Admission cap: image slots in flight (decoding, queued or on the
        # device) before new requests are shed with 429.
        self.max_inflight = max_inflight or 4 * self.max_batch
        self._admit = threading.Semaphore(self.max_inflight)
        # Graceful drain (serve_forever): /readyz goes 503 and new classify
        # work is shed with 503, while admitted requests finish (up to
        # drain_s) before stop() fails whatever remains.
        self.drain_s = drain_s
        self._draining = False
        self._inflight = 0  # admitted image slots currently held
        # Classify handlers running, from do_POST entry to the response
        # written: slots release before the write, and a request still
        # reading its body holds none yet; wait_drained must see both.
        self._active_requests = 0
        self._inflight_lock = threading.Lock()
        # Bounded decode pool (cv2 decode is the CPU-heavy part of a
        # request). Its threads never touch CUDA.
        self._decode_pool = ThreadPoolExecutor(
            max_workers=decode_workers or min(4, (os.cpu_count() or 1) * 2))
        # Unbounded: admission is the one source of truth for what is in
        # flight (a bounded queue double-counted 504'd jobs).
        self._jobs: queue.Queue[_Job] = queue.Queue()
        # Serializes /reload: interleaved load/probe/swap could leave older
        # weights, or a model_version that disagrees with them, last.
        self._reload_lock = threading.Lock()
        self._bucket_sizes = self._compute_buckets()
        self._stop = threading.Event()
        self._worker_ready = threading.Event()
        self._worker_error: BaseException | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []

    # -- device worker: micro-batches pending requests ----------------------
    def _compute_buckets(self):
        """Device-call batch sizes: powers of 2 times the smallest legal
        batch up to the classifier's batch size (and it). A lone request
        ships one image, not a full batch of padding; a call pads at most 2x.
        On a mesh the smallest is the data axis, so every rank gets whole
        rows of each bucket."""
        base = 1
        mesh = getattr(self.classifier, "mesh", None)
        if mesh is not None:
            base = int(mesh.shape["data"])
        b, out = base, []
        while b < self.classifier.batch_size:
            out.append(b)
            b *= 2
        out.append(self.classifier.batch_size)
        return out

    @staticmethod
    def _bucket_for(n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _zeros(self, n: int) -> torch.Tensor:
        side = self.classifier.host_side
        return torch.zeros((n, side, side, 3), dtype=torch.uint8, device=self.classifier.device)

    def _warmup(self):
        """Run every bucket once, the kernels' build included, and fetch a
        result of each, so no request pays either."""
        for b in self._bucket_sizes:
            ids, _ = self._device_call(self._zeros(b))
            int(ids[0])  # a fetch: the call has completed

    def _device_call(self, x: torch.Tensor):
        """(ids, probs) of the serving weights on the device batch x. On a
        mesh rank 0 first sends the header and x, and every rank makes the
        call."""
        if self._lockstep is not None:
            self._lockstep.send(_PREDICT, x.shape[0])
            self._lockstep.share(x)
        clf = self.classifier
        return clf._predict(clf.variables, x)

    def _worker_start(self):
        """Make the classifier's device this thread's current device and
        touch it once: a thread's first CUDA call costs milliseconds, which
        the first request would otherwise pay. Rank 0 of a mesh then waits
        until every follower takes part in a header, so that a ready
        worker means ready ranks."""
        # The weights' device has an index where classifier.device may not.
        dev = next(iter(schema.flatten_tensors(self.classifier.variables).values())).device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev).add_(1).item()
        if self._lockstep is not None and self.rank == 0:
            self._lockstep.send(_NOOP, wait=True)

    def _mesh_failed(self, exc: BaseException):
        """A collective of a mesh server failed: the ranks are out of
        lockstep, so rank 0 stops serving and its serve_forever raises. A
        no-op without a mesh."""
        if self._lockstep is None:
            return
        get_logger("server").error("mesh collective failed, stopping: %s: %s", type(exc).__name__, exc)
        self._mesh_error = exc
        self._stop.set()
        if self._httpd is not None:
            threading.Thread(target=self._httpd.shutdown, daemon=True).start()

    def _worker(self):
        try:
            self._worker_start()
        except BaseException as exc:  # reported by start(), which raises it
            self._worker_error = exc
            self._worker_ready.set()
            return
        self._worker_ready.set()
        clf = self.classifier
        cuda = clf.device.type == "cuda"
        side = clf.host_side

        def dead(j: _Job) -> bool:
            # Abandoned (client got its 504) or past its deadline (client
            # is getting one): device time on it would starve new requests.
            return j.abandoned or time.monotonic() > j.deadline

        def dispatch_round(batch_jobs):
            """Stage this round's chunks and enqueue their device calls.
            Returns (batch_jobs, chunks, dispatch_failed); a failure is
            recorded, never raised: the worker must survive everything."""
            rows = [(job, k) for job in batch_jobs for k in range(len(job.images))
                    if job.images[k] is not None]
            chunks = []
            try:
                for at in range(0, len(rows), self.max_batch):
                    chunk = rows[at: at + self.max_batch]
                    bsz = self._bucket_for(len(chunk), self._bucket_sizes)
                    # A fresh pinned tensor per chunk: see the module
                    # docstring for why it is never one kept and rewritten.
                    staged = torch.empty((bsz, side, side, 3), dtype=torch.uint8, pin_memory=cuda)
                    host = staged.numpy()
                    for i, (job, k) in enumerate(chunk):
                        host[i] = job.images[k]
                    host[len(chunk):] = 0
                    with trace("serve/device_call"):
                        x = staged.to(clf.device, non_blocking=True)
                        ids, probs = self._device_call(x)
                        fetched = None
                        if cuda:
                            ids, probs = _to_host_async(ids), _to_host_async(probs)
                            fetched = torch.cuda.Event()
                            fetched.record()
                    # Counted once dispatched, bucket padding included: the
                    # bytes that really went to the device.
                    SPANS.count("serve/device_call_bytes", host.nbytes)
                    chunks.append((chunk, ids, probs, fetched))
            except Exception as exc:
                self._mesh_failed(exc)
                return batch_jobs, chunks, True
            return batch_jobs, chunks, False

        def finalize(round_):
            """Wait for this round's results and complete its jobs. A failed
            chunk (its wait or its assembly raised, or the dispatch cut the
            round short) fails only the jobs it left incomplete."""
            batch_jobs, chunks, failed = round_
            for chunk, ids_h, probs_h, fetched in chunks:
                # The wait and the assembly stay inside the handler: a CUDA
                # fault surfaces at the wait, and an assembly error (say, a
                # class_labels list shorter than the head) must fail the
                # round as device_error, not kill the worker thread.
                try:
                    with trace("serve/fetch"):
                        if fetched is not None:
                            fetched.synchronize()
                        ids = np.asarray(ids_h)
                        probs = np.asarray(probs_h)
                    for i, (job, k) in enumerate(chunk):
                        cid = int(ids[i])
                        job.results[k] = {
                            "label": clf.class_labels[cid],
                            "class_id": cid,
                            "confidence": float(probs[i, cid]),
                            "probs": [float(p) for p in probs[i]],
                        }
                except Exception:
                    failed = True
                    continue
            for job in batch_jobs:
                if failed and not all(job.results[k] is not None
                                      for k in range(len(job.images))
                                      if job.images[k] is not None):
                    job.error = "device_error"
                job.event.set()

        # Depth-2 pipelining: round i+1's device calls are enqueued before
        # round i's results are waited for, so the wait overlaps the next
        # round's host work. When the queue goes quiet, `pending` is
        # finalized within ~2 ms.
        pending = None
        while not self._stop.is_set():
            try:
                first = self._jobs.get(timeout=0.002 if pending else 0.2)
            except queue.Empty:
                if pending is not None:
                    finalize(pending)
                    pending = None
                if self._lockstep is not None and time.monotonic() - self._lockstep.sent > HEARTBEAT_S:
                    try:
                        self._lockstep.send(_NOOP)
                    except Exception as exc:
                        self._mesh_failed(exc)
                continue
            if first.reload:
                first.reply = self._mesh_reload()
                first.event.set()
                continue
            # Coalesce whole jobs until the device batch is full; a large
            # /classify_batch job is chunked over several device calls.
            batch_jobs = [] if dead(first) else [first]
            total = len(first.images) if batch_jobs else 0
            while total < self.max_batch:
                try:
                    j = self._jobs.get_nowait()
                except queue.Empty:
                    break
                if j.reload:  # runs on a later turn, after this batch
                    self._jobs.put(j)
                    break
                if dead(j):
                    continue
                batch_jobs.append(j)
                total += len(j.images)
            if not batch_jobs:
                continue
            new_round = dispatch_round(batch_jobs)
            if pending is not None:
                finalize(pending)
            pending = new_round
        if pending is not None:
            finalize(pending)
        if self._lockstep is not None and self._mesh_error is None:
            try:
                self._lockstep.send(_STOP, wait=True)  # the followers return
            except Exception as exc:
                self._mesh_failed(exc)

    def _preprocess(self, body: bytes):
        import cv2

        if not body:  # cv2.imdecode asserts on an empty buffer
            return None
        im = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        if im is None:
            return None
        # The file path's crop and resize (classify.prep_decoded): HTTP and
        # predict_paths give the same pixels for the same decoded image.
        return self.classifier.prep_decoded(im)

    # -- request plumbing (admission -> decode -> device -> result) ---------
    def _admit_with_budget(self, n_images: int, budget_s: float | None):
        """Stamp the request's deadline and take image-weighted admission
        slots. Returns (deadline, acquired); the caller releases `acquired`
        and has been shed if acquired < n_images."""
        budget = self.request_timeout_s
        if budget_s is not None and budget_s > 0:
            budget = min(budget_s, self.request_timeout_s)
        deadline = time.monotonic() + budget
        acquired = 0
        for _ in range(n_images):
            if not self._admit.acquire(blocking=False):
                break
            acquired += 1
        with self._inflight_lock:
            self._inflight += acquired
        return deadline, acquired

    def _release_slots(self, n: int):
        with self._inflight_lock:
            self._inflight -= n
        for _ in range(n):
            self._admit.release()

    def _run_job(self, bodies: list[bytes], budget_s: float | None = None):
        """Decode on the bounded pool, enqueue one job, wait for its results
        up to the deadline stamped at admission. Returns (job, images), or
        "overloaded" when admission sheds the request."""
        deadline, acquired = self._admit_with_budget(len(bodies), budget_s)
        try:
            if acquired < len(bodies):
                return "overloaded"
            images = list(self._decode_pool.map(self._preprocess, bodies))
            job = _Job(images, deadline=deadline)
            if self._stop.is_set():
                # The worker is gone or going: nobody would answer.
                job.error = "shutting_down"
                job.event.set()
            elif any(im is not None for im in images):
                self._jobs.put(job)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not job.event.wait(timeout=remaining):
                    # The client gets a 504; the worker drops the job.
                    job.abandoned = True
            else:
                job.event.set()  # nothing decodable: no device work
            return job, images
        finally:
            self._release_slots(acquired)

    def _run_stream(self, bodies: list[bytes], budget_s: float | None, emit) -> str | None:
        """The streaming twin of _run_job: one admission over all images,
        one job per max_batch chunk, and `emit(index, result)` as each
        chunk completes. Returns "overloaded" when admission sheds, else
        None. emit raising (client gone) abandons the remaining chunks."""
        deadline, acquired = self._admit_with_budget(len(bodies), budget_s)
        jobs: list[_Job] = []
        try:
            if acquired < len(bodies):
                return "overloaded"
            images = list(self._decode_pool.map(self._preprocess, bodies))
            for at in range(0, len(images), self.max_batch):
                job = _Job(images[at: at + self.max_batch], deadline=deadline)
                jobs.append(job)
                if self._stop.is_set():
                    job.error = "shutting_down"
                    job.event.set()
                elif any(im is not None for im in job.images):
                    self._jobs.put(job)
                else:
                    job.event.set()
            idx = 0
            for job in jobs:
                remaining = deadline - time.monotonic()
                done = remaining > 0 and job.event.wait(timeout=remaining)
                for k in range(len(job.images)):
                    if job.images[k] is None:
                        emit(idx, {"error": "undecodable image"})
                    elif job.results[k] is not None:
                        emit(idx, job.results[k])
                    elif not done:
                        emit(idx, {"error": "inference timeout"})
                    else:
                        emit(idx, {"error": f"inference backend: {job.error or 'unavailable'}"})
                    idx += 1
            return None
        except ConnectionError:
            return None  # client went away; finally abandons the rest
        finally:
            for job in jobs:
                if not job.event.is_set():
                    job.abandoned = True
            self._release_slots(acquired)

    def _reload_latest(self):
        """Load the max-step checkpoint from model_dir and swap it in.
        Returns (status_code, payload). On a mesh it runs as a job on the
        worker thread (module docstring)."""
        if self.model_dir is None:
            return 403, {"error": "server started without --model-dir; reload disabled"}
        if self._lockstep is not None:
            job = _Job([], reload=True)
            if not self._stop.is_set():
                self._jobs.put(job)
                job.event.wait()
            return job.reply or (503, {"error": f"reload not run: {job.error or 'shutting_down'}"})
        with self._reload_lock:
            return self._reload_latest_locked()

    def _open_store(self):
        """The model dir's store (params/checkpoint.open_store: npz files
        win, else DCP directories; raises on the JAX package's orbax
        directories)."""
        return open_store(self.model_dir)

    def _reload_latest_locked(self):
        clf = self.classifier
        try:
            # Inside the 409 guard: a corrupt file matching the checkpoint
            # pattern answers "rejected, old weights kept".
            loaded = self._open_store().load(cfg=clf.cfg)
        except Exception as exc:  # noqa: BLE001
            return 409, {"error": f"checkpoint rejected: {type(exc).__name__}: {exc}"}
        if loaded is None:
            return 404, {"error": f"no checkpoint found in {self.model_dir}"}
        var_flat, step = loaded
        try:
            variables = self._gated(var_flat)
            # It runs on this request thread, beside the worker serving the
            # old weights, and holds no lock the worker takes.
            self._probe(variables)
        except Exception as exc:  # noqa: BLE001
            return 409, {"error": f"checkpoint rejected: {type(exc).__name__}: {exc}"}
        return self._swap(variables, step)

    def _gated(self, var_flat: dict):
        """The serving tree of a checkpoint's flat dict, on the device.
        Structural gate before any swap: it must match the serving tree
        path for path and shape for shape (a checkpoint with another
        num_classes would otherwise serve silently wrong answers against
        this server's labels); raises ValueError."""
        clf = self.classifier
        variables = schema.variables_from_numpy(var_flat, clf.cfg, clf.device)
        old_flat = schema.flatten_tensors(clf.variables)
        new_flat = schema.flatten_tensors(variables)
        if set(old_flat) != set(new_flat):
            raise ValueError(
                f"variable set differs: only-old={sorted(set(old_flat) - set(new_flat))[:3]} "
                f"only-new={sorted(set(new_flat) - set(old_flat))[:3]}")
        for k in old_flat:
            if tuple(new_flat[k].shape) != tuple(old_flat[k].shape):
                raise ValueError(f"{k}: shape {tuple(new_flat[k].shape)} != serving "
                                 f"{tuple(old_flat[k].shape)}")
        return variables

    def _probe(self, variables):
        """Probe device call: one smallest-bucket forward on the new weights
        must give finite probabilities before the swap (NaN or Inf weights
        pass the structural gate); raises ValueError."""
        _, probs = self.classifier._predict(variables, self._zeros(self._bucket_sizes[0]))
        if not bool(torch.isfinite(probs).all()):
            raise ValueError("probe device call produced non-finite probabilities")

    def _swap(self, variables, step: int):
        self.classifier.variables = variables
        self.model_version = {"step": int(step), "path": self.model_dir}
        return 200, {"status": "reloaded", "step": int(step)}

    def _mesh_reload(self):
        """Rank 0's worker: choose the max-step checkpoint, send its step
        and reload it on every rank (`_reload_step`). (status, payload)."""
        try:
            ckpts = self._open_store().list_checkpoints()
        except Exception as exc:  # noqa: BLE001
            return 409, {"error": f"checkpoint rejected: {type(exc).__name__}: {exc}"}
        if not ckpts:
            return 404, {"error": f"no checkpoint found in {self.model_dir}"}
        step = max(c[0] for c in ckpts)
        try:
            self._lockstep.send(_RELOAD, step=step)
            return self._reload_step(step)
        except Exception as exc:  # a collective failed
            self._mesh_failed(exc)
            return 503, {"error": f"inference backend: device_error ({type(exc).__name__}: {exc})"}

    def _reload_step(self, step: int):
        """Every rank of a mesh: load the checkpoint at `step` from this
        rank's own store and gate it; if every rank did, probe it (a
        collective call, whose gathered probabilities every rank judges
        alike) and swap it in. All ranks swap or none does. (status,
        payload); a failed collective raises."""
        clf = self.classifier
        error = None
        try:
            store = self._open_store()
            path = next(p for s, _, p in store.list_checkpoints() if s == step)
            variables = self._gated(store.load(path, cfg=clf.cfg)[0])
        except Exception as exc:  # noqa: BLE001
            error = f"{type(exc).__name__}: {exc}"
        flag = torch.tensor([float(error is not None)], device=clf.device)
        refused = int(C.all_reduce_sum(flag, self._lockstep.group).item())
        if refused:
            return 409, {"error": f"checkpoint rejected on {refused} of {dist.get_world_size()} ranks: "
                                  f"{error or 'see the rejecting ranks'}"}
        try:
            self._probe(variables)
        except ValueError as exc:
            return 409, {"error": f"checkpoint rejected: {type(exc).__name__}: {exc}"}
        return self._swap(variables, step)

    # -- http ---------------------------------------------------------------
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response carries Content-Length
            # (_send). Paths that leave the request body unread (413, 411,
            # a big body on an unknown route) send Connection: close, since
            # the unread bytes would be parsed as the next request.
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY and a buffered wfile: with the stdlib defaults
            # (Nagle on, unbuffered writes) a response leaves as two small
            # segments, and on a reused connection the second waits for the
            # client's delayed ACK (~40 ms on Linux). The buffer makes
            # headers and body one segment; handle_one_request flushes
            # after every request, and the NDJSON path per line.
            disable_nagle_algorithm = True
            wbufsize = 64 * 1024
            # Idle keep-alive connections pin a thread each; the stdlib
            # closes one whose socket read times out between requests.
            timeout = server_self.idle_connection_s

            def log_message(self, *a):  # quiet
                pass

            def log_request(self, code="-", size="-"):
                # send_response calls this for every answered request,
                # before the status line is written, so a logging failure
                # must never propagate (it would reset every connection).
                if server_self._access_log.path is not None:
                    t0 = getattr(self, "_t0", None)
                    try:
                        server_self._access_log.emit(
                            "request",
                            method=self.command,
                            path=self.path.partition("?")[0],
                            status=int(code) if str(code).isdigit() else str(code),
                            ms=round((time.monotonic() - t0) * 1e3, 3) if t0 is not None else None,
                        )
                    except OSError as exc:
                        server_self._access_log.path = None  # drop it, keep serving; warn once
                        get_logger("server").warning("access log disabled: %s", exc)

            def _send(self, code: int, payload, headers=()):
                body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_overloaded(self):
                self._send(429, {"error": "server overloaded, retry later"},
                           headers=(("Retry-After", "1"),))

            def do_GET(self):
                self._t0 = time.monotonic()
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/readyz":
                    # Readiness: the device worker started and runs, and the
                    # server is not draining.
                    worker = server_self._threads[0] if server_self._threads else None
                    with server_self._inflight_lock:
                        inflight = server_self._inflight
                    if server_self._draining:
                        self._send(503, {"status": "draining", "inflight": inflight})
                    elif (not server_self._stop.is_set() and worker is not None
                          and worker.is_alive() and server_self._worker_ready.is_set()):
                        self._send(200, {"status": "ready", "inflight": inflight})
                    else:
                        self._send(503, {"status": "not ready",
                                         "stopping": server_self._stop.is_set()})
                elif self.path == "/labels":
                    self._send(200, server_self.classifier.class_labels)
                elif self.path == "/version":
                    self._send(200, server_self.model_version)
                elif self.path == "/metrics":
                    self._send(200, SPANS.summary())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                self._t0 = time.monotonic()
                path, _, query = self.path.partition("?")
                if path in ("/classify", "/classify_batch"):
                    # Counted from here through the response write, for the
                    # drain (slot accounting alone releases too early).
                    with server_self._inflight_lock:
                        server_self._active_requests += 1
                    try:
                        if server_self._draining:
                            # Shed before reading the body; the unread bytes
                            # force a close.
                            self._send(503, {"error": "server draining"},
                                       headers=(("Connection", "close"), ("Retry-After", "1")))
                        elif path == "/classify":
                            self._classify_single()
                        else:
                            self._classify_batch(stream="stream=1" in query.split("&"))
                    finally:
                        with server_self._inflight_lock:
                            server_self._active_requests -= 1
                elif path == "/reload":
                    self._drain_small_body()
                    code, payload = server_self._reload_latest()
                    self._send(code, payload)
                else:
                    self._drain_small_body()
                    self._send(404, {"error": "not found"})

            def _drain_small_body(self):
                """Consume an incidental request body so keep-alive framing
                stays intact; anything big, chunked or malformed forces a
                close instead."""
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    self.close_connection = True
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self.close_connection = True
                    return
                if 0 < length <= (1 << 16):
                    self.rfile.read(length)
                elif length:
                    self.close_connection = True

            def _budget_s(self) -> float | None:
                """The X-Timeout-Seconds header; _admit_with_budget clamps it
                to request_timeout_s (a client may ask for less, never more)."""
                raw = self.headers.get("X-Timeout-Seconds")
                if raw is None:
                    return None
                try:
                    return float(raw)
                except ValueError:
                    return None

            def _read_body(self):
                """The request body, or None after answering 411/400/413.
                The Content-Length check runs before any read."""
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    self._send(411, {"error": "chunked bodies unsupported; send Content-Length"},
                               headers=(("Connection", "close"),))
                    return None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._send(400, {"error": "malformed Content-Length"},
                               headers=(("Connection", "close"),))
                    return None
                if length > server_self.max_body_bytes:
                    self._send(413, {"error": f"body too large ({length} bytes; max "
                                              f"{server_self.max_body_bytes})"},
                               headers=(("Connection", "close"),))
                    return None
                return self.rfile.read(length)

            def _classify_single(self):
                with trace("serve/request"):
                    body = self._read_body()
                    if body is None:
                        return
                    out = server_self._run_job([body], budget_s=self._budget_s())
                if out == "overloaded":
                    self._send_overloaded()
                    return
                job, images = out
                if job.results[0] is not None:
                    self._send(200, job.results[0])
                elif images[0] is None:
                    self._send(400, {"error": "undecodable image"})
                elif job.error:
                    # A server-side failure on a valid request: 5xx, so
                    # clients retry.
                    self._send(503, {"error": f"inference backend: {job.error}"})
                elif not job.event.is_set():
                    self._send(504, {"error": "inference timeout"})
                else:
                    self._send(503, {"error": "inference unavailable"})

            def _classify_batch(self, stream: bool = False):
                with trace("serve/request_batch"):
                    raw = self._read_body()
                    if raw is None:
                        return
                    try:
                        images = json.loads(raw)["images"]
                        if not isinstance(images, list):
                            raise TypeError("images is not a list")
                    except Exception:
                        self._send(400, {"error": 'body must be JSON {"images": [base64, ...]}'})
                        return
                    if not images:
                        if stream:
                            self._start_stream()
                        else:
                            self._send(200, {"results": []})
                        return
                    # Size cap before any base64 work: rejection stays cheap.
                    if len(images) > server_self.max_inflight:
                        self._send(413, {"error": f"too many images (max {server_self.max_inflight})"})
                        return
                    try:
                        bodies = [base64.b64decode(s) for s in images]
                    except Exception:
                        self._send(400, {"error": "invalid base64 image"})
                        return
                    if stream:
                        self._classify_batch_stream(bodies)
                        return
                    out = server_self._run_job(bodies, budget_s=self._budget_s())
                if out == "overloaded":
                    self._send_overloaded()
                    return
                job, images = out
                if job.error:
                    self._send(503, {"error": f"inference backend: {job.error}"})
                    return
                if not job.event.is_set():
                    self._send(504, {"error": "inference timeout"})
                    return
                self._send(200, {"results": [r if r is not None else {"error": "undecodable image"}
                                             for r in job.results]})

            def _start_stream(self):
                """NDJSON response head: the length is unknown up front, so
                the stream ends by connection close (HTTP/1.0 semantics)."""
                self.protocol_version = "HTTP/1.0"
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()

            def _classify_batch_stream(self, bodies):
                """One NDJSON line per image, emitted as each max_batch
                chunk's device call completes. Admission runs before the
                200 head, so overload still sheds with a clean 429."""
                sent_head = []

                def emit(i, result):
                    if not sent_head:
                        self._start_stream()
                        sent_head.append(True)
                    line = dict(result)
                    line["index"] = i
                    self.wfile.write((json.dumps(line) + "\n").encode())
                    self.wfile.flush()

                out = server_self._run_stream(bodies, self._budget_s(), emit)
                if out == "overloaded":
                    self._send_overloaded()
                elif not sent_head:
                    self._start_stream()  # all undecodable: still a stream

        return Handler

    def start(self):
        if self.warmup:
            self._warmup()

        # The default listen backlog (5) refuses a burst of concurrent
        # clients at the socket; the micro-batching design wants deep queues.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _Server((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        worker = threading.Thread(target=self._worker, daemon=True, name="roomnet-serve-worker")
        worker.start()
        # Ready before the socket answers: /readyz's 200 means the worker
        # has its device.
        if not self._worker_ready.wait(WORKER_START_S) or self._worker_error is not None:
            self._stop.set()
            self._httpd.server_close()
            self._httpd = None  # never served: stop() must not wait for it
            raise RuntimeError("the device worker did not start") from self._worker_error
        self._threads = [worker, threading.Thread(target=self._httpd.serve_forever, daemon=True)]
        if self.auto_reload_s is not None:
            self._threads.append(threading.Thread(target=self._auto_reload_loop, daemon=True))
        for t in self._threads[1:]:
            t.start()
        return self

    def _auto_reload_loop(self):
        log = get_logger("server")
        last_rejected = None  # warn once per failing step, not per poll
        last_poll_error = None  # warn once per distinct failure, not per poll
        while not self._stop.wait(self.auto_reload_s):
            try:
                # Re-opened per poll: the dir's contents may change format.
                ckpts = self._open_store().list_checkpoints()
            except Exception as exc:  # noqa: BLE001
                # A transient poll failure must not kill the thread: a dead
                # poller would serve stale weights forever.
                err = f"{type(exc).__name__}: {exc}"
                if err != last_poll_error:
                    last_poll_error = err
                    log.warning("auto-reload: poll failed (%s); retrying "
                                "(logged once until it changes)", err)
                continue
            last_poll_error = None
            if not ckpts:
                continue
            step = ckpts[-1][0]
            current = self.model_version.get("step")
            if current is not None and step <= current:
                continue
            code, payload = self._reload_latest()
            if code == 200:
                last_rejected = None
                log.info("auto-reload: now serving step %s", payload["step"])
            elif step != last_rejected:
                last_rejected = step
                log.warning("auto-reload: step %s rejected (%s); keeping step %s",
                            step, payload.get("error"), current)

    def begin_drain(self):
        """Refuse new classify work (503 + Connection: close; /readyz goes
        503) while the worker answers everything already admitted."""
        self._draining = True

    def wait_drained(self, timeout_s: float) -> bool:
        """Block until every in-flight classify request has been answered
        (no active handlers, no held slots, an empty queue) or timeout_s
        passes. Returns True when drained."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            with self._inflight_lock:
                n = self._inflight + self._active_requests
            if n == 0 and self._jobs.empty():
                return True
            time.sleep(0.02)
        return False

    def stop(self):
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._decode_pool.shutdown(wait=False, cancel_futures=True)
        worker = self._threads[0] if self._threads else None
        if self._lockstep is not None and worker is not None and worker is not threading.current_thread():
            worker.join(WORKER_START_S)  # its last act is the followers' STOP
        # Fail queued jobs fast: their handlers would otherwise sit out
        # their budgets. Swept three times: a handler that raced past the
        # _stop check in _run_job may enqueue just after a sweep.
        for sweep in range(3):
            while True:
                try:
                    job = self._jobs.get_nowait()
                except queue.Empty:
                    break
                job.error = job.error or "shutting_down"
                job.event.set()
            if sweep < 2:
                time.sleep(0.05)

    def serve_forever(self):
        """Run until interrupted. SIGTERM gets the same clean shutdown as
        Ctrl-C: with drain_s > 0 the server drains first (/readyz 503, new
        classify work shed, admitted requests answered for up to drain_s),
        then stop() fails whatever remains. Returns 0. On a mesh, rank 0
        then sends STOP, and a failed collective makes it raise; a follower
        runs `follow`."""
        import signal

        if self.rank != 0:
            return self.follow()

        def _sigterm(*_):
            raise KeyboardInterrupt

        # Installed before start(): a stop signal racing start-up must take
        # the clean path. signal.signal works only from the main thread.
        if threading.current_thread() is threading.main_thread():
            prev = signal.signal(signal.SIGTERM, _sigterm)
        else:
            prev = None
        try:
            self.start()
            self._threads[1].join()
        except KeyboardInterrupt:
            pass
        finally:
            try:
                if self.drain_s > 0 and self._mesh_error is None:
                    self.begin_drain()
                    self.wait_drained(self.drain_s)
            except KeyboardInterrupt:
                pass  # a second signal during the drain: straight to stop
            finally:
                self.stop()
                if prev is not None:
                    signal.signal(signal.SIGTERM, prev)
        if self._mesh_error is not None:
            self.wait_drained(5.0)  # the failed requests' 503s go out first
            raise RuntimeError("a collective of the mesh failed; the ranks are out of lockstep") \
                from self._mesh_error
        return 0

    def follow(self) -> int:
        """A follower's serve_forever (mesh rank > 0): bind no socket, make
        rank 0's collective calls in its order, and return 0 at its STOP.
        SIGTERM is ignored here (a launcher sends it to every rank): the
        rank ends when rank 0, drained, sends STOP. If rank 0 is lost, the
        next collective raises after the group's timeout."""
        import signal

        self._worker_start()
        prev = None
        if threading.current_thread() is threading.main_thread():
            prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
        try:
            clf = self.classifier
            while True:
                op, bucket, step = self._lockstep.receive()
                if op == _STOP:
                    return 0
                if op == _PREDICT:
                    x = self._zeros(bucket)
                    self._lockstep.share(x)
                    clf._predict(clf.variables, x)
                elif op == _RELOAD:
                    self._reload_step(step)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)
