"""ctypes binding for the native host decoder (csrc/roomnet_io.cpp).

Port of roomnet_tpu/data/native.py. The library fuses decode -> crop ->
resize -> flip per image (JPEG via libjpeg, PNG via libpng, nothing else)
and fills a contiguous batch buffer with an internal thread pool, no GIL on
the hot path. Crop and flip choices stay in Python, so the native side is a
pure function of (path, crop rect, flips, out_side) and the cv2 path gives
the same images to within its fixed-point rounding.

The port compiles its own copy of the source with g++ at first use into
build/roomnet_tpu_torch/ (`ops.kernels._build.build_host`); it never loads
the JAX package's csrc/libroomnet_io.so, which was built for another host.
Callers check `available()`, which is false only where that build cannot
happen here (no g++, or no libjpeg/libpng headers), and take the cv2 path.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from ..ops.kernels import _build

_LIB = None
_TRIED = False
_lock = threading.Lock()


def _load():
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build.build_host("roomnet_io")))
        except (RuntimeError, OSError) as e:
            lines = str(e).splitlines() or [type(e).__name__]
            logging.getLogger("roomnet_tpu_torch.native").warning(
                "native decoder unavailable, decode takes the cv2 path: %s%s", lines[0],
                next((" (" + ln.strip() + ")" for ln in lines[1:] if "error" in ln), ""))
            return None
        lib.rn_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
        lib.rn_probe.restype = ctypes.c_int
        lib.rn_load_preprocess_scaled.argtypes = (
            [ctypes.c_char_p] + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_ubyte)])
        lib.rn_load_preprocess_scaled.restype = ctypes.c_int
        lib.rn_load_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rn_load_preprocess_batch.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def probe(path: str) -> tuple[int, int] | None:
    """(h, w) from the image header only, or None if undecodable."""
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.rn_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        return h.value, w.value
    return None


def load_preprocess(
    path: str,
    crop: tuple[int, int, int, int] | None,
    out_side: int,
    flip_lr: bool = False,
    flip_ud: bool = False,
    min_decode_side: int = 0,
) -> np.ndarray | None:
    """Decode+crop+resize+flip one image -> (S,S,3) BGR uint8, or None.

    min_decode_side > 0 enables DCT-scaled JPEG decode (1/2..1/8): up to 8x
    less decode work when the source is much larger than the target, with
    pixels slightly off the full decode (serving fast path, not parity).
    Crop coords remain in original-image space.
    """
    lib = _load()
    out = np.empty((out_side, out_side, 3), np.uint8)
    cx, cy, cw, ch = crop if crop is not None else (-1, -1, -1, -1)
    ok = lib.rn_load_preprocess_scaled(
        path.encode(), cx, cy, cw, ch, out_side, int(flip_lr), int(flip_ud),
        int(min_decode_side), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if ok else None


def load_preprocess_batch(
    paths: list[str],
    crops: np.ndarray,  # (n,4) int32, cx=-1 => full image
    out_side: int,
    flips: np.ndarray,  # (n,2) int32
    nthreads: int = 0,
    min_decode_side: int = 0,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch fused pipeline -> ((n,S,S,3) uint8, ok bool mask).

    `out`, when given, is a C-contiguous (>= n, S, S, 3) uint8 array whose
    first n rows receive the batch (a pinned staging buffer, say); rows of
    unreadable files are zeroed."""
    lib = _load()
    n = len(paths)
    if out is None:
        out = np.empty((n, out_side, out_side, 3), np.uint8)
    elif (out.dtype != np.uint8 or not out.flags.c_contiguous or out.shape[0] < n
          or out.shape[1:] != (out_side, out_side, 3)):
        raise ValueError(f"out must be C-contiguous uint8 (>={n},{out_side},{out_side},3), "
                         f"got {out.shape} {out.dtype}")
    ok = np.zeros(n, np.int32)
    crops = np.ascontiguousarray(crops, np.int32)
    flips = np.ascontiguousarray(flips, np.int32)
    if crops.shape != (n, 4) or flips.shape != (n, 2):
        raise ValueError(f"crops must be ({n},4) and flips ({n},2), got {crops.shape} {flips.shape}")
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.rn_load_preprocess_batch(
        arr,
        n,
        crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_side,
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        nthreads,
        int(min_decode_side),
    )
    return out[:n], ok.astype(bool)
