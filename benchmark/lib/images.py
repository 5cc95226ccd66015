"""Seeded images: the traffic's pixels, made by the benchmark alone.

`make_image` is a frozen copy of the repository's procedural 6-class
generator (tools/make_synth_dataset.py), so the traffic never changes under
the program's feet. A pool is a few such base images per class, varied on
the device: each image of the pool is a base with its own seeded noise and
its own flips, so every row differs while the pool is made in a few large
calls (numpy draws each base; the card draws the variations). Files of
such images are written as JPEGs by `jpeg_files`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_CLASSES = 6


def numpy_rng(seed: int, stream: int) -> np.random.RandomState:
    """A RandomState for (seed, stream); any whole seed, also beyond 32 bits."""
    state = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(1)[0]
    return np.random.RandomState(int(state))


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(2, np.uint64)[0]))
    return g


def _canvas(rng, h, w):
    base = rng.randint(30, 226, size=3)
    return np.ones((h, w, 3), np.float32) * base


def _noise(rng, img, amp=18):
    img += rng.randn(*img.shape).astype(np.float32) * rng.uniform(2, amp)
    return img


def make_image(cls_id: int, rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB of class `cls_id`: stripes, checks, blobs,
    gradients or rectangles, with random colour, scale, phase and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = _canvas(rng, h, w)
    c2 = rng.randint(0, 256, size=3).astype(np.float32)
    if cls_id == 0:  # horizontal stripes
        f = rng.uniform(0.03, 0.25)
        mask = (np.sin(yy * f + rng.uniform(0, 6.3)) > rng.uniform(-0.4, 0.4))
        img[mask] = c2
    elif cls_id == 1:  # vertical stripes
        f = rng.uniform(0.03, 0.25)
        mask = (np.sin(xx * f + rng.uniform(0, 6.3)) > rng.uniform(-0.4, 0.4))
        img[mask] = c2
    elif cls_id == 2:  # checkerboard
        s = rng.randint(8, 48)
        mask = ((yy // s).astype(int) + (xx // s).astype(int)) % 2 == 0
        img[mask] = c2
    elif cls_id == 3:  # random blobs
        for _ in range(rng.randint(6, 18)):
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            r = rng.randint(8, max(9, min(h, w) // 5))
            col = rng.randint(0, 256, size=3).astype(np.float32)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[m] = col
    elif cls_id == 4:  # diagonal gradient
        ang = rng.uniform(0.6, 1.0) * rng.choice([-1, 1])
        g = (xx * np.cos(ang) + yy * np.sin(ang))
        g = (g - g.min()) / (np.ptp(g) + 1e-6)
        img = img * (1 - g[..., None]) + c2 * g[..., None]
    else:  # axis-aligned rectangles mosaic
        for _ in range(rng.randint(5, 14)):
            y0, x0 = rng.randint(0, h - 10), rng.randint(0, w - 10)
            y1 = y0 + rng.randint(8, h // 2)
            x1 = x0 + rng.randint(8, w // 2)
            img[y0:y1, x0:x1] = rng.randint(0, 256, size=3).astype(np.float32)
    img = _noise(rng, img)
    return np.clip(img, 0, 255).astype(np.uint8)


def bases(seed: int, n: int, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, h, w, 3) uint8 BGR images and their (n,) int32 classes, class
    i % 6 for image i."""
    rng = numpy_rng(seed, 1)
    ims = np.stack([make_image(i % N_CLASSES, rng, h, w)[:, :, ::-1] for i in range(n)])
    return ims, (np.arange(n) % N_CLASSES).astype(np.int32)


def vary(b: torch.Tensor, idx: torch.Tensor, noise: int, g: torch.Generator) -> np.ndarray:
    """(len(idx), h, w, 3) uint8 host images: base idx[i] of the device
    batch `b`, flipped left-right and up-down by a seeded coin each, plus
    uniform noise in [-noise, noise], clipped."""
    flips = torch.randint(0, 2, (len(idx), 2), generator=g, device=b.device, dtype=torch.uint8)
    x = b[idx].to(torch.int16)
    x = torch.where(flips[:, 0].view(-1, 1, 1, 1).bool(), x.flip(2), x)
    x = torch.where(flips[:, 1].view(-1, 1, 1, 1).bool(), x.flip(1), x)
    x = x + torch.randint(-noise, noise + 1, x.shape, generator=g, device=b.device, dtype=torch.int16)
    return x.clamp_(0, 255).to(torch.uint8).cpu().numpy()


def pool(seed: int, n: int, side: int, n_bases: int, noise: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(n, side, side, 3) uint8 BGR host images and their int32 classes.
    Image i is base i % n_bases, varied (`vary`)."""
    ims, cls = bases(seed, n_bases, side, side)
    g = torch_generator(seed, 2, device)
    idx = torch.arange(n, device=device) % n_bases
    return vary(torch.from_numpy(ims).to(device), idx, noise, g), cls[idx.cpu().numpy()]


def jpeg_files(seed: int, n: int, h: int, w: int, n_bases: int, noise: int, quality: int, directory: str,
               device, chunk: int = 128) -> list[str]:
    """Write n (h, w) JPEG files of baseline quality `quality` into
    `directory` and return their paths, file i from base i % n_bases, varied
    (`vary`) on the device a chunk at a time and encoded by cv2 on a thread
    pool (cv2 lets go of the interpreter's lock while it encodes). Each file
    is flushed to disk before this returns, so that the kernel's writeback
    of them does not fall into a measured window; the page cache keeps
    them."""
    import cv2

    ims, _ = bases(seed, n_bases, h, w)
    b = torch.from_numpy(ims).to(device)
    g = torch_generator(seed, 4, device)
    paths = [os.path.join(directory, f"{i:05d}.jpg") for i in range(n)]

    def write(path: str, im: np.ndarray) -> None:
        ok, buf = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError(f"cv2 could not encode {path}")
        with open(path, "wb") as f:
            f.write(buf.tobytes())
            os.fsync(f.fileno())

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for at in range(0, n, chunk):
            x = vary(b, torch.arange(at, min(at + chunk, n), device=device) % n_bases, noise, g)
            list(ex.map(write, paths[at: at + len(x)], x))
    return paths
