"""Seeded images: the traffic's pixels, made by the benchmark alone.

`make_image` is a frozen copy of the repository's procedural 6-class
generator (tools/make_synth_dataset.py), so the traffic never changes under
the program's feet. A pool is a few such base images per class, varied on
the device: each image of the pool is a base with its own seeded noise and
its own flips, so every row differs while the pool is made in a few large
calls (numpy draws each base; the card draws the variations).
"""

from __future__ import annotations

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


def pool(seed: int, n: int, side: int, n_bases: int, noise: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(n, side, side, 3) uint8 BGR host images and their int32 classes.
    Image i is base i % n_bases, flipped left-right and up-down by a seeded
    coin each, plus uniform noise in [-noise, noise], clipped."""
    ims, cls = bases(seed, n_bases, side, side)
    g = torch_generator(seed, 2, device)
    b = torch.from_numpy(ims).to(device)
    idx = torch.arange(n, device=device) % n_bases
    flips = torch.randint(0, 2, (n, 2), generator=g, device=device, dtype=torch.uint8)
    x = b[idx].to(torch.int16)
    x = torch.where(flips[:, 0].view(-1, 1, 1, 1).bool(), x.flip(2), x)
    x = torch.where(flips[:, 1].view(-1, 1, 1, 1).bool(), x.flip(1), x)
    x = x + torch.randint(-noise, noise + 1, x.shape, generator=g, device=device, dtype=torch.int16)
    out = x.clamp_(0, 255).to(torch.uint8).cpu().numpy()
    return out, cls[idx.cpu().numpy()]
