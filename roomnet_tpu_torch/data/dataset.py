"""Dataset preparation: list files, validity filtering, balanced split
(port of roomnet_tpu/data/dataset.py).

Reference behaviour preserved (train.py:44-112):
  * unreadable images dropped up front, in parallel (train.py:68-73 used a
    fork Pool; here a thread pool — cv2.imread releases the GIL);
  * class-balanced split: per-class train size = 90% of the *smallest*
    class (train.py:84-88);
  * outputs: ``train_list.txt`` / ``val_list.txt`` with ``<path> <label>``
    lines (paths may contain spaces; label is the last token —
    generator.py:101-104) and ``label_mappings.json`` (train.py:83);
  * warm path: existing list files are reused (train.py:55-61).

The seeded split draws the JAX package's numpy sequence, so both packages
write the same list files for the same seed.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from glob import glob

import numpy as np


@dataclass
class SplitResult:
    train_lines: list[str]
    val_lines: list[str]
    label_mappings: dict[str, int]


def parse_list_line(line: str) -> tuple[str, int]:
    """'<path with spaces> <label>\\n' -> (path, label) (generator.py:101-104)."""
    parts = line.strip().split(" ")
    return " ".join(parts[:-1]), int(parts[-1])


def is_readable_image(fpath: str) -> bool:
    import cv2

    return cv2.imread(fpath) is not None


def filter_valid_fpaths(fpaths: list[str], workers: int | None = None) -> list[str]:
    """Drop unreadable images (reference train.py:44-51), concurrently."""
    workers = workers or (os.cpu_count() or 8)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        keep = list(ex.map(is_readable_image, fpaths))
    return [p for p, k in zip(fpaths, keep) if k]


def extract_fpaths(
    data_dir: str,
    train_list_fpath: str = "train_list.txt",
    val_list_fpath: str = "val_list.txt",
    label_mappings_fpath: str = "label_mappings.json",
    *,
    train_frac: float = 0.9,
    seed: int | None = None,
    workers: int | None = None,
) -> tuple[list[str], list[str]]:
    """Generate (or reuse) balanced train/val list files. Same contract as
    reference train.py:54-112 with an optional seed for reproducibility."""
    if os.path.isfile(train_list_fpath) and os.path.isfile(val_list_fpath):
        with open(train_list_fpath) as f:
            train_txt = f.readlines()
        with open(val_list_fpath) as f:
            val_txt = f.readlines()
        return train_txt, val_txt

    rng = np.random.RandomState(seed)
    class_dirs = [d for d in sorted(glob(os.path.join(data_dir, "*"))) if os.path.isdir(d)]
    if not class_dirs:
        raise FileNotFoundError(f"no class dirs under {data_dir}")

    with ThreadPoolExecutor(max_workers=len(class_dirs)) as ex:
        futs = [ex.submit(filter_valid_fpaths, sorted(glob(os.path.join(d, "*"))), workers)
                for d in class_dirs]
        per_class = [f.result() for f in futs]

    labels = [os.path.basename(d.rstrip(os.sep)) for d in class_dirs]
    with open(label_mappings_fpath, "w") as f:
        json.dump({name: i for i, name in enumerate(labels)}, f, indent=4, sort_keys=True)

    train_n = int(train_frac * min(len(ps) for ps in per_class))
    train_txt, val_txt = [], []
    for i, paths in enumerate(per_class):
        paths = list(paths)
        rng.shuffle(paths)
        train_txt += [f"{p} {i}\n" for p in paths[:train_n]]
        val_txt += [f"{p} {i}\n" for p in paths[train_n:]]
    rng.shuffle(train_txt)
    rng.shuffle(val_txt)
    with open(train_list_fpath, "w") as f:
        f.writelines(train_txt)
    with open(val_list_fpath, "w") as f:
        f.writelines(val_txt)
    return train_txt, val_txt
