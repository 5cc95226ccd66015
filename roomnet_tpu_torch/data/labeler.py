"""Manual image labeling tool (port of roomnet_tpu/data/labeler.py, the
reference manual_classifier.py:11-95).

  * iterates a directory, shows each image and reads one key as its label;
  * resumable: labels.csv is the source of truth, and images already
    labeled are skipped on restart (manual_classifier.py:46-52, 60-64);
  * labeled images are copied into a directory per label;
  * everything is logged to log.txt; ESC aborts (manual_classifier.py:84-86).

The UI is pluggable: a cv2 window where there is a display, stdin prompts
otherwise (over SSH the reference's `cv2.imshow` would crash).
"""

from __future__ import annotations

import csv
import os
import shutil
from glob import glob
from typing import Callable

ESC = 27


def _cv2_ui(im_path: str) -> int:
    import cv2

    im = cv2.imread(im_path)
    if im is None:
        return -1
    cv2.imshow("image", im)
    return int(cv2.waitKey())


def _stdin_ui(im_path: str) -> int:
    # Stripped before the empty check: space + Enter re-prompts.
    resp = input(f"label for {os.path.basename(im_path)} (single key, 'q' to quit): ").strip()
    if not resp:
        return -1
    if resp.lower() == "q":
        return ESC
    return ord(resp[0])


class ImageLabeler:
    def __init__(self, in_dir: str, ui: Callable[[str], int] | None = None):
        self.in_dir = in_dir
        self.output_dir = in_dir.rstrip(os.sep) + "-labelled"
        self.log_file_fpath = os.path.join(self.output_dir, "log.txt")
        self.label_file_path = os.path.join(self.output_dir, "labels.csv")
        self.img_paths = sorted(glob(os.path.join(in_dir, "*")))
        os.makedirs(self.output_dir, exist_ok=True)
        self.num_images = len(self.img_paths)
        self.processed_image_names: list[str] = []
        self.ui = ui if ui is not None else (_cv2_ui if os.environ.get("DISPLAY") else _stdin_ui)

    def pl(self, line: str):
        with open(self.log_file_fpath, "a+") as f:
            f.write(line + "\n")
        print(line)

    def write_to_csv(self, img_name: str, label: list[str]):
        # The csv module quotes a file name with a comma, so resume matches
        # it; other names are written unquoted.
        with open(self.label_file_path, "a+", newline="") as f:
            csv.writer(f).writerow([os.path.basename(img_name)] + list(label))

    def extract_existing_labels(self) -> list[str]:
        if not os.path.isfile(self.label_file_path):
            return []
        with open(self.label_file_path, newline="") as f:
            return [row[0] for row in csv.reader(f) if row]

    def preprocess_label(self, label_raw: int) -> list[str]:  # override per use
        return [str(label_raw)]

    def label2dirname(self, label: list[str]) -> str:  # override per use
        return str(label[0])

    def run_labeller(self, resume: bool = True) -> int:
        """Label every image not labeled yet; returns how many were labeled."""
        if resume:
            self.processed_image_names = self.extract_existing_labels()
            self.pl(f"Resuming: {len(self.processed_image_names)} already labeled")
        labeled = 0
        for i, img_path in enumerate(self.img_paths):
            img_fname = os.path.basename(img_path)
            if img_fname in self.processed_image_names:
                self.pl(f"skip (done): {img_fname}")
                continue
            key = self.ui(img_path)
            if key == ESC:
                self.pl("Aborted by user")
                return labeled
            if key < 0:
                self.pl(f"unreadable/unlabeled: {img_fname}")
                continue
            label = self.preprocess_label(key)
            dst = os.path.join(self.output_dir, "binned_files", self.label2dirname(label))
            os.makedirs(dst, exist_ok=True)
            shutil.copy(img_path, dst)
            self.write_to_csv(img_fname, label)
            self.processed_image_names.append(img_fname)
            labeled += 1
            self.pl(f"{img_fname} -> {label}  ({100.0 * (i + 1) / self.num_images:.1f}%)")
        self.pl("All labels done")
        return labeled
