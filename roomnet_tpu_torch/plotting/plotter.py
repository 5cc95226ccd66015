"""Performance plots: the reference's four PNGs and its legacy plot (port of
roomnet_tpu/plotting/plotter.py).

  * `plot_training_stats` = plotter.py:25-112: the accuracy plot and the
    per-class F-score, recall and precision plots from the stats JSON,
    sorted by step, the best step in each title;
  * `plot_checkpoint_accuracies` = legacy_plotter.py:19-37: the accuracy
    curve parsed from checkpoint file names (``--{acc}--{step}``);
  * `plot_eval_sweep`: measured against file-name accuracy by step, from
    `infer/classify.evaluate_checkpoints`.

matplotlib (Agg) is imported only inside the functions that draw: plotting
runs on a host with matplotlib, and every other module imports without it.
"""

from __future__ import annotations

import json
import os
import re
from glob import glob

import numpy as np

CLASS_COLORS = (np.array([(244, 35, 231), (69, 69, 69), (219, 219, 0), (0, 0, 142), (0, 79, 100), (119, 10, 32)])
                .astype(np.float32) / 255.0)
CKPT_NAME_RE = re.compile(r"--(?P<acc>[\d.eE+-]+)--(?P<step>\d+)\.(npz|meta)$")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _accuracy_plot(plt, steps, accs, ylabel: str, out_path: str):
    plt.clf()
    plt.plot(steps, accs, "-", color="red", label="Classification Accuracy")
    plt.title(f"Model with max overall score is at step {steps[accs.argmax()]}\nwith value {accs.max()}")
    plt.legend(loc="best")
    plt.xlabel("Train Step")
    plt.ylabel(ylabel)
    plt.savefig(out_path, bbox_inches="tight", dpi=200)


def plot_training_stats(stats_json: str = "all_train_stats.json", out_dir: str = "performance_plots",
                        class_labels: list[str] | None = None, val_size: int | str = 1839) -> list[str]:
    """The accuracy, fscore, recall and precision PNGs from the stats JSON.
    `class_labels` name the per-class curves (default the reference's six);
    `val_size`, the validation set's size, goes into the axis labels (default
    the reference's 1839 images)."""
    from .. import CLASS_LABELS

    plt = _plt()
    class_labels = class_labels or CLASS_LABELS
    os.makedirs(out_dir, exist_ok=True)
    with open(stats_json) as f:
        stats = json.load(f)
    steps = np.array([s["step"] for s in stats])
    order = np.argsort(steps)
    steps = steps[order]
    accs = np.array([s["accuracy"] for s in stats])[order]

    def ragged(key):
        # The reference's own stats file mixes 4-, 6- and 67-class entries:
        # short rows are padded with NaN, which matplotlib leaves as gaps.
        rows = [s[key] for s in stats]
        arr = np.full((len(rows), max(len(r) for r in rows)), np.nan)
        for i, r in enumerate(rows):
            arr[i, : len(r)] = r
        return arr[order]

    per_class = {"fscore": ragged("f-scores"), "recall": ragged("recalls"), "precision": ragged("precisions")}
    acc_path = os.path.join(out_dir, "accuracy_plot.png")
    _accuracy_plot(plt, steps, accs, f"Validation Overall Accuracy over {val_size} images", acc_path)
    outputs = [acc_path]
    for name, arr in per_class.items():
        path = os.path.join(out_dir, f"{name}_plot.png")
        plt.clf()
        plt.figure(figsize=(20, 20))
        title = "Best Overall class performers -\n"
        for i in range(min(arr.shape[1], len(class_labels))):
            plt.plot(steps, arr[:, i], "-", color=CLASS_COLORS[i % len(CLASS_COLORS)], label=class_labels[i])
            best = np.nanargmax(arr[:, i])
            title += f"{class_labels[i]}---> model at step {steps[best]} with value {arr[best, i]}\n"
        plt.title(title)
        plt.legend(loc="best")
        plt.xlabel("Train Step")
        plt.ylabel(f"Validation Class {name} over {val_size} images")
        plt.savefig(path, bbox_inches="tight", dpi=200)
        plt.close("all")
        outputs.append(path)
    return outputs


def plot_checkpoint_accuracies(model_dir: str, out_path: str | None = None) -> str:
    """The accuracy curve from checkpoint file names (legacy_plotter.py:19-37)."""
    plt = _plt()
    pairs = []
    for p in glob(os.path.join(model_dir, "*roomnet*")):
        m = CKPT_NAME_RE.search(os.path.basename(p))
        if m:
            try:
                pairs.append((int(m.group("step")), float(m.group("acc"))))
            except ValueError:
                continue
    if not pairs:
        raise FileNotFoundError(f"no acc-named checkpoints in {model_dir}")
    pairs.sort()
    out_path = out_path or (model_dir.rstrip(os.sep) + "_accuracy_plot.png")
    _accuracy_plot(plt, np.array([s for s, _ in pairs]), np.array([a for _, a in pairs]),
                   "Validation Overall Accuracy", out_path)
    return out_path


def plot_eval_sweep(eval_result: dict, out_path: str) -> str:
    """Measured against file-name accuracy by step, from an
    `evaluate_checkpoints` result: file-name accuracies were scored against
    whatever validation set each run had; the measured curve uses one list."""
    plt = _plt()
    entries = eval_result["checkpoints"]
    named = [(e["step"], e["name_accuracy"]) for e in entries if e["name_accuracy"] is not None]
    plt.clf()
    plt.plot(np.array([e["step"] for e in entries]), np.array([e["accuracy"] for e in entries]), "-o",
             color="red", label="Measured Accuracy")
    if named:
        plt.plot([s for s, _ in named], [a for _, a in named], "--x", color="gray", label="Filename Accuracy")
    best = eval_result["best"]
    plt.title(f"Best measured model is at step {best['step']}\nwith value {best['accuracy']}")
    plt.legend(loc="best")
    plt.xlabel("Train Step")
    plt.ylabel("Accuracy on the evaluation list")
    plt.savefig(out_path, bbox_inches="tight", dpi=200)
    return out_path
