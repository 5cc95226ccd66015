"""The port's plots (roomnet_tpu_torch/plotting/plotter.py) against
roomnet_tpu's: both packages' functions on the same stats JSON (the
reference's schema, with its ragged 4-, 6- and 67-class entries), the same
evaluate_checkpoints result and the same checkpoint dir write the same file
names, and the decoded pixels of each PNG are equal (exact). The `plot`,
`plot-checkpoints` and `eval-ckpts --plot` subcommands are in
tests/test_torch_cli.py. matplotlib is an offline dependency: skipped
without it.
"""

import json
import os

import numpy as np
import pytest

from roomnet_tpu.plotting import plotter as jplot
from roomnet_tpu_torch import CLASS_LABELS
from roomnet_tpu_torch.plotting import plotter as tplot

plt = pytest.importorskip("matplotlib.pyplot")
cv2 = pytest.importorskip("cv2")


def stats(ragged: bool) -> list:
    """Stats entries in the reference schema, out of step order; with
    `ragged`, per-class lists of 4, 6 and 67 entries as in the reference's
    own all_train_stats.json."""
    rng = np.random.RandomState(7)
    widths = (4, 6, 67, 6) if ragged else (6, 6, 6, 6)
    return [{"step": step, "accuracy": float(rng.rand()),
             "precisions": rng.rand(w).tolist(), "recalls": rng.rand(w).tolist(), "f-scores": rng.rand(w).tolist()}
            for step, w in zip((30, 10, 40, 20), widths)]


def pixels(path: str) -> np.ndarray:
    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert im is not None and im.size > 0, path
    return im


def same_images(got: list, want: list):
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(pixels(g), pixels(w), err_msg=os.path.basename(g))


@pytest.mark.parametrize("ragged", [False, True])
def test_training_stats_plots_equal_the_jax_packages(tmp_path, ragged):
    sp = tmp_path / "stats.json"
    sp.write_text(json.dumps(stats(ragged)))
    outs = {}
    for name, mod in (("jax", jplot), ("port", tplot)):
        plt.close("all")
        outs[name] = mod.plot_training_stats(str(sp), str(tmp_path / name))
    assert [os.path.basename(p) for p in outs["port"]] == ["accuracy_plot.png", "fscore_plot.png",
                                                           "recall_plot.png", "precision_plot.png"]
    same_images(outs["port"], outs["jax"])


def saved_text(monkeypatch) -> list:
    """Patch pyplot.savefig to record, at each save, the file name and the
    current axes' title, axis labels and legend entries."""
    real, seen = plt.savefig, []

    def savefig(path, *args, **kwargs):
        ax = plt.gca()
        legend = ax.get_legend()
        seen.append((os.path.basename(str(path)), ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                     [t.get_text() for t in legend.get_texts()] if legend else []))
        return real(path, *args, **kwargs)

    monkeypatch.setattr(plt, "savefig", savefig)
    return seen


@pytest.mark.parametrize("class_labels,val_size", [(None, 360), (["a", "b", "c", "d", "e", "f"], "600")])
def test_class_labels_and_val_size_label_the_plots_as_the_jax_package_does(tmp_path, monkeypatch, class_labels,
                                                                          val_size):
    sp = tmp_path / "stats.json"
    sp.write_text(json.dumps(stats(False)))
    texts, outs = {}, {}
    for name, mod in (("jax", jplot), ("port", tplot)):
        plt.close("all")
        seen = saved_text(monkeypatch)
        outs[name] = mod.plot_training_stats(str(sp), str(tmp_path / name), class_labels=class_labels,
                                             val_size=val_size)
        texts[name] = seen
        monkeypatch.undo()
    assert texts["port"] == texts["jax"]
    assert texts["port"][0][3] == f"Validation Overall Accuracy over {val_size} images"
    assert texts["port"][1][4] == (class_labels or CLASS_LABELS)
    assert all(t[3].endswith(f"over {val_size} images") for t in texts["port"])
    same_images(outs["port"], outs["jax"])


def test_eval_sweep_plot_equals_the_jax_packages(tmp_path):
    """Measured and file-name curves, with a marker checkpoint that has no
    file-name accuracy."""
    result = {"checkpoints": [{"step": 10, "name_accuracy": 0.5, "accuracy": 0.4},
                              {"step": 20, "name_accuracy": None, "accuracy": 0.9},
                              {"step": 30, "name_accuracy": 0.8, "accuracy": 0.7}],
              "best": {"step": 20, "accuracy": 0.9}}
    outs = {}
    for name, mod in (("jax", jplot), ("port", tplot)):
        plt.close("all")
        (tmp_path / name).mkdir()
        outs[name] = [mod.plot_eval_sweep(result, str(tmp_path / name / "sweep.png"))]
    same_images(outs["port"], outs["jax"])


def test_checkpoint_accuracy_plot_equals_the_jax_packages(tmp_path):
    for name in ("jax", "port"):
        d = tmp_path / name / "models"
        d.mkdir(parents=True)
        for acc, step in [("0.5", 10), ("0.8", 30), ("0.7", 20), ("interrupt", 40)]:
            (d / f"roomnet--{acc}--{step}.npz").write_bytes(b"x")
    outs = {}
    for name, mod in (("jax", jplot), ("port", tplot)):
        plt.close("all")
        outs[name] = [mod.plot_checkpoint_accuracies(str(tmp_path / name / "models"))]
    assert os.path.basename(outs["port"][0]) == "models_accuracy_plot.png"
    same_images(outs["port"], outs["jax"])
    with pytest.raises(FileNotFoundError):
        tplot.plot_checkpoint_accuracies(str(tmp_path))
