"""tools/train_synth_torch.py, the port's from-scratch curriculum run, on the
CPU at tests/tiny.py's geometry (6 classes): the summary has exactly the keys
of the JAX tool's committed run (docs/synth_convergence_r4/summary.json), its
phases are the JAX TrainConfig.reference_curriculum's, its throughput is the
JAX tool's sum of phase batch sizes over the wall time, the plots name the
val list's size, and the tool takes the JAX tool's flags and defaults plus
--device. The Trainer's steps against the JAX Trainer's are
tests/test_torch_train_loop_parity.py's.
"""

import ast
import dataclasses
import json
import os
import pathlib
import re
import types

import pytest

from chip_smoke import tiny_config
from roomnet_tpu.train.loop import TrainConfig as JTrainConfig
from roomnet_tpu.train.loop import phase_at as jphase_at
from tools import train_synth_torch as T

REPO = pathlib.Path(__file__).resolve().parents[1]
cv2 = pytest.importorskip("cv2")
STEPS, SAVE_FREQ, PER_CLASS = 8, 4, 6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny run: 36 generated JPEGs, 8 steps over the four phases, a
    validation and a checkpoint at step 4; the tool's clock reads 100 s and
    then 150 s, and every saved figure's axis labels are recorded."""
    plt = pytest.importorskip("matplotlib.pyplot")
    root = tmp_path_factory.mktemp("train_synth")
    clock = iter((100.0, 150.0))
    labels = []
    real_savefig, real_time = plt.savefig, T.time

    def savefig(path, *args, **kwargs):
        labels.append((os.path.basename(str(path)), plt.gca().get_ylabel()))
        return real_savefig(path, *args, **kwargs)

    plt.savefig, T.time = savefig, types.SimpleNamespace(time=lambda: next(clock))
    try:
        summary = T.train_synth(str(root / "data"), str(root / "work"), STEPS, per_class=PER_CLASS,
                                save_freq=SAVE_FREQ, cfg=dataclasses.replace(tiny_config(), num_classes=6),
                                device="cpu")
    finally:
        plt.savefig, T.time = real_savefig, real_time
    return {"summary": summary, "work": root / "work", "labels": labels}


def test_summary_has_the_jax_runs_keys_and_curriculum(run):
    with open(REPO / "docs" / "synth_convergence_r4" / "summary.json") as f:
        want_keys = set(json.load(f))
    with open(run["work"] / "summary.json") as f:
        summary = json.load(f)
    assert summary == run["summary"] and set(summary) == want_keys
    phases = JTrainConfig.reference_curriculum(total_steps=STEPS)
    assert summary["phases"] == [dataclasses.asdict(p) for p in phases]
    images_seen = sum(jphase_at(phases, s).batch_size for s in range(STEPS))  # tools/train_synth.py's sum
    assert summary["wall_s"] == 50.0
    assert summary["img_per_s_train_incl_val"] == round(images_seen / 50.0, 1)
    assert summary["steps"] == STEPS and summary["n_validations"] == 1 and summary["best_step"] == SAVE_FREQ
    with open(run["work"] / "all_train_stats.json") as f:
        stats = json.load(f)
    assert [e["step"] for e in stats] == [SAVE_FREQ]
    assert summary["final_accuracies"] == [stats[0]["accuracy"]] == [summary["best_accuracy"]]
    assert os.listdir(run["work"] / "models") == [f"roomnet--{stats[0]['accuracy']}--{SAVE_FREQ}.npz"]


def test_plots_name_the_val_lists_size(run):
    with open(run["work"] / "val_list.txt") as f:
        n_val = sum(1 for line in f if line.strip())
    assert n_val > 0
    names = [n for n, _ in run["labels"]]
    assert names == ["accuracy_plot.png", "fscore_plot.png", "recall_plot.png", "precision_plot.png"]
    assert all((run["work"] / n).stat().st_size > 0 for n in names)
    assert run["labels"][0][1] == f"Validation Overall Accuracy over {n_val} images"


def test_no_validation_gives_the_short_summary(tmp_path, run):
    """Fewer steps than save_freq: the JAX tool's three-key summary, no
    summary.json."""
    data = run["work"].parent / "data"
    summary = T.train_synth(str(data), str(tmp_path / "work"), 2, save_freq=SAVE_FREQ,
                            cfg=dataclasses.replace(tiny_config(), num_classes=6), device="cpu")
    assert set(summary) == {"steps", "wall_s", "n_validations"} and summary["n_validations"] == 0
    assert summary["steps"] == 2 and not (tmp_path / "work" / "summary.json").exists()


def flags(path: pathlib.Path) -> dict:
    """{flag: default} of every add_argument call in a script's source."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            default = next((k.value for k in node.keywords if k.arg == "default"), None)
            out[node.args[0].value] = ast.literal_eval(default) if default is not None else None
    return out


def test_flags_and_defaults_are_the_jax_tools_plus_device():
    assert flags(REPO / "tools" / "train_synth_torch.py") == {**flags(REPO / "tools" / "train_synth.py"),
                                                              "--device": None}


def test_main_hands_the_flags_to_train_synth(monkeypatch):
    seen = {}
    monkeypatch.setattr(T, "train_synth", lambda *a, **kw: seen.update(args=a, kw=kw))
    T.main(["--steps", "16000", "--workdir", "w", "--device", "cpu"])
    assert seen["args"] == ("/tmp/synth_rooms", "w", 16000)
    assert seen["kw"] == dict(per_class=600, save_freq=100, learn_rate=2e-4, seed=0, device="cpu")


def test_the_tool_imports_neither_jax_nor_the_jax_package():
    source = (REPO / "tools" / "train_synth_torch.py").read_text()
    imports = re.findall(r"(?m)^\s*(?:import|from)\s+([\w.]+)", source)
    assert imports and not [m for m in imports if m.split(".")[0] in ("jax", "jaxlib", "roomnet_tpu")]
